"""Wrapper of the candidate-compaction CUDA kernel (``csrc/extract.cu``).

``compact_append`` appends the set bits of a packed (nl, nw) mask to an
int32 (capacity, 2) buffer as (i, j) pairs, in the reference's order (row
by row, word by word, the lowest bit first), and returns the new count,
which is never clamped: a count above the capacity means the tail was
dropped.  On CUDA tensors it makes one kernel launch on the current stream
(or raises); on CPU tensors it runs the plain-torch version in ``ref.py``.
There is no fallback from one to the other.

A call costs the host one allocation (the 0-d output count) and one launch:
an int ``count`` goes to the kernel by value, a device tensor by pointer,
and the kernel's look-back state lives on in ``LookBackState``, one array
per (device, stream), tagged per call with an epoch instead of being reset
by a launch.

Unlike the JAX package's functional update, ``buf`` is written in place
(a new buffer a step would double the device memory of a band step).
Counts are int32 as in the reference: a mask of 2**31 bits or more could
wrap them, so it raises.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.extract.ref import compact_append_ref

__all__ = ["MAX_BITS", "LookBackState", "bytes_bound", "compact_append",
           "launches"]

# int32 counts and slots: a mask must hold fewer bits than this
MAX_BITS = 1 << 31
TILE_WORDS = 8192                # kTileWords in csrc/extract.cu
MAX_TILES = -(-(MAX_BITS // 32) // TILE_WORDS)
# the look-back state: the ticket counter, then one word a tile
STATE_WORDS = 1 + MAX_TILES
# epochs run 1 .. EPOCH_LIMIT - 1 (30 bits of a state word); the state is
# zeroed before they start again
EPOCH_LIMIT = 1 << 30
_PTR, _INT, _UINT, _LL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                          ctypes.c_longlong)
_ARGTYPES = [_PTR, _LL, _INT, _INT, _INT, _LL, _PTR, _PTR, _PTR, _LL, _PTR,
             _LL, _UINT, _PTR]

# kernel launches since the last reset (``launches["compact"] = 0``)
launches = {"compact": 0}
# fleet workers launch from several threads: one call at a time takes its
# state and epoch and launches, so the epochs on a stream follow its order
_LOCK = threading.Lock()


def bytes_bound(nl: int, nw: int, n_pairs: int, capacity: int,
                count: int = 0) -> int:
    """Bytes a compaction of an (nl, nw) mask holding ``n_pairs`` set bits
    must move, into a buffer of ``capacity`` slots from slot ``count``:
    the mask read once, 8 B a pair written (slots in [0, capacity)), and
    the counts read and written (8 B), whatever an implementation reads
    again."""
    written = max(0, min(capacity, count + n_pairs) - max(0, count))
    return 4 * nl * nw + 8 * written + 8


class LookBackState:
    """The kernel's look-back state, one int64 array of ``STATE_WORDS``
    per (device, stream), zeroed when it is made, and the epoch of each
    call on it.  Two streams never share an array, so their calls may run
    at once; calls on one stream run in its order.  Sized for the largest
    mask a call takes, so it never grows."""

    def __init__(self):
        self._slots = {}

    def take(self, device: torch.device, stream: int):
        """(state, epoch) for the next call on ``stream`` of ``device``;
        the state is zeroed (on that stream) before an epoch is reused."""
        slot = self._slots.get((device, stream))
        if slot is None:
            slot = self._slots[device, stream] = [
                torch.zeros(STATE_WORDS, dtype=torch.int64, device=device), 0]
        slot[1] += 1
        if slot[1] >= EPOCH_LIMIT:
            slot[0].zero_()
            slot[1] = 1
        return slot[0], slot[1]


_STATE = LookBackState()


def compact_append(packed: torch.Tensor, buf: torch.Tensor, count, *,
                   row_offset: int = 0, col_offset: int = 0):
    """packed: int32 (nl, nw) mask (bit b of word w is column 32w + b);
    buf: int32 (capacity, 2), written in place; count: pairs already in
    ``buf`` (int, or an int32 0-d tensor on ``buf``'s device); row_offset,
    col_offset: the global coordinates of packed[0, 0]'s bit 0.

    Returns (buf, new_count), new_count an int32 0-d tensor on ``buf``'s
    device; new_count > capacity means the tail was dropped."""
    nl, nw = packed.shape
    if nl * nw * 32 >= MAX_BITS:
        raise ValueError(
            f"compact_append: a ({nl}, {nw}) mask holds {nl * nw * 32} bits; "
            f"int32 counts need fewer than 2**31 (narrow the band)")
    if buf.dim() != 2 or buf.shape[1] != 2 or buf.dtype != torch.int32:
        raise ValueError(f"compact_append: buf must be int32 (capacity, 2), "
                         f"got {buf.dtype} {tuple(buf.shape)}")
    if packed.is_cpu and buf.is_cpu:
        return compact_append_ref(packed, buf, count, row_offset=row_offset,
                                  col_offset=col_offset)
    return _launch(packed, buf, count, row_offset, col_offset)


def count_arg(count, device: torch.device):
    """(value, tensor): an int ``count`` goes to the kernel by value (the
    tensor is None); an int32 scalar tensor on ``device`` by pointer."""
    if isinstance(count, torch.Tensor):
        if count.device != device or count.dtype != torch.int32 \
                or count.numel() != 1:
            raise ValueError(f"compact_append: count must be an int32 scalar "
                             f"on {device}, got {count.dtype} on "
                             f"{count.device}")
        return 0, count.reshape(())
    value = int(count)
    if not -2 ** 31 <= value < 2 ** 31:
        raise ValueError(f"compact_append: count {value} is not an int32")
    return value, None


def launch_args(packed, buf, count, row_offset, col_offset, stream, state,
                epoch):
    """(the C entry point's arguments, the 0-d int32 output count)."""
    value, count_in = count_arg(count, buf.device)
    nl, nw = packed.shape
    count_out = torch.empty((), dtype=torch.int32, device=buf.device)
    args = (packed.data_ptr(), nl * nw, nw, int(row_offset), int(col_offset),
            value, None if count_in is None else count_in.data_ptr(),
            count_out.data_ptr(), buf.data_ptr(), buf.shape[0],
            state.data_ptr(), state.numel(), epoch, stream)
    return args, count_out


def _launcher():
    lib = _build.load("extract")
    fn = lib.compact_launch
    if fn.argtypes is None:      # untyped, ctypes would cut pointers to int
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return lib, fn


def _launch(packed, buf, count, row_offset, col_offset):
    dev = buf.device
    if not buf.is_cuda or packed.device != dev:
        raise ValueError(f"compact_append: mask and buffer must be on one "
                         f"CUDA device, got {packed.device} and {dev}")
    if packed.dtype != torch.int32 or not packed.is_contiguous():
        raise ValueError(f"compact_append: the mask must be a contiguous "
                         f"int32 tensor, got {packed.dtype}, strides "
                         f"{packed.stride()}")
    if not buf.is_contiguous() or buf.data_ptr() % 8:
        raise ValueError("compact_append: buf must be contiguous and "
                         "8-byte aligned (one 8-byte store a pair)")
    if packed.numel() == 0:
        value, count_in = count_arg(count, dev)
        if count_in is not None:
            return buf, count_in.clone()
        return buf, torch.full((), value, dtype=torch.int32, device=dev)
    lib, fn = _launcher()
    # the raw handle: a Stream object a call would cost the host microseconds
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    with _LOCK:
        state, epoch = _STATE.take(dev, stream)
        args, count_out = launch_args(packed, buf, count, row_offset,
                                      col_offset, stream, state, epoch)
        if dev.index == torch.cuda.current_device():
            status = fn(*args)
        else:                   # the runtime launches on its current device
            with torch.cuda.device(dev):
                status = fn(*args)
        if status == 0:
            launches["compact"] += 1
    _build.check(lib, status, "compact_append")
    return buf, count_out
