"""Wrapper of the candidate-compaction CUDA kernel (``csrc/extract.cu``).

``compact_append`` appends the set bits of a packed (nl, nw) mask to an
int32 (capacity, 2) buffer as (i, j) pairs, in the reference's order (row
by row, word by word, the lowest bit first), and returns the new count,
which is never clamped: a count above the capacity means the tail was
dropped.  On CUDA tensors it launches the kernel's three passes on the
current stream (or raises); on CPU tensors it runs the plain-torch version
in ``ref.py``.  There is no fallback from one to the other.

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

__all__ = ["MAX_BITS", "compact_append", "launches"]

# int32 counts and slots: a mask must hold fewer bits than this
MAX_BITS = 1 << 31
_WORDS_PER_BLOCK = 4096          # kWordsPerBlock in csrc/extract.cu
_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_PTR, _LL, _INT, _INT, _INT, _PTR, _PTR, _PTR, _LL, _PTR, _PTR]

# kernel launches since the last reset (``launches["compact"] = 0``)
launches = {"compact": 0}
_COUNT_LOCK = threading.Lock()


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
    if isinstance(count, torch.Tensor):
        if count.device != dev or count.dtype != torch.int32 \
                or count.numel() != 1:
            raise ValueError(f"compact_append: count must be an int32 scalar "
                             f"on {dev}, got {count.dtype} on {count.device}")
        count_in = count.reshape(())
    else:
        # a fill, not a copy from the host (which would wait on the stream)
        count_in = torch.full((), int(count), dtype=torch.int32, device=dev)
    nl, nw = packed.shape
    n_words = nl * nw
    if n_words == 0:
        return buf, count_in.clone()
    count_out = torch.empty((), dtype=torch.int32, device=dev)
    blocks = -(-n_words // _WORDS_PER_BLOCK)
    scratch = torch.empty(2 * blocks, dtype=torch.int32, device=dev)
    lib, fn = _launcher()
    args = (packed.data_ptr(), n_words, nw, int(row_offset), int(col_offset),
            count_in.data_ptr(), count_out.data_ptr(), buf.data_ptr(),
            buf.shape[0], scratch.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if dev.index == torch.cuda.current_device():
        status = fn(*args)
    else:                       # the runtime launches on its current device
        with torch.cuda.device(dev):
            status = fn(*args)
    _build.check(lib, status, "compact_append")
    with _COUNT_LOCK:           # fleet workers launch from several threads
        launches["compact"] += 1
    return buf, count_out
