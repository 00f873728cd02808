"""Wrapper of the threshold-sweep CUDA kernels (``csrc/threshold_sweep.cu``).

``threshold_sweep`` has two routes.  With ``axes`` (``ops.rank_axes`` of
the thresholds, at most ``RANKED_MAX_BINS`` bins) it takes the ranked
route: rank each sample row against every clause's distinct threshold
values, histogram the rank vectors, take a prefix along every clause and
read each threshold row off the table.  Without ``axes`` it takes the
direct route, which compares every sample row with every threshold row.

On CUDA tensors the wrapper launches the route's kernels on the current
stream (or raises); on CPU tensors it runs the route's plain-torch
version in ``ref.py``.  There is no fallback from one to the other.  The
result is the exact int32 (G, 2) count table, [:, 0] positives and
[:, 1] selected (the TPU kernel's 128-lane f32 layout is not kept).
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.threshold_sweep.ref import (
    threshold_sweep_ranked_ref, threshold_sweep_ref)

MAX_CLAUSES = 32
# the ranked route's (bins, 2) int32 table lives in one block's shared
# memory: 2**14 bins is 128 KB
RANKED_MAX_BINS = 1 << 14
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_DIRECT_ARGTYPES = [_PTR] * 4 + [_INT] * 3 + [_PTR] * 2
_RANKED_ARGTYPES = [_PTR] * 6 + [_INT] * 3 + [_PTR] * 3

# wrapper calls that launched a kernel since the last reset (set each to 0):
# every call, and each route's calls
launches = {"threshold_sweep": 0, "threshold_sweep_ranked": 0,
            "threshold_sweep_direct": 0}
_COUNT_LOCK = threading.Lock()


def threshold_sweep(cd, labels, valid, thetas, *, axes=None, tg: int = 256,
                    tk: int = 512) -> torch.Tensor:
    """cd: (k, C) f32; labels, valid: (k,) f32 in {0, 1} (valid 0 marks a
    pad row); thetas: (G, C) f32.  Returns int32 (G, 2).

    axes: ``(values, offsets)`` from ``ops.rank_axes(thetas)`` for the
    ranked route: values (sum of u_c,) f32 on the inputs' device, offsets
    (C + 1,) int32 on the CPU (the axis lengths are launch parameters).
    Any k and G.  Without axes, the direct route: k and G must be
    multiples of ``tk`` and ``tg`` (``ops.sweep`` pads: labels/valid with
    0, thetas with -inf)."""
    k, c = cd.shape
    g = thetas.shape[0]
    if axes is None and (k % tk != 0 or g % tg != 0):
        raise ValueError(f"threshold_sweep: k={k} and G={g} must be "
                         f"multiples of tk={tk} and tg={tg}; pad via ops.sweep")
    tensors = (cd, labels, valid, thetas)
    if all(t.device.type == "cpu" for t in tensors) and \
            (axes is None or axes[0].device.type == "cpu"):
        if axes is None:
            return threshold_sweep_ref(cd, labels, thetas, valid)
        return threshold_sweep_ranked_ref(cd, labels, thetas, valid, axes)
    dev = cd.device
    if axes is not None:
        tensors += (axes[0],)
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"threshold_sweep: inputs must all be on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.float32 or not t.is_contiguous() for t in tensors):
        raise TypeError("threshold_sweep: inputs must be contiguous float32")
    if thetas.shape[1] != c or labels.shape != (k,) or valid.shape != (k,):
        raise ValueError(f"threshold_sweep: mismatched shapes "
                         f"{[tuple(t.shape) for t in tensors[:4]]}")
    if not 1 <= c <= MAX_CLAUSES:
        raise ValueError(f"threshold_sweep: C={c} outside 1..{MAX_CLAUSES}")
    out = torch.empty((g, 2), dtype=torch.int32, device=dev)
    lib, direct, ranked = _launchers()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if axes is None:
        args = (direct, cd.data_ptr(), labels.data_ptr(), valid.data_ptr(),
                thetas.data_ptr(), k, g, c, out.data_ptr(), stream)
        route = "threshold_sweep_direct"
    else:
        table = torch.empty((_check_axes(axes, c), 2), dtype=torch.int32,
                            device=dev)
        args = (ranked, cd.data_ptr(), labels.data_ptr(), valid.data_ptr(),
                thetas.data_ptr(), axes[0].data_ptr(), axes[1].data_ptr(), k,
                g, c, table.data_ptr(), out.data_ptr(), stream)
        route = "threshold_sweep_ranked"
    if dev.index == torch.cuda.current_device():
        status = args[0](*args[1:])
    else:                           # the runtime launches on its current device
        with torch.cuda.device(dev):
            status = args[0](*args[1:])
    _build.check(lib, status, "threshold_sweep")
    with _COUNT_LOCK:               # fleet workers launch from several threads
        launches["threshold_sweep"] += 1
        launches[route] += 1
    return out


@functools.cache
def _launchers():
    """The loaded library and its two launch functions, typed once."""
    lib = _build.load("threshold_sweep")
    direct, ranked = lib.threshold_sweep_launch, lib.threshold_sweep_ranked_launch
    direct.argtypes, direct.restype = _DIRECT_ARGTYPES, ctypes.c_int
    ranked.argtypes, ranked.restype = _RANKED_ARGTYPES, ctypes.c_int
    return lib, direct, ranked


def _check_axes(axes, c: int) -> int:
    """The ranked route's bin count, after checking its offsets: int32
    (C + 1,) on the CPU, from 0 to len(values), non-decreasing, at most
    RANKED_MAX_BINS bins."""
    values, offsets = axes
    if offsets.device.type != "cpu" or offsets.dtype != torch.int32 or \
            offsets.shape != (c + 1,) or not offsets.is_contiguous():
        raise ValueError("threshold_sweep: axis offsets must be a contiguous "
                         "int32 CPU tensor of C + 1 entries")
    off = offsets.tolist()
    lengths = [b - a for a, b in zip(off, off[1:])]
    if off[0] != 0 or off[-1] != values.numel() or min(lengths) < 0:
        raise ValueError("threshold_sweep: axis offsets must run from 0 to "
                         "len(values) without decreasing")
    bins = math.prod(lengths)
    if bins > RANKED_MAX_BINS:
        raise ValueError(f"threshold_sweep: {bins} bins exceed the ranked "
                         f"route's {RANKED_MAX_BINS}; use the direct route")
    return bins
