"""Wrapper of the threshold-sweep CUDA kernel (``csrc/threshold_sweep.cu``).

On CUDA tensors ``threshold_sweep`` launches the kernel on the current
stream (or raises); on CPU tensors it runs the plain-torch version in
``ref.py``.  There is no fallback from one to the other.  The result is
the exact int32 (G, 2) count table, [:, 0] positives and [:, 1] selected
(the TPU kernel's 128-lane f32 layout is not kept).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.threshold_sweep.ref import threshold_sweep_ref

MAX_CLAUSES = 32
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2

# kernel launches since the last reset (``launches["threshold_sweep"] = 0``)
launches = {"threshold_sweep": 0}


def threshold_sweep(cd, labels, valid, thetas, *, tg: int = 256,
                    tk: int = 512) -> torch.Tensor:
    """cd: (k, C) f32; labels, valid: (k,) f32 in {0, 1} (valid 0 marks a
    pad row); thetas: (G, C) f32.  k and G must be multiples of ``tk`` and
    ``tg`` (``ops.sweep`` pads: labels/valid with 0, thetas with -inf).
    Returns int32 (G, 2)."""
    k, c = cd.shape
    g = thetas.shape[0]
    if k % tk != 0 or g % tg != 0:
        raise ValueError(f"threshold_sweep: k={k} and G={g} must be "
                         f"multiples of tk={tk} and tg={tg}; pad via ops.sweep")
    tensors = (cd, labels, valid, thetas)
    if all(t.device.type == "cpu" for t in tensors):
        return threshold_sweep_ref(cd, labels, thetas, valid)
    dev = cd.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"threshold_sweep: inputs must all be on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.float32 or not t.is_contiguous() for t in tensors):
        raise TypeError("threshold_sweep: inputs must be contiguous float32")
    if thetas.shape[1] != c or labels.shape != (k,) or valid.shape != (k,):
        raise ValueError(f"threshold_sweep: mismatched shapes "
                         f"{[tuple(t.shape) for t in tensors]}")
    if not 1 <= c <= MAX_CLAUSES:
        raise ValueError(f"threshold_sweep: C={c} outside 1..{MAX_CLAUSES}")
    out = torch.empty((g, 2), dtype=torch.int32, device=dev)
    lib = _build.load("threshold_sweep")
    fn = lib.threshold_sweep_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(cd.data_ptr(), labels.data_ptr(), valid.data_ptr(),
                    thetas.data_ptr(), k, g, c, out.data_ptr(), stream)
    _build.check(lib, status, "threshold_sweep")
    launches["threshold_sweep"] += 1
    return out
