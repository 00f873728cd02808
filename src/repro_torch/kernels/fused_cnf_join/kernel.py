"""Wrapper of the fused CNF-join CUDA kernel (``csrc/cnf_join.cu``).

``cnf_join_block`` computes what the JAX package's Pallas kernel of the
same name computes: the packed CNF mask over the full (n_l x n_r) plane,
one (tl x tr) tile at a time, plus, with ``with_evals``, the per-tile
count of clauses evaluated.  On CUDA tensors it launches the kernel on
the current stream (or raises); on CPU tensors it runs the plain-torch
version in ``ref.py``.  There is no fallback from one to the other.

The mask is int32 (n_l, n_r / 32); bit b of word w is column 32w+b, and
bit 31 is the sign bit (view it as uint32 after ``.cpu()``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_cnf_join import ref
from repro_torch.kernels.fused_cnf_join.ref import SCAL, VEC

__all__ = ["SCAL", "VEC", "cnf_join_block", "launches"]

MAX_CLAUSES = 32
MAX_MEMBERS = 64
_C_INT, _C_LL, _C_PTR = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
_ARGTYPES = [_C_PTR] * 4 + [_C_LL] * 4 + [_C_INT] * 4 + \
    [ctypes.POINTER(ctypes.c_int)] * 3 + [ctypes.POINTER(ctypes.c_float)] + \
    [_C_INT] * 3 + [_C_PTR] * 4

# kernel launches since the last reset (``launches["cnf_join"] = 0``)
launches = {"cnf_join": 0}


def _check_tiles(n_l: int, n_r: int, tl: int, tr: int) -> None:
    if tr % 32 != 0:
        raise ValueError(
            f"tr={tr} must be a multiple of 32: the output bitmask packs "
            f"32 R-neighbours per 32-bit word and a ragged tile would be "
            f"silently truncated")
    if n_l % tl != 0 or n_r % tr != 0:
        raise ValueError(
            f"(n_l={n_l}, n_r={n_r}) must be multiples of tiles "
            f"(tl={tl}, tr={tr}); pad via ops.pack_features")


def cnf_join_block(emb_l, emb_r, scal_l, scal_r, clauses, thetas, *,
                   tl: int = 256, tr: int = 512, early_reject: bool = False,
                   with_evals: bool = False):
    """Evaluate the CNF over the full (n_l x n_r) plane.

    emb_l: (F_v, n_l, D) f32   emb_r: (F_v, n_r, D) f32
    scal_l: (F_s, n_l) f32     scal_r: (F_s, n_r) f32
    clauses: tuple of clauses, each a tuple of (kind, idx) members
    thetas: per-clause thresholds, rounded to f32 for the compare
    early_reject: evaluate the later clauses of a tile only where clause 0
        passes somewhere in it (the mask is the same either way)
    with_evals: also return the (n_l // tl, n_r // tr) int32 grid of
        clauses evaluated per tile

    Returns the int32 (n_l, n_r // 32) mask, or ``(mask, evals)``.
    """
    n_l, n_r = emb_l.shape[1], emb_r.shape[1]
    _check_tiles(n_l, n_r, tl, tr)
    tensors = (emb_l, emb_r, scal_l, scal_r)
    if emb_l.is_cpu and emb_r.is_cpu and scal_l.is_cpu and scal_r.is_cpu:
        packed, evals = ref.cnf_join_tiles_ref(
            emb_l, emb_r, scal_l, scal_r, clauses, thetas, tl=tl, tr=tr,
            early_reject=early_reject)
        return (packed, evals) if with_evals else packed
    return _launch(tensors, clauses, thetas, tl, tr, early_reject, with_evals)


def _launcher():
    """The loaded library and its launch function, typed once."""
    lib = _build.load("cnf_join")
    fn = lib.cnf_join_launch
    if fn.argtypes is None:      # untyped, ctypes would cut pointers to int
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return lib, fn


@functools.lru_cache(maxsize=256)
def _plan(clauses: tuple, thetas: tuple, fv: int, fs: int) -> tuple:
    """The clause structure as the C interface takes it: (n_clauses,
    clause_off, kind, index, theta), validated once per plan."""
    kinds, index, offs = [], [], [0]
    for members in clauses:
        if not members:
            raise ValueError("cnf_join_block: empty clause")
        for kind, fi in members:
            kind, fi = int(kind), int(fi)
            bound = fv if kind == VEC else fs
            if kind not in (VEC, SCAL) or not 0 <= fi < bound:
                raise ValueError(f"cnf_join_block: bad member {(kind, fi)}")
            kinds.append(kind)
            index.append(fi)
        offs.append(len(kinds))
    if not 1 <= len(clauses) <= MAX_CLAUSES or len(kinds) > MAX_MEMBERS \
            or len(thetas) != len(clauses):
        raise ValueError(f"cnf_join_block: {len(clauses)} clauses / "
                         f"{len(kinds)} members / {len(thetas)} thetas (at "
                         f"most {MAX_CLAUSES} / {MAX_MEMBERS})")
    as_int = (lambda xs: (ctypes.c_int * len(xs))(*xs))
    # ctypes rounds each Python float to the nearest f32, as numpy does
    return (len(clauses), as_int(offs), as_int(kinds), as_int(index),
            (ctypes.c_float * len(thetas))(*map(float, thetas)))


def _plan_of(clauses, thetas, fv: int, fs: int) -> tuple:
    """``_plan`` keyed by the arguments as given where they are hashable
    (the engine passes tuples), else by their tuple copies."""
    try:
        return _plan(clauses, thetas, fv, fs)
    except TypeError:              # lists: unhashable
        return _plan(tuple(tuple(map(tuple, m)) for m in clauses),
                     tuple(thetas), fv, fs)


def _launch(tensors, clauses, thetas, tl, tr, early_reject, with_evals):
    # the checks below are written to cost little host time: at the main
    # path's size a call's host dispatch is comparable to its device time
    emb_l, emb_r, scal_l, scal_r = tensors
    dev = emb_l.device
    if not emb_l.is_cuda or emb_r.device != dev or scal_l.device != dev \
            or scal_r.device != dev:
        raise ValueError(f"cnf_join_block: inputs must all be on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    if not (emb_l.dtype == emb_r.dtype == scal_l.dtype == scal_r.dtype
            == torch.float32):
        raise TypeError(f"cnf_join_block: inputs must be float32, got "
                        f"{[t.dtype for t in tensors]}")
    fv, n_l, d = emb_l.shape
    fv_r, n_r, d_r = emb_r.shape
    fs, n_sl = scal_l.shape
    fs_r, n_sr = scal_r.shape
    if fv_r != fv or d_r != d or n_sl != n_l or n_sr != n_r or fs_r != fs:
        raise ValueError(f"cnf_join_block: mismatched plane shapes "
                         f"{[tuple(t.shape) for t in tensors]}")
    strides = (emb_l.stride(), emb_r.stride(), scal_l.stride(),
               scal_r.stride())
    for name, st, row in zip(("emb_l", "emb_r", "scal_l", "scal_r"), strides,
                             ((d, 1), (d, 1), (1,), (1,))):
        if st[1:] != row:
            raise ValueError(f"cnf_join_block: {name} rows must be contiguous")
    plan = _plan_of(clauses, thetas, fv, fs)
    out = torch.empty((n_l, n_r // 32), dtype=torch.int32, device=dev)
    evals = torch.empty((n_l // tl, n_r // tr), dtype=torch.int32,
                        device=dev) if with_evals else None
    # early reject: a flag per logical tile where clause 0 passes, and a
    # count of finished blocks (the last one writes the evals grid); the
    # launch function zeroes it on the stream
    live = torch.empty((n_l // tl) * (n_r // tr) + 1, dtype=torch.int32,
                       device=dev) if early_reject and len(clauses) >= 2 \
        else None
    if n_l and n_r:
        lib, fn = _launcher()
        args = (emb_l.data_ptr(), emb_r.data_ptr(), scal_l.data_ptr(),
                scal_r.data_ptr(), *(st[0] for st in strides), n_l, n_r, d,
                *plan, tl, tr, int(bool(early_reject)), out.data_ptr(),
                evals.data_ptr() if evals is not None else None,
                live.data_ptr() if live is not None else None,
                torch.cuda.current_stream(dev).cuda_stream)
        if dev.index == torch.cuda.current_device():
            status = fn(*args)
        else:                       # the runtime launches on its current device
            with torch.cuda.device(dev):
                status = fn(*args)
        _build.check(lib, status, "cnf_join_block")
        launches["cnf_join"] += 1
    return (out, evals) if with_evals else out
