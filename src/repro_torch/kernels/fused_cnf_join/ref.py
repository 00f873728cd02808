"""Plain-torch version of the fused CNF-join kernel (identical math, unfused).

Every feature's full (n_l, n_r) distance plane is materialized, then
min-reduced over each clause's members and compared against the clause
threshold; clauses are ANDed.  The kernel wrapper (``kernel.py``) uses
these functions for tensors on the CPU, and ``chip_smoke.py`` holds the
CUDA kernel against them on the card.

Thresholds are rounded to float32 before the compare, exactly as the JAX
reference kernel does (a Python float against an f32 array is weakly
typed there, so the compare runs in f32).  The numpy engine compares f32
distances against float64 thresholds instead; the two can disagree only
for a distance that sits between a threshold and its f32 rounding.

torch has thin ``uint32`` support, so packed masks are ``int32`` words
whose bit 31 is the sign bit; ``unpack_mask`` (and any comparison against
the reference) views them as ``uint32`` after ``.cpu()``.
"""

from __future__ import annotations

import numpy as np
import torch

# feature kind tags used in the clause structure
VEC, SCAL = 0, 1


def _clause_dist(emb_l, emb_r, scal_l, scal_r, members) -> torch.Tensor:
    dmin = None
    for kind, fi in members:
        if kind == VEC:
            dot = emb_l[fi] @ emb_r[fi].T
            d = torch.clamp(0.5 - 0.5 * dot, 0.0, 1.0)
        else:
            d = torch.clamp(torch.abs(scal_l[fi][:, None] - scal_r[fi][None, :]),
                            0.0, 1.0)
        dmin = d if dmin is None else torch.minimum(dmin, d)
    return dmin


def _clause_pass(emb_l, emb_r, scal_l, scal_r, members, theta) -> torch.Tensor:
    dmin = _clause_dist(emb_l, emb_r, scal_l, scal_r, members)
    return dmin <= torch.tensor(float(theta), dtype=torch.float32,
                                device=dmin.device)


def cnf_join_ref(emb_l, emb_r, scal_l, scal_r, clauses, thetas) -> torch.Tensor:
    """Returns the boolean match matrix (n_l, n_r)."""
    ok = None
    for ci, members in enumerate(clauses):
        pas = _clause_pass(emb_l, emb_r, scal_l, scal_r, members, thetas[ci])
        ok = pas if ok is None else ok & pas
    return ok


def cnf_join_ref_counted(emb_l, emb_r, scal_l, scal_r, clauses, thetas, *,
                         early_reject: bool = True):
    """``cnf_join_ref`` with the band-level short-circuit and an honest
    conjunct-eval count: ``(ok, evals_units)``, where ``evals_units`` is the
    number of clauses whose distance plane was computed for this band (1
    for a band whose first clause passes nowhere, under ``early_reject``
    with >= 2 clauses)."""
    n_c = len(clauses)
    ok = _clause_pass(emb_l, emb_r, scal_l, scal_r, clauses[0], thetas[0])
    if early_reject and n_c >= 2 and not bool(ok.any()):
        return torch.zeros_like(ok), 1
    for ci in range(1, n_c):
        ok = ok & _clause_pass(emb_l, emb_r, scal_l, scal_r, clauses[ci],
                               thetas[ci])
    return ok, n_c


def cnf_join_tiles_ref(emb_l, emb_r, scal_l, scal_r, clauses, thetas, *,
                       tl: int, tr: int, early_reject: bool):
    """What the tiled kernel returns, computed unfused: ``(packed, evals)``
    with ``packed`` the int32 (n_l, n_r/32) mask and ``evals`` the int32
    (n_l/tl, n_r/tr) grid of clauses evaluated per tile (1 for a tile whose
    first clause passes nowhere, under ``early_reject`` with >= 2 clauses;
    the mask of such a tile is all zero either way)."""
    n_c = len(clauses)
    ok0 = _clause_pass(emb_l, emb_r, scal_l, scal_r, clauses[0], thetas[0])
    ok = ok0
    for ci in range(1, n_c):
        ok = ok & _clause_pass(emb_l, emb_r, scal_l, scal_r, clauses[ci],
                               thetas[ci])
    n_l, n_r = ok0.shape
    live = ok0.reshape(n_l // tl, tl, n_r // tr, tr).any(dim=3).any(dim=1)
    evals = torch.full(live.shape, n_c, dtype=torch.int32, device=ok.device)
    if early_reject and n_c >= 2:
        evals[~live] = 1
    return pack_mask(ok), evals


def pack_mask(ok: torch.Tensor) -> torch.Tensor:
    """Pack a boolean (n_l, n_r) matrix to int32 words along R: bit b of
    word w is column 32w+b (bit 31 is the sign bit)."""
    n_l, n_r = ok.shape
    if n_r % 32 != 0:
        raise ValueError(
            f"n_r={n_r} must be a multiple of 32 to pack into 32-bit words; "
            f"a ragged tail would be silently truncated")
    shifts = torch.arange(32, dtype=torch.int64, device=ok.device)
    words = (ok.reshape(n_l, n_r // 32, 32).to(torch.int64) << shifts).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def unpack_mask(packed, n_r: int) -> np.ndarray:
    """int32/uint32 (n_l, n_r//32) words -> bool (n_l, n_r) numpy array."""
    if isinstance(packed, torch.Tensor):
        packed = packed.cpu().numpy()
    p = np.ascontiguousarray(packed).view(np.uint32)
    bits = ((p[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1).astype(bool)
    return bits.reshape(p.shape[0], -1)[:, :n_r]


def dot_error_band(d: int) -> float:
    """D * 2**-24: the bound on the rounding error of an f32 dot product of
    unit vectors of length D, so two f32 implementations that sum in
    different orders may classify a pair apart only if its float64
    distance lies within this band of a threshold."""
    return d * 2.0 ** -24


def threshold_gap(emb_l, emb_r, scal_l, scal_r, clauses, thetas, ii,
                  jj) -> np.ndarray:
    """For the pairs (ii[k], jj[k]): the float64 distance from each
    clause's min distance to that clause's threshold, minimized over the
    clauses (a pair can flip only through a clause whose gap is small)."""
    ii = torch.as_tensor(np.asarray(ii, np.int64), device=emb_l.device)
    jj = torch.as_tensor(np.asarray(jj, np.int64), device=emb_l.device)
    gap = torch.full(ii.shape, float("inf"), dtype=torch.float64,
                     device=emb_l.device)
    for members, theta in zip(clauses, thetas):
        dmin = None
        for kind, fi in members:
            if kind == VEC:
                dot = (emb_l[fi][ii].double() * emb_r[fi][jj].double()).sum(-1)
                d = torch.clamp(0.5 - 0.5 * dot, 0.0, 1.0)
            else:
                d = torch.clamp(torch.abs(scal_l[fi][ii].double()
                                          - scal_r[fi][jj].double()), 0.0, 1.0)
            dmin = d if dmin is None else torch.minimum(dmin, d)
        gap = torch.minimum(gap, torch.abs(dmin - float(theta)))
    return gap.cpu().numpy()
