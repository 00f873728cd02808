"""Padded threshold sweep + candidate grid for step ⑥ (Eq 4).

``sweep`` pads the inputs to the kernel's tile multiples and returns the
(pos, sel) counts as float32 arrays, like the JAX reference; the counts
are exact integers.  ``sweep_counts`` is the guarantee path's entry
point: it runs the sweep on the requested device — the CUDA kernel on a
GPU, the plain-torch version on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.threshold_sweep.kernel import threshold_sweep


def _pad_rows(x, n, value):
    pad = n - x.shape[0]
    if pad <= 0:
        return x
    width = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, width, constant_values=value)


def sweep(cd: np.ndarray, labels: np.ndarray, thetas: np.ndarray, *,
          tg: int = 256, tk: int = 512, device="cuda"):
    """Padded sweep. Returns (pos_counts, sel_counts) as float32 (G,) arrays.

    Pad rows are excluded by an explicit validity mask (labels and valid
    padded with 0), not by sentinel distances (``inf <= inf`` is true);
    the cd pad value is immaterial, 0 keeps the compare well defined.
    Pad threshold rows are -inf, so they select nothing.
    """
    dev = resolve_device(device)
    k, c = cd.shape
    g = thetas.shape[0]
    kp = -(-k // tk) * tk
    gp = -(-g // tg) * tg
    cd_p = _pad_rows(cd.astype(np.float32), kp, 0.0)
    lab_p = _pad_rows(labels.astype(np.float32), kp, 0.0)
    valid_p = _pad_rows(np.ones(k, np.float32), kp, 0.0)
    th_p = _pad_rows(thetas.astype(np.float32), gp, -np.inf)
    out = threshold_sweep(*(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                            for a in (cd_p, lab_p, valid_p, th_p)),
                          tg=tg, tk=tk)
    out = out[:g].cpu().numpy().astype(np.float32)
    return out[:, 0], out[:, 1]


def sweep_counts(cd: np.ndarray, labels: np.ndarray, thetas: np.ndarray, *,
                 device="cuda") -> tuple:
    """(pos_counts, sel_counts) for the guarantee path (Eq 4)."""
    if thetas.shape[0] == 0:
        return np.zeros(0, np.float32), np.zeros(0, np.float32)
    return sweep(cd, labels, thetas, device=device)


def candidate_grid(cd_pos: np.ndarray, max_per_dim: int = 24,
                   max_grid: int = 4096) -> np.ndarray:
    """Cartesian grid of per-clause positive-distance quantiles.

    ``max_grid`` caps the total grid size: the naive cartesian product is
    ``max_per_dim ** C`` — an unguarded 24^C blowup for wide scaffolds —
    so per-dim quantile counts are shrunk (largest dim first) until the
    product fits.  Every dim always keeps its max positive distance (the
    recall-1 corner), so the grid is never infeasible when the sample has
    positives; at least 2 values per dim are kept whenever available.
    """
    c = cd_pos.shape[1]
    if c == 0:
        return np.zeros((1, 0), np.float32)
    uniq = [np.unique(cd_pos[:, j]) for j in range(c)]
    counts = [min(len(u), max_per_dim) for u in uniq]
    # shrink the largest dim until the cartesian product fits the cap
    while int(np.prod(counts)) > max_grid and max(counts) > 2:
        counts[int(np.argmax(counts))] -= 1
    axes = []
    for j, u in enumerate(uniq):
        if len(u) > counts[j]:
            qs = np.linspace(0, 1, counts[j])
            vals = np.unique(np.quantile(u, qs, method="nearest"))
        else:
            vals = u
        if len(vals) == 0 or vals[-1] != u[-1]:
            vals = np.append(vals, u[-1])   # keep the recall-1 corner
        axes.append(vals)
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.stack([m.ravel() for m in mesh], axis=1).astype(np.float32)
