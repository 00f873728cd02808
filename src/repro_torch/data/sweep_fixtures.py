"""Threshold-sweep fixtures shared by the CPU tests, the GPU tests and
``chip_smoke.py``.

``edge_fixture`` holds every edge of f32 ``<=`` that the sweep's routes
must keep: +-inf and NaN on both sides, -0.0 against +0.0, distances
equal to thresholds, duplicate threshold rows and invalid sample rows
(+inf distances, so only ``valid`` keeps them out).  ``grid_fixture`` is
a labelled sample and the ``candidate_grid`` that ``plan_join``'s device
sweep builds from its positives, optionally followed by -inf rows up to the
next multiple of 256 above its size, as the direct route pads a grid.
``direct_fixture`` is ``edge_fixture`` at any C, padded for the direct
route and followed by a block of invalid rows.  ``bins_thetas`` gives
threshold rows whose clause c holds exactly ``u[c]`` distinct values, to
put the ranked route's bin count where a test wants it.
"""

from __future__ import annotations

import numpy as np

from repro_torch.kernels.threshold_sweep.ops import candidate_grid

_F32 = np.float32
# distances and thresholds that sit on an edge of f32 <=
_SPECIAL = np.array([-np.inf, -1.0, -0.0, 0.0, 0.25, 0.5, 1.0, np.inf],
                   _F32)


def edge_fixture(seed: int, k: int = 1037, c: int = 3, g: int = 48):
    """(cd, labels, valid, thetas): k sample rows (not a multiple of 512)
    and g threshold rows, f32, with at most 17 distinct threshold values a
    clause (at most 17**c bins)."""
    rng = np.random.default_rng(seed)
    pool = np.concatenate([_SPECIAL, rng.uniform(-1.5, 1.5, 9).astype(_F32)])
    cd = rng.uniform(-1.5, 1.5, size=(k, c)).astype(_F32)
    on_edge = rng.random((k, c)) < 0.5
    cd[on_edge] = rng.choice(np.append(pool, np.nan), size=int(on_edge.sum()))
    labels = (rng.random(k) < 0.4).astype(_F32)
    valid = (rng.random(k) >= 0.1).astype(_F32)
    valid[-40:] = 0.0
    cd[-40:] = np.inf                      # invalid rows that pass +inf
    thetas = rng.choice(pool, size=(g, c))
    thetas[0] = np.inf
    thetas[1] = -np.inf
    thetas[2] = -0.0
    thetas[3] = 0.0
    thetas[4, 0] = np.nan
    thetas[5] = [np.inf] + [0.5] * (c - 1)
    thetas[g - 4:] = thetas[6:10]          # duplicate rows
    return cd, labels, valid, thetas.astype(_F32)


def direct_fixture(c: int, seed: int = 0):
    """``edge_fixture(seed, 1037, c, 300)`` padded as ``ops.sweep`` pads the
    direct route (sample rows to 1536 with valid 0, -inf threshold rows to
    512), then 2048 more invalid rows at -inf, which every threshold but a
    NaN would pass: whole stages of pad rows that only ``valid`` keeps
    out."""
    k, g, pad_block = 1037, 300, 2048
    cd, labels, valid, th = edge_fixture(seed, k=k, c=c, g=g)
    kp = 1536 + pad_block
    cd = np.concatenate([cd, np.zeros((kp - k - pad_block, c), _F32),
                         np.full((pad_block, c), -np.inf, _F32)])
    labels = np.pad(labels, (0, kp - k), constant_values=1.0)
    valid = np.pad(valid, (0, kp - k))
    th = np.concatenate([th, np.full((512 - g, c), -np.inf, _F32)])
    return cd, labels, valid, th


def grid_fixture(seed: int, k: int, c: int, pad: bool):
    """(cd, labels, valid, thetas): k sample rows with about 10 %
    positives, which sit closer, and ``candidate_grid`` of the positives;
    ``pad`` appends 1 to 256 -inf rows, up to the next multiple of 256."""
    rng = np.random.default_rng(seed)
    labels = rng.random(k) < 0.1
    cd = rng.uniform(0, 1, size=(k, c)).astype(_F32)
    cd[labels] *= _F32(0.4)
    thetas = candidate_grid(cd[labels])
    if pad:
        g = thetas.shape[0]
        thetas = np.concatenate(
            [thetas, np.full((256 - g % 256, c), -np.inf, _F32)])
    return cd, labels.astype(_F32), np.ones(k, _F32), thetas


def bins_thetas(u, seed: int = 0) -> np.ndarray:
    """max(u) threshold rows in which clause c takes exactly u[c] distinct
    values, so that the ranked route sees prod(u) bins."""
    rng = np.random.default_rng(seed)
    g = max(u)
    cols = []
    for n in u:
        vals = np.sort(rng.choice(4 * g, size=n, replace=False)) / (4 * g)
        cols.append(vals[np.arange(g) % n])
    return np.stack(cols, axis=1).astype(_F32)
