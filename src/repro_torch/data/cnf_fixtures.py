"""Representative CNF scaffolds for the synth datasets, and the CNF
kernel's boundary fixture.

``representative_cnf`` is shared by the engine parity tests and
``chip_smoke.py`` so both exercise the *same* decomposition.
``boundary_fixture`` puts pairs exactly on a clause's threshold, where the
kernel's f32 arithmetic and its plain version may part, so that the GPU
tests and ``chip_smoke.py`` measure how far apart they get.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.featurize import FeaturizationSpec
from repro_torch.kernels.fused_cnf_join.ref import SCAL, VEC


def representative_cnf(ds):
    """(specs, clauses, thetas) for a dataset by its field schema.

    police_records gets the paper's running example (date conjunct,
    officer/location disjunct); anything else gets one word-overlap clause
    per leading field.
    """
    fields = list(ds.fields_l.keys())
    if "incident_date" in fields:
        specs = [
            FeaturizationSpec("incident_date", "", "arithmetic", "llm", "incident_date"),
            FeaturizationSpec("officer_names", "", "word_overlap", "llm", "officer_names"),
            FeaturizationSpec("location", "", "semantic", "llm", "location"),
        ]
        return specs, [[0], [1, 2]], [0.02, 0.35]
    specs, clauses, thetas = [], [], []
    for i, f in enumerate(fields[:2]):
        specs.append(FeaturizationSpec(f, "", "word_overlap", "llm", f))
        clauses.append([i])
        thetas.append(0.4)
    return specs, clauses, thetas


def boundary_fixture(seed: int, *, nl: int = 512, nr: int = 1024,
                     d: int = 256, n_pairs: int = 64, n_dup: int = 64):
    """Kernel inputs with pairs on the thresholds: ``(arrays, clauses,
    thetas, pairs)``.

    ``arrays`` are (emb_l, emb_r, scal_l, scal_r) float32 numpy arrays:
    two planes of random unit vectors and one scalar plane.  ``clauses``
    are (SCAL 0), (VEC 0), (VEC 1).  ``thetas["on_threshold"]`` puts each
    embed clause's threshold exactly on the float64 distance of one of
    ``n_pairs`` chosen pairs ``pairs = (ii, jj)``, built at that distance
    in both planes, so all of them sit on it to within the rounding of
    f32 components.
    ``thetas["duplicates"]`` compares the embed clauses at theta = 0: the
    first ``n_dup`` rows of R are exact copies of the first ``n_dup`` rows
    of L, which pass only where the f32 dot product of a vector with
    itself rounds to >= 1.

    Clause 0 is the early-reject gate, far from its threshold (distance
    0.25 at theta 0.5): it passes on the first three quarters of L and
    nowhere on the last, so the evals grid of any tiling is the same for
    every implementation while the embed clauses' bits may part inside
    the f32 band.
    """
    rng = np.random.default_rng(seed)

    def unit(x):
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    el = unit(rng.normal(size=(2, nl, d))).astype(np.float32)
    er = unit(rng.normal(size=(2, nr, d))).astype(np.float32)
    live_rows = 3 * nl // 4
    ii = n_dup + rng.choice(live_rows - n_dup, size=n_pairs, replace=False)
    jj = n_dup + rng.choice(nr - n_dup, size=n_pairs, replace=False)
    thetas = [0.5]
    for f in range(2):
        target = 0.3 + 0.1 * f                     # distance, dot = 1 - 2t
        cos = 1.0 - 2.0 * target
        left = el[f, ii].astype(np.float64)
        u = rng.normal(size=left.shape)
        u = unit(u - (u * left).sum(-1, keepdims=True) * left)
        er[f, jj] = unit(cos * left + np.sqrt(1.0 - cos * cos) * u)
        d64 = 0.5 - 0.5 * (el[f, ii].astype(np.float64)
                           * er[f, jj].astype(np.float64)).sum(-1)
        thetas.append(float(np.sort(d64)[n_pairs // 2]))
    er[:, :n_dup] = el[:, :n_dup]
    scal_l = np.full((1, nl), 0.25, np.float32)
    scal_l[0, live_rows:] = 8.0
    scal_r = np.full((1, nr), 0.5, np.float32)
    clauses = (((SCAL, 0),), ((VEC, 0),), ((VEC, 1),))
    return ((el, er, scal_l, scal_r), clauses,
            {"on_threshold": tuple(thetas), "duplicates": (0.5, 0.0, 0.0)},
            (ii, jj))
