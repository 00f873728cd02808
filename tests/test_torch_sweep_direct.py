"""The threshold sweep's direct route against the JAX reference, on the
CPU.

The direct route compares every sample row with every threshold row; its
CUDA kernel (``csrc/threshold_sweep.cu``, ``threshold_sweep_launch``)
tiles threshold rows by the clause count C (8 rows a thread up to C 8, 4
up to C 16, 2 above, C 17..32 run with +inf clauses up to the next
multiple of 4), stages sample rows through shared memory in stages that
need not divide k, and sizes its threads by G.  These tests hold the
route's plain version (the wrapper on CPU tensors) and
``ops.sweep(..., device="cpu")`` to the JAX package's Pallas kernel in
interpret mode, its ``ops.sweep(..., interpret=True)`` and its ``ref.py``
on the shapes that tiling meets: C in {1, 8, 9, 15, 32}; k not a
multiple of 32 before padding; NaN, +-0.0 and +-inf on both sides; a
block of pad rows at -inf that only ``valid`` keeps out; G 1 and 2**15
(a 15-clause ``candidate_grid``, which takes the direct route) at small
k.  tests/test_torch_cuda_kernels.py holds the kernel to the plain
version on the card on the same fixtures.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.threshold_sweep import ops as jops
from repro.kernels.threshold_sweep.kernel import threshold_sweep as jkernel
from repro.kernels.threshold_sweep.ref import threshold_sweep_ref as jref
from repro_torch.data.sweep_fixtures import direct_fixture, grid_fixture
from repro_torch.kernels.threshold_sweep import ops as tops
from repro_torch.kernels.threshold_sweep.kernel import (RANKED_MAX_BINS,
                                                        threshold_sweep)
from repro_torch.kernels.threshold_sweep.ops import candidate_grid

CLAUSES = (1, 8, 9, 15, 32)
K, G = 1037, 300                    # direct_fixture's unpadded shape


def _plain(cd, labels, valid, th):
    return threshold_sweep(*(torch.from_numpy(a) for a in
                             (cd, labels, valid, th))).numpy()


def _jax_ref(cd, labels, th, valid=None):
    out = jref(jnp.asarray(cd), jnp.asarray(labels), jnp.asarray(th),
               None if valid is None else jnp.asarray(valid))
    return np.asarray(out)


@pytest.mark.parametrize("c", CLAUSES)
def test_direct_fixture_holds_every_edge(c):
    cd, labels, valid, th = direct_fixture(c, seed=c)
    assert cd.shape[0] % 512 == 0 and th.shape[0] % 256 == 0
    assert np.isnan(cd).any() and np.isnan(th).any()
    for v in (np.inf, -np.inf):
        assert (cd == v).any() and (th == v).any()
    zeros = np.concatenate([cd[np.isfinite(cd)], th[np.isfinite(th)]])
    assert (np.signbit(zeros) & (zeros == 0)).any() and \
        (~np.signbit(zeros) & (zeros == 0)).any()
    assert (valid[-2048:] == 0).all() and (cd[-2048:] == -np.inf).all()


@pytest.mark.parametrize("c", CLAUSES)
def test_direct_plain_version_matches_jax_kernel(c):
    """The wrapper's direct route on CPU tensors against the Pallas kernel
    in interpret mode and the jnp oracle, on the padded inputs with their
    validity mask: counts exactly equal."""
    cd, labels, valid, th = direct_fixture(c, seed=c)
    got = _plain(cd, labels, valid, th)
    assert got.dtype == np.int32
    want = np.asarray(jkernel(*(jnp.asarray(a) for a in
                                (cd, labels, valid, th)),
                              interpret=True))[:, :2]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _jax_ref(cd, labels, th, valid))
    # a pad threshold row (-inf) selects only valid rows at -inf in every
    # clause; a +inf row selects every valid row but those with a NaN
    at_neg_inf = (valid != 0) & (cd == -np.inf).all(axis=1)
    assert (got[G:, 1] == int(at_neg_inf.sum())).all()
    assert got[0, 1] == int(((valid != 0) & ~np.isnan(cd).any(axis=1)).sum())


@pytest.mark.parametrize("c", CLAUSES)
def test_direct_sweep_matches_jax_sweep(c):
    """``ops.sweep(device="cpu")`` on the unpadded rows (k 1037) against the
    reference's ``ops.sweep`` (interpret mode) and ``ref.py``."""
    cd, labels, _, th = direct_fixture(c, seed=c)
    cd, labels, th = cd[:K], labels[:K] != 0, th[:G]
    got = tops.sweep(cd, labels, th, device="cpu")
    want = jops.sweep(cd, labels, th, interpret=True)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    ref = _jax_ref(cd, labels.astype(np.float32), th)
    np.testing.assert_array_equal(np.stack(got, axis=1), ref)


@pytest.mark.parametrize("g", [1, 1 << 15])
def test_fifteen_clause_grid_matches_jax(g):
    """A 15-clause ``candidate_grid`` (2**15 rows, 2**15 bins: the direct
    route) and its first row alone, at k 333: ``ops.sweep`` and the
    direct route's plain version against the reference."""
    cd, labels, _, th = grid_fixture(215, 333, 15, False)
    assert th.shape == (1 << 15, 15)
    th = th[:g]
    assert (tops.rank_axes(th)[2] > RANKED_MAX_BINS) == (g > 1)
    got = tops.sweep(cd, labels != 0, th, device="cpu")
    want = jops.sweep(cd, labels, th, interpret=True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.stack(got, axis=1),
                                  _jax_ref(cd, labels, th))
    # the direct route's plain version on the inputs as ops.sweep pads them
    kp, gp = 512, -(-g // 256) * 256
    pad = np.zeros((kp - 333, 15), np.float32)
    plain = _plain(np.concatenate([cd, pad]), np.pad(labels, (0, kp - 333)),
                   np.pad(np.ones(333, np.float32), (0, kp - 333)),
                   np.concatenate([th, np.full((gp - g, 15), -np.inf,
                                               np.float32)]))
    np.testing.assert_array_equal(plain[:g], np.stack(got, axis=1))
    assert (plain[g:] == 0).all()
    assert plain[:, 1].max() > 0 or g == 1    # the recall-1 corner selects


def test_candidate_grid_wide_scaffold_keeps_two_values_a_clause():
    """At 15 clauses with 24 distinct positive distances each, the cap
    leaves 2 values a clause (the smallest and the largest), 2**15 rows.
    The reference's cap multiplies the counts in int64, which wraps
    (24**15 > 2**63), ends its loop early and asks for a grid too large to
    build (src/repro/kernels/threshold_sweep/ops.py:85); the port's
    product is exact."""
    rng = np.random.default_rng(15)
    pos = rng.uniform(0, 1, size=(400, 15)).astype(np.float32)
    grid = candidate_grid(pos)
    assert grid.shape == (1 << 15, 15)
    for j in range(15):
        assert sorted(set(grid[:, j].tolist())) == \
            [float(pos[:, j].min()), float(pos[:, j].max())]
    with pytest.raises(ValueError, match="too large"):
        jops.candidate_grid(pos)
