"""The threshold sweep's ranked route vs the direct route and the JAX
reference, on the CPU.

``threshold_sweep_ranked_ref`` (rank every sample row against each
clause's distinct threshold values, histogram, prefix, gather) must give
exactly the int counts of ``threshold_sweep_ref`` (every row against every
row) and of the JAX package's oracle and Pallas kernel (interpret mode):
on ``candidate_grid`` grids for C = 1..6 with and without -inf pad rows,
on +-inf, NaN and +-0.0 on both sides, duplicate threshold rows, invalid
sample rows, k not a multiple of 512 and G = 1.  ``ops.sweep`` picks the
route from the thresholds' bin count alone.  (tests/test_torch_cuda_kernels.py
holds the CUDA kernels against both plain versions on the card.)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scaffold as jscaffold
from repro.kernels.threshold_sweep import kernel as jkernel
from repro.kernels.threshold_sweep import ops as jops
from repro.kernels.threshold_sweep.ref import threshold_sweep_ref as jref
from repro_torch.core import scaffold as tscaffold
from repro_torch.data.sweep_fixtures import (bins_thetas, edge_fixture,
                                             grid_fixture)
from repro_torch.kernels.threshold_sweep import ops as tops
from repro_torch.kernels.threshold_sweep.kernel import (RANKED_MAX_BINS,
                                                        threshold_sweep)
from repro_torch.kernels.threshold_sweep.ref import (threshold_sweep_ranked_ref,
                                                     threshold_sweep_ref)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ranked(cd, labels, valid, thetas):
    values, offsets, _ = tops.rank_axes(thetas)
    return threshold_sweep_ranked_ref(_t(cd), _t(labels), _t(thetas),
                                      _t(valid), (_t(values), _t(offsets)))


def _assert_routes_agree(cd, labels, valid, thetas, *, pallas=False):
    """ranked == direct == the JAX oracle (== the Pallas kernel), as ints."""
    got = _ranked(cd, labels, valid, thetas).numpy()
    direct = threshold_sweep_ref(_t(cd), _t(labels), _t(thetas),
                                 _t(valid)).numpy()
    np.testing.assert_array_equal(got, direct)
    want = np.asarray(jref(jnp.asarray(cd), jnp.asarray(labels),
                           jnp.asarray(thetas), jnp.asarray(valid)))
    np.testing.assert_array_equal(got, want.astype(np.int64))
    if pallas:
        k, g = cd.shape[0], thetas.shape[0]
        kp, gp = -(-k // 256) * 256, -(-g // 16) * 16
        pad = lambda a, n, v: np.concatenate(  # noqa: E731
            [a, np.full((n - a.shape[0],) + a.shape[1:], v, np.float32)])
        out = np.asarray(jkernel.threshold_sweep(
            *(jnp.asarray(a) for a in (pad(cd, kp, 0.0), pad(labels, kp, 0.0),
                                       pad(valid, kp, 0.0),
                                       pad(thetas, gp, -np.inf))),
            tg=16, tk=256, interpret=True))
        np.testing.assert_array_equal(got, out[:g, :2].astype(np.int64))
    return got


def test_rank_axes_sorted_distinct_nan_dropped_zero_merged():
    th = np.array([[0.5, np.nan, 2.0],
                   [-0.0, np.nan, 2.0],
                   [0.0, np.nan, -np.inf],
                   [np.inf, np.nan, 2.0],
                   [0.5, np.nan, np.nan]], np.float32)
    values, offsets, bins = tops.rank_axes(th)
    assert values.dtype == np.float32 and offsets.dtype == np.int32
    np.testing.assert_array_equal(offsets, [0, 3, 3, 5])
    np.testing.assert_array_equal(values, [0.0, 0.5, np.inf, -np.inf, 2.0])
    assert not np.signbit(values[0])            # -0.0 merged into +0.0
    assert bins == 0                            # clause 1 has no value


@pytest.mark.parametrize("u,route", [((128, 128), "ranked"),
                                     ((5, 29, 113), "direct")])
def test_route_choice_at_the_bin_limit(monkeypatch, u, route):
    """2**14 bins still take the ranked route, 2**14 + 1 the direct one;
    both give the brute-force counts."""
    thetas = bins_thetas(u)
    assert tops.rank_axes(thetas)[2] == RANKED_MAX_BINS + (route == "direct")
    routes = []

    def spy(*args, axes=None, **kw):
        routes.append("ranked" if axes is not None else "direct")
        return threshold_sweep(*args, axes=axes, **kw)
    monkeypatch.setattr(tops, "threshold_sweep", spy)
    rng = np.random.default_rng(len(u))
    k = 700
    cd = rng.uniform(0, 1, size=(k, len(u))).astype(np.float32)
    labels = rng.random(k) < 0.3
    pos, sel = tops.sweep(cd, labels, thetas, device="cpu")
    assert routes == [route]
    want = threshold_sweep_ref(_t(cd), _t(labels.astype(np.float32)),
                               _t(thetas)).numpy()
    np.testing.assert_array_equal(pos, want[:, 0])
    np.testing.assert_array_equal(sel, want[:, 1])


@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("c", [1, 2, 3, 4, 5, 6])
def test_ranked_matches_direct_and_jax_on_candidate_grids(c, pad):
    cd, labels, valid, thetas = grid_fixture(30 + c, 1200 + 37 * c, c, pad)
    assert tops.rank_axes(thetas)[2] <= RANKED_MAX_BINS
    got = _assert_routes_agree(cd, labels, valid, thetas)
    assert got[:, 1].max() > 0
    if pad:
        assert (got[-1] == 0).all()             # a -inf row selects nothing


@pytest.mark.parametrize("g", [48, 1])
def test_ranked_matches_direct_and_jax_on_the_edges(g):
    """+-inf and NaN on both sides, +-0.0, distances on thresholds,
    duplicate rows, invalid +inf rows, k = 1037; G = 1 too."""
    cd, labels, valid, thetas = edge_fixture(3)
    got = _assert_routes_agree(cd, labels, valid, thetas[:g], pallas=True)
    if g > 1:
        assert got[0, 1] == int((valid != 0).sum()) - int(
            np.isnan(cd[valid != 0]).any(axis=1).sum())
        assert (got[4] == 0).all()              # a NaN threshold
        np.testing.assert_array_equal(got[-4:], got[6:10])


def test_ranked_signed_zero_and_infinities():
    cd = np.array([[-0.0], [0.0], [1e-30], [-np.inf], [np.inf], [np.nan]],
                  np.float32)
    labels = np.array([1, 0, 1, 0, 1, 1], np.float32)
    valid = np.ones(6, np.float32)
    thetas = np.array([[-0.0], [0.0], [-np.inf], [np.inf]], np.float32)
    got = _assert_routes_agree(cd, labels, valid, thetas)
    np.testing.assert_array_equal(got, [[1, 3], [1, 3], [0, 1], [3, 5]])


def test_ranked_threshold_missing_from_its_axis_is_flagged():
    cd = np.zeros((4, 1), np.float32)
    axes = (_t(np.array([0.0, 1.0], np.float32)), _t(np.array([0, 2], np.int32)))
    got = threshold_sweep_ranked_ref(_t(cd), torch.ones(4), _t(
        np.array([[0.5], [1.0], [np.nan]], np.float32)), torch.ones(4), axes)
    assert got.tolist() == [[-1, -1], [4, 4], [0, 0]]


def test_ranked_all_nan_column_selects_nothing():
    cd, labels, valid, _ = edge_fixture(5, c=2)
    thetas = np.array([[0.5, np.nan], [np.inf, np.nan]], np.float32)
    assert tops.rank_axes(thetas)[2] == 0
    got = _assert_routes_agree(cd, labels, valid, thetas)
    assert (got == 0).all()


def test_sweep_takes_the_ranked_route_unpadded_and_matches_jax():
    """ops.sweep on the edge fixture's thresholds (no valid mask: ops
    marks every given row valid) equals the JAX ops.sweep."""
    cd, labels, _, thetas = edge_fixture(7)
    got = tops.sweep(cd, labels != 0, thetas, device="cpu")
    want = jops.sweep(cd, labels != 0, thetas, tg=16, tk=256, interpret=True)
    for a, b in zip(got, want):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("c", [4, 5, 6])
def test_min_fpr_thresholds_device_route_wide_scaffolds(c):
    rng = np.random.default_rng(40 + c)
    k = 2000
    labels = rng.random(k) < 0.1
    cd = rng.uniform(0, 1, size=(k, c)).astype(np.float32)
    cd[labels] *= 0.4
    want = jscaffold.min_fpr_thresholds(cd, labels, 0.9, method="device")
    got = tscaffold.min_fpr_thresholds(cd, labels, 0.9, method="device",
                                       device="cpu")
    np.testing.assert_array_equal(got.theta, want.theta)
    assert (got.fpr, got.recall, got.feasible) == \
        (want.fpr, want.recall, want.feasible)
