"""repro_torch threshold sweep vs the JAX reference.

(pos, sel) counts must equal the JAX reference exactly — the jnp oracle
and the Pallas kernel in interpret mode — on the fixtures of
tests/test_kernels.py (pad rows, ±inf thresholds, ragged tiles).  The grid
helper and the device route of ``min_fpr_thresholds`` must agree too.
(tests/test_torch_cuda_kernels.py holds the CUDA kernel against the plain
version on the card.)
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import scaffold as jscaffold
from repro.kernels.threshold_sweep import ops as jops
from repro.kernels.threshold_sweep.ref import threshold_sweep_ref as jref
from repro_torch.core import scaffold as tscaffold
from repro_torch.kernels.threshold_sweep import ops as tops
from repro_torch.kernels.threshold_sweep.kernel import threshold_sweep
from repro_torch.kernels.threshold_sweep.ref import threshold_sweep_ref


def _jax_counts(cd, labels, th):
    out = np.asarray(jref(jnp.asarray(cd), jnp.asarray(labels.astype(np.float32)),
                          jnp.asarray(th)))
    return out[:, 0], out[:, 1]


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("k,c,g", [(300, 1, 50), (700, 3, 200), (1024, 5, 64)])
def test_sweep_matches_jax(k, c, g):
    rng = np.random.default_rng(k)
    cd = rng.uniform(0, 1, size=(k, c)).astype(np.float32)
    labels = rng.random(k) < 0.3
    th = rng.uniform(0, 1, size=(g, c)).astype(np.float32)
    got = tops.sweep(cd, labels, th, tg=64, tk=256, device="cpu")
    _assert_same(got, _jax_counts(cd, labels, th))
    _assert_same(got, jops.sweep(cd, labels, th, tg=64, tk=256, interpret=True))


def test_sweep_pad_rows_not_counted():
    """k=100 under a 256-row tile with all-+inf thresholds: the validity
    mask, not a sentinel distance, keeps the 156 pad rows out."""
    k, c = 100, 2
    rng = np.random.default_rng(5)
    cd = rng.uniform(0, 1, size=(k, c)).astype(np.float32)
    labels = rng.random(k) < 0.4
    th = np.array([[np.inf, np.inf], [np.inf, 0.5], [-np.inf, 0.5]], np.float32)
    pos, sel = tops.sweep(cd, labels, th, tg=64, tk=256, device="cpu")
    _assert_same((pos, sel), jops.sweep(cd, labels, th, tg=64, tk=256,
                                        interpret=True))
    assert sel[0] == k and pos[0] == labels.sum()
    assert sel[2] == 0 and pos[2] == 0


def test_sweep_inf_distances_ragged_tiles():
    k, c, g = 333, 3, 37
    rng = np.random.default_rng(9)
    cd = rng.uniform(0, 1, size=(k, c)).astype(np.float32)
    cd[rng.random(size=(k, c)) < 0.08] = np.inf
    labels = rng.random(k) < 0.3
    th = rng.uniform(0, 1, size=(g, c)).astype(np.float32)
    th[0] = np.inf
    th[-1] = -np.inf
    th[5, 1] = np.inf
    got = tops.sweep(cd, labels, th, tg=16, tk=128, device="cpu")
    _assert_same(got, _jax_counts(cd, labels, th))
    _assert_same(got, jops.sweep(cd, labels, th, tg=16, tk=128, interpret=True))


def test_sweep_counts_matches_reference_dispatcher():
    rng = np.random.default_rng(11)
    k, c, g = 500, 2, 90
    cd = rng.uniform(0, 1, size=(k, c)).astype(np.float32)
    labels = rng.random(k) < 0.25
    th = rng.uniform(0, 1, size=(g, c)).astype(np.float32)
    th[3] = np.inf
    _assert_same(tops.sweep_counts(cd, labels, th, device="cpu"),
                 jops.sweep_counts(cd, labels, th))
    pos_e, sel_e = tops.sweep_counts(cd, labels, np.zeros((0, c), np.float32),
                                     device="cpu")
    assert pos_e.shape == (0,) and sel_e.shape == (0,)


def test_plain_version_is_exact_beyond_f32_counts():
    """int32 counts stay exact where an f32 accumulator would round
    (2**24 + 1 is not an f32 value); the plain version walks k in chunks."""
    k = 2 ** 24 + 1
    cd = torch.zeros((k, 1))
    out = threshold_sweep_ref(cd, torch.ones(k), torch.tensor([[0.5], [-1.0]]),
                              torch.ones(k))
    assert out.dtype == torch.int32
    assert out.tolist() == [[k, k], [0, 0]]


def test_wrapper_rejects_untiled_shapes():
    with pytest.raises(ValueError, match="multiples"):
        threshold_sweep(torch.zeros((100, 2)), torch.zeros(100),
                        torch.ones(100), torch.zeros((64, 2)), tg=64, tk=256)


@pytest.mark.parametrize("c,max_grid", [(2, 4096), (5, 512), (0, 4096)])
def test_candidate_grid_matches_reference(c, max_grid):
    rng = np.random.default_rng(3 + c)
    pos = rng.uniform(0, 1, size=(600, c)).astype(np.float32)
    got = tops.candidate_grid(pos, max_grid=max_grid)
    want = jops.candidate_grid(pos, max_grid=max_grid)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("c", [1, 2, 3])
def test_min_fpr_thresholds_device_route_matches_reference(c):
    rng = np.random.default_rng(20 + c)
    k = 3000
    labels = rng.random(k) < 0.1
    cd = rng.uniform(0, 1, size=(k, c)).astype(np.float32)
    cd[labels] *= 0.4                    # positives sit closer
    for method in ("device", "auto"):
        want = jscaffold.min_fpr_thresholds(cd, labels, 0.9, method=method)
        got = tscaffold.min_fpr_thresholds(cd, labels, 0.9, method=method,
                                           device="cpu")
        np.testing.assert_array_equal(got.theta, want.theta)
        assert (got.fpr, got.recall, got.feasible) == \
            (want.fpr, want.recall, want.feasible)


def test_device_route_raises_without_gpu_instead_of_falling_back():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the cuda route would run")
    cd = np.random.default_rng(0).uniform(0, 1, size=(50, 2)).astype(np.float32)
    labels = np.arange(50) % 5 == 0
    with pytest.raises(RuntimeError, match="CUDA"):
        tscaffold.min_fpr_thresholds(cd, labels, 0.9, method="auto",
                                     device="cuda")
