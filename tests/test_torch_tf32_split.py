"""The 3xTF32 split arithmetic of the CUDA CNF kernel, emulated on the CPU.

``csrc/cnf_join.cu`` computes each embed dot product on the tensor cores
as Ah.Bh + Ah.Bl + Al.Bh, with hi = cvt.rna.tf32.f32(x) and lo =
cvt.rna.tf32.f32(x - hi).  These tests emulate cvt.rna in torch (int32
view: add 0x1000, clear the low 13 bits) and pin the numerical argument
that lets the kernel use that split: the distance stays within half the
f32 band ``dot_error_band(D) / 2`` of its float64 value, for random unit
vectors and for exact duplicates, so a mask bit can differ from the plain
version only for a pair within the band of a threshold.
"""

import numpy as np
import pytest
import torch

from repro_torch.data.cnf_fixtures import boundary_fixture
from repro_torch.kernels.fused_cnf_join import ref as cref


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(n, D) x (m, D) f32 -> (n, m) f32 dot products as 3xTF32."""
    ah = rna_tf32(a)
    al = rna_tf32(a - ah)
    bh = rna_tf32(b)
    bl = rna_tf32(b - bh)
    return al @ bh.T + ah @ bl.T + ah @ bh.T


def _unit(rng, n, d):
    x = rng.normal(size=(n, d))
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _dist(dot):
    return torch.clamp(0.5 - 0.5 * dot, 0.0, 1.0)


def test_rna_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, 0.1],
                     dtype=torch.float32)
    got = rna_tf32(x)
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    # ties round away from zero, on either sign
    assert got[1].item() == 1.0 + 2.0 ** -10
    assert got[2].item() == 1.0 + 2.0 ** -10
    assert got[3].item() == -(1.0 + 2.0 ** -10)
    assert got[4].item() == 1.0
    assert abs(got[5].item() - 0.1) <= 0.1 * 2.0 ** -11


@pytest.mark.parametrize("d", [128, 130, 256])
def test_split_residue_is_below_two_to_minus_22(d):
    x = torch.from_numpy(_unit(np.random.default_rng(d), 64, d))
    hi = rna_tf32(x)
    lo = rna_tf32(x - hi)
    rest = (x.double() - hi.double() - lo.double()).abs()
    assert (rest <= x.double().abs() * 2.0 ** -22).all()


@pytest.mark.parametrize("d", [128, 130, 256])
def test_split_distance_within_half_band(d):
    rng = np.random.default_rng(1000 + d)
    a, b = _unit(rng, 64, d), _unit(rng, 96, d)
    got = _dist(split_dot(torch.from_numpy(a), torch.from_numpy(b)))
    want = _dist(torch.from_numpy(a.astype(np.float64) @ b.astype(np.float64).T))
    assert (got.double() - want).abs().max().item() <= cref.dot_error_band(d) / 2


@pytest.mark.parametrize("d", [128, 130, 256])
def test_split_distance_of_duplicates_within_half_band(d):
    a = _unit(np.random.default_rng(2000 + d), 128, d)
    got = _dist(torch.diagonal(split_dot(torch.from_numpy(a),
                                         torch.from_numpy(a))))
    a64 = a.astype(np.float64)
    want = _dist(torch.from_numpy((a64 * a64).sum(-1)))
    assert (got.double() - want).abs().max().item() <= cref.dot_error_band(d) / 2


def test_boundary_fixture_puts_pairs_on_the_thresholds():
    arrays, clauses, thetas, (ii, jj) = boundary_fixture(
        3, nl=128, nr=256, d=130, n_dup=16)
    el, er, sl, sr = arrays
    band = cref.dot_error_band(130)
    theta = thetas["on_threshold"]
    assert clauses[0] == ((cref.SCAL, 0),)
    assert (np.abs(sl[0, ii] - sr[0, jj]) <= theta[0] / 2).all()
    for f in range(2):
        d64 = 0.5 - 0.5 * (el[f, ii].astype(np.float64)
                           * er[f, jj].astype(np.float64)).sum(-1)
        assert (d64 == theta[f + 1]).sum() >= 1
        assert np.abs(d64 - theta[f + 1]).max() <= band / 100
    np.testing.assert_array_equal(er[:, :16], el[:, :16])
    assert thetas["duplicates"] == (theta[0], 0.0, 0.0)


@pytest.mark.parametrize("case", ["on_threshold", "duplicates"])
def test_split_mask_differs_from_plain_only_inside_band(case):
    """The kernel's arithmetic, emulated, against the plain version on the
    boundary fixture: every differing bit lies inside the f32 band."""
    arrays, clauses, thetas, _ = boundary_fixture(5, nl=128, nr=256, d=256,
                                                  n_dup=32)
    thetas = thetas[case]
    el, er, sl, sr = (torch.from_numpy(a) for a in arrays)
    gate = torch.abs(sl[0][:, None] - sr[0][None, :]) <= \
        torch.tensor(thetas[0], dtype=torch.float32)
    split_ok, plain_ok = gate, gate
    for f in range(2):
        t32 = torch.tensor(thetas[f + 1], dtype=torch.float32)
        split_ok = split_ok & (_dist(split_dot(el[f], er[f])) <= t32)
        plain_ok = plain_ok & (_dist(el[f] @ er[f].T) <= t32)
    assert plain_ok.any()
    ii, jj = np.nonzero((split_ok != plain_ok).numpy())
    gap = cref.threshold_gap(el, er, sl, sr, clauses, thetas, ii, jj)
    assert (gap <= cref.dot_error_band(256)).all()
