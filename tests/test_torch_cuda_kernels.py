"""The port's CUDA kernels against their plain-torch versions, on the card.

These tests need a CUDA device (a CUDA kernel has no CPU mode) and skip
without one.  The file imports neither jax nor the JAX package, so it runs
on a GPU machine that has only the port's dependencies:

    python -m pytest -q tests/test_torch_cuda_kernels.py

``chip_smoke.py`` runs the same comparisons at the main path's shapes.
The threshold sweep's ranked route is held against both plain versions
(``threshold_sweep_ranked_ref`` and the brute-force
``threshold_sweep_ref``) on the fixtures of
``tests/test_torch_sweep_ranked.py``, which hold those against the JAX
package on the CPU.
"""

import numpy as np
import pytest
import torch

from repro_torch.data.cnf_fixtures import boundary_fixture
from repro_torch.kernels.fused_cnf_join import ref as cref
from repro_torch.kernels.fused_cnf_join.kernel import SCAL, VEC, cnf_join_block
from repro_torch.data.sweep_fixtures import (bins_thetas, edge_fixture,
                                             grid_fixture)
from repro_torch.kernels.threshold_sweep import kernel as sk
from repro_torch.kernels.threshold_sweep.kernel import threshold_sweep
from repro_torch.kernels.threshold_sweep.ops import rank_axes
from repro_torch.kernels.threshold_sweep.ref import (threshold_sweep_ranked_ref,
                                                     threshold_sweep_ref)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _cnf_inputs(rng, fv, nl, nr, d):
    el = rng.normal(size=(fv, nl, d)).astype(np.float32)
    er = rng.normal(size=(fv, nr, d)).astype(np.float32)
    el /= np.linalg.norm(el, axis=-1, keepdims=True)
    er /= np.linalg.norm(er, axis=-1, keepdims=True)
    sl = rng.uniform(0, 1.5, size=(1, nl)).astype(np.float32)
    sr = rng.uniform(0, 1.5, size=(1, nr)).astype(np.float32)
    return el, er, sl, sr


def _assert_kernel_matches_plain(device, arrays, structure, thetas, *, tl,
                                 tr, early_reject):
    """Equal evals grids; a mask bit may differ only for a pair whose f64
    distance lies within D * 2**-24 of a threshold (3xTF32 split products
    and f32 sums in another order).  Returns the evals grid."""
    nr, d = arrays[1].shape[1], arrays[0].shape[2]
    cpu = cnf_join_block(*map(torch.from_numpy, arrays), structure, thetas,
                         tl=tl, tr=tr, early_reject=early_reject,
                         with_evals=True)
    gpu_in = [torch.from_numpy(a).to(device) for a in arrays]
    gpu = cnf_join_block(*gpu_in, structure, thetas, tl=tl, tr=tr,
                         early_reject=early_reject, with_evals=True)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(gpu[1].cpu().numpy(), cpu[1].numpy())
    ii, jj = np.nonzero(cref.unpack_mask(gpu[0], nr)
                        != cref.unpack_mask(cpu[0], nr))
    gap = cref.threshold_gap(*gpu_in, structure, thetas, ii, jj)
    assert (gap <= cref.dot_error_band(d)).all()
    return cpu[1].numpy()


@pytest.mark.parametrize("early_reject", [False, True])
@pytest.mark.parametrize("nl,nr,d,tl,tr,structure", [
    (256, 512, 256, 128, 256, (((VEC, 0), (SCAL, 0)), ((VEC, 1),))),
    (128, 128, 128, 64, 64, (((VEC, 0),), ((VEC, 1),), ((SCAL, 0), (VEC, 0)))),
    (512, 1024, 130, 256, 512, (((SCAL, 0),), ((VEC, 0), (VEC, 1)))),
    (96, 96, 128, 32, 32, (((SCAL, 0),),)),
    # a logical tile larger than the 128 x 128 block tile
    (512, 1024, 256, 256, 512, (((VEC, 0),), ((VEC, 1), (SCAL, 0)))),
    # logical tiles smaller than a block tile, ragged block tiles
    (224, 288, 128, 32, 32, (((VEC, 0), (SCAL, 0)), ((VEC, 1),))),
    # K padding: D not a multiple of the 32-wide chunk (136) or of 4 (130)
    (256, 384, 136, 64, 128, (((VEC, 1),), ((VEC, 0),))),
    (192, 256, 130, 64, 64, (((VEC, 0),), ((SCAL, 0), (VEC, 1)))),
    # more block tiles than one wave of the card holds
    (2304, 4096, 64, 256, 512, (((VEC, 0),), ((VEC, 1), (SCAL, 0)))),
])
def test_cnf_join_kernel_matches_plain_version(cuda_device, nl, nr, d, tl, tr,
                                               structure, early_reject):
    rng = np.random.default_rng(nl + d)
    arrays = _cnf_inputs(rng, 2, nl, nr, d)
    arrays[2][0, : nl // 2] += 3.0            # dead tiles for early_reject
    thetas = tuple(0.35 + 0.1 * i for i in range(len(structure)))
    _assert_kernel_matches_plain(cuda_device, arrays, structure, thetas,
                                 tl=tl, tr=tr, early_reject=early_reject)


@pytest.mark.parametrize("c", [1, 2, 5, 11])
def test_threshold_sweep_kernel_matches_plain_version(cuda_device, c):
    rng = np.random.default_rng(c)
    k, g = 20480, 512
    cd = rng.uniform(0, 1, size=(k, c)).astype(np.float32)
    cd[rng.random(size=(k, c)) < 0.05] = np.inf
    labels = (rng.random(k) < 0.3).astype(np.float32)
    valid = np.ones(k, np.float32)
    valid[-300:] = 0
    th = rng.uniform(0, 1, size=(g, c)).astype(np.float32)
    th[0], th[1] = np.inf, -np.inf
    args = [torch.from_numpy(a) for a in (cd, labels, valid, th)]
    want = threshold_sweep(*args)
    got = threshold_sweep(*(a.to(cuda_device) for a in args))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


def test_wrappers_count_launches(cuda_device):
    from repro_torch.kernels.fused_cnf_join import kernel as ck
    keys = ("threshold_sweep", "threshold_sweep_ranked", "threshold_sweep_direct")
    before = (ck.launches["cnf_join"], *(sk.launches[n] for n in keys))
    el, er, sl, sr = (torch.zeros(s, device=cuda_device)
                      for s in ((1, 64, 128), (1, 64, 128), (1, 64), (1, 64)))
    cnf_join_block(el, er, sl, sr, (((VEC, 0),),), (0.5,), tl=32, tr=32)
    # one count per call, early reject over two clauses included
    cnf_join_block(el, er, sl, sr, (((VEC, 0),), ((SCAL, 0),)), (0.5, 0.5),
                   tl=32, tr=32, early_reject=True, with_evals=True)
    sweep_in = (torch.zeros((512, 2), device=cuda_device),
                torch.zeros(512, device=cuda_device),
                torch.ones(512, device=cuda_device),
                torch.zeros((256, 2), device=cuda_device))
    threshold_sweep(*sweep_in)
    # the ranked route: one count per call, its two kernels included
    threshold_sweep(*sweep_in, axes=(torch.zeros(2, device=cuda_device),
                                     torch.tensor([0, 1, 2], dtype=torch.int32)))
    # plain versions on CPU tensors launch nothing
    cnf_join_block(el.cpu(), er.cpu(), sl.cpu(), sr.cpu(), (((VEC, 0),),),
                   (0.5,), tl=32, tr=32)
    threshold_sweep(*(t.cpu() for t in sweep_in))
    assert (ck.launches["cnf_join"], *(sk.launches[n] for n in keys)) == \
        (before[0] + 2, before[1] + 2, before[2] + 1, before[3] + 1)


def test_cnf_join_kernel_live_and_dead_tiles_in_one_block(cuda_device):
    """32 x 32 logical tiles in a checkerboard of live and dead under one
    128 x 128 block tile: clause 0 (a scalar) can pass only in the live
    ones, so the evals grid must mix 1 and C inside every block tile."""
    nl = nr = 256
    arrays = _cnf_inputs(np.random.default_rng(11), 2, nl, nr, 128)
    tile_l, tile_r = np.arange(nl) // 32, np.arange(nr) // 32
    arrays[2][0] = np.where(tile_l % 2 == 0, 0.0, 5.0).astype(np.float32)
    arrays[3][0] = np.where(tile_r % 2 == 0, 0.05, -5.0).astype(np.float32)
    arrays[3][0, 1::64] = 4.9            # a few live pairs in odd tiles too
    structure = (((SCAL, 0),), ((VEC, 0),), ((VEC, 1), (SCAL, 0)))
    evals = _assert_kernel_matches_plain(
        cuda_device, arrays, structure, (0.1, 0.45, 0.4), tl=32, tr=32,
        early_reject=True)
    for bi in range(2):
        for bj in range(2):
            block = evals[4 * bi:4 * bi + 4, 4 * bj:4 * bj + 4]
            assert (block == 1).any() and (block == 3).any()


@pytest.mark.parametrize("case", ["on_threshold", "duplicates"])
@pytest.mark.parametrize("early_reject", [False, True])
@pytest.mark.parametrize("tl,tr", [(256, 512), (32, 64)])
def test_cnf_join_kernel_boundary_thresholds(cuda_device, tl, tr,
                                             early_reject, case):
    """64 pairs on every clause's threshold, and exact duplicates compared
    at theta = 0: the kernel may part from the plain version only there,
    inside the band."""
    arrays, clauses, thetas, _ = boundary_fixture(21)
    _assert_kernel_matches_plain(cuda_device, arrays, clauses, thetas[case],
                                 tl=tl, tr=tr, early_reject=early_reject)


def _sweep_case(case):
    """(cd, labels, valid, thetas) of a ranked-route case."""
    kind, arg = case
    if kind == "grid":
        return grid_fixture(60 + arg[0], 20480 + 37, *arg)
    if kind == "edge":
        cd, labels, valid, thetas = edge_fixture(11)
        return cd, labels, valid, thetas[:arg]
    thetas = bins_thetas(arg, seed=len(arg))
    rng = np.random.default_rng(sum(arg))
    k = 20480 + 37
    # half the distances on threshold values, a few NaN, 5 % invalid
    cd = rng.uniform(0, 1, size=(k, len(arg))).astype(np.float32)
    on = rng.random(cd.shape) < 0.5
    cd[on] = thetas[rng.integers(0, thetas.shape[0], size=cd.shape),
                    np.arange(len(arg))][on]
    cd[rng.random(cd.shape) < 0.01] = np.nan
    labels = (rng.random(k) < 0.3).astype(np.float32)
    valid = (rng.random(k) >= 0.05).astype(np.float32)
    return cd, labels, valid, thetas


def _ranked_on_card(device, cd, labels, valid, thetas):
    """The ranked kernels' counts and both plain versions' (on the CPU)."""
    values, offsets, _ = rank_axes(thetas)
    cpu = [torch.from_numpy(np.ascontiguousarray(a))
           for a in (cd, labels, valid, thetas, values, offsets)]
    before = sk.launches["threshold_sweep_ranked"]
    got = threshold_sweep(*(t.to(device) for t in cpu[:4]),
                          axes=(cpu[4].to(device), cpu[5]))
    torch.cuda.synchronize()
    assert sk.launches["threshold_sweep_ranked"] == before + 1
    ranked = threshold_sweep_ranked_ref(cpu[0], cpu[1], cpu[3], cpu[2],
                                        (cpu[4], cpu[5]))
    direct = threshold_sweep_ref(cpu[0], cpu[1], cpu[3], cpu[2])
    np.testing.assert_array_equal(ranked.numpy(), direct.numpy())
    np.testing.assert_array_equal(got.cpu().numpy(), direct.numpy())
    return got


@pytest.mark.parametrize("case", [
    *(("grid", (c, pad)) for c in range(1, 7) for pad in (False, True)),
    ("edge", 48), ("edge", 1),
    ("bins", (128, 128)),                 # the 2**14-bin limit
    ("bins", (1 << 14,)),                 # one line of 2**14 to scan
    ("bins", (40,)),                      # a shared histogram, C = 1
    ("bins", (2, 2, 2, 2, 2, 1, 1)),      # 32 bins: lane counters, any C
    ("bins", (2,) * 9),                   # 512 bins, any C
], ids=str)
def test_threshold_sweep_ranked_kernel_matches_plain_versions(cuda_device,
                                                              case):
    got = _ranked_on_card(cuda_device, *_sweep_case(case))
    assert int(got[:, 1].max()) > 0


@pytest.mark.parametrize("case", ["missing", "all_nan"])
def test_threshold_sweep_ranked_kernel_nan_and_missing_thresholds(cuda_device,
                                                                   case):
    """A NaN threshold selects nothing; a threshold missing from its axis
    comes out as (-1, -1); a clause with no value at all (0 bins) drops
    every sample row.  As the plain version on the CPU."""
    rng = np.random.default_rng(9)
    cd = torch.from_numpy(rng.uniform(0, 1, size=(5000, 2)).astype(np.float32))
    labels = torch.from_numpy((rng.random(5000) < 0.5).astype(np.float32))
    valid = torch.ones(5000)
    if case == "missing":
        thetas = torch.tensor([[0.5, 0.5], [0.25, 1.0], [np.nan, 1.0]])
        axes = (torch.tensor([0.5, 1.0, 0.5, 1.0]),
                torch.tensor([0, 2, 4], dtype=torch.int32))
    else:
        thetas = torch.tensor([[0.5, np.nan], [np.inf, np.nan]])
        axes = (torch.tensor([0.5, np.inf]),
                torch.tensor([0, 2, 2], dtype=torch.int32))
    want = threshold_sweep(cd, labels, valid, thetas, axes=axes)
    got = threshold_sweep(*(t.to(cuda_device) for t in (cd, labels, valid,
                                                         thetas)),
                          axes=(axes[0].to(cuda_device), axes[1]))
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    if case == "missing":
        assert want[1].tolist() == [-1, -1] and want[2].tolist() == [0, 0]
    else:
        assert (want == 0).all()


@pytest.mark.parametrize("u", [(3,), (40,)])
def test_threshold_sweep_ranked_kernel_full_blocks(cuda_device, u):
    """k large enough that every block walks its full 63 steps (64 512
    rows), nine in ten of them in one bin: the largest counts a block's
    packed 16-bit histogram and its lane counters hold."""
    k = 70_000_000
    thetas = torch.from_numpy(bins_thetas(u)).to(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    cd = torch.where(torch.rand((k, 1), generator=g, device=cuda_device) < 0.9,
                     thetas[0, 0], torch.rand((k, 1), generator=g,
                                              device=cuda_device))
    labels = (torch.rand(k, generator=g, device=cuda_device) < 0.5).float()
    valid = torch.ones(k, device=cuda_device)
    values, offsets, _ = rank_axes(thetas.cpu().numpy())
    axes = (torch.from_numpy(values).to(cuda_device), torch.from_numpy(offsets))
    got = threshold_sweep(cd, labels, valid, thetas, axes=axes)
    want = threshold_sweep_ref(cd, labels, thetas, valid)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(threshold_sweep_ranked_ref(cd, labels, thetas, valid,
                                                  axes), want)
