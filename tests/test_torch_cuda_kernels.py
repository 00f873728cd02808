"""The port's CUDA kernels against their plain-torch versions, on the card.

These tests need a CUDA device (a CUDA kernel has no CPU mode) and skip
without one.  The file imports neither jax nor the JAX package, so it runs
on a GPU machine that has only the port's dependencies:

    python -m pytest -q tests/test_torch_cuda_kernels.py

``chip_smoke.py`` runs the same comparisons at the main path's shapes.
"""

import numpy as np
import pytest
import torch

from repro_torch.data.cnf_fixtures import boundary_fixture
from repro_torch.kernels.fused_cnf_join import ref as cref
from repro_torch.kernels.fused_cnf_join.kernel import SCAL, VEC, cnf_join_block
from repro_torch.kernels.threshold_sweep.kernel import threshold_sweep


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
    from repro_torch.kernels.threshold_sweep import kernel as sk
    before = (ck.launches["cnf_join"], sk.launches["threshold_sweep"])
    el, er, sl, sr = (torch.zeros(s, device=cuda_device)
                      for s in ((1, 64, 128), (1, 64, 128), (1, 64), (1, 64)))
    cnf_join_block(el, er, sl, sr, (((VEC, 0),),), (0.5,), tl=32, tr=32)
    # one count per call, early reject over two clauses included
    cnf_join_block(el, er, sl, sr, (((VEC, 0),), ((SCAL, 0),)), (0.5, 0.5),
                   tl=32, tr=32, early_reject=True, with_evals=True)
    threshold_sweep(torch.zeros((512, 2), device=cuda_device),
                    torch.zeros(512, device=cuda_device),
                    torch.ones(512, device=cuda_device),
                    torch.zeros((256, 2), device=cuda_device))
    # plain versions on CPU tensors launch nothing
    cnf_join_block(el.cpu(), er.cpu(), sl.cpu(), sr.cpu(), (((VEC, 0),),),
                   (0.5,), tl=32, tr=32)
    assert (ck.launches["cnf_join"], sk.launches["threshold_sweep"]) == \
        (before[0] + 2, before[1] + 1)


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
