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


@pytest.mark.parametrize("early_reject", [False, True])
@pytest.mark.parametrize("nl,nr,d,tl,tr,structure", [
    (256, 512, 256, 128, 256, (((VEC, 0), (SCAL, 0)), ((VEC, 1),))),
    (128, 128, 128, 64, 64, (((VEC, 0),), ((VEC, 1),), ((SCAL, 0), (VEC, 0)))),
    (512, 1024, 130, 256, 512, (((SCAL, 0),), ((VEC, 0), (VEC, 1)))),
    (96, 96, 128, 32, 32, (((SCAL, 0),),)),
])
def test_cnf_join_kernel_matches_plain_version(cuda_device, nl, nr, d, tl, tr,
                                               structure, early_reject):
    rng = np.random.default_rng(nl + d)
    arrays = _cnf_inputs(rng, 2, nl, nr, d)
    arrays[2][0, : nl // 2] += 3.0            # dead tiles for early_reject
    thetas = tuple(0.35 + 0.1 * i for i in range(len(structure)))
    cpu = cnf_join_block(*map(torch.from_numpy, arrays), structure, thetas,
                         tl=tl, tr=tr, early_reject=early_reject,
                         with_evals=True)
    gpu_in = [torch.from_numpy(a).to(cuda_device) for a in arrays]
    gpu = cnf_join_block(*gpu_in, structure, thetas, tl=tl, tr=tr,
                         early_reject=early_reject, with_evals=True)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(gpu[1].cpu().numpy(), cpu[1].numpy())
    ii, jj = np.nonzero(cref.unpack_mask(gpu[0], nr)
                        != cref.unpack_mask(cpu[0], nr))
    # f32 dot products summed in another order: only pairs whose f64
    # distance lies within D * 2**-24 of a threshold may differ
    gap = cref.threshold_gap(*gpu_in, structure, thetas, ii, jj)
    assert (gap <= cref.dot_error_band(d)).all()


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
    threshold_sweep(torch.zeros((512, 2), device=cuda_device),
                    torch.zeros(512, device=cuda_device),
                    torch.ones(512, device=cuda_device),
                    torch.zeros((256, 2), device=cuda_device))
    # plain versions on CPU tensors launch nothing
    cnf_join_block(el.cpu(), er.cpu(), sl.cpu(), sr.cpu(), (((VEC, 0),),),
                   (0.5,), tl=32, tr=32)
    assert (ck.launches["cnf_join"], sk.launches["threshold_sweep"]) == \
        (before[0] + 1, before[1] + 1)
