"""The port's CUDA kernels against their plain-torch versions, on the card.

These tests need a CUDA device (a CUDA kernel has no CPU mode) and skip
without one.  The file imports neither jax nor the JAX package, so it runs
on a GPU machine that has only the port's dependencies:

    python -m pytest -q tests/test_torch_cuda_kernels.py

``chip_smoke.py`` runs the same comparisons at the main path's shapes.
The compaction kernel (``csrc/extract.cu``) must give its plain version's
buffer and count bit for bit, on the fixtures of
``tests/test_torch_extract.py`` (which hold the plain version against
the JAX package) and on a 2**14 x 2**12 random mask; the ring engine on
the card must give the CPU ring's chunks.
The threshold sweep's ranked route is held against both plain versions
(``threshold_sweep_ranked_ref`` and the brute-force
``threshold_sweep_ref``) on the fixtures of
``tests/test_torch_sweep_ranked.py``, which hold those against the JAX
package on the CPU.  Its direct route is held to ``threshold_sweep_ref``
bit for bit on the fixtures of ``tests/test_torch_sweep_direct.py`` (C in
{1, 8, 9, 15, 32} with every f32 edge and whole stages of pad rows, a
15-clause ``candidate_grid`` and its first row), at several G (the
kernel's thread count follows G) and on a count above 2**24.
"""

import numpy as np
import pytest
import torch

from repro_torch.data.cnf_fixtures import boundary_fixture
from repro_torch.kernels.fused_cnf_join import ref as cref
from repro_torch.kernels.fused_cnf_join.kernel import SCAL, VEC, cnf_join_block
from repro_torch.data.sweep_fixtures import (bins_thetas, direct_fixture,
                                             edge_fixture, grid_fixture)
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


def _direct_on_card(device, cd, labels, valid, th):
    """The direct route on the card against ``threshold_sweep_ref`` on the
    CPU, bit for bit, and one launch counted."""
    before = sk.launches["threshold_sweep_direct"]
    got = threshold_sweep(*(torch.from_numpy(a).to(device)
                            for a in (cd, labels, valid, th)))
    torch.cuda.synchronize()
    assert sk.launches["threshold_sweep_direct"] == before + 1
    want = threshold_sweep_ref(*(torch.from_numpy(a)
                                 for a in (cd, labels, th, valid)))
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    return got.cpu().numpy()


@pytest.mark.parametrize("c", [1, 8, 9, 15, 32])
def test_threshold_sweep_direct_kernel_edges(cuda_device, c):
    """NaN, +-0.0 and +-inf on both sides, k 1037 padded, and 2048 pad rows
    at -inf that only valid keeps out."""
    _direct_on_card(cuda_device, *direct_fixture(c, seed=c))


@pytest.mark.parametrize("g", [256, 768, 4352])
def test_threshold_sweep_direct_kernel_thread_counts(cuda_device, g):
    """G 256 and 768 run blocks of fewer than 256 threads, 4352 two strips
    at C 5."""
    rng = np.random.default_rng(g)
    k = 5120
    cd = rng.uniform(0, 1, size=(k, 5)).astype(np.float32)
    labels = (rng.random(k) < 0.3).astype(np.float32)
    th = rng.uniform(0.2, 1, size=(g, 5)).astype(np.float32)
    got = _direct_on_card(cuda_device, cd, labels, np.ones(k, np.float32), th)
    assert got[:, 1].max() > 0


@pytest.mark.parametrize("g", [1, 1 << 15])
def test_threshold_sweep_direct_kernel_fifteen_clause_grid(cuda_device, g):
    """A 15-clause ``candidate_grid`` (2**15 rows) and its first row at k
    333, padded as ``ops.sweep`` pads the direct route."""
    cd, labels, valid, th = grid_fixture(215, 333, 15, False)
    th = th[:g]
    gp = -(-g // 256) * 256
    got = _direct_on_card(
        cuda_device, np.pad(cd, ((0, 512 - 333), (0, 0))),
        np.pad(labels, (0, 512 - 333)), np.pad(valid, (0, 512 - 333)),
        np.concatenate([th, np.full((gp - g, 15), -np.inf, np.float32)]))
    assert (got[g:] == 0).all()


def test_threshold_sweep_direct_kernel_counts_above_f32(cuda_device):
    """k = 2**24 + 512 rows that all pass row 0: the count is exact int32
    where an f32 count would round (2**24 + 1 is not an f32 value)."""
    k = (1 << 24) + 512
    th = torch.full((256, 1), -np.inf, device=cuda_device)
    th[0, 0], th[1, 0] = 0.5, -1.0
    before = sk.launches["threshold_sweep_direct"]
    got = threshold_sweep(torch.zeros((k, 1), device=cuda_device),
                          torch.ones(k, device=cuda_device),
                          torch.ones(k, device=cuda_device), th)
    torch.cuda.synchronize()
    assert sk.launches["threshold_sweep_direct"] == before + 1
    assert got[:2].tolist() == [[k, k], [0, 0]]
    assert int(got[2:].abs().sum()) == 0


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


# --- the serving path: planes resident on the card --------------------------

def _police_planes(device, n=12):
    from repro_torch.core.costs import CostLedger
    from repro_torch.data import synth
    from repro_torch.data.cnf_fixtures import representative_cnf
    from repro_torch.data.simulated_llm import SimulatedExtractor
    from repro_torch.serving.planes import FeaturePlaneStore, corpus_fingerprint
    ds = synth.police_records(n_incidents=n, reports_per_incident=2, seed=3)
    specs, clauses, thetas = representative_cnf(ds)
    store = FeaturePlaneStore(device=device)
    planes = store.provide(
        specs, SimulatedExtractor(ds), CostLedger(),
        fp_l=corpus_fingerprint(ds.name, "l", ds.texts_l, ds.fields_l),
        fp_r=corpus_fingerprint(ds.name, "r", ds.texts_r, ds.fields_r))
    return planes, clauses, thetas


@pytest.mark.parametrize("off", [0, 5])
def test_pack_features_device_on_cuda_matches_host_pack(cuda_device, off):
    """The assembly on the card writes the host pack's bits, for the
    whole plane set and for a ragged ``slice_r`` view."""
    from repro_torch.kernels.fused_cnf_join import ops
    planes, clauses, _ = _police_planes(cuda_device)
    planes = planes.slice_r(off) if off else planes
    assert planes.device.type == "cuda"
    for tl, tr in ((32, 64), (64, 128)):
        dev = ops.pack_features_device(planes, clauses, tl=tl, tr=tr)
        host = ops.pack_features(list(planes), clauses, tl=tl, tr=tr)
        for got, want in zip(dev[:4], host[:4]):
            assert got.is_cuda and got.is_contiguous()
            np.testing.assert_array_equal(
                got.cpu().numpy().view(np.uint32), want.view(np.uint32))
        assert dev[4:] == host[4:]
        staged = ops.stage_planes(planes, clauses, tl=tl, tr=tr,
                                  device=cuda_device)
        assert staged.bytes_h2d == 0


class _RawCudaArray:
    """A float32 view at an arbitrary device address (``torch.as_tensor``
    reads ``__cuda_array_interface__`` without copying)."""

    def __init__(self, ptr, shape):
        self.__cuda_array_interface__ = {
            "shape": shape, "typestr": "<f4", "data": (ptr, False),
            "version": 2, "strides": None}


def test_cnf_join_wrapper_rejects_misaligned_view(cuda_device):
    buf = torch.zeros(4 * 64 * 128 + 64, dtype=torch.uint8,
                      device=cuda_device)
    emb = torch.as_tensor(_RawCudaArray(buf.data_ptr() + 2, (1, 64, 128)),
                          device=cuda_device)
    assert emb.data_ptr() % 4 == 2          # a view, not an aligned copy
    ok = torch.zeros((1, 64, 128), device=cuda_device)
    scal = torch.zeros((1, 64), device=cuda_device)
    with pytest.raises(ValueError, match="not 4-byte aligned"):
        cnf_join_block(emb, ok, scal, scal, (((VEC, 0),),), (0.5,),
                       tl=64, tr=64)
    with pytest.raises(ValueError, match="not 4-byte aligned"):
        cnf_join_block(ok, emb, scal, scal, (((VEC, 0),),), (0.5,),
                       tl=64, tr=64)
    del buf


def test_warm_cuda_query_launches_kernel_without_upload(cuda_device):
    from repro_torch.core.join import FDJConfig
    from repro_torch.data import synth
    from repro_torch.kernels.fused_cnf_join import kernel as ck
    from repro_torch.serving.join_service import JoinService
    ds = synth.police_records(n_incidents=15, reports_per_incident=2, seed=3)
    cfg = FDJConfig(engine="cuda", engine_opts=dict(tl=32, tr=64), seed=0,
                    mc_trials=4000)
    svc = JoinService(ds, cfg)
    assert svc.store.device.type == "cuda"
    cold = svc.query()
    before = ck.launches["cnf_join"]
    warm = svc.query()
    assert ck.launches["cnf_join"] > before
    assert warm.plan_hit and warm.pairs == cold.pairs
    assert warm.cost.inference == 0.0 and warm.cost.bytes_h2d == 0
    assert warm.join.engine_stats.bytes_h2d == 0
    # and the same pairs as the plain-torch path on the CPU
    cpu = JoinService(ds, FDJConfig(engine="cuda", device="cpu",
                                    engine_opts=dict(tl=32, tr=64), seed=0,
                                    mc_trials=4000)).query()
    assert cpu.pairs == cold.pairs


def test_fleet_concurrent_cuda_matches_serial(cuda_device):
    """Worker threads launch both kernels on the current stream: the
    pairs of a concurrent run equal a serial run's byte for byte."""
    from repro_torch.core.join import FDJConfig
    from repro_torch.data import synth
    from repro_torch.serving.fleet import JoinFleet
    names = ("a", "b", "c")

    def cfg():
        return FDJConfig(engine="cuda", engine_opts=dict(tl=32, tr=64),
                         seed=0, mc_trials=4000)

    def ds():
        return synth.police_records(n_incidents=12, reports_per_incident=2,
                                    seed=3)
    with JoinFleet(max_concurrent=1) as ref:
        for name in names:
            ref.add_tenant(name, ds(), cfg())
        want = {name: [ref.query(name).pairs for _ in range(2)]
                for name in names}
    with JoinFleet(max_concurrent=3) as fleet:
        for name in names:
            fleet.add_tenant(name, ds(), cfg())
        futures = [(name, fleet.submit(name))
                   for _ in range(2) for name in names]
        got = {}
        for name, fut in futures:
            got.setdefault(name, []).append(fut.result(timeout=300).pairs)
    assert got == want


# --- the compaction kernel and the ring engine ---------------------------------

def _words(seed, nl, nw, density):
    rng = np.random.default_rng(seed)
    bits = rng.random((nl, nw, 32)) < density
    words = (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1)
    return torch.from_numpy(words.astype(np.uint32).view(np.int32))


def _compact_both(device, packed, cap, count=0, **offsets):
    """(kernel buffer, count), (plain buffer, count) on the same inputs."""
    from repro_torch.kernels.extract.kernel import compact_append
    from repro_torch.kernels.extract.ref import compact_append_ref
    fill = torch.full((cap, 2), -1, dtype=torch.int32)
    got = compact_append(packed.to(device), fill.to(device),
                         torch.full((), count, dtype=torch.int32,
                                    device=device), **offsets)
    want = compact_append_ref(packed, fill.clone(), count, **offsets)
    torch.cuda.synchronize()
    return (got[0].cpu(), int(got[1])), (want[0], int(want[1]))


@pytest.mark.parametrize("density", [0.0, 1e-3, 0.5, 1.0])
@pytest.mark.parametrize("nl,nw,cap_extra", [
    (1, 1, 16), (7, 3, 16), (33, 5, 16), (64, 12, 16), (64, 12, -40),
    (300, 17, 0),      # more than one block of 4096 words, a ragged tail
])
def test_compaction_kernel_matches_plain_version(cuda_device, nl, nw,
                                                 cap_extra, density):
    packed = _words(nl * 100 + nw, nl, nw, density)
    n_set = int(np.unpackbits(packed.numpy().view(np.uint8)).sum())
    cap = max(n_set + cap_extra, 0)
    for offsets in (dict(), dict(row_offset=4096, col_offset=262112)):
        got, want = _compact_both(cuda_device, packed, cap, **offsets)
        assert torch.equal(got[0], want[0]) and got[1] == want[1] == n_set


@pytest.mark.parametrize("density", [1e-3, 0.5])
def test_compaction_kernel_on_a_2_14_by_2_12_mask(cuda_device, density):
    packed = _words(14, 1 << 14, (1 << 12) // 32, density)
    n_set = int(np.unpackbits(packed.numpy().view(np.uint8)).sum())
    for cap in (n_set + 8, n_set // 2):
        got, want = _compact_both(cuda_device, packed, cap, count=5,
                                  col_offset=4096)
        assert torch.equal(got[0], want[0]) and got[1] == want[1] == n_set + 5


def test_compaction_kernel_appends_and_unaligned_masks(cuda_device):
    """A second call appends from the first's device count; a mask that
    starts 4 bytes past a 16-byte boundary takes the one-word loads."""
    from repro_torch.kernels.extract import kernel as ek
    a, b = _words(1, 40, 9, 0.3), _words(2, 40, 9, 0.3)
    flat = torch.empty(b.numel() + 1, dtype=torch.int32)
    flat[1:] = b.reshape(-1)
    dev_b = flat.to(cuda_device)[1:].view(40, 9)
    assert dev_b.data_ptr() % 16 == 4
    cap = 6000
    before = ek.launches["compact"]
    buf = torch.full((cap, 2), -1, dtype=torch.int32, device=cuda_device)
    buf, cnt = ek.compact_append(a.to(cuda_device), buf, 0)
    buf, cnt = ek.compact_append(dev_b, buf, cnt, row_offset=40)
    want = torch.full((cap, 2), -1, dtype=torch.int32)
    want, wcnt = ek.compact_append(a, want, 0)
    want, wcnt = ek.compact_append(b, want, wcnt, row_offset=40)
    torch.cuda.synchronize()
    assert torch.equal(buf.cpu(), want) and int(cnt) == int(wcnt)
    assert ek.launches["compact"] == before + 2
    with pytest.raises(ValueError, match="one CUDA device"):
        ek.compact_append(a, buf, 0)


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_ring_engine_on_cuda_matches_cpu(cuda_device, depth):
    """Chunks, accounting and retries of the ring on the card equal the
    plain-torch ring's (small capacity: every dense step retries)."""
    from repro_torch.core.costs import CostLedger
    from repro_torch.data import synth
    from repro_torch.data.cnf_fixtures import representative_cnf
    from repro_torch.data.simulated_llm import SimulatedExtractor
    from repro_torch.engine import get_engine
    ds = synth.police_records(n_incidents=37, reports_per_incident=2, seed=5)
    specs, clauses, thetas = representative_cnf(ds)
    feats = SimulatedExtractor(ds).materialize(specs, CostLedger())
    opts = dict(tl=32, tr=32, r_chunk=64, capacity=64, prefetch_depth=depth)
    rows = []
    for device in ("cuda", "cpu"):
        eng = get_engine("sharded", device=device, **opts)
        chunks = list(eng.evaluate_stream(feats, clauses, thetas))
        rows.append(([(c.candidates, c.stats.bytes_to_host,
                       c.stats.conjunct_evals) for c in chunks],
                     eng.last_sweep_capacity))
    assert rows[0] == rows[1]
    assert rows[0][1] > 64


def test_fleet_on_sharded_cuda_counts_band_steps(cuda_device):
    """Two tenants on the ring engine on the card: every band step takes a
    scheduler ticket, and the concurrent run equals the serial run."""
    from repro_torch.core.join import FDJConfig
    from repro_torch.data import synth
    from repro_torch.serving.fleet import JoinFleet
    runs = {}
    for workers in (1, 2):
        with JoinFleet(max_concurrent=workers) as fleet:
            for name in ("a", "b"):
                fleet.add_tenant(name, synth.police_records(
                    n_incidents=12, reports_per_incident=2, seed=3),
                    FDJConfig(engine="sharded",
                              engine_opts=dict(tl=32, tr=32, r_chunk=32),
                              seed=0, mc_trials=4000))
            futs = [fleet.submit(t) for t in ("a", "b", "a", "b")]
            runs[workers] = [f.result(timeout=300).pairs for f in futs]
            summary = fleet.drain()
        assert summary["band_steps"] > 0 and summary["failed"] == 0
    assert runs[1] == runs[2]
