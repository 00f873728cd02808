"""repro_torch fused CNF join vs the JAX reference kernel.

The same inputs, made by numpy from a seed, go through the JAX Pallas
kernel (interpret mode, as tests/test_kernels.py runs it) and the port's
wrapper on CPU tensors (its plain-torch version).  Masks must agree bit for
bit; the evals grid must agree exactly at equal tile sizes.
(tests/test_torch_cuda_kernels.py holds the CUDA kernel against the plain
version on the card.)
"""

import os
import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.costs import CostLedger
from repro.core.featurize import FeatureData as JFeatureData, FeaturizationSpec
from repro.data.simulated_llm import SimulatedExtractor
from repro.data.synth import police_records
from repro.engine.numpy_engine import NumpyEngine as JNumpyEngine
from repro_torch.core.featurize import (FeatureData as TFeatureData,
                                        FeaturizationSpec as TSpec)
from repro.kernels.fused_cnf_join import ops as jops, ref as jref
from repro.kernels.fused_cnf_join.kernel import cnf_join_block as j_block
from repro_torch.engine.numpy_engine import NumpyEngine
from repro_torch.kernels.fused_cnf_join import ops as tops, ref as tref
from repro_torch.kernels.fused_cnf_join.kernel import (SCAL, VEC,
                                                       cnf_join_block)


def _mk_inputs(rng, fv, fs, nl, nr, d):
    """tests/test_kernels.py's fixture generator."""
    el = rng.normal(size=(fv, nl, d)).astype(np.float32)
    er = rng.normal(size=(fv, nr, d)).astype(np.float32)
    el /= np.linalg.norm(el, axis=-1, keepdims=True)
    er /= np.linalg.norm(er, axis=-1, keepdims=True)
    sl = rng.uniform(0, 1.5, size=(max(fs, 1), nl)).astype(np.float32)
    sr = rng.uniform(0, 1.5, size=(max(fs, 1), nr)).astype(np.float32)
    return el, er, sl, sr


def _both(arrays, clauses, thetas, *, tl, tr, early_reject):
    """(jax mask as uint32, jax evals, torch mask as uint32, torch evals)."""
    jm, je = j_block(*map(jnp.asarray, arrays), clauses, thetas, tl=tl, tr=tr,
                     interpret=True, early_reject=early_reject,
                     with_evals=True)
    tm, te = cnf_join_block(*map(torch.from_numpy, arrays), clauses, thetas,
                            tl=tl, tr=tr, early_reject=early_reject,
                            with_evals=True)
    return (np.asarray(jm), np.asarray(je),
            tm.numpy().view(np.uint32), te.numpy())


@pytest.mark.parametrize("early_reject", [False, True])
@pytest.mark.parametrize("nl,nr,d,tl,tr", [
    (128, 128, 128, 64, 128),
    (256, 512, 128, 128, 256),
    (256, 256, 256, 256, 256),
    (512, 256, 128, 128, 128),
])
def test_mask_matches_jax_on_kernel_shapes(nl, nr, d, tl, tr, early_reject):
    rng = np.random.default_rng(nl + nr)
    arrays = _mk_inputs(rng, 2, 1, nl, nr, d)
    clauses = (((VEC, 0), (SCAL, 0)), ((VEC, 1),))
    jm, je, tm, te = _both(arrays, clauses, (0.45, 0.52), tl=tl, tr=tr,
                           early_reject=early_reject)
    assert jm.dtype == tm.dtype == np.uint32
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(te, je)


@pytest.mark.parametrize("structure", [
    (((VEC, 0),),),
    (((SCAL, 0),),),
    (((VEC, 0), (VEC, 1)), ((SCAL, 0),)),
    (((VEC, 0),), ((VEC, 1),), ((SCAL, 0), (VEC, 0))),
])
def test_mask_matches_jax_on_clause_structures(structure):
    rng = np.random.default_rng(7)
    arrays = _mk_inputs(rng, 2, 1, 128, 128, 128)
    thetas = tuple(0.3 + 0.1 * i for i in range(len(structure)))
    jm, je, tm, te = _both(arrays, structure, thetas, tl=64, tr=64,
                           early_reject=True)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(te, je)
    # the unpacked mask is the reference's boolean match matrix
    want = np.asarray(jref.cnf_join_ref(*map(jnp.asarray, arrays), structure,
                                        thetas))
    np.testing.assert_array_equal(tref.unpack_mask(tm, 128), want)


def test_early_reject_dead_tiles_count_one_clause():
    """A first clause that passes nowhere in some tiles: those tiles count
    1 clause and write zero words, in both implementations."""
    rng = np.random.default_rng(3)
    el, er, sl, sr = _mk_inputs(rng, 1, 1, 128, 128, 128)
    sl[0, :64] = 5.0                       # rows 0..63 fail the scalar clause
    clauses = (((SCAL, 0),), ((VEC, 0),))
    jm, je, tm, te = _both((el, er, sl, sr), clauses, (0.3, 0.6), tl=64,
                           tr=64, early_reject=True)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(te, je)
    assert (te[0] == 1).all() and (te[1] == 2).all()
    assert not tm[:64].any()


@pytest.mark.parametrize("dead", [False, True])
@pytest.mark.parametrize("early_reject", [False, True])
def test_counted_ref_matches_jax(dead, early_reject):
    """The band-level short-circuit: a band whose first clause passes
    nowhere counts 1 clause under early_reject, else every clause."""
    rng = np.random.default_rng(5)
    arrays = list(_mk_inputs(rng, 1, 1, 64, 96, 128))
    if dead:
        arrays[2] = arrays[2] + 5.0
    clauses = (((SCAL, 0),), ((VEC, 0),))
    j_ok, j_n = jref.cnf_join_ref_counted(*map(jnp.asarray, arrays), clauses,
                                          (0.3, 0.55), early_reject=early_reject)
    t_ok, t_n = tref.cnf_join_ref_counted(*map(torch.from_numpy, arrays),
                                          clauses, (0.3, 0.55),
                                          early_reject=early_reject)
    np.testing.assert_array_equal(t_ok.numpy(), np.asarray(j_ok))
    assert t_n == int(j_n) == (1 if dead and early_reject else 2)
    assert t_ok.any() != dead


def test_pack_mask_bits_and_sign_bit():
    rng = np.random.default_rng(1)
    ok = rng.random((6, 96)) < 0.5
    ok[:, 31] = True                       # bit 31: the int32 sign bit
    got = tref.pack_mask(torch.from_numpy(ok))
    assert got.dtype == torch.int32
    want = np.asarray(jref.pack_mask(jnp.asarray(ok)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(tref.unpack_mask(got, 96), ok)


def test_pack_mask_rejects_ragged_width():
    with pytest.raises(ValueError, match="multiple of 32"):
        tref.pack_mask(torch.zeros((4, 40), dtype=torch.bool))


def test_kernel_rejects_ragged_tr():
    el, er = torch.zeros((1, 64, 128)), torch.zeros((1, 48, 128))
    sl, sr = torch.zeros((1, 64)), torch.zeros((1, 48))
    with pytest.raises(ValueError, match="multiple of 32"):
        cnf_join_block(el, er, sl, sr, (((VEC, 0),),), (0.5,), tl=64, tr=48)


def test_kernel_rejects_untiled_shapes():
    el, er = torch.zeros((1, 60, 128)), torch.zeros((1, 64, 128))
    sl, sr = torch.zeros((1, 60)), torch.zeros((1, 64))
    with pytest.raises(ValueError, match="pack_features"):
        cnf_join_block(el, er, sl, sr, (((VEC, 0),),), (0.5,), tl=32, tr=32)


def test_theta_rounds_to_f32_like_the_reference():
    """theta64 sits just below an f32 distance d, so f32(theta64) == d: the
    kernel path (f32 compare, like the Pallas kernel's weakly typed float)
    admits the pair; the numpy engine (f64 theta) rejects it."""
    x = np.float32(0.25)
    y = np.float32(0.0625)
    d = np.float32(x - y)                          # exact scalar distance
    theta64 = float(d) - float(np.spacing(d)) / 4  # rounds to d in f32
    assert np.float32(theta64) == d and theta64 < float(d)
    n = 32
    sl = np.full((1, n), 2.0, np.float32)
    sr = np.full((1, n), -2.0, np.float32)
    sl[0, 3], sr[0, 5] = x, y
    el = np.zeros((1, n, 128), np.float32)
    er = np.zeros((1, n, 128), np.float32)
    clauses = (((SCAL, 0),),)
    jm, _, tm, _ = _both((el, er, sl, sr), clauses, (theta64,), tl=32, tr=32,
                         early_reject=False)
    np.testing.assert_array_equal(tm, jm)
    ok = tref.unpack_mask(tm, n)
    assert ok[3, 5] and ok.sum() == 1

    # the numpy engine compares against f64 theta: the same pair fails
    # (the reference's numpy engine does the same)
    spec = {"name": "s", "description": "", "distance_kind": "arithmetic",
            "extractor_kind": "llm", "field": "s"}
    t_feats = [TFeatureData(TSpec(**spec), "scalar", sl[0], sr[0])]
    j_feats = [JFeatureData(FeaturizationSpec(**spec), "scalar", sl[0], sr[0])]
    for engine, feats in ((NumpyEngine, t_feats), (JNumpyEngine, j_feats)):
        assert engine(block=16).evaluate(feats, [[0]], [theta64]) \
            .candidates == []
        assert engine(block=16).evaluate(feats, [[0]], [float(d)]) \
            .candidates == [(3, 5)]


def test_threshold_gap_takes_the_nearest_clause():
    """The tolerance helper the card checks use: per pair, the float64 gap
    between a clause's min distance and its threshold, min over clauses."""
    el = np.zeros((1, 2, 4), np.float32)
    er = np.zeros((1, 2, 4), np.float32)
    el[0, :, 0] = 1.0
    er[0, 0, 0] = 1.0                      # dot 1 -> embed distance 0
    sl = np.array([[0.5, 0.0]], np.float32)
    sr = np.array([[0.25, 0.9]], np.float32)
    clauses = (((SCAL, 0),), ((VEC, 0),))
    gap = tref.threshold_gap(*map(torch.from_numpy, (el, er, sl, sr)), clauses,
                             (0.3, 0.4), [0, 1], [0, 1])
    # pair (0,0): scalar 0.25 vs 0.3, embed 0 vs 0.4; pair (1,1): 0.9, 0.5
    np.testing.assert_allclose(gap, [0.05, 0.1], atol=1e-7)
    assert tref.dot_error_band(128) == 128 * 2.0 ** -24


def _police_feats():
    ds = police_records(n_incidents=40, reports_per_incident=2)
    specs = [FeaturizationSpec("incident_date", "", "arithmetic", "llm", "incident_date"),
             FeaturizationSpec("officer_names", "", "word_overlap", "llm", "officer_names"),
             FeaturizationSpec("location", "", "semantic", "llm", "location")]
    return SimulatedExtractor(ds).materialize(specs, CostLedger())


def test_pack_features_matches_reference():
    """Kernel layout, pad markers [-2, 1]/[1, -2] and the ±1e9 scalar pad."""
    feats = _police_feats()
    for clauses in ([[0], [1, 2]], [[2, 1]], [[0]]):
        want = jops.pack_features(feats, clauses, tl=32, tr=64)
        got = tops.pack_features(feats, clauses, tl=32, tr=64)
        for w, g in zip(want[:4], got[:4]):
            assert w.dtype == g.dtype
            np.testing.assert_array_equal(g, w)
        assert got[4:] == want[4:]
    emb_l, emb_r, scal_l, scal_r, _, n_l, n_r = \
        tops.pack_features(feats, [[0], [1, 2]], tl=32, tr=64)
    d_raw = feats[1].data_l.shape[1]
    assert (emb_l[:, n_l:, d_raw - 2] == -2).all()
    assert (emb_l[:, n_l:, d_raw - 1] == 1).all()
    assert (emb_r[:, n_r:, d_raw - 2] == 1).all()
    assert (emb_r[:, n_r:, d_raw - 1] == -2).all()
    assert (scal_l[:, n_l:] == 1e9).all() and (scal_r[:, n_r:] == -1e9).all()


@pytest.mark.parametrize("early_reject", [True, False])
def test_corpus_stream_matches_reference(early_reject):
    """evaluate_corpus_stream on CPU == the reference pallas stream: pairs,
    bytes_to_host, bytes_h2d and conjunct_evals, block by block."""
    feats = _police_feats()
    clauses, th = [[0], [1, 2]], [0.02, 0.35]
    want = list(jops.evaluate_corpus_stream(
        feats, clauses, th, tl=32, tr=64, l_block=64, interpret=True,
        early_reject=early_reject))
    got = list(tops.evaluate_corpus_stream(
        feats, clauses, th, tl=32, tr=64, l_block=64,
        early_reject=early_reject, device="cpu"))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert g.pairs == w.pairs
        assert g.bytes_to_host == w.bytes_to_host
        assert g.bytes_h2d == w.bytes_h2d
        assert g.conjunct_evals == w.conjunct_evals
    assert sum(len(g.pairs) for g in got) > 0
    pairs, nbytes = tops.evaluate_corpus(feats, clauses, th, tl=32, tr=64,
                                         device="cpu", return_mask_bytes=True)
    assert sorted(pairs) == sorted(p for g in got for p in g.pairs)
    assert nbytes == sum(w.bytes_to_host for w in jops.evaluate_corpus_stream(
        feats, clauses, th, tl=32, tr=64, interpret=True))


def test_wrapper_types_the_launch_function(monkeypatch):
    """The launch function gets its argument types before its first call:
    untyped, ctypes would pass every pointer as a 32-bit int."""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_cnf_join import kernel as tkernel
    fake = types.SimpleNamespace(cnf_join_launch=ctypes.CDLL(None).labs)
    assert fake.cnf_join_launch.argtypes is None
    monkeypatch.setattr(_build, "load", lambda name: fake)
    _, fn = tkernel._launcher()
    assert fn.argtypes == tkernel._ARGTYPES and fn.restype is ctypes.c_int
    assert len(fn.argtypes) == 23            # cnf_join_launch's parameters


def test_wrapper_plan_rounds_thetas_to_f32_and_validates():
    from repro_torch.kernels.fused_cnf_join import kernel as tkernel
    clauses = (((VEC, 0), (SCAL, 0)), ((VEC, 1),))
    n, offs, kinds, index, theta = tkernel._plan(clauses, (0.1, 1 / 3), 2, 1)
    assert n == 2 and list(offs) == [0, 2, 3]
    assert list(kinds) == [VEC, SCAL, VEC] and list(index) == [0, 0, 1]
    np.testing.assert_array_equal(np.array(list(theta), np.float32),
                                  np.array([0.1, 1 / 3], np.float32))
    with pytest.raises(ValueError, match="bad member"):
        tkernel._plan((((VEC, 2),),), (0.5,), 2, 1)
    with pytest.raises(ValueError, match="thetas"):
        tkernel._plan(clauses, (0.5,), 2, 1)


def test_plan_of_keys_lists_by_their_tuple_copies():
    from repro_torch.kernels.fused_cnf_join import kernel as tkernel
    as_tuples = tkernel._plan_of((((VEC, 0),), ((SCAL, 0),)), (0.25, 0.5),
                                 1, 1)
    as_lists = tkernel._plan_of([[[VEC, 0]], [(SCAL, 0)]], [0.25, 0.5], 1, 1)
    assert as_lists is as_tuples               # one cached plan



_PTXAS_STDERR = """\
ptxas info    : 11 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115cnf_join_kernelILb1EEEvNS_6PlanesENS_3CnfEiiiPiS3_S3_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115cnf_join_kernelILb1EEEvNS_6PlanesENS_3CnfEiiiPiS3_S3_
    48 bytes stack frame, 48 bytes spill stores, 48 bytes spill loads
ptxas info    : Used 128 registers, 1 barriers, 48 bytes cumulative stack size, 1328 bytes cmem[0]
"""


@pytest.mark.parametrize("line,kept", [
    (2, True),          # the kernel's name
    (4, True),          # its stack and spills
    (5, True),          # its registers
    (1, False),         # module-level lines
    (3, False),
])
def test_build_report_keeps_the_kernel_lines_of_ptxas(line, kept):
    from repro_torch.kernels import _build
    text = _PTXAS_STDERR.splitlines()[line - 1]
    assert bool(_build._PTXAS_KEEP.search(text)) is kept


def test_ptxas_report_reads_the_report_beside_the_library(tmp_path,
                                                          monkeypatch):
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    assert _build.ptxas_report("cnf_join") == []          # not built
    lib = _build._target("cnf_join")[1]
    assert os.path.dirname(lib) == str(tmp_path)
    with open(f"{lib}.ptxas.txt", "w") as f:
        f.write("Used 128 registers\n\n48 bytes spill stores\n")
    assert _build.ptxas_report("cnf_join") == ["Used 128 registers",
                                               "48 bytes spill stores"]
