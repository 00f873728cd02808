"""repro_torch step-② engines vs the JAX reference engines.

The port's ``cuda`` and ``sharded`` engines (on CPU tensors: the kernels'
plain versions) and its ``numpy`` engine must return the reference
engines' candidate set on
the ragged synth cases of tests/test_engines.py, the empty scaffold and an
all-missing feature column.  Planes come from each package's own
extractor and must agree array for array.  Streamed chunks must be
disjoint, with a sorted union equal to ``evaluate``.
"""

import numpy as np
import pytest

from repro.core.costs import CostLedger as JLedger
from repro.core.featurize import FeaturizationSpec as JSpec, vectorize as jvec
from repro.data import synth as jsynth
from repro.data.cnf_fixtures import representative_cnf as j_cnf
from repro.data.simulated_llm import SimulatedExtractor as JExtractor
from repro.engine import get_engine as j_engine
from repro_torch.core.costs import CostLedger
from repro_torch.core.featurize import FeaturizationSpec, vectorize
from repro_torch.data import synth
from repro_torch.data.cnf_fixtures import representative_cnf
from repro_torch.data.simulated_llm import SimulatedExtractor
from repro_torch.engine import ENGINES, get_engine

_OPTS = {"numpy": dict(block=64), "cuda": dict(tl=32, tr=64, device="cpu"),
         "sharded": dict(tl=32, tr=32, r_chunk=64, device="cpu")}
_J_OPTS = {"numpy": dict(block=64), "pallas": dict(tl=32, tr=64)}


def _port(feats, clauses, thetas):
    return {n: get_engine(n, **_OPTS[n]).evaluate(feats, clauses, thetas)
            for n in ENGINES}


def _reference(feats, clauses, thetas):
    return {n: j_engine(n, **o).evaluate(feats, clauses, thetas).candidates
            for n, o in _J_OPTS.items()}


def _assert_planes_equal(t_feats, j_feats):
    assert len(t_feats) == len(j_feats)
    for t, j in zip(t_feats, j_feats):
        assert (t.kind, t.scale) == (j.kind, j.scale)
        np.testing.assert_array_equal(t.data_l, j.data_l)
        np.testing.assert_array_equal(t.data_r, j.data_r)


def _assert_all_equal(port, ref):
    base = ref["numpy"]
    assert ref["pallas"] == base
    for name, res in port.items():
        assert res.candidates == base, (
            f"{name} disagrees with the reference: "
            f"{len(res.candidates)} vs {len(base)} candidates")
    return base


@pytest.mark.parametrize("dataset,kw", [
    ("police_records", dict(n_incidents=37, reports_per_incident=2, seed=5)),
    ("citations", dict(n_docs=101, seed=9)),
], ids=["police_ragged", "citations_ragged"])
def test_engines_match_reference_on_synth_datasets(dataset, kw):
    t_ds = getattr(synth, dataset)(**kw)
    j_ds = getattr(jsynth, dataset)(**kw)
    specs, clauses, thetas = representative_cnf(t_ds)
    j_specs, j_clauses, j_thetas = j_cnf(j_ds)
    assert (clauses, thetas) == (j_clauses, j_thetas)
    t_feats = SimulatedExtractor(t_ds).materialize(specs, CostLedger())
    j_feats = JExtractor(j_ds).materialize(j_specs, JLedger())
    _assert_planes_equal(t_feats, j_feats)
    port = _port(t_feats, clauses, thetas)
    base = _assert_all_equal(port, _reference(j_feats, clauses, thetas))
    assert len(base) > 0
    for res in port.values():
        assert (res.stats.n_l, res.stats.n_r) == (t_ds.n_l, t_ds.n_r)
        assert res.stats.n_candidates == len(base)


def test_engines_match_reference_on_empty_scaffold():
    t_ds = synth.police_records(n_incidents=10, reports_per_incident=2, seed=1)
    specs, _, _ = representative_cnf(t_ds)
    feats = SimulatedExtractor(t_ds).materialize(specs, CostLedger())
    for res in _port(feats, [], []).values():
        assert len(res.candidates) == t_ds.n_l * t_ds.n_r


def test_engines_match_reference_on_all_missing_column():
    n_l, n_r = 41, 53
    vals_l = [f"item {i % 7}" for i in range(n_l)]
    vals_r = [f"item {i % 7}" for i in range(n_r)]
    args = (("name", "", "word_overlap", "llm", "name"),
            ("dead", "", "semantic", "llm", "dead"))
    t_feats = [vectorize(FeaturizationSpec(*args[0]), vals_l, vals_r),
               vectorize(FeaturizationSpec(*args[1]), [None] * n_l, [None] * n_r)]
    j_feats = [jvec(JSpec(*args[0]), vals_l, vals_r),
               jvec(JSpec(*args[1]), [None] * n_l, [None] * n_r)]
    _assert_planes_equal(t_feats, j_feats)
    assert _assert_all_equal(_port(t_feats, [[1]], [0.9]),
                             _reference(j_feats, [[1]], [0.9])) == []
    dis = _assert_all_equal(_port(t_feats, [[0, 1]], [0.3]),
                            _reference(j_feats, [[0, 1]], [0.3]))
    live = _assert_all_equal(_port(t_feats, [[0]], [0.3]),
                             _reference(j_feats, [[0]], [0.3]))
    assert dis == live and len(dis) > 0


@pytest.mark.parametrize("engine", ENGINES)
def test_stream_chunks_disjoint_and_union_equals_evaluate(engine):
    ds = synth.citations(n_docs=101, seed=9)
    specs, clauses, thetas = representative_cnf(ds)
    feats = SimulatedExtractor(ds).materialize(specs, CostLedger())
    small = {"numpy": dict(block=32), "cuda": dict(l_block=32),
             "sharded": dict(r_chunk=32)}[engine]
    eng = get_engine(engine, **{**_OPTS[engine], **small})
    chunks = list(eng.evaluate_stream(feats, clauses, thetas))
    assert len(chunks) > 1
    seen = set()
    for idx, ch in enumerate(chunks):
        assert ch.index == idx
        assert ch.candidates == sorted(ch.candidates)
        assert seen.isdisjoint(ch.candidates)
        seen.update(ch.candidates)
    assert sorted(seen) == eng.evaluate(feats, clauses, thetas).candidates


def test_cuda_engine_accounting_matches_reference_pallas():
    """bytes_to_host, bytes_h2d and conjunct_evals per evaluation."""
    ds = synth.police_records(n_incidents=37, reports_per_incident=2, seed=5)
    specs, clauses, thetas = representative_cnf(ds)
    feats = SimulatedExtractor(ds).materialize(specs, CostLedger())
    got = get_engine("cuda", **_OPTS["cuda"]).evaluate(feats, clauses, thetas)
    j_ds = jsynth.police_records(n_incidents=37, reports_per_incident=2, seed=5)
    j_specs, _, _ = j_cnf(j_ds)
    j_feats = JExtractor(j_ds).materialize(j_specs, JLedger())
    want = j_engine("pallas", **_J_OPTS["pallas"]).evaluate(j_feats, clauses,
                                                            thetas)
    for key in ("bytes_to_host", "bytes_h2d", "conjunct_evals", "n_candidates"):
        assert getattr(got.stats, key) == getattr(want.stats, key), key


def test_cuda_engine_on_cuda_without_gpu_raises():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        get_engine("cuda")
