"""repro_torch's ring engine (``engine="sharded"``) vs the JAX reference's
``ShardedEngine`` on its 1-device host mesh, on the CPU.

Chunk by chunk, with the same tiles, ``r_chunk`` and capacity as the
reference's tests (``tl = tr = 32``, ``r_chunk`` 64), at ring depths 1, 2
and 4, on both eval-unit paths (``use_kernel``), with overflow retries:
the same chunks in the same order, pairs, ``conjunct_evals``,
``bytes_to_host``, ``last_sweep_caps``, and the same trace events
(overflow / invalidate / redispatch and their caps).  Then ports of the
reference's compaction oracle tests (tests/test_bitmask.py), its ring
tests (tests/test_streaming.py) and its capacity tests
(tests/test_engines.py) on the port's engine, and a one-shot ``products``
join through ``engine="sharded"`` equal to the reference's pairs, theta,
candidates and dollars.
"""

import time

import numpy as np
import pytest
import torch

from repro.core.costs import CostLedger as JLedger
from repro.core.join import FDJConfig as JCfg, fdj_join as j_fdj_join
from repro.data import synth as j_synth
from repro.data.cnf_fixtures import representative_cnf as j_cnf
from repro.data.simulated_llm import (SimulatedExtractor as JExtractor,
                                      SimulatedProposer as JProposer)
from repro.engine import get_engine as j_engine
from repro.launch._args import make_dataset as j_dataset
from repro.obs import Tracer as JTracer, use_tracer as j_use_tracer
from repro_torch.core.costs import CostLedger
from repro_torch.core.featurize import FeaturizationSpec, vectorize
from repro_torch.core.join import FDJConfig, fdj_join
from repro_torch.data import synth
from repro_torch.data.cnf_fixtures import representative_cnf
from repro_torch.data.simulated_llm import SimulatedExtractor, SimulatedProposer
from repro_torch.engine import extract, get_engine
from repro_torch.engine.sharded import ShardedEngine
from repro_torch.kernels.fused_cnf_join import ref as cref
from repro_torch.launch._args import make_dataset
from repro_torch.launch.join import run_join
from repro_torch.obs import Tracer, use_tracer
from repro_torch.serving.fleet import BandScheduler

# the reference's test tiles (tests/test_streaming.py _OPTS["sharded"])
_OPTS = dict(tl=32, tr=32, r_chunk=64)


def _ring(**kw):
    return get_engine("sharded", device="cpu", **kw)


_DATASETS = {
    # 74 x 74: not a multiple of any tile edge -> padding exercised
    "police_ragged": ("police_records",
                      dict(n_incidents=37, reports_per_incident=2, seed=5)),
    # 101 x 101: ragged on both sides for r_chunk=64
    "citations_ragged": ("citations", dict(n_docs=101, seed=9)),
}


def _materialized(name):
    fn, kw = _DATASETS[name]
    ds = getattr(synth, fn)(**kw)
    specs, clauses, thetas = representative_cnf(ds)
    feats = SimulatedExtractor(ds).materialize(specs, CostLedger())
    j_ds = getattr(j_synth, fn)(**kw)
    j_specs, _, _ = j_cnf(j_ds)
    j_feats = JExtractor(j_ds).materialize(j_specs, JLedger())
    return feats, j_feats, clauses, thetas


def _trace_rows(tracer):
    """Per band step: its events (name, attrs without timestamps) and its
    dispatch/pull slices' attrs without walls, in recording order."""
    spans = tracer.spans()
    rows = []
    for sp in spans:
        if not sp.name.startswith("band_step["):
            continue
        kids = {c.name: {k: v for k, v in c.attrs.items() if k != "enqueue_s"}
                for c in spans if c.parent_id == sp.span_id}
        rows.append((sp.name, sp.track,
                     [(e.name, e.attrs) for e in sp.events], kids))
    return rows


def _chunk_row(ch):
    st = ch.stats
    return (ch.index, ch.candidates, st.n_candidates, st.bytes_to_host,
            st.bytes_h2d, st.bytes_reshard, st.conjunct_evals,
            st.overlap_s == 0.0)


# --- chunk-by-chunk parity with the reference ---------------------------------

@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["band_units", "tile_units"])
@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("name", list(_DATASETS))
def test_ring_matches_reference_chunk_by_chunk(name, depth, use_kernel):
    feats, j_feats, clauses, thetas = _materialized(name)
    # capacity 64 overflows the dense steps: retries re-dispatch successors
    opts = dict(_OPTS, prefetch_depth=depth, use_kernel=use_kernel,
                capacity=64)
    tracer, j_tracer = Tracer(), JTracer()
    eng = _ring(**opts)
    with use_tracer(tracer):
        got = list(eng.evaluate_stream(feats, clauses, thetas))
    j_eng = j_engine("sharded", **opts)
    with j_use_tracer(j_tracer):
        want = list(j_eng.evaluate_stream(j_feats, clauses, thetas))
    assert len(got) > 1
    assert [_chunk_row(c) for c in got] == [_chunk_row(c) for c in want]
    np.testing.assert_array_equal(eng.last_sweep_caps, j_eng.last_sweep_caps)
    rows, j_rows = _trace_rows(tracer), _trace_rows(j_tracer)
    assert rows == j_rows
    events = {e for r in rows for e, _ in r[2]}
    assert "overflow" in events
    if depth > 1:
        assert {"invalidate", "redispatch"} <= events
    if depth == 1:
        assert all(c.stats.overlap_s == 0.0 for c in got)


def test_ring_stage_span_matches_reference():
    feats, j_feats, clauses, thetas = _materialized("police_ragged")
    tracer, j_tracer = Tracer(), JTracer()
    with use_tracer(tracer):
        _ring(**_OPTS).evaluate(feats, clauses, thetas)
    with j_use_tracer(j_tracer):
        j_engine("sharded", **_OPTS).evaluate(j_feats, clauses, thetas)
    stage = [s.attrs for s in tracer.spans() if s.name == "stage_planes"]
    j_stage = [s.attrs for s in j_tracer.spans() if s.name == "stage_planes"]
    assert stage == j_stage and stage[0]["bytes_h2d"] > 0


# --- ports of tests/test_bitmask.py: compaction vs the np.nonzero oracle -----

def _packed(ok):
    return cref.pack_mask(torch.from_numpy(ok))


@pytest.mark.parametrize("seed", range(6))
def test_extraction_matches_nonzero_oracle(seed):
    rng = np.random.default_rng(100 + seed)
    nl = int(rng.integers(1, 40))
    nw = int(rng.integers(1, 6))
    ok = rng.random((nl, nw * 32)) < rng.uniform(0.0, 0.6)
    cap = int(ok.sum()) + 8
    buf, count = extract.extract_pairs(_packed(ok), capacity=cap)
    count = int(count)
    assert count == int(ok.sum())
    got = sorted(map(tuple, buf[:count].tolist()))
    ii, jj = np.nonzero(ok)
    assert got == sorted(zip(ii.tolist(), jj.tolist()))
    assert (buf[count:] == -1).all()             # filler untouched past count


def test_extraction_applies_offsets():
    ok = np.zeros((4, 32), bool)
    ok[0, 0] = ok[3, 31] = True
    buf, count = extract.extract_pairs(_packed(ok), capacity=4,
                                       row_offset=100, col_offset=1000)
    assert sorted(map(tuple, buf[: int(count)].tolist())) == \
        [(100, 1000), (103, 1031)]


def test_extraction_overflow_detected_not_silent():
    """count keeps growing past capacity so the caller can detect + retry."""
    ok = np.ones((8, 32), bool)                  # 256 candidates
    buf, count = extract.extract_pairs(_packed(ok), capacity=10)
    assert int(count) == 256                     # true total, not clamped
    assert buf.shape == (10, 2) and (buf >= 0).all()


def test_extraction_append_across_chunks():
    """compact_append accumulates two chunks exactly like one big extract."""
    rng = np.random.default_rng(7)
    ok1 = rng.random((16, 64)) < 0.3
    ok2 = rng.random((16, 64)) < 0.3
    cap = int(ok1.sum() + ok2.sum()) + 4
    buf = torch.full((cap, 2), -1, dtype=torch.int32)
    buf, cnt = extract.compact_append(_packed(ok1), buf, 0)
    buf, cnt = extract.compact_append(_packed(ok2), buf, cnt, col_offset=64)
    got = sorted(map(tuple, buf[: int(cnt)].tolist()))
    ii, jj = np.nonzero(np.concatenate([ok1, ok2], axis=1))
    assert got == sorted(zip(ii.tolist(), jj.tolist()))


def test_sharded_engine_rejects_ragged_tr():
    with pytest.raises(ValueError, match="multiple of 32"):
        ShardedEngine(tr=48, device="cpu")
    with pytest.raises(ValueError, match="multiple of tr"):
        ShardedEngine(tr=32, r_chunk=40, device="cpu")


# --- ports of tests/test_streaming.py ------------------------------------------

def _same_text(n_l, n_r=None):
    spec = FeaturizationSpec("name", "", "word_overlap", "llm", "name")
    return [vectorize(spec, ["same text"] * n_l, ["same text"] * (n_r or n_l))]


def test_sharded_stream_overflow_retry():
    """An undersized per-chunk buffer must grow (>=4x) mid-stream and the
    union must still be the complete candidate set — no truncated chunk."""
    n = 40
    feats = _same_text(n)
    eng = _ring(tl=32, tr=32, r_chunk=32, capacity=8)
    chunks = list(eng.evaluate_stream(feats, [[0]], [0.5]))
    assert eng.last_sweep_capacity >= 4 * 8      # the >=4x growth rule
    assert eng.capacity == 8                     # config never mutated
    union = sorted(p for ch in chunks for p in ch.candidates)
    assert union == [(i, j) for i in range(n) for j in range(n)]
    for ch in chunks:
        assert len(ch.candidates) == ch.stats.n_candidates


def test_vacuous_conjunction_streams_in_bounded_chunks(monkeypatch):
    import repro_torch.engine.base as base_mod
    monkeypatch.setattr(base_mod, "VACUOUS_CHUNK_PAIRS", 7)
    spec = FeaturizationSpec("name", "", "word_overlap", "llm", "name")
    feats = [vectorize(spec, [f"l{i}" for i in range(5)],
                       [f"r{j}" for j in range(3)])]
    chunks = list(_ring(**_OPTS).evaluate_stream(feats, [], []))
    assert [len(ch.candidates) for ch in chunks] == [6, 6, 3]
    assert [ch.index for ch in chunks] == [0, 1, 2]
    union = [p for ch in chunks for p in ch.candidates]
    assert sorted(union) == [(i, j) for i in range(5) for j in range(3)]
    assert _ring(**_OPTS).evaluate(feats, [], []).candidates == sorted(union)


def _banded_density_fixture():
    """33 x 128 corpus whose matches all live in R band [64, 96): with
    r_chunk=32 the sweep is 4 steps and only step 2 overflows."""
    n_l = 33
    texts_r = ["zzz yyy"] * 64 + ["same text"] * 32 + ["zzz yyy"] * 32
    spec = FeaturizationSpec("name", "", "word_overlap", "llm", "name")
    feats = [vectorize(spec, ["same text"] * n_l, texts_r)]
    return feats, [(i, j) for i in range(n_l) for j in range(64, 96)]


@pytest.mark.parametrize("ring_opts", [
    dict(), dict(prefetch_depth=1),
    dict(prefetch_depth=1), dict(prefetch_depth=2), dict(prefetch_depth=3),
    dict(prefetch_depth=4),
], ids=["db", "serial", "depth1", "depth2", "depth3", "depth4"])
def test_sharded_retry_mid_pipeline_drops_and_duplicates_nothing(ring_opts):
    feats, want = _banded_density_fixture()
    eng = _ring(tl=32, tr=32, r_chunk=32, capacity=1, **ring_opts)
    tracer = Tracer()
    with use_tracer(tracer):
        chunks = list(eng.evaluate_stream(feats, [[0]], [0.25]))
    assert len(chunks) == 4                      # one per R band
    union = [p for ch in chunks for p in ch.candidates]
    assert len(union) == len(set(union)), "retry duplicated a chunk"
    assert sorted(union) == want, "retry dropped or truncated a chunk"
    for ch in chunks:
        assert len(ch.candidates) == ch.stats.n_candidates
    assert eng.last_sweep_capacity >= 33 * 32    # grew to the hot band
    assert eng.capacity == 1                     # config untouched
    assert sorted(union) == get_engine("numpy").evaluate(
        feats, [[0]], [0.25]).candidates
    # the in-flight successors of the overflowing step were re-dispatched
    depth = eng.effective_prefetch_depth
    events = [(e.name, e.attrs) for sp in tracer.spans() for e in sp.events]
    assert ("overflow", {"counts_max": 33 * 32, "cap": 1}) in events
    inval = [a["steps"] for n, a in events if n == "invalidate"]
    redis = [a["cap"] for n, a in events if n == "redispatch"]
    if depth == 1:
        assert inval == [] and redis == []
    else:
        assert inval == [list(range(3, min(2 + depth, 4)))]
        assert redis == [eng.last_sweep_capacity] * len(inval[0])


def test_sharded_overlap_accounting_pipelined_vs_serial():
    """overlap_s is > 0 when the ring kept a successor step in flight
    during host pulls, exactly 0 when forced serial."""
    feats, _, clauses, thetas = _materialized("police_ragged")
    db = _ring(**_OPTS).evaluate(feats, clauses, thetas)
    serial = _ring(prefetch_depth=1, **_OPTS).evaluate(feats, clauses,
                                                       thetas)
    depth1 = _ring(prefetch_depth=1, **_OPTS).evaluate(feats, clauses, thetas)
    deep = _ring(prefetch_depth=4, **_OPTS).evaluate(feats, clauses, thetas)
    assert db.candidates == serial.candidates == depth1.candidates \
        == deep.candidates
    assert db.stats.overlap_s > 0
    assert deep.stats.overlap_s > 0
    assert serial.stats.overlap_s == 0.0
    assert depth1.stats.overlap_s == 0.0
    for st in (db.stats, serial.stats, depth1.stats, deep.stats):
        assert st.dispatch_wall_s > 0 and st.pull_wall_s > 0


@pytest.mark.parametrize("device", ["cuda", "cuda:0"])
def test_sharded_plain_cnf_refused_on_cuda(device):
    """use_kernel=False is the CPU tests' eval-unit switch: on a CUDA device
    the ring never runs the plain-torch CNF (checked before the device is
    resolved, so this raises with or without a card)."""
    with pytest.raises(ValueError, match="use_kernel=False"):
        get_engine("sharded", device=device, use_kernel=False)
    assert not _ring(use_kernel=False).use_kernel      # the CPU keeps it


def test_sharded_prefetch_depth_resolution_and_validation():
    assert _ring().effective_prefetch_depth == 2
    assert _ring(prefetch_depth=4).effective_prefetch_depth == 4
    assert _ring(prefetch_depth=1).effective_prefetch_depth == 1
    # one spelling of the depth: the reference's legacy double_buffer is
    # not taken
    with pytest.raises(TypeError, match="double_buffer"):
        _ring(double_buffer=False)
    with pytest.raises(ValueError, match="prefetch_depth"):
        _ring(prefetch_depth=0)


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_sharded_prefetch_depth_stream_parity(depth):
    feats, _, clauses, thetas = _materialized("police_ragged")
    opts = dict(_OPTS, prefetch_depth=depth)
    for cl, th in ((clauses, thetas), ([], [])):
        chunks = list(_ring(**opts).evaluate_stream(feats, cl, th))
        batch = _ring(**opts).evaluate(feats, cl, th)
        union = [p for ch in chunks for p in ch.candidates]
        assert len(union) == len(set(union))
        assert sorted(union) == batch.candidates
        assert [ch.index for ch in chunks] == list(range(len(chunks)))
        for ch in chunks:
            assert ch.candidates == sorted(ch.candidates)
        assert sum(ch.stats.bytes_to_host for ch in chunks) \
            == batch.stats.bytes_to_host
        if cl:
            assert batch.stats.n_candidates > 0 and len(chunks) > 1


def test_stream_wall_clock_excludes_consumer_time():
    """Per-chunk wall measures engine time only: a slow consumer must not
    inflate step-② accounting (the pump relies on this split).  The stall
    (200 ms a chunk) is far above the ring's own time on this corpus, so a
    hold billed to any chunk would show."""
    ds = synth.police_records(n_incidents=20, reports_per_incident=2, seed=2)
    specs, clauses, thetas = representative_cnf(ds)
    feats = SimulatedExtractor(ds).materialize(specs, CostLedger())
    walls = []
    # one intra-op thread: on a loaded host a pool of idle OpenMP threads
    # can hold a tiny plain-torch matmul for 100 ms and more
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for ch in _ring(tl=32, tr=32, r_chunk=32).evaluate_stream(
                feats, clauses, thetas):
            walls.append(ch.stats.wall_s)
            time.sleep(0.2)                      # consumer stalls 200 ms/chunk
    finally:
        torch.set_num_threads(threads)
    assert len(walls) > 1
    assert sum(walls) < 0.2                      # engine time stays its own


# --- ports of tests/test_engines.py ----------------------------------------------

def test_sharded_capacity_overflow_is_retried_not_truncated():
    n = 40
    feats = _same_text(n)
    res = _ring(tl=32, tr=32, r_chunk=64, capacity=64).evaluate(
        feats, [[0]], [0.5])
    assert len(res.candidates) == n * n
    assert res.candidates == get_engine("numpy").evaluate(
        feats, [[0]], [0.5]).candidates


def test_sharded_capacity_one_forces_retry_on_every_chunk():
    n = 33
    feats = _same_text(n)
    want = [(i, j) for i in range(n) for j in range(n)]
    eng = _ring(tl=32, tr=32, r_chunk=32, capacity=1)
    assert eng.evaluate(feats, [[0]], [0.5]).candidates == want
    assert eng.last_sweep_capacity >= 4 and eng.capacity == 1
    eng2 = _ring(tl=32, tr=32, r_chunk=32, capacity=1)
    chunks = list(eng2.evaluate_stream(feats, [[0]], [0.5]))
    assert len(chunks) == 2                      # padded R = 64 -> two chunks
    for ch in chunks:
        assert len(ch.candidates) == ch.stats.n_candidates > 0
    assert sorted(p for ch in chunks for p in ch.candidates) == want


def test_sharded_capacity_growth_is_sweep_local():
    n = 40
    spec = FeaturizationSpec("name", "", "word_overlap", "llm", "name")
    dense = _same_text(n)
    sparse = [vectorize(spec, ["aaa bbb"] * n, ["zzz yyy"] * n)]
    eng = _ring(tl=32, tr=32, r_chunk=64, capacity=64)
    assert len(eng.evaluate(dense, [[0]], [0.5]).candidates) == n * n
    assert eng.last_sweep_capacity >= 4 * 64 and eng.capacity == 64
    assert eng.evaluate(sparse, [[0]], [0.25]).candidates == []
    assert eng.last_sweep_capacity == 64
    assert list(eng.last_sweep_caps) == [64]


def test_sharded_host_bytes_scale_with_candidates():
    """Host transfer is O(candidates): 12 bytes a step plus 8 a pulled
    pair, far below the plane."""
    ds = synth.police_records(n_incidents=50, reports_per_incident=2, seed=3)
    specs, clauses, thetas = representative_cnf(ds)
    feats = SimulatedExtractor(ds).materialize(specs, CostLedger())
    chunks = list(_ring(**_OPTS).evaluate_stream(feats, clauses, thetas))
    s = _ring(**_OPTS).evaluate(feats, clauses, thetas).stats
    assert s.bytes_to_host <= 8 * (s.n_candidates + 64) + 1024
    assert s.bytes_to_host < s.plane_bytes / 4
    for ch in chunks:                            # no retry at the default cap
        assert ch.stats.bytes_to_host >= 12 + 8 * ch.stats.n_candidates
        assert (ch.stats.bytes_to_host - 12) % 8 == 0


# --- devices, the scheduler, the one-shot join ----------------------------------

def test_sharded_engine_on_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        get_engine("sharded")


def test_band_steps_go_through_the_scheduler():
    """Each enqueue (every band step and every re-dispatch) takes one
    scheduler ticket."""
    feats, want = _banded_density_fixture()
    sched = BandScheduler()
    eng = _ring(tl=32, tr=32, r_chunk=32, capacity=1, prefetch_depth=2,
                scheduler=sched)
    assert eng.evaluate(feats, [[0]], [0.25]).candidates == want
    # 4 band steps + the overflowing step's retry + its 1 in-flight
    # successor re-dispatched
    assert sched.band_steps == 6


_REF: dict = {}


def _reference_products(r_chunk):
    """The reference's one-shot products join through its sharded engine."""
    if r_chunk not in _REF:
        ds = j_dataset("products", size=0.3)
        cfg = JCfg(engine="sharded", engine_opts=dict(r_chunk=r_chunk),
                   prefetch_depth=2)
        _REF[r_chunk] = j_fdj_join(ds, ds.make_oracle(), JProposer(ds),
                                   JExtractor(ds), cfg)
    return _REF[r_chunk]


@pytest.mark.parametrize("stream", [False, True], ids=["barrier", "stream"])
def test_products_join_through_sharded_matches_reference(stream):
    want = _reference_products(128)
    ds = make_dataset("products", size=0.3)
    cfg = FDJConfig(engine="sharded", device="cpu", prefetch_depth=2,
                    stream_refinement=stream, engine_opts=dict(r_chunk=128))
    got = fdj_join(ds, ds.make_oracle(), SimulatedProposer(ds),
                   SimulatedExtractor(ds), cfg)
    assert got.pairs == want.pairs
    np.testing.assert_array_equal(got.theta, want.theta)
    assert got.candidate_count == want.candidate_count > len(got.pairs) > 0
    assert got.cost.total == want.cost.total
    assert got.scaffold.clauses == want.scaffold.clauses == [[4], [2]]
    for key in ("bytes_to_host", "bytes_h2d", "conjunct_evals"):
        assert getattr(got.engine_stats, key) == \
            getattr(want.engine_stats, key), key


def test_launcher_sharded_on_cpu_matches_reference():
    """``launch.join --engine sharded --device cpu --r-chunk 128
    --prefetch-depth 2``, as the launcher's own function runs it."""
    want = _reference_products(128)
    out = run_join("products", size=0.3, engine="sharded", device="cpu",
                   prefetch_depth=2, r_chunk=128)
    assert out["candidates"] == want.candidate_count
    assert out["theta"] == [float(t) for t in want.theta]
    assert out["engine"]["engine"] == "sharded"
    assert out["engine"]["bytes_to_host"] == want.engine_stats.bytes_to_host
    assert out["recall"] == round(want.recall, 4)


def test_serve_join_on_sharded_matches_reference():
    """``launch.serve_join --engine sharded --r-chunk 128 --prefetch-depth
    2``: a cold, a warm, an append and a delta query, event for event and
    dollar for dollar as the reference's launcher on its sharded engine."""
    from repro.launch._args import engine_opts_from as j_opts
    from repro.launch.serve_join import run_serve as j_run_serve
    from repro_torch.launch._args import engine_opts_from
    from repro_torch.launch.serve_join import run_serve
    script = "query,query,append=5,query"
    got = run_serve("products", engine="sharded", device="cpu", size=0.2,
                    holdout=10, script=script, prefetch_depth=2,
                    engine_opts=engine_opts_from(128))
    want = j_run_serve("products", engine="sharded", size=0.2, holdout=10,
                       script=script, prefetch_depth=2,
                       engine_opts=j_opts(128))

    def events(out):
        return [{k: v for k, v in e.items() if k != "wall_s"}
                for e in out["events"]]
    assert events(got) == events(want)
    assert got["summary"]["service_ledger"] == \
        want["summary"]["service_ledger"]
    assert events(got)[-1]["delta_rows"] == 5
    assert events(got)[1]["bytes_h2d"] == 0
