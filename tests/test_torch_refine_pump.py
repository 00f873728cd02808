"""The port's RefinementPump unit tests + streaming/barrier fdj_join
parity.

Ports the 12 tests of tests/test_refine_pump.py that
tests/test_torch_precision.py does not already cover (that file holds
the Appx-C stream parity).  The pump must batch oracle calls, bound its
queue, block its producer without busy-waiting, surface worker and
engine failures and count the chunks a dead worker drops;
``fdj_join(stream_refinement=True)`` must return identical pairs, recall,
candidate counts and ledger totals to barrier mode on every engine of the
port (``device="cpu"``), the barrier run equal to the reference's, and in
the degenerate empty-scaffold (refine-everything) case.  Every wait a
test bounds has a timeout of its own.
"""

import threading
import time

import pytest

from repro_torch.core.costs import CostLedger
from repro_torch.core.join import FDJConfig, fdj_join
from repro_torch.core.refine import RefinementPump
from repro_torch.core.scaffold import Scaffold
from repro_torch.data import synth
from repro_torch.data.simulated_llm import SimulatedExtractor, SimulatedProposer
from repro_torch.engine import ENGINES
from repro_torch.engine.base import CandidateChunk, EngineStats


def _chunks(groups, engine="scripted"):
    out = []
    for i, g in enumerate(groups):
        stats = EngineStats(engine, n_l=10, n_r=10, n_candidates=len(g),
                            wall_s=0.001, bytes_to_host=8 * len(g))
        out.append(CandidateChunk(sorted(g), stats, i))
    return out


def _no_pump_thread():
    return not any(t.name == "refine-pump" for t in threading.enumerate())


# --- pump units -------------------------------------------------------------

def test_pump_batches_and_accepts():
    calls = []

    def refine(batch):
        calls.append(list(batch))
        return {p for p in batch if p[0] % 2 == 0}   # accept even rows

    pump = RefinementPump(refine, batch_pairs=4, max_queue_chunks=2)
    groups = [[(i, j) for j in range(3)] for i in range(5)]
    res = pump.run(iter(_chunks(groups)))
    flat = [p for g in groups for p in sorted(g)]
    assert res.pairs == {p for p in flat if p[0] % 2 == 0}
    assert res.candidates == sorted(flat)
    # every batch except the final flush is exactly batch_pairs
    assert all(len(b) == 4 for b in calls[:-1]) and len(calls[-1]) <= 4
    assert [p for b in calls for p in b] == flat     # arrival order preserved
    assert res.stats.chunks == 5 and res.stats.batches == len(calls)
    assert res.engine_stats.n_candidates == len(flat)
    assert res.engine_stats.bytes_to_host == 8 * len(flat)


def test_pump_final_mode_runs_once_on_sorted_union():
    seen = []

    def final(cands):
        seen.append(list(cands))
        return set(cands[:2])

    pump = RefinementPump(final=final)
    res = pump.run(iter(_chunks([[(3, 0), (1, 0)], [(2, 0)]])))
    assert seen == [[(1, 0), (2, 0), (3, 0)]]        # one call, sorted union
    assert res.pairs == {(1, 0), (2, 0)}


def test_pump_requires_exactly_one_mode():
    with pytest.raises(ValueError):
        RefinementPump()
    with pytest.raises(ValueError):
        RefinementPump(lambda b: set(), final=lambda c: set())


def test_pump_worker_failure_propagates():
    def refine(batch):
        raise RuntimeError("oracle down")

    pump = RefinementPump(refine, batch_pairs=2, max_queue_chunks=1)
    with pytest.raises(RuntimeError, match="oracle down"):
        pump.run(iter(_chunks([[(0, 0), (0, 1)], [(1, 0)], [(2, 0)]])))
    assert _no_pump_thread()


def test_pump_worker_failure_counts_dropped_chunks():
    """A dead worker's failure handler keeps draining the queue (so the
    producer's blocking put can never hang on a full queue) and counts
    every chunk it throws away instead of discarding it silently."""
    all_put = threading.Event()

    def refine(batch):
        # die only after the producer has queued everything: the handler
        # must then drain a deterministic 5 chunks in sink mode
        all_put.wait(5.0)
        raise RuntimeError("oracle down")

    groups = [[(i, 0)] for i in range(6)]

    def stream():
        for ch in _chunks(groups):
            yield ch
        all_put.set()                    # set on the post-last-put next()

    pump = RefinementPump(refine, batch_pairs=1, max_queue_chunks=len(groups))
    with pytest.raises(RuntimeError, match="oracle down"):
        pump.run(stream())
    assert pump.last_stats.chunks_dropped == len(groups) - 1
    assert _no_pump_thread()


def test_pump_put_blocks_without_busy_wait():
    """The producer's put is a plain blocking put: while backpressured by
    a stalled worker, no producer wall accrues to step2_wall."""
    release = threading.Event()

    def refine(batch):
        release.wait(5.0)
        return set(batch)

    def stream():
        for ch in _chunks([[(i, 0)] for i in range(6)]):
            yield ch                     # instant production

    pump = RefinementPump(refine, batch_pairs=1, max_queue_chunks=1)
    out = {}
    t = threading.Thread(target=lambda: out.setdefault(
        "res", pump.run(stream())))
    t.start()
    time.sleep(0.3)                      # producer sits blocked in q.put
    release.set()
    t.join(5.0)
    assert not t.is_alive()
    res = out["res"]
    assert res.pairs == {(i, 0) for i in range(6)}
    assert res.stats.chunks_dropped == 0
    # the ~0.3 s spent blocked in put() is not engine time
    assert res.stats.step2_wall < 0.05


def test_pump_engine_failure_shuts_worker_down():
    """A stream that raises mid-sweep must not leak the worker thread."""
    def refine(batch):
        return set(batch)

    def stream():
        yield _chunks([[(0, 0)]])[0]
        raise RuntimeError("engine died")

    pump = RefinementPump(refine, batch_pairs=1, max_queue_chunks=1)
    with pytest.raises(RuntimeError, match="engine died"):
        pump.run(stream())
    assert _no_pump_thread()


@pytest.mark.parametrize("engine", ENGINES)
def test_stream_validation_fails_at_call_site(engine):
    """evaluate_stream must validate eagerly, not at the first next()."""
    from repro_torch.data.cnf_fixtures import representative_cnf
    from repro_torch.engine import get_engine
    ds = synth.police_records(n_incidents=10, reports_per_incident=2)
    specs, clauses, _ = representative_cnf(ds)
    feats = SimulatedExtractor(ds).materialize(specs, CostLedger())
    eng = get_engine(engine, **({} if engine == "numpy" else
                                {"device": "cpu"}))
    with pytest.raises(ValueError, match="thresholds"):
        eng.evaluate_stream(feats, clauses, [0.5])


def test_pump_overlaps_slow_refinement_with_production():
    """With a slow oracle and slow producer, total << step2 + refine."""
    def refine(batch):
        time.sleep(0.04)
        return set(batch)

    def slow_stream():
        for ch in _chunks([[(i, 0), (i, 1)] for i in range(5)]):
            time.sleep(0.04)                          # engine production
            yield ch

    pump = RefinementPump(refine, batch_pairs=2, max_queue_chunks=2)
    res = pump.run(slow_stream())
    assert res.stats.step2_wall >= 0.15
    assert res.stats.refine_wall >= 0.15
    assert res.stats.overlap_wall > 0.05              # genuinely pipelined
    assert res.stats.total_wall < (res.stats.step2_wall
                                   + res.stats.refine_wall - 0.05)


def test_pump_bounded_queue_backpressures_producer():
    """A stalled worker must stop the producer after max_queue chunks."""
    release = threading.Event()
    produced = []

    def refine(batch):
        release.wait(5.0)
        return set(batch)

    def stream():
        for ch in _chunks([[(i, 0)] for i in range(8)]):
            produced.append(ch.index)
            yield ch

    pump = RefinementPump(refine, batch_pairs=1, max_queue_chunks=2)
    out = {}
    t = threading.Thread(target=lambda: out.setdefault(
        "res", pump.run(stream())))
    t.start()
    time.sleep(0.3)
    # worker holds chunk 0; queue holds 2; producer blocked on the next put:
    # far fewer than all 8 chunks may have been pulled from the stream
    assert len(produced) <= 5
    release.set()
    t.join(5.0)
    assert not t.is_alive()
    assert out["res"].pairs == {(i, 0) for i in range(8)}


# --- fdj_join parity --------------------------------------------------------

_OPTS = {"numpy": {}, "cuda": dict(tl=32, tr=64, l_block=32),
         "sharded": dict(tl=32, tr=32, r_chunk=64)}


def _run_join(stream, *, precision_target=1.0, engine="numpy", seed=3):
    ds = synth.police_records(n_incidents=30, reports_per_incident=2,
                              seed=seed)
    oracle = ds.make_oracle()
    cfg = FDJConfig(engine=engine, stream_refinement=stream, seed=seed,
                    precision_target=precision_target, refine_batch_pairs=32,
                    pump_queue_chunks=2, block=32, device="cpu",
                    engine_opts=_OPTS[engine])
    return fdj_join(ds, oracle, SimulatedProposer(ds),
                    SimulatedExtractor(ds, seed=seed), cfg)


def _run_reference_join(seed=3):
    from repro.core.join import FDJConfig as JCfg, fdj_join as j_fdj_join
    from repro.data import synth as j_synth
    from repro.data.simulated_llm import (SimulatedExtractor as JExtractor,
                                          SimulatedProposer as JProposer)
    ds = j_synth.police_records(n_incidents=30, reports_per_incident=2,
                                seed=seed)
    cfg = JCfg(engine="numpy", seed=seed, refine_batch_pairs=32,
               pump_queue_chunks=2, block=32)
    return j_fdj_join(ds, ds.make_oracle(), JProposer(ds),
                      JExtractor(ds, seed=seed), cfg)


def _assert_join_parity(a, b):
    assert a.pairs == b.pairs
    assert a.recall == b.recall and a.precision == b.precision
    assert a.candidate_count == b.candidate_count
    assert a.met_target == b.met_target
    # per-pair charges are additive, so totals agree up to float-sum order
    for k, v in a.cost.breakdown().items():
        assert b.cost.breakdown()[k] == pytest.approx(v, rel=1e-9, abs=1e-12)


@pytest.mark.parametrize("engine", ENGINES)
def test_join_stream_parity(engine):
    a = _run_join(False, engine=engine)
    b = _run_join(True, engine=engine)
    _assert_join_parity(a, b)
    assert b.cost.step2_wall > 0                      # pump recorded walls
    assert a.cost.overlap_wall == 0.0                 # barrier: no overlap
    _assert_join_parity(a, _run_reference_join())


def test_join_stream_parity_degenerate_empty_scaffold(monkeypatch):
    """No useful featurization -> refine-everything fallback, both modes."""
    from repro_torch.core import scaffold as scaffold_lib

    monkeypatch.setattr(scaffold_lib, "get_logical_scaffold",
                        lambda *a, **k: Scaffold(clauses=[]))
    a = _run_join(False)
    b = _run_join(True)
    _assert_join_parity(a, b)
    assert a.candidate_count == 60 * 60               # every pair refined
    assert a.engine_stats is None and b.engine_stats is None
