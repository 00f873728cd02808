"""The paper's headline guarantee on the port: over repeated seeded runs,
``repro_torch``'s ``fdj_join`` achieves recall >= recall_target with
failure rate <= δ (Thm — recall w.h.p.), in barrier and streaming
refinement, and after distribution-shifting appends through the serving
path.

Ports tests/test_guarantees.py.  The 5-trial smoke (alternating modes)
runs the port and the reference on the same seeds: every trial's recall,
candidate count and ledger dollars must equal the reference's, on each of
the port's engines (``device="cpu"``), and at most one trial may miss the
target.  The sweeps keep the reference's bound (failure rate <= δ + 2σ
binomial slack, mean recall >= T) and its ``slow`` marker; they run the
port's main engine, ``cuda``, here on the CPU (its kernels' plain
versions).  ``chip_smoke.py`` phase 12 (b) runs the barrier sweep on the
card.
"""

import math

import numpy as np
import pytest

from repro_torch.core.join import FDJConfig, fdj_join
from repro_torch.data import synth
from repro_torch.data.simulated_llm import SimulatedExtractor, SimulatedProposer
from repro_torch.engine import ENGINES

TARGET, DELTA = 0.9, 0.1

_DATASETS = {
    "biodex": lambda mod, seed: mod.biodex(n_notes=150, n_terms=40,
                                           seed=seed),
    "police": lambda mod, seed: mod.police_records(
        n_incidents=35, reports_per_incident=2, seed=seed),
}


def _trial(name: str, seed: int, stream: bool, engine: str = "cuda"):
    ds = _DATASETS[name](synth, seed)
    cfg = FDJConfig(recall_target=TARGET, delta=DELTA, seed=seed,
                    mc_trials=5000, stream_refinement=stream, engine=engine,
                    device="cpu")
    return fdj_join(ds, ds.make_oracle(), SimulatedProposer(ds),
                    SimulatedExtractor(ds, seed=seed), cfg)


def _reference_trial(name: str, seed: int, stream: bool):
    from repro.core.join import FDJConfig as JCfg, fdj_join as j_fdj_join
    from repro.data import synth as j_synth
    from repro.data.simulated_llm import (SimulatedExtractor as JExtractor,
                                          SimulatedProposer as JProposer)
    ds = _DATASETS[name](j_synth, seed)
    cfg = JCfg(recall_target=TARGET, delta=DELTA, seed=seed,
               mc_trials=5000, stream_refinement=stream)
    return j_fdj_join(ds, ds.make_oracle(), JProposer(ds),
                      JExtractor(ds, seed=seed), cfg)


def _check_rate(recalls: list, what: str) -> None:
    trials = len(recalls)
    assert trials >= 50
    fails = sum(r < TARGET for r in recalls)
    slack = 2.0 * math.sqrt(DELTA * (1.0 - DELTA) / trials)
    assert fails / trials <= DELTA + slack, (
        f"{what} failure rate {fails}/{trials} exceeds δ={DELTA} "
        f"(+{slack:.3f} slack)")
    assert float(np.mean(recalls)) >= TARGET


@pytest.fixture(scope="module")
def reference_smoke():
    return [_reference_trial("biodex", seed, bool(seed % 2))
            for seed in range(5)]


@pytest.mark.parametrize("engine", ENGINES)
def test_recall_guarantee_smoke(engine, reference_smoke):
    """5 trials alternating barrier/stream, each equal to the reference's
    trial on the same seed; at δ=0.1, more than one failure among five
    would put the guarantee far outside its budget."""
    fails = 0
    for seed, want in enumerate(reference_smoke):
        got = _trial("biodex", seed, stream=bool(seed % 2), engine=engine)
        assert got.recall == want.recall, seed
        assert got.candidate_count == want.candidate_count, seed
        assert got.cost.breakdown() == want.cost.breakdown(), seed
        fails += int(got.recall < TARGET)
    assert fails <= 1, f"{fails}/5 trials missed recall target {TARGET}"


@pytest.mark.slow
@pytest.mark.parametrize("stream", [False, True], ids=["barrier", "stream"])
def test_recall_guarantee_sweep(stream):
    """≥50 trials across two dataset families: observed failure rate must
    stay within δ plus two-sigma binomial slack, and mean recall >= T."""
    recalls = [_trial(name, seed, stream).recall
               for name in _DATASETS for seed in range(25)]
    _check_rate(recalls, "barrier" if not stream else "stream")


_SERVE_DATASETS = {
    "movies": lambda seed: synth.movies_pages(
        n_movies=25, cast_size=4, filler_sentences=1, seed=seed),
    "police": lambda seed: synth.police_records(
        n_incidents=30, reports_per_incident=2, seed=seed),
}


def _serving_trial(mk_ds, seed: int) -> float:
    """Cold query -> distribution-shifting append -> recalibrated query:
    the recall the *served* (recalibrated) path actually delivers."""
    from repro_torch.serving.join_service import (JoinService,
                                                  hold_out_right,
                                                  perturb_rows)
    ds = mk_ds(seed)
    base, delta = hold_out_right(ds, max(ds.n_r // 4, 1))
    cfg = FDJConfig(recall_target=TARGET, delta=DELTA, seed=seed,
                    mc_trials=5000, device="cpu")
    svc = JoinService(base, cfg)
    svc.query()
    svc.append_right(perturb_rows(delta, seed=seed))
    return svc.query().join.recall


@pytest.mark.slow
def test_recall_guarantee_survives_shifted_appends():
    """≥50 serving trials with a scripted distribution-shifting append
    between the cold and the recalibrated query: observed failure rate of
    the *post-shift* query must stay within δ plus two-sigma binomial
    slack — recall as a serving-time invariant, not just a plan-time one."""
    recalls = [_serving_trial(mk, seed)
               for mk in _SERVE_DATASETS.values() for seed in range(25)]
    _check_rate(recalls, "post-shift")
