"""The fleet over a world of two ranks sharing card 0 over gloo: concurrent
mixed cold / warm queries equal a serial run byte for byte, and both equal
the port's CPU world on the same fixture.

These tests need a CUDA device and skip without one.  The file imports
neither jax nor the JAX package, so it runs on a GPU machine that has only
the port's dependencies:

    python -m pytest -q tests/test_torch_fleet_world_cuda.py

Three tenants of police_records (40 incidents, tests/test_fleet.py's
fixture) on engine ``sharded``: on the card with one worker, then three,
and on the CPU with one worker, every rank alike, all in one world; rank 0
orders the admissions and every collective call.  On the card rank 0's
pairs, theta, candidates and per-component dollar sums equal the serial
run's, one plan is built, the store's puts are equal, every rank agrees on
rank 0's order, and kernel A and the compaction ran on both ranks.  Rank
0's card results also equal the CPU world's (which
tests/test_torch_fleet_world.py holds equal to the reference JoinFleet on
the same fixture): theta exactly, and candidates and pairs but for
candidates within the f32 band of a threshold
(``kernels/fused_cnf_join/ref.py`` ``threshold_gap`` / ``dot_error_band``);
the dollars exactly where no candidate differs.
"""

import math

import pytest
import torch

import test_torch_fleet_world as fw
from repro_torch.launch.ep_world import run_world


def _run(m, workers: int, out: dict) -> tuple:
    """The three tenants' two queries each, serially or concurrently; the
    fleet and its rows by tenant."""
    f = fw._fleet(m, workers)
    for name in fw._NAMES:
        f.add_tenant(name, fw._ds(m, n=40), fw._cfg(m))
    if workers == 1:
        res = [(n, f.query(n)) for n in fw._NAMES for _ in range(2)]
    else:
        futs = [(n, f.submit(n)) for _ in range(2) for n in fw._NAMES]
        res = [(n, fut.result(timeout=600)) for n, fut in futs]
    summary = f.drain()
    rows: dict = {}
    for n, r in res:
        row = fw._row(r)
        row["cands"] = sorted(map(tuple, r.join.candidates or []))
        rows.setdefault(n, []).append(row)
    parts = [r["breakdown"] for rs in rows.values() for r in rs]
    run = {"rows": {n: [(r["pairs"], r["theta"], r["candidates"])
                        for r in rs] for n, rs in rows.items()},
           "cands": {n: [r["cands"] for r in rs] for n, rs in rows.items()},
           "dollars": {k: math.fsum(p[k] for p in parts) for k in parts[0]},
           "misses": f.plan_library.misses,
           "puts": f.store.snapshot()["puts"],
           "failed": summary["failed"]}
    fw._close(m, f, out)
    return f, run


def _differ_in_band(f, name: str, got: list, want: list) -> tuple:
    """The candidates of tenant ``name`` that one run has and the other
    lacks, and whether every one lies within the f32 band of a threshold
    of the tenant's plan in fleet ``f``."""
    diff = sorted(set(map(tuple, got)) ^ set(map(tuple, want)))
    if not diff:
        return 0, True
    from repro_torch.core.costs import CostLedger
    from repro_torch.core.join import apply_conjunct_order
    from repro_torch.data.simulated_llm import SimulatedExtractor
    from repro_torch.kernels.fused_cnf_join import ref
    from repro_torch.kernels.fused_cnf_join.ops import pack_features
    svc = f.service(name)
    plan = svc._plans[svc._plan_key(svc.cfg)]
    feats = SimulatedExtractor(svc.dataset, seed=svc.cfg.seed).materialize(
        plan.used_specs, CostLedger())
    clauses, th = apply_conjunct_order(plan.sc_local.clauses, plan.theta,
                                       plan.conjunct_order)
    arrays = pack_features(feats, clauses, tl=8, tr=32)
    args = [torch.from_numpy(x) for x in arrays[:4]]
    gap = ref.threshold_gap(*args, arrays[4], th, [p[0] for p in diff],
                            [p[1] for p in diff])
    return len(diff), bool((gap <= ref.dot_error_band(args[0].shape[2]))
                           .all())


def cuda_job(mesh, device, payload: dict) -> dict:
    """One rank: the serial and the concurrent fleet on the card, then the
    serial fleet on the CPU; rank 0 holds the card runs to the CPU's."""
    import torch.distributed as dist
    out: dict = {"reports": []}
    card = fw._Port("host", str(device))
    for workers in (1, 3):
        _, out[workers] = _run(card, workers, out)
    cpu_fleet, cpu = _run(fw._Port("host", "cpu"), 1, out)
    out["cpu"] = cpu
    if dist.get_rank() == 0:
        out["vs_cpu"] = {
            workers: {n: [_differ_in_band(cpu_fleet, n, got, want)
                          for got, want in zip(out[workers]["cands"][n],
                                               cpu["cands"][n])]
                      for n in fw._NAMES}
            for workers in (1, 3)}
    return out


@pytest.fixture(scope="module")
def world():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ring launches CUDA kernels")
    launches: list = []
    ranks = run_world((2, 1), cuda_job, {}, device="cuda", timeout=600,
                      launches=launches)
    return ranks, launches


def test_world_on_card_concurrent_matches_serial(world):
    ranks, _ = world
    serial, conc = ranks[0][1], ranks[0][3]
    assert conc["rows"] == serial["rows"]
    assert conc["dollars"] == serial["dollars"]
    assert conc["misses"] == serial["misses"] == 1
    assert conc["puts"] == serial["puts"]
    assert conc["failed"] == serial["failed"] == 0
    assert all(p for rs in conc["rows"].values() for p, _t, _c in rs)


def test_world_on_card_ranks_agree_and_launch(world):
    ranks, launches = world
    for r in ranks:
        assert len(r["reports"]) == 3
        assert all(rep["ranks_agree"] for rep in r["reports"])
    assert ranks[1][3]["rows"]["a"][0][0] == []      # pairs went to rank 0
    for counts in launches:
        assert counts["cnf_join"] > 0 and counts["compact"] > 0


def test_world_on_card_matches_the_cpu_world(world):
    ranks, _ = world
    cpu = ranks[0]["cpu"]
    assert cpu["misses"] == 1 and cpu["failed"] == 0
    for workers in (1, 3):
        card = ranks[0][workers]
        for n in fw._NAMES:
            for (pairs, theta, count), (cpu_pairs, cpu_theta, cpu_count), \
                    cands, cpu_cands, (differ, in_band) in zip(
                        card["rows"][n], cpu["rows"][n], card["cands"][n],
                        cpu["cands"][n], ranks[0]["vs_cpu"][workers][n]):
                assert theta == cpu_theta
                assert in_band, f"{n}: candidates differ outside the band"
                assert count == len(cands) and cpu_count == len(cpu_cands)
                moved = set(map(tuple, cands)) ^ set(map(tuple, cpu_cands))
                assert len(moved) == differ
                # a pair is a candidate the oracle accepts: pairs differ
                # only in candidates that differ
                assert set(map(tuple, pairs)) ^ set(map(tuple, cpu_pairs)) \
                    <= moved
        if not any(d for rs in ranks[0]["vs_cpu"][workers].values()
                   for d, _ in rs):
            assert card["dollars"] == cpu["dollars"]
