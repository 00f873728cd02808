"""Multi-pod join dry-run: the ring engine L-sharded over a world of
P·D·M ranks.

Spawns the world itself (``torch.multiprocessing``, spawn context; one
process a rank, ``gloo`` rendezvous through a file in a fresh temporary
directory) and runs, on a ``(pod, data, model)`` join mesh of those ranks,
the JAX package's dry-run checks (``repro.launch.multipod_dryrun``):

  * **parity**   — the sharded ring's candidates ≡ the numpy engine's on a
    ragged corpus, the depth-4 ring reporting nonzero overlap on the
    multi-step sweep, and ``bytes_to_host`` exactly 12 B a rank a step + 8 B
    a pair; plus the capacity-1 fixture (every step overflows; the ≥4×
    per-shard retry must recover the full cross product without mutating
    the configured capacity);
  * **stream**   — per-step chunks are disjoint and their union ≡ batch;
  * **serving**  — a ``JoinService`` over a mesh-attached
    ``FeaturePlaneStore``: the warm query charges $0 extraction, moves 0
    plane bytes to the device and reports 0 reshard bytes (a cold query on
    a world > 1 reports > 0); the delta query evaluates only L × ΔR;
  * **collectives** (in place of the reference's compiled-program check) —
    every rank's ledger of ``torch.distributed`` calls
    (``distributed.collectives``): at least one cross-pod call on a mesh of
    more than one pod, every cross-pod call one int32 a rank, candidate
    pairs only over the pull group, no plane or mask bytes anywhere;
  * **cell** (``--cell N``) — the production cell of
    ``launch.join.build_join_cell`` at N x N (262144 is the production
    plane): seeded unit vectors on each rank's device, pinned in a store,
    run through the ring at ``--cell-r-chunk``, with the rank's L shard
    shaped as the cell says, each kernel launched once a band step (on
    CUDA), and
    ``bytes_to_host`` exactly 12 B a rank a step + 8 B a pair.

Every rank runs on ``cuda:0`` by default (several ranks may share one
card: the collectives are gloo's, on the host) and the kernels run; asking
for ``cuda`` without a card raises.  ``--device cpu`` runs every rank on
the CPU (the kernels' plain versions).

Usage:

  PYTHONPATH=src python -m repro_torch.launch.multipod_dryrun --mesh 2,1,1 \\
      --cell 262144
  PYTHONPATH=src python -m repro_torch.launch.multipod_dryrun --mesh 2,2,2 \\
      --device cpu

Prints one JSON report on stdout (marker line ``MULTIPOD_DRYRUN_JSON``,
see ``launch/dryrun_client.py``); exits nonzero on any failed check, or
when a rank fails or the world outlives ``--timeout``.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback

from repro_torch.launch.dryrun_client import MARKER

# the reference dry-run's tiles: the smallest L shard and the per-model
# sub-band are whole tiles on any mesh; tr is the 32-bit packed word
TL, TR = 8, 32


def _require(cond, msg: str) -> None:
    """A check of the dry-run (``assert`` would vanish under ``-O``)."""
    if not cond:
        raise AssertionError(msg)


def _opts(mesh, a, **extra) -> dict:
    return dict(mesh=mesh, tl=TL, tr=TR, r_chunk=TR * mesh.shape["model"],
                use_kernel=a["kernel"] or a["device"] == "cuda",
                device=a["device"], **extra)


def _chunk_rows(chunks) -> list:
    return [[ch.index, [list(p) for p in ch.candidates],
             ch.stats.n_candidates, ch.stats.bytes_to_host,
             ch.stats.bytes_h2d, ch.stats.bytes_reshard,
             ch.stats.conjunct_evals] for ch in chunks]


def _stream(eng, feats, clauses, thetas) -> tuple:
    """(chunks, overflow retries) of one traced evaluation."""
    from repro_torch.obs import Tracer, use_tracer
    tracer = Tracer()
    with use_tracer(tracer):
        chunks = list(eng.evaluate_stream(feats, clauses, thetas))
    retries = sum(e.name == "overflow" for sp in tracer.spans()
                  for e in sp.events)
    return chunks, retries


def _check_parity(mesh, rep: dict, a: dict) -> None:
    from repro_torch.core.costs import CostLedger
    from repro_torch.core.featurize import FeaturizationSpec, vectorize
    from repro_torch.data import synth
    from repro_torch.data.cnf_fixtures import representative_cnf
    from repro_torch.data.simulated_llm import SimulatedExtractor
    from repro_torch.engine import get_engine
    from repro_torch.engine.base import EngineStats

    opts = _opts(mesh, a)
    r_chunk = opts["r_chunk"]
    # corpus sized so the R sweep takes >= 2 stream steps on this mesh
    n_inc = max(37, r_chunk // 2 + 1)
    ds = synth.police_records(n_incidents=n_inc, reports_per_incident=2,
                              seed=5)
    specs, clauses, thetas = representative_cnf(ds)
    feats = SimulatedExtractor(ds).materialize(specs, CostLedger())
    oracle = get_engine("numpy", block=256).evaluate(feats, clauses, thetas)
    # every evaluation runs on every rank before anything is asserted: a
    # rank that stopped early would leave the others in a collective
    eng = get_engine("sharded", prefetch_depth=4, **opts)
    chunks, retries = _stream(eng, feats, clauses, thetas)
    batch_caps = eng.last_sweep_caps.tolist()
    stream = list(get_engine("sharded", **opts).evaluate_stream(
        feats, clauses, thetas))
    n = 33
    spec = FeaturizationSpec("name", "", "word_overlap", "llm", "name")
    dense = [vectorize(spec, ["same text"] * n, ["same text"] * n)]
    eng1 = get_engine("sharded", **_opts(mesh, a, capacity=1))
    chunks1, retries1 = _stream(eng1, dense, [[0]], [0.5])

    _require(eng1.capacity == 1 and eng1.last_sweep_capacity >= 4, (
        f"overflow: final capacity {eng1.last_sweep_capacity}, configured "
        f"{eng1.capacity} (want >= 4 and 1)"))
    s = EngineStats.merged([ch.stats for ch in chunks])
    cands = sorted(p for ch in chunks for p in ch.candidates)
    n_steps = -(-s.n_r // r_chunk) if chunks else 0
    rep["parity"] = {
        "n_l": s.n_l, "n_r": s.n_r, "candidates": len(cands),
        "bytes_to_host": s.bytes_to_host, "bytes_h2d": s.bytes_h2d,
        "bytes_reshard": s.bytes_reshard, "plane_bytes": s.plane_bytes,
        "steps": n_steps, "retries": retries,
        "dispatch_wall_s": round(s.dispatch_wall_s, 4),
        "pull_wall_s": round(s.pull_wall_s, 4),
        "overlap_s": round(s.overlap_s, 4),
        "prefetch_depth": eng.effective_prefetch_depth,
        "conjunct_evals": s.conjunct_evals, "last_sweep_caps": batch_caps}
    rep["stream"] = {"chunks": len(stream)}
    rep["overflow"] = {"candidates": sum(len(c.candidates) for c in chunks1),
                       "final_capacity": eng1.last_sweep_capacity,
                       "retries": retries1,
                       "last_sweep_caps": eng1.last_sweep_caps.tolist()}
    if a["detail"]:
        rep["parity"]["chunks"] = _chunk_rows(chunks)
        rep["overflow"]["chunks"] = _chunk_rows(chunks1)
    if not mesh.is_coordinator:
        _require(not chunks and not stream and not chunks1,
                 "a rank other than the coordinator yielded chunks")
        return
    _require(cands == oracle.candidates, (
        f"mesh candidates diverge from numpy: {len(cands)} vs "
        f"{len(oracle.candidates)}"))
    _require(cands, "degenerate parity corpus")
    _require(n_steps >= 2 and s.overlap_s > 0, (
        f"depth-4 ring over {n_steps} steps reported overlap "
        f"{s.overlap_s}: the pipeline degraded to the serial loop"))
    _require(s.conjunct_evals > 0, "conjunct-eval accounting missing")
    want = 12 * mesh.size * n_steps + 8 * len(cands)
    _require(retries or s.bytes_to_host == want, (
        f"bytes_to_host {s.bytes_to_host}, want 12 B a rank a step + 8 B a "
        f"pair = {want}"))
    union = [p for ch in stream for p in ch.candidates]
    _require(len(union) == len(set(union)), "stream chunks overlap")
    _require(sorted(union) == oracle.candidates, "stream union != batch")
    for ch in stream:
        _require(ch.candidates == sorted(ch.candidates), "chunk not sorted")
    got1 = sorted(p for ch in chunks1 for p in ch.candidates)
    _require(got1 == [(i, j) for i in range(n) for j in range(n)],
             "overflow retry truncated candidates")
    _require(retries1 >= 1, "the capacity-1 fixture never overflowed")


def _check_serving(mesh, rep: dict, a: dict) -> None:
    from repro_torch.core.join import FDJConfig
    from repro_torch.data import synth
    from repro_torch.serving.join_service import JoinService, hold_out_right
    from repro_torch.serving.planes import FeaturePlaneStore

    # movies: embed-only planes keep the append on the incremental path
    ds = synth.movies_pages(n_movies=24, cast_size=4, filler_sentences=1,
                            seed=0)
    base, delta_rows = hold_out_right(ds, n_delta=ds.n_r // 5)
    opts = _opts(mesh, a)
    device = opts.pop("device")
    cfg = FDJConfig(engine="sharded", seed=0, mc_trials=4000, device=device,
                    engine_opts=opts)
    svc = JoinService(base, cfg, store=FeaturePlaneStore(device=device,
                                                         mesh=mesh))
    cold = svc.query()
    warm = svc.query()
    svc.append_right(delta_rows)
    dq = svc.query()
    rep["serving"] = {
        "cold_reshard_bytes": cold.cost.bytes_reshard,
        "warm_reshard_bytes": warm.cost.bytes_reshard,
        "warm_h2d_bytes": warm.cost.bytes_h2d,
        "warm_extraction_cost": warm.cost.inference,
        "delta_rows": dq.delta_rows,
        "cold_wall_s": round(cold.wall_s, 3),
        "warm_wall_s": round(warm.wall_s, 3),
    }
    _require(warm.cost.inference == 0.0, (
        f"warm query charged ${warm.cost.inference} extraction"))
    _require(warm.cost.bytes_h2d == 0, (
        f"warm query moved {warm.cost.bytes_h2d} plane bytes to the device"))
    _require(warm.cost.bytes_reshard == 0, (
        f"warm query paid {warm.cost.bytes_reshard} reshard bytes: the "
        f"mesh layout was not memoized"))
    _require(dq.delta_rows == len(delta_rows.texts),
             "delta query re-evaluated the full corpus")
    if mesh.is_coordinator:
        _require(warm.pairs == cold.pairs, "warm pairs diverge from cold")
        _require((cold.cost.bytes_reshard > 0) == (mesh.size > 1), (
            f"cold reshard {cold.cost.bytes_reshard} B on a world of "
            f"{mesh.size}"))


def _check_cell(mesh, rep: dict, a: dict) -> None:
    """The production cell at ``a["cell"]`` rows a side through the ring
    from a plane store on this rank's device."""
    import torch
    from repro_torch.core.costs import CostLedger
    from repro_torch.core.featurize import FeaturizationSpec
    from repro_torch.engine import get_engine
    from repro_torch.kernels.extract import kernel as ek
    from repro_torch.kernels.fused_cnf_join import kernel as ck
    from repro_torch.launch.join import build_join_cell
    from repro_torch.serving.planes import FeaturePlaneStore

    step, (a_l, a_r) = build_join_cell(mesh, n_l=a["cell"], n_r=a["cell"])
    fv, rows_l, d = a_l.shape
    n_l = rows_l * (mesh.size // mesh.shape["model"])
    n_r = a_r.shape[1] * mesh.shape["model"]
    dev = torch.device(a["device"])
    g = torch.Generator(device=dev).manual_seed(0)
    emb_l = torch.randn((fv, n_l, d), generator=g, device=dev)
    emb_r = torch.randn((fv, n_r, d), generator=g, device=dev)
    emb_l /= emb_l.norm(dim=-1, keepdim=True)
    emb_r /= emb_r.norm(dim=-1, keepdim=True)
    specs = [FeaturizationSpec(f"f{f}", "", "semantic", "code", f"f{f}")
             for f in range(fv)]
    store = FeaturePlaneStore(device=dev, mesh=mesh)
    for f, spec in enumerate(specs):
        for side, emb in (("l", emb_l), ("r", emb_r)):
            store.put(spec, side, "cell", [], emb[f].cpu().numpy(), "embed",
                      1.0, device=emb[f])
    planes = store.provide(specs, None, CostLedger(), fp_l="cell",
                           fp_r="cell")
    scaffold = [[f] for f in range(len(step.clauses))]
    r_chunk = a["cell_r_chunk"] * mesh.shape["model"]
    eng = get_engine("sharded", mesh=mesh, r_chunk=r_chunk,
                     device=a["device"])
    ck.launches["cnf_join"] = 0
    ek.launches["compact"] = 0
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    res = eng.evaluate(planes, scaffold, step.thetas)
    sync()
    wall = time.perf_counter() - t0
    launches = {"cnf_join": ck.launches["cnf_join"],
                "compact": ek.launches["compact"]}
    shard = next(v for k, v in planes.pack_cache.items() if k[0] == "mesh")
    steps = n_r // r_chunk
    s = res.stats
    rep["cell"] = {
        "n": a["cell"], "r_chunk": r_chunk, "steps": steps,
        "candidates": s.n_candidates, "bytes_to_host": s.bytes_to_host,
        "bytes_reshard": s.bytes_reshard, "wall_s": wall,
        "dispatch_wall_s": s.dispatch_wall_s, "pull_wall_s": s.pull_wall_s,
        "overlap_s": s.overlap_s, "conjunct_evals": s.conjunct_evals,
        "shard_rows": shard[0].shape[1], "cell_shard": list(a_l.shape),
        "launches": launches}
    _require(shard[0].shape[1] == rows_l and shard[0].shape[2] == d, (
        f"rank's L shard {tuple(shard[0].shape)} is not the cell's "
        f"{tuple(a_l.shape)}"))
    # kernels launch on CUDA only (their plain versions count nothing)
    _require(dev.type != "cuda"
             or launches["cnf_join"] == launches["compact"] == steps,
             f"cell launches {launches} over {steps} band steps")
    if mesh.is_coordinator:
        want = 12 * mesh.size * steps + 8 * s.n_candidates
        _require(s.bytes_to_host == want, (
            f"cell bytes_to_host {s.bytes_to_host}, want {want}"))


def _rank_main(rank: int, world: int, init_file: str, a: dict, out) -> None:
    """One rank of the world: join it, run the checks on the mesh, and put
    (rank, report, failed check names) on ``out``."""
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    rep, failed = {}, []
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{init_file}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=a["group_timeout"]))
        if a["device"] == "cuda":
            torch.cuda.set_device(0)
        from repro_torch.distributed.mesh import make_join_mesh
        from repro_torch.kernels.extract import kernel as ek
        from repro_torch.kernels.fused_cnf_join import kernel as ck
        from repro_torch.kernels.threshold_sweep import kernel as sk
        mesh = make_join_mesh(*a["mesh"])
        rep["coords"] = mesh.coords
        checks = [("parity", _check_parity)]
        if not a["skip_serving"]:
            checks.append(("serving", _check_serving))
        if a["cell"]:
            checks.append(("cell", _check_cell))
        for name, check in checks:
            try:
                check(mesh, rep, a)
            except Exception as e:
                failed.append(name)
                rep[name] = {"error": f"{type(e).__name__}: {e}",
                             "traceback": traceback.format_exc()}
        rep["launches"] = {"cnf_join": ck.launches["cnf_join"],
                           "compact": ek.launches["compact"],
                           **sk.launches}
        rep["ledger"] = mesh.ledger.summary()
        dist.barrier()
        dist.destroy_process_group()
    except Exception as e:
        failed.append("world")
        rep["world"] = {"error": f"{type(e).__name__}: {e}",
                        "traceback": traceback.format_exc()}
    out.put((rank, rep, failed))


def _collectives(ranks: list) -> dict:
    """The invariant over every rank's ledger."""
    from repro_torch.distributed.collectives import (GROUP_KINDS,
                                                     check_counts_only)
    ledgers = [r["ledger"] for r in ranks]
    findings = [f"rank {i}: {f}" for i, led in enumerate(ledgers)
                for f in check_counts_only(led)]
    by_group = {k: sum(led["by_group"][k]["bytes"] for led in ledgers)
                for k in GROUP_KINDS}
    by_payload = {}
    for led in ledgers:
        for p, b in led["by_payload"].items():
            by_payload[p] = by_payload.get(p, 0) + b
    return {
        "cross_pod_calls": ledgers[0]["cross_pod_calls"],
        "max_cross_call_bytes": max(led["max_cross_call_bytes"]
                                    for led in ledgers),
        "cross_call_budget_bytes": ledgers[0]["cross_call_budget_bytes"],
        "bytes_by_group": by_group, "bytes_by_payload": by_payload,
        "calls_by_group": {k: ledgers[0]["by_group"][k]["calls"]
                           for k in GROUP_KINDS},
        "plane_mask_bytes": sum(b for p, b in by_payload.items()
                                if p not in ("counts", "pairs")),
        "ops": ledgers[0]["ops"], "findings": findings}


def run_world(shape: tuple, *, device: str = "cuda", kernel: bool = False,
              skip_serving: bool = False, cell: int = 0,
              cell_r_chunk: int = 4096, detail: bool = False,
              timeout: float = 300.0) -> dict:
    """Spawn the P·D·M-rank world, run the checks, and return the report
    (``status`` "ok" or "failed").  Raises when ``device`` is "cuda" and
    torch sees no card."""
    import torch.multiprocessing as mp
    from repro_torch.device import resolve_device
    resolve_device(device)
    n = shape[0] * shape[1] * shape[2]
    a = dict(mesh=tuple(shape), device=device, kernel=kernel,
             skip_serving=skip_serving, cell=cell, cell_r_chunk=cell_r_chunk,
             detail=detail,
             group_timeout=max(10, min(120, int(timeout) - 10)))
    t0 = time.time()
    tmp = tempfile.mkdtemp(prefix="fdj_world_")
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n, os.path.join(tmp, "rendezvous"), a, out))
             for r in range(n)]
    for p in procs:
        p.start()
    got = {}
    try:
        while len(got) < n:
            left = timeout - (time.time() - t0)
            try:
                r, rep_r, failed_r = out.get(timeout=max(left, 0.1))
            except queue_mod.Empty:
                break
            got[r] = (rep_r, failed_r)
        for p in procs:
            p.join(timeout=max(1.0, timeout - (time.time() - t0)))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    rep = {"mesh": list(shape), "devices": n, "device": device,
           "use_kernel": bool(kernel or device == "cuda"), "status": "ok"}
    failed = sorted({f for _, fr in got.values() for f in fr})
    missing = [r for r in range(n) if r not in got]
    if missing:
        failed.append(f"ranks {missing} reported nothing within "
                      f"{timeout:.0f} s")
    if 0 in got:
        rep0 = got[0][0]
        for key in ("parity", "stream", "overflow", "serving", "cell",
                    "world"):
            if key in rep0:
                rep[key] = rep0[key]
    if not missing:
        ranks = [got[r][0] for r in range(n)]
        rep["ranks"] = [{"rank": r, "coords": ranks[r].get("coords"),
                         "launches": ranks[r].get("launches"),
                         "cell_wall_s": ranks[r].get("cell", {}).get("wall_s"),
                         "failed": got[r][1],
                         "errors": {k: ranks[r][k]["error"]
                                    for k in got[r][1] if k in ranks[r]}}
                        for r in range(n)]
        if all("ledger" in rr for rr in ranks):
            rep["collectives"] = c = _collectives(ranks)
            if c["findings"] or c["plane_mask_bytes"] or (
                    shape[0] > 1 and c["cross_pod_calls"] < 1) or (
                    shape[0] == 1 and c["cross_pod_calls"] != 0):
                failed.append("collectives")
    if device == "cuda":
        import torch
        rep["card"] = torch.cuda.get_device_name(0)
    rep["wall_s"] = round(time.time() - t0, 1)
    if failed:
        rep["status"] = "failed"
        rep["failed"] = failed
    return rep


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="2,2,2",
                    help="P,D,M join-mesh shape: a world of P*D*M ranks")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where every rank runs (cuda: all on cuda:0, "
                         "kernels on; cpu: the kernels' plain versions)")
    ap.add_argument("--kernel", action="store_true",
                    help="on the CPU, count evals by the kernel's tiles "
                         "(use_kernel=True) instead of whole sub-bands")
    ap.add_argument("--skip-serving", action="store_true",
                    help="skip the serving check")
    ap.add_argument("--cell", type=int, default=0, metavar="N",
                    help="also run the production cell at N x N rows "
                         "(262144: the production plane)")
    ap.add_argument("--cell-r-chunk", type=int, default=4096,
                    help="the cell's R band a model-axis rank")
    ap.add_argument("--detail", action="store_true",
                    help="report the parity and overflow runs chunk by "
                         "chunk")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds the whole world may take")
    args = ap.parse_args()
    shape = tuple(int(x) for x in args.mesh.split(","))
    if len(shape) != 3 or min(shape) < 1:
        raise SystemExit(f"--mesh must be P,D,M with P,D,M >= 1, got {shape}")
    rep = run_world(shape, device=args.device, kernel=args.kernel,
                    skip_serving=args.skip_serving, cell=args.cell,
                    cell_r_chunk=args.cell_r_chunk, detail=args.detail,
                    timeout=args.timeout)
    print(MARKER + json.dumps(rep, default=str), flush=True)
    raise SystemExit(1 if rep["status"] != "ok" else 0)


if __name__ == "__main__":
    main()
