"""Fleet-serving launcher: N tenants, one store, K workers.

  PYTHONPATH=src python -m repro_torch.launch.serve_fleet --engine cuda \
      [--device cpu] --tenants 4 --queries 3 --shared --max-concurrent 2

Builds a ``JoinFleet``, registers ``--tenants`` tenants (``--shared``
gives every tenant the SAME corpus — the plane/plan dedup demo;
otherwise each tenant gets its own seed), then submits ``--queries``
queries per tenant concurrently through the admission loop.  Prints one
JSON event per completed query (which tenant, recall, extraction $,
dedup hits, wall) and a fleet summary: per-tenant ledgers, p50/p99 query
wall from the ``fleet.query_wall_s`` histogram, scheduler band-step /
interleave counts (0 until an engine streams bands through the
scheduler), and the shared store's counters.
"""

from __future__ import annotations

import argparse
import json

from repro_torch.core.join import FDJConfig
from repro_torch.launch._args import add_common_flags, make_dataset
from repro_torch.launch.serve_join import SERVE_SCALE
from repro_torch.obs import Tracer, use_tracer, write_trace
from repro_torch.serving.fleet import JoinFleet


def run_fleet(dataset: str = "police_records", engine: str = "cuda",
              stream: bool = False, size: float = 1.0, target: float = 0.9,
              delta: float = 0.1, seed: int = 0, n_tenants: int = 2,
              queries: int = 2, shared: bool = True,
              max_concurrent: int = 2, byte_budget=None, tenant_budget=None,
              oracle_latency=0.0, trace_out=None,
              device: str = "cuda") -> dict:
    fleet = JoinFleet(byte_budget=byte_budget, device=device,
                      max_concurrent=max_concurrent)
    for t in range(n_tenants):
        ds = make_dataset(dataset, size=size,
                          seed=seed if shared else seed + t,
                          scale=SERVE_SCALE)
        cfg = FDJConfig(recall_target=target, delta=delta, engine=engine,
                        device=device, stream_refinement=stream, seed=seed)
        fleet.add_tenant(f"t{t}", ds, cfg, byte_budget=tenant_budget,
                         oracle_factory=(
                             lambda d=ds: d.make_oracle(oracle_latency)))

    tracer = Tracer() if trace_out else None
    events = []
    with use_tracer(tracer):
        # interleaved submission (t0, t1, ..., t0, t1, ...): every tenant
        # has work queued from the start, so admission rotates and
        # different queries' launches contend for the device
        futures = [(name, fleet.submit(name))
                   for _ in range(queries) for name in fleet.tenants]
        for name, fut in futures:
            r = fut.result()
            ev = {"tenant": name, "recall": round(r.join.recall, 4),
                  "precision": round(r.join.precision, 4),
                  "pairs": len(r.pairs), "plan_hit": r.plan_hit,
                  "extraction_$": round(r.cost.inference, 6),
                  "dedup_hits": r.cost.plane_dedup_hits,
                  "bytes_h2d": r.cost.bytes_h2d,
                  "wall_s": round(r.wall_s, 3)}
            events.append(ev)
            print(json.dumps(ev))
        summary = fleet.drain()
    if tracer is not None:
        write_trace(tracer, trace_out, metadata={
            "tenants": summary["tenants"], "engine": engine,
            "device": device,
            "metrics": fleet.metrics.as_dict()})
    wall_hist = fleet.metrics.histogram("fleet.query_wall_s")
    summary.update(
        latency={k: round(v, 4) for k, v in wall_hist.summary().items()},
        p50_wall_s=round(wall_hist.quantile(0.5), 4),
        p99_wall_s=round(wall_hist.quantile(0.99), 4),
        tenant_ledgers={
            name: {k: round(v, 6) for k, v in
                   fleet.service(name).ledger.breakdown().items()}
            for name in fleet.tenants},
        tenant_bytes={name: fleet.store.tenant_bytes(name)
                      for name in fleet.tenants})
    fleet.close()
    print(json.dumps({"summary": summary}, indent=1))
    return {"events": events, "summary": summary}


def main():
    ap = add_common_flags(argparse.ArgumentParser())
    ap.add_argument("--tenants", type=int, default=2)
    ap.add_argument("--queries", type=int, default=2,
                    help="queries submitted per tenant")
    ap.add_argument("--shared", action="store_true",
                    help="all tenants join the SAME corpus (plane + plan "
                         "dedup demo); default gives each tenant its own "
                         "seed")
    ap.add_argument("--max-concurrent", type=int, default=2,
                    help="fleet worker threads (queries in flight at once)")
    ap.add_argument("--byte-budget", type=int, default=None,
                    help="shared plane-store device byte budget")
    ap.add_argument("--tenant-budget", type=int, default=None,
                    help="per-tenant charged-byte budget (fair eviction)")
    ap.add_argument("--oracle-latency", type=float, default=0.0,
                    help="simulated L_p round-trip seconds per labeled "
                         "pair (GIL-released; see SimulatedOracle)")
    args = ap.parse_args()
    run_fleet(args.dataset, args.engine, args.stream, args.size, args.target,
              args.delta, args.seed, args.tenants, args.queries, args.shared,
              args.max_concurrent, args.byte_budget, args.tenant_budget,
              oracle_latency=args.oracle_latency, trace_out=args.trace_out,
              device=args.device)


if __name__ == "__main__":
    main()
