"""Join-serving launcher: load a corpus, serve a scripted query stream.

  PYTHONPATH=src python -m repro_torch.launch.serve_join \
      --dataset police_records --engine cuda [--device cpu] --holdout 40 \
      --script "query,query,append=20,query,append,query@target=0.8"

Script ops (comma-separated, run in order against one JoinService):

  * ``query``            — FDJ query with the launcher's base config
  * ``query@target=0.8`` — override recall target (``@stream`` toggles the
    streaming refinement pump, ``@engine=numpy`` the backend)
  * ``append[=K]``       — append K held-out R rows (default: the rest)
  * ``replan``           — query with refresh_plan=True

Prints one JSON event per op: recall/precision, plan-cache hit, delta rows
joined incrementally, per-query extraction charges (zero on the warm
path), plane-store hit rate and bytes-to-device — the serving story of
DESIGN.md §4 as a watchable stream.
"""

from __future__ import annotations

import argparse
import json

from repro_torch.core.join import FDJConfig, QueryOptions
from repro_torch.launch._args import add_common_flags, make_dataset
from repro_torch.obs import Tracer, use_tracer, write_trace
from repro_torch.serving.join_service import DeltaRows, JoinService, hold_out_right
from repro_torch.serving.planes import FeaturePlaneStore

# serving launchers run half the one-shot launcher's corpus scale: many
# queries per run, same wall budget
SERVE_SCALE = 0.5


def _dataset(name: str, size: float, seed: int):
    return make_dataset(name, size=size, seed=seed, scale=SERVE_SCALE)


def _take_delta(pool: DeltaRows, k: int, base_n: int):
    """First k held-out rows (as a DeltaRows) + the remaining pool."""
    k = min(k, len(pool.texts))
    cut = base_n + k
    head = DeltaRows(pool.texts[:k],
                     {f: v[:k] for f, v in pool.fields.items()},
                     {(i, j) for (i, j) in pool.truth if j < cut})
    tail = DeltaRows(pool.texts[k:],
                     {f: v[k:] for f, v in pool.fields.items()},
                     {(i, j) for (i, j) in pool.truth if j >= cut})
    return head, tail


def _parse_op(op: str) -> tuple:
    """'query@target=0.8@stream' -> ('query', {...})."""
    parts = op.split("@")
    kw: dict = {}
    for p in parts[1:]:
        if p == "stream":
            kw["stream"] = True
        elif "=" in p:
            k, v = p.split("=", 1)
            k = {"target": "recall_target", "precision": "precision_target"}\
                .get(k, k)
            kw[k] = v if k == "engine" else float(v)
        else:
            raise ValueError(f"unknown query modifier {p!r}")
    return parts[0], kw


def run_serve(dataset: str = "police_records", engine: str = "cuda",
              stream: bool = False, size: float = 1.0, target: float = 0.9,
              delta: float = 0.1, holdout: int = 0,
              script: str = "query,query", seed: int = 0,
              byte_budget=None, trace_out=None,
              device: str = "cuda") -> dict:
    ds = _dataset(dataset, size, seed)
    pool = None
    if holdout:
        ds, pool = hold_out_right(ds, holdout)
    cfg = FDJConfig(recall_target=target, delta=delta, engine=engine,
                    device=device, stream_refinement=stream, seed=seed)
    svc = JoinService(ds, cfg,
                      store=FeaturePlaneStore(byte_budget, device=device))
    tracer = Tracer() if trace_out else None
    events = []
    with use_tracer(tracer):
        events = _run_script(svc, script, pool)
    if tracer is not None:
        write_trace(tracer, trace_out, metadata={
            "dataset": svc.dataset.name, "engine": engine, "script": script,
            "device": device,
            "wall_summary": svc.ledger.wall_summary(),
            "metrics": svc.metrics.as_dict(),
        })
    summary = {
        "dataset": svc.dataset.name, "n_l": svc.dataset.n_l,
        "n_r": svc.dataset.n_r, "queries": svc.queries,
        "appends": svc.appends,
        "service_ledger": {k: round(v, 6)
                           for k, v in svc.ledger.breakdown().items()},
        "serving": svc.ledger.serving_summary(),
        "latency": {k: round(v, 4) for k, v in
                    svc.metrics.histogram("serve.query_wall_s")
                    .summary().items()},
        "store": svc.store.snapshot(),
    }
    print(json.dumps({"summary": summary}, indent=1))
    return {"events": events, "summary": summary}


def _run_script(svc: JoinService, script: str, pool) -> list:
    events = []
    for raw in [s for s in script.split(",") if s.strip()]:
        name, kw = _parse_op(raw.strip())
        if name.startswith("append"):
            k = int(name.split("=", 1)[1]) if "=" in name \
                else (len(pool.texts) if pool else 0)
            if not pool or not pool.texts:
                raise ValueError("append: no held-out rows (use --holdout)")
            head, pool = _take_delta(pool, k, svc.dataset.n_r)
            info = svc.append_right(head)
            ev = {"op": raw, "rows": info["rows"],
                  "extraction_$": round(info["ledger"].inference, 6),
                  "bytes_to_device": info["store"]["bytes_to_device"],
                  "n_r": svc.dataset.n_r}
        elif name in ("query", "replan"):
            # the typed request surface (DESIGN.md §8): script modifiers
            # become one QueryOptions, same shape JoinFleet.submit takes
            named = {k: kw.pop(k) for k in
                     ("engine", "stream", "recall_target",
                      "precision_target", "delta") if k in kw}
            r = svc.query(QueryOptions(
                refresh_plan=(name == "replan"), overrides=kw, **named))
            st = r.store
            looked = st["hits"] + st["misses"]
            ev = {"op": raw, "recall": round(r.join.recall, 4),
                  "precision": round(r.join.precision, 4),
                  "pairs": len(r.pairs), "plan_hit": r.plan_hit,
                  "delta_rows": r.delta_rows,
                  "extraction_$": round(r.cost.inference, 6),
                  "plane_hit_rate": round(st["hits"] / looked, 3) if looked else None,
                  "bytes_h2d": r.cost.bytes_h2d,
                  "wall_s": round(r.wall_s, 3)}
        else:
            raise ValueError(f"unknown script op {raw!r}")
        events.append(ev)
        print(json.dumps(ev))
    return events


def main():
    ap = add_common_flags(argparse.ArgumentParser())
    ap.add_argument("--holdout", type=int, default=0,
                    help="R rows held back for append ops")
    ap.add_argument("--script", default="query,query")
    ap.add_argument("--byte-budget", type=int, default=None,
                    help="plane-store device byte budget (LRU eviction)")
    args = ap.parse_args()
    run_serve(args.dataset, args.engine, args.stream, args.size, args.target,
              args.delta, args.holdout, args.script, args.seed,
              args.byte_budget, trace_out=args.trace_out, device=args.device)


if __name__ == "__main__":
    main()
