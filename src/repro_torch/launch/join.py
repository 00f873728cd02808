"""FDJ join launcher — the paper's end-to-end pipeline as a CLI, on PyTorch.

  PYTHONPATH=src python -m repro_torch.launch.join --dataset products \
      --size 4 --engine cuda [--stream] [--device cpu] \
      [--precision-target 0.9] [--trace-out t.json]

Prints one JSON report: recall/precision, the cost breakdown relative to
the naive all-pairs join, step-② engine stats and the per-phase walls
(``plan_s`` for steps ①–⑥, ``execute_s`` for steps ⑦–⑨).  ``--trace-out``
writes the run's trace; check it with
``python -m repro_torch.launch.trace_report t.json --check``.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

from repro_torch.core.costs import naive_join_cost
from repro_torch.core.join import (FDJConfig, execute_join, make_label_fn,
                                   plan_join)
from repro_torch.data.simulated_llm import SimulatedExtractor, SimulatedProposer
from repro_torch.launch._args import add_common_flags, make_dataset
from repro_torch.obs import Tracer, current_tracer, use_tracer, write_trace


def run_join(dataset: str = "police_records", target: float = 0.9,
             delta: float = 0.1, engine: str = "cuda", size: float = 1.0,
             seed: int = 0, stream: bool = False, device: str = "cuda", *,
             precision_target: float = 1.0,
             trace_out: Optional[str] = None) -> dict:
    """One cold join (``fdj_join``'s two halves, timed apart)."""
    ds = make_dataset(dataset, size=size, seed=seed)
    oracle = ds.make_oracle()
    cfg = FDJConfig(recall_target=target, delta=delta, engine=engine,
                    precision_target=precision_target, device=device,
                    seed=seed, stream_refinement=stream)
    # one extractor and one label cache across both halves, as fdj_join
    # shares them: extraction is charged on first touch, refinement reuses
    # the sample labels
    extractor = SimulatedExtractor(ds, seed=seed)
    label = make_label_fn(oracle, {})
    tracer = Tracer() if trace_out else None
    with use_tracer(tracer), current_tracer().span(
            "fdj_join", engine=engine, stream=stream):
        t0 = time.perf_counter()
        plan = plan_join(ds, oracle, SimulatedProposer(ds), extractor, cfg,
                         ledger=oracle.ledger, label=label)
        t1 = time.perf_counter()
        res = execute_join(ds, oracle, extractor, cfg, plan,
                           ledger=oracle.ledger, label=label)
        t2 = time.perf_counter()
    if tracer is not None:
        write_trace(tracer, trace_out, metadata={
            "dataset": ds.name, "engine": engine, "stream": stream,
            "device": device, "wall_summary": res.cost.wall_summary(),
            "breakdown": res.cost.breakdown(),
        })
    naive = naive_join_cost(ds.texts_l, ds.texts_r)
    walls = {k: round(v, 4) for k, v in res.cost.wall_summary().items()}
    walls.update(plan_s=round(t1 - t0, 4), execute_s=round(t2 - t1, 4))
    return {
        "dataset": ds.name, "n_l": ds.n_l, "n_r": ds.n_r,
        "recall": round(res.recall, 4), "precision": round(res.precision, 4),
        "recall_target": target, "precision_target": precision_target,
        "t_prime": round(res.t_prime, 4),
        "met_target": res.met_target,
        "clauses": res.scaffold.clauses,
        "theta": [float(t) for t in res.theta],
        "featurizations": [s.key for s in res.specs],
        "candidates": res.candidate_count,
        "cost_ratio": round(res.cost.total / naive, 4),
        "breakdown": {k: round(v / naive, 4) for k, v in res.cost.breakdown().items()},
        "engine": (res.engine_stats.as_dict() if res.engine_stats else None),
        "device": device,
        "stream_refinement": stream,
        "walls": walls,
    }


def main():
    ap = add_common_flags(argparse.ArgumentParser())
    ap.add_argument("--precision-target", type=float, default=1.0)
    args = ap.parse_args()
    out = run_join(args.dataset, args.target, args.delta, args.engine,
                   args.size, args.seed, stream=args.stream,
                   device=args.device,
                   precision_target=args.precision_target,
                   trace_out=args.trace_out)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
