"""FDJ join launcher — the paper's end-to-end pipeline as a CLI, on PyTorch.

  PYTHONPATH=src python -m repro_torch.launch.join --dataset products \
      --size 4 --engine cuda|sharded [--stream] [--device cpu] \
      [--prefetch-depth 2 --r-chunk 512] [--pods P] \
      [--precision-target 0.9] [--trace-out t.json]

Prints one JSON report: recall/precision, the cost breakdown relative to
the naive all-pairs join, step-② engine stats and the per-phase walls
(``plan_s`` for steps ①–⑥, ``execute_s`` for steps ⑦–⑨).  ``--trace-out``
writes the run's trace; check it with
``python -m repro_torch.launch.trace_report t.json --check``.

Under a ``torchrun``-style environment (``WORLD_SIZE``, ``RANK``,
``MASTER_ADDR``, ``MASTER_PORT``) every rank joins the world over
``gloo`` and runs the same join; the sharded engine shards L over the
ranks (``--pods`` of them in the pod axis) and rank 0 prints the report.
Without that environment the world is this process.

Also exposes the *production join cell* (``build_join_cell``): the fused
CNF evaluation over the 262144 x 262144 plane, L rows sharded over
(pod, data), R over model.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Optional

from repro_torch.core.costs import naive_join_cost
from repro_torch.core.join import (FDJConfig, execute_join, make_label_fn,
                                   plan_join)
from repro_torch.data.simulated_llm import SimulatedExtractor, SimulatedProposer
from repro_torch.launch._args import (add_common_flags, engine_opts_from,
                                      make_dataset)
from repro_torch.obs import Tracer, current_tracer, use_tracer, write_trace


def run_join(dataset: str = "police_records", target: float = 0.9,
             delta: float = 0.1, engine: str = "cuda", size: float = 1.0,
             seed: int = 0, stream: bool = False, device: str = "cuda", *,
             precision_target: float = 1.0, pods: int = 1,
             prefetch_depth: Optional[int] = None,
             r_chunk: Optional[int] = None,
             trace_out: Optional[str] = None) -> dict:
    """One cold join (``fdj_join``'s two halves, timed apart)."""
    ds = make_dataset(dataset, size=size, seed=seed)
    oracle = ds.make_oracle()
    cfg = FDJConfig(recall_target=target, delta=delta, engine=engine,
                    precision_target=precision_target, device=device,
                    seed=seed, stream_refinement=stream, pods=pods,
                    prefetch_depth=prefetch_depth,
                    engine_opts=engine_opts_from(r_chunk))
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
            "device": device, "prefetch_depth": prefetch_depth,
            "wall_summary": res.cost.wall_summary(),
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


# ---------------------------------------------------------------------------
# the production join cell
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class JoinCellStep:
    """One CNF-join step of the production cell: ``step(emb_l, emb_r)`` is
    the packed int32 mask of the cell's clauses at its thresholds (the
    kernel on CUDA tensors, its plain version on CPU tensors), at the
    kernel's default tiles."""
    clauses: tuple
    thetas: tuple

    def __call__(self, emb_l, emb_r, **kw):
        import torch
        from repro_torch.kernels.fused_cnf_join.kernel import cnf_join_block
        scal_l = torch.zeros((1, emb_l.shape[1]), device=emb_l.device)
        scal_r = torch.zeros((1, emb_r.shape[1]), device=emb_r.device)
        return cnf_join_block(emb_l, emb_r, scal_l, scal_r, self.clauses,
                              self.thetas, **kw)


def build_join_cell(mesh, *, n_l: int = 262144, n_r: int = 262144,
                    f_vec: int = 4, d: int = 128, n_clauses: int = 3):
    """The production cell — 3 one-member embed clauses at theta 0.4 over
    an ``n_l`` x ``n_r`` plane of ``f_vec`` embeddings of width ``d`` —
    as (step, (a_l, a_r)): the step callable and this rank's inputs as
    ``device="meta"`` tensors, L rows sharded over the mesh's (pod, data)
    and R rows over its model axis."""
    import torch
    from repro_torch.distributed.mesh import l_shard_axes
    from repro_torch.kernels.fused_cnf_join.kernel import VEC
    l_ways = 1
    for a in l_shard_axes(mesh):
        l_ways *= mesh.shape[a]
    r_ways = mesh.shape.get("model", 1)
    step = JoinCellStep(tuple(((VEC, i),) for i in range(n_clauses)),
                        tuple(0.4 for _ in range(n_clauses)))
    a_l = torch.empty((f_vec, n_l // l_ways, d), device="meta")
    a_r = torch.empty((f_vec, n_r // r_ways, d), device="meta")
    return step, (a_l, a_r)


def main():
    from repro_torch.distributed.mesh import init_from_env, world_rank
    ap = add_common_flags(argparse.ArgumentParser())
    ap.add_argument("--precision-target", type=float, default=1.0)
    ap.add_argument("--pods", type=int, default=1,
                    help="pod-axis width of the sharded engine's (pod, "
                         "data, model) join mesh over the torch.distributed "
                         "world (FDJConfig.pods; needs that many ranks — "
                         "see launch/multipod_dryrun)")
    args = ap.parse_args()
    init_from_env()
    out = run_join(args.dataset, args.target, args.delta, args.engine,
                   args.size, args.seed, stream=args.stream,
                   device=args.device,
                   precision_target=args.precision_target, pods=args.pods,
                   prefetch_depth=args.prefetch_depth, r_chunk=args.r_chunk,
                   # one trace file: the coordinating rank's
                   trace_out=args.trace_out if world_rank() == 0 else None)
    if world_rank() == 0:
        print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
