"""Multi-pod dry-run of the model zoo: every (architecture x shape) cell
traced for rank 0 of a production mesh, on the ``meta`` device.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch starcoder2-3b \\
      --shape decode_32k --mesh single          # one cell
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

The reference lowers and compiles each cell over 512 emulated devices and
reads its compiler's analyses.  The port has no compiler, and a world of
256 or 512 processes does not fit a host, so each cell is built for rank 0
of an ``AbstractMesh`` of the production shape (``launch/cells.py``; every
rank's blocks have the shape of rank 0's) and its step is run once on
``meta`` tensors: shapes and dtypes, no storage, no card.  The record:

  * ``status``: ``ok``, ``skipped`` (with the reason) or ``error`` (with
    the message); ``trace_s``;
  * ``flops_per_device``: the matmul-class operations that
    ``torch.utils.flop_counter.FlopCounterMode`` counts (matrix products,
    convolutions, attention), forward and backward and any recomputation;
    not XLA's count, which takes every elementwise op too;
  * ``collective_bytes_per_device``, ``collective_by_kind`` (by op),
    ``collective_by_axis`` (by the port's axis label), ``collective_ops``
    (calls): the ``AxisLedger``'s bookings of rank 0's calls, each the
    bytes the port's call books (a gather's whole result, an all-reduce's
    buffer), not the bytes of a compiled program's collectives; a
    prefill or decode cell's ``weights`` label is the one-time gather of
    the weights it keeps;
  * ``memory``: ``argument_bytes`` (rank 0's blocks of the parameters,
    optimizer state, batch and decode state, as the reference's per-device
    argument size counts them; ``argument_bytes_by`` splits them), the
    batch as the port's rank holds it (``batch_held_bytes``: whole),
    ``output_bytes`` (the step's outputs; a train step updates the
    parameters in place and returns the optimizer state and metrics),
    ``kept_bytes`` (the weights a prefill or decode gathers and keeps,
    ``layers.kept_block``: on a state call the embedding and unembedding
    are kept whole), and ``temp_bytes`` / ``generated_code_bytes`` null:
    there is no compiler to plan a program's buffers.

A tensor off ``meta`` that holds an element, made during a trace, is an
error.  Records go to ``build/dryrun/<mesh>/<arch>__<shape>.json``
(gitignored); the process exits 1 when any cell failed.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.common.config import SHAPES
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed.mesh import make_production_mesh
from repro_torch.launch.cells import argument_bytes, build_cell, cell_supported

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "build", "dryrun")
NO_COMPILER = "no compiler: the port runs each op as it comes"


class _MetaOnly(TorchDispatchMode):
    """Raises on any op whose output is a tensor off the ``meta`` device
    that holds an element: a dry-run's trace allocates nothing.  (An empty
    tensor allocates nothing either: ``torch.utils.checkpoint`` makes one
    on the CPU as a marker on some torch versions.)"""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor) and not t.is_meta and t.numel():
                raise RuntimeError(f"{func} made a tensor on {t.device} in "
                                   f"a meta trace")
        return out


def one_period(arch: str) -> int:
    """The fewest layers that hold every (block, FFN) kind of ``arch``'s
    config: its dense first layers, then one period of its pattern (the
    block pattern, the cross-attention interval and the MoE step)."""
    cfg = get_config(arch)
    p = len(cfg.block_pattern)
    for k in (cfg.cross_attn_every, cfg.moe.moe_layer_step if cfg.moe else 0):
        if k > 1:
            p = p * k // math.gcd(p, k)
    return (cfg.moe.first_dense_layers if cfg.moe else 0) + p


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _kept_bytes(model) -> int:
    """The bytes of the weights ``model``'s modules keep gathered
    (``layers.kept_block``)."""
    return sum(hit[2].numel() * hit[2].element_size()
               for m in model.modules()
               for hit in m.__dict__.get("_kept", {}).values())


def trace_cell(cell) -> dict:
    """Run the cell's ``fn`` once on its arguments under
    ``FlopCounterMode`` and a fresh ``AxisLedger`` (the cell's mesh's):
    the flop count, the ledger's rows and summary, the outputs' bytes and
    the weights kept, and the wall."""
    ledger = cell.mesh.axis_ledger
    ledger.reset()
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc:
        if getattr(cell.mesh, "abstract", False):
            with _MetaOnly():
                out = cell.fn(*cell.abstract_args)
        else:
            out = cell.fn(*cell.abstract_args)
    wall = time.perf_counter() - t0
    summary = ledger.summary()
    by_kind: dict = {}
    for r in summary["rows"]:
        by_kind[r["op"]] = by_kind.get(r["op"], 0) + r["bytes"]
    return {"trace_s": wall, "flops": int(fc.get_total_flops()),
            "ledger": summary, "by_kind": by_kind,
            "output_bytes": _nbytes(out),
            "kept_bytes": _kept_bytes(cell.abstract_args[0])}


def run_cell(arch: str, shape: str, mesh_kind: str, *, out_dir: str = RESULTS,
             verbose: bool = True, **cell_kw) -> dict:
    """Build and trace one cell for rank 0 of the ``single`` (16, 16) or
    ``multi`` (2, 16, 16) production mesh; write and return its record."""
    ok, why = cell_supported(arch, shape)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind}
    if not ok:
        rec.update(status="skipped", reason=why)
        _save(rec, out_dir, mesh_kind, arch, shape)
        return rec
    t0 = time.time()
    try:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"),
                                    abstract=True)
        cell = build_cell(arch, shape, mesh, **cell_kw)
        t_build = time.time() - t0
        got = trace_cell(cell)
        args = argument_bytes(cell)
        base = get_config(arch)
        rows = got["ledger"]["rows"]
        rec.update(
            status="ok",
            layers=cell.cfg.num_layers,
            heads={"config": [base.num_heads, base.num_kv_heads],
                   "cell": [cell.cfg.num_heads, cell.cfg.num_kv_heads]},
            build_s=round(t_build, 2),
            trace_s=round(got["trace_s"], 2),
            flops_per_device=got["flops"],
            flops_counted="FlopCounterMode: matmul-class ops only, not "
                          "XLA's count",
            bytes_per_device=None,
            collective_bytes_per_device=sum(r["bytes"] for r in rows),
            collective_by_kind=got["by_kind"],
            collective_by_axis=got["ledger"]["by_axis"],
            collective_ops=sum(r["calls"] for r in rows),
            collective_rows=rows,
            collective_counted="the AxisLedger's bookings of rank 0's "
                               "calls, not HLO bytes",
            memory={
                "argument_bytes": args["total"],
                "argument_bytes_by": {k: v for k, v in args.items()
                                      if k != "total"},
                "batch_held_bytes": _nbytes(
                    cell.abstract_args[1 if cell.kind == "prefill" else 2:]),
                "output_bytes": got["output_bytes"],
                "kept_bytes": got["kept_bytes"],
                "temp_bytes": None,
                "generated_code_bytes": None,
                "null_because": NO_COMPILER,
            },
            note=cell.note,
        )
        if verbose:
            m = rec["memory"]
            print(f"[{mesh_kind}] {arch} x {shape}: OK "
                  f"flops/dev={rec['flops_per_device']:.3e} "
                  f"coll/dev={rec['collective_bytes_per_device']:.3e} "
                  f"args={_gb(m['argument_bytes'])} "
                  f"kept={_gb(m['kept_bytes'])} "
                  f"(build {rec['build_s']}s trace {rec['trace_s']}s)",
                  flush=True)
    except Exception as e:
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc())
        if verbose:
            print(f"[{mesh_kind}] {arch} x {shape}: ERROR {rec['error']}",
                  flush=True)
            print(rec["traceback"], file=sys.stderr, flush=True)
    _save(rec, out_dir, mesh_kind, arch, shape)
    return rec


def _gb(x):
    return f"{x/2**30:.2f}GiB" if x is not None else "?"


def _save(rec, out_dir, mesh_kind, arch, shape):
    d = os.path.join(out_dir, mesh_kind)
    os.makedirs(d, exist_ok=True)
    rec = dict(rec)
    rec.pop("traceback", None)
    with open(os.path.join(d, f"{arch}__{shape}.json"), "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="")
    ap.add_argument("--shape", default="")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--remat-policy", default=None)
    ap.add_argument("--param-cast", default=None)
    ap.add_argument("--layers", default=None,
                    help="layers_override: a count, or 'period' for "
                         "one_period(arch)")
    ap.add_argument("--out-dir", default=RESULTS)
    args = ap.parse_args(argv)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    archs = ARCH_IDS if (args.all or not args.arch) else args.arch.split(",")
    shapes = list(SHAPES) if (args.all or not args.shape) else args.shape.split(",")
    n_ok = n_skip = n_err = 0
    for mesh_kind in meshes:
        for arch in archs:
            layers = (None if args.layers is None else one_period(arch)
                      if args.layers == "period" else int(args.layers))
            for shape in shapes:
                rec = run_cell(arch, shape, mesh_kind, out_dir=args.out_dir,
                               remat_policy=args.remat_policy,
                               param_cast=args.param_cast,
                               layers_override=layers)
                n_ok += rec["status"] == "ok"
                n_skip += rec["status"] == "skipped"
                n_err += rec["status"] == "error"
    print(f"dryrun done: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    raise SystemExit(1 if n_err else 0)


if __name__ == "__main__":
    main()
