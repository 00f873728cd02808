"""Jobs on a model mesh over a world of processes: the expert-parallel MoE
and the model zoo's steps on ``(data, model)`` worlds.

``run_world(shape, job, payload)`` spawns one process a rank
(``torch.multiprocessing``, spawn context), joins them in a ``gloo`` world
through a file rendezvous in a temporary directory, builds
``make_mesh(shape, ("data", "model"))`` (or other ``axes``) on every rank,
runs ``JOBS[job]`` (or ``job`` itself, a module-level function
``job(mesh, device, payload)``) and returns each rank's result (a dict of
numpy arrays and plain values), in rank order.  Ranks on ``cuda`` share
card 0: gloo lets several ranks share one card, NCCL does not.  A rank
that fails, or a world that does not finish within ``timeout``, raises
``RuntimeError`` with the ranks' tracebacks.

The jobs (``payload`` keys in each docstring):

  * ``ep_fn``: one expert-parallel function of ``models/moe.py`` on a
    smoke config's MoE weights, as the reference's ``shard_map`` runs it;
    the output, ``aux``, this rank's router ids and, with ``grad``, the
    gradients of ``sum(out * wgt) + aux_weight * aux``;
  * ``model``: a smoke model over the mesh (every leaf its block,
    ``use_ep``): a forward, a prefill and teacher-forced decode steps
    against this rank's block of the state (its blocks, bytes and ledger
    a step reported; optionally with f32 caches, ``cache_dtype``), and a
    train step;
  * ``restore``: a checkpoint restored onto the mesh;
  * ``save``: a model's tree gathered from the ranks' blocks and written
    by rank 0;
  * ``shard``: ``shard_leaf`` blocks of an array under several specs;
  * ``cell``: a cell of ``launch/cells.py`` (its heads padded for the
    mesh) on whole weights drawn from a seed: its step traced as the
    dry-run traces it, a train step, or a prefill into its state and its
    decode steps;
  * ``many``: several of these in turn on one world (a world costs a few
    seconds to spawn).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback

import numpy as np

AXES = ("data", "model")


def _np(t):
    import torch
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return t


def _cfg(p: dict):
    """The payload's smoke config of ``arch`` with its ``overrides`` (a
    dict of config fields), ``dtype`` and ``capacity_factor``."""
    from repro_torch.configs import get_smoke
    cfg = dataclasses.replace(get_smoke(p["arch"]), **p.get("overrides", {}))
    if p.get("dtype"):
        cfg = dataclasses.replace(cfg, dtype=p["dtype"])
    if p.get("capacity_factor"):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=p["capacity_factor"]))
    return cfg


# ---------------------------------------------------------------------------
# jobs
# ---------------------------------------------------------------------------

def ep_specs(fn: str, env, mesh, b: int, shared: bool):
    """(params spec, x spec, aux vary axes) of the ``shard_map`` that runs
    ``fn`` in the tests: ``ep`` (tokens over batch and ``model``, experts
    over ``model``), ``replicated`` (tokens over batch only), ``dsharded``
    (tokens whole; experts and shared experts also over ``fsdp`` on
    d_model, ``moe_param_specs``)."""
    from repro_torch.distributed.mesh import Spec, axis_size
    from repro_torch.models import moe
    bw = axis_size(mesh, env.batch)
    bax = env.batch if b % bw == 0 and b >= bw else ()
    bspec = moe._axspec(bax)
    if fn == "dsharded":
        return moe.moe_param_specs(env, shared), Spec(None, None, None), ()
    pspec = {"router": Spec(None, None), "w_gate": Spec("model", None, None),
             "w_up": Spec("model", None, None),
             "w_down": Spec("model", None, None)}
    if shared:
        pspec["shared"] = {k: Spec(None, None)
                           for k in ("w_gate", "w_up", "w_down")}
    if fn == "ep":
        return pspec, Spec(bspec, "model", None), tuple(bax) + ("model",)
    return pspec, Spec(bspec, None, None), tuple(bax)


def _job_ep_fn(mesh, dev, p: dict) -> dict:
    """``fn`` (``ep``, ``replicated``, ``dsharded`` or ``block``) on the
    MoE weights ``params`` (a nested dict of whole numpy arrays) and the
    whole input ``x`` (B, S, d); ``grad``: also the gradients of
    ``sum(out * wgt) + aux_weight * aux`` (``block``: of this rank's
    weight blocks, else of the whole weights) and of x, and for a top-1
    router the router's gradient of ``aux`` alone."""
    import torch
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.mesh import AxisEnv, Spec, shard_leaf
    from repro_torch.models import moe
    from repro_torch.models.layers import tree_map
    from repro_torch.models.transformer import _zip_map
    cfg = _cfg(p)
    cdt = getattr(torch, cfg.dtype)
    env = AxisEnv.from_mesh(mesh)
    grad = p.get("grad", False)
    params = tree_map(lambda a: torch.as_tensor(a).to(dev), p["params"])
    x = torch.as_tensor(p["x"]).to(dev).requires_grad_(grad)
    shared = "shared" in params
    stats = {}
    if p["fn"] == "block":
        params = _zip_map(lambda t, sp: shard_leaf(mesh, t, sp).clone()
                          .requires_grad_(grad), params,
                          moe.moe_param_specs(env, shared))

        def run():
            return moe.moe_block_sharded(params, x, cfg, mesh, env, cdt,
                                         stats)
    else:
        params = tree_map(lambda a: a.requires_grad_(grad), params)
        pspec, x_spec, vary = ep_specs(p["fn"], env, mesh, x.shape[0], shared)

        def body(pl, xl):
            if p["fn"] == "ep":
                o, a = moe.moe_ffn_ep(pl, xl, cfg, mesh, "model", cdt, stats)
            elif p["fn"] == "replicated":
                o, a = moe.moe_ffn_ep_replicated(pl, xl, cfg, mesh, "model",
                                                 cdt, stats)
            else:
                o, a = moe.moe_ffn_ep_replicated_dsharded(
                    pl, xl, cfg, mesh, "model", env.fsdp, cdt, stats)
            if vary:
                a = coll.pmean(a, mesh, vary, "+".join(vary))
            return o, a

        def run():
            return coll.shard_map(body, mesh, (pspec, x_spec),
                                  (x_spec, Spec()))(params, x)
    out, aux = run()
    res = {"out": _np(out), "aux": float(aux.detach()),
           "ids": _np(stats["ids"]), "dropped": int(stats["dropped"])}
    if grad:
        wgt = torch.as_tensor(p["wgt"]).to(dev)
        loss = torch.sum(out.float() * wgt) + p.get("aux_weight", 1.0) * aux
        loss.backward()
        res["grads"] = tree_map(lambda t: _np(t.grad), params)
        res["x_grad"] = _np(x.grad)
        res["ledger"] = mesh.axis_ledger.summary()
        if cfg.moe.top_k == 1:
            # a top-1 weight renormalises to w / w = 1: the router's
            # gradient through the output is rounding residue, and only
            # aux's part is exact; that part alone
            params["router"].grad = None
            out, aux = run()
            aux.backward()
            res["router_grad_aux"] = _np(params["router"].grad)
        return res
    res["ledger"] = mesh.axis_ledger.summary()
    return res


def nudge_(tensors, seed: int) -> None:
    """Move every element of ``tensors`` one ulp up or down in place, the
    side drawn from ``seed`` (a generator on their device) tensor by
    tensor in the order given: another draw of the rounding."""
    import torch
    g = None
    with torch.no_grad():
        for t in tensors:
            if g is None:
                g = torch.Generator(device=t.device).manual_seed(seed)
            up = torch.rand(t.shape, generator=g, device=t.device) < 0.5
            inf = torch.full_like(t, float("inf"))
            t.copy_(torch.nextafter(t, torch.where(up, inf, -inf)))


def sorted_leaves(tree: dict) -> list:
    """The leaves of a nested dict, keys sorted at every level."""
    from repro_torch.models.layers import tree_leaves
    return [t for _, t in sorted(tree_leaves(tree), key=lambda pt: pt[0])]


def _draw(cfg, mesh, dev, p: dict):
    """The model over the mesh (``None``: whole): drawn from ``seed`` on
    the CPU and this rank's blocks kept, or this rank's blocks of the
    whole ``tree`` (numpy, the reference's layout); with ``nudge`` (a
    seed) that tree, or the whole drawn one, first ``nudge_``d in the
    reference's leaf order (keys sorted); with ``gate`` every cross
    layer's gate then set to it (0 at init, where a cross layer adds
    nothing)."""
    model = _draw_blocks(cfg, mesh, dev, p)
    if p.get("gate") is not None:
        import torch
        with torch.no_grad():
            for blk in model.layers:
                if blk.kind == "cross_attn":
                    blk.attn.gate.fill_(p["gate"])
    return model


def _draw_blocks(cfg, mesh, dev, p: dict):
    import torch
    from repro_torch.convert import model_tree_to_numpy
    from repro_torch.distributed.mesh import shard_leaf
    from repro_torch.models import transformer
    from repro_torch.models.layers import tree_map
    from repro_torch.models.transformer import _zip_map
    tree = p.get("tree")
    if p.get("nudge") is not None:
        if tree is None:
            tree = model_tree_to_numpy(cfg, transformer.init_params(
                cfg, torch.Generator().manual_seed(p.get("seed", 0)), "cpu"))
        tree = tree_map(lambda a: torch.tensor(np.asarray(a)), tree)
        nudge_(sorted_leaves(tree), p["nudge"])
    if tree is None:
        return transformer.init_params(
            cfg, torch.Generator().manual_seed(p.get("seed", 0)), "cpu",
            mesh=mesh).to(dev)
    if mesh is not None:
        specs = transformer.mesh_specs(cfg, mesh)
        tree = _zip_map(lambda a, s: shard_leaf(mesh, torch.as_tensor(a), s),
                        tree, specs)
    tree = tree_map(lambda a: torch.as_tensor(a).clone().to(dev), tree)
    return transformer.Transformer(cfg, transformer.weights_from_tree(
        cfg, tree, mesh))


def _job_model(mesh, dev, p: dict) -> dict:
    """A smoke model over the mesh (``_draw``; with ``whole`` the whole
    model and no mesh, a world of one in this process), the MoE FFNs with
    ``use_ep``.  ``forward`` (B, S): the logits of a forward with no
    state.  ``prompt`` (B, S) prefilled into a cache of ``capacity``
    slots, then each column of ``decode`` (B, n) decoded in turn
    (teacher-forced).  ``train`` {tokens, labels}: one ``make_train_step``
    step after (AdamW at ``TrainConfig()``, or ``tcfg``'s overrides).
    ``memory`` (B, M, F), where given, feeds the cross layers of the
    forward, the prefill and the train step.
    ``valid_from`` (B,), where given, left-pads the prompt (the prefill
    and every decode step take it).  Over the mesh the state is this
    rank's block of it (``init_state(mesh=)``); with ``cache_dtype`` the
    KV and latent caches are allocated in that dtype (a test's witness of
    a mesh's arithmetic, ``init_state``).
    Returns the forward's logits, the prefill's last logits, every decode
    step's, the MoE layers' router ids and dropped choices a call (prefill
    calls first), this rank's state after the prefill (``prefill_cache``)
    and after the last step (``cache``) and its bytes (``state_bytes``),
    the collective ledger of the prefill and decode (``ledger``), its
    calls and bytes by axis of the prefill (``prefill_ledger``) and of
    each decode step (``step_ledgers``), and of the train step
    (``train_ledger``), the train metrics, the optimizer's ``m`` gathered
    whole (the reference's tree), this rank's block shapes (the
    reference's layout) and its mesh coordinates (``coords``)."""
    import torch
    from repro_torch.common.config import TrainConfig
    from repro_torch.distributed.mesh import AxisEnv
    from repro_torch.models import moe, steps, transformer
    from repro_torch.models.layers import tree_leaves
    from repro_torch.optim import adamw
    cfg = _cfg(p)
    on = None if p.get("whole") else mesh
    model = _draw(cfg, on, dev, p)
    named = {n: t.detach() for n, t in model.named_parameters()}
    row = {"coords": dict(mesh.coords),
           "blocks": {"/".join(path): list(t.shape) for path, t in
                      tree_leaves(transformer.tree_from_weights(cfg, named))}}
    memory = (None if p.get("memory") is None
              else torch.as_tensor(p["memory"]).to(dev))
    if p.get("forward") is not None:
        with torch.no_grad():
            row["forward"] = _np(model(torch.as_tensor(p["forward"]).to(dev),
                                       memory=memory, use_ep=True,
                                       mesh=on)[0])
    calls = []
    hooks = [b.ffn.register_forward_hook(lambda mod, i, o: calls.append(
        (mod.stats["ids"].cpu().numpy(), int(mod.stats["dropped"]))))
        for b in model.layers if isinstance(b.ffn, moe.MoEFFN)]
    mesh.axis_ledger.reset()
    if p.get("prompt") is not None:
        prompt = torch.as_tensor(p["prompt"]).to(dev)
        valid_from = (None if p.get("valid_from") is None
                      else torch.as_tensor(p["valid_from"]).to(dev))
        b, s = prompt.shape
        prefill = steps.make_prefill_step(cfg, p.get("capacity", s + 16),
                                          use_ep=True, mesh=on,
                                          cache_dtype=p.get("cache_dtype"))
        state, last = prefill(model, prompt, valid_from, memory=memory)
        row.update(prefill_calls=len(calls), prefill=_np(last),
                   prefill_cache=_np_state(state),
                   prefill_ledger=mesh.axis_ledger.summary()["by_axis"])
        decode = steps.make_decode_step(cfg, use_ep=True, mesh=on)
        toks = torch.as_tensor(p.get("decode", np.zeros((b, 0), np.int64))
                               ).to(dev)
        logits, row["step_ledgers"] = [], []
        for j in range(toks.shape[1]):
            pos = torch.full((b, 1), s + j, dtype=torch.int32, device=dev)
            before = mesh.axis_ledger.summary()["by_axis"]
            state, lg = decode(model, state, toks[:, j:j + 1], pos,
                               valid_from)
            logits.append(_np(lg))
            row["step_ledgers"].append(ledger_delta(
                mesh.axis_ledger.summary()["by_axis"], before))
        row["decode"] = np.stack(logits) if logits else None
        row["cache"] = _np_state(state)
        row["state_bytes"] = sum(t.numel() * t.element_size()
                                 for layer in state for t in layer.values()
                                 if torch.is_tensor(t))
        del state
    row["ledger"] = mesh.axis_ledger.summary()
    for h in hooks:
        h.remove()
    row["ids"] = [c[0] for c in calls]
    row["dropped"] = [c[1] for c in calls]
    if p.get("train") is not None:
        tcfg = TrainConfig(**p.get("tcfg", {}))
        opt = adamw.init_opt_state(dict(model.named_parameters()))
        step = steps.make_train_step(cfg, tcfg, use_ep=True, mesh=on)
        batch = {k: torch.as_tensor(v).to(dev) for k, v in p["train"].items()}
        if memory is not None:
            batch["memory"] = memory
        mesh.axis_ledger.reset()
        opt, met = step(model, opt, batch)
        row["train_ledger"] = mesh.axis_ledger.summary()
        row["metrics"] = {k: float(v) for k, v in met.items()}
        if on is None:
            row["m"] = _np_tree(transformer.tree_from_weights(cfg, opt["m"]))
        else:
            specs = transformer.local_specs(cfg, AxisEnv.from_mesh(mesh))
            row["m"] = _whole_tree(cfg, opt["m"], mesh, specs)
    return row


def whole_weights(cfg, dev, p: dict) -> dict:
    """A whole model's weights (world 1, keyed by parameter name) drawn
    from ``seed`` by a generator on ``dev``, every cross layer's gate set
    to ``gate`` where given, the reference tree ``nudge_``d by ``nudge``
    (a seed) where given."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.models.layers import tree_map
    model = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(p.get("seed", 0)), dev)
    weights = {n: t.detach() for n, t in model.named_parameters()}
    if p.get("gate") is not None:
        weights = {n: torch.full_like(t, p["gate"]) if n.endswith("attn.gate")
                   else t for n, t in weights.items()}
    if p.get("nudge") is not None:
        tree = tree_map(lambda t: t.clone(),
                        transformer.tree_from_weights(cfg, weights))
        nudge_(sorted_leaves(tree), p["nudge"])
        weights = transformer.weights_from_tree(cfg, tree)
    return weights


def _job_cell(mesh, dev, p: dict) -> dict:
    """A cell of ``launch/cells.py`` run for real on this rank: ``arch``'s
    smoke config (``_cfg``; its full config with ``full``, cut to
    ``layers``) at ``shape`` (a ``ShapeConfig``'s fields), built by
    ``build_cell`` on ``whole_weights`` (padded for the mesh's ``tp`` and
    this rank's blocks kept).  With ``trace``: the cell's step once on its
    own arguments, as ``launch.dryrun.trace_cell`` traces it (the flops,
    the ledger's rows).  A train cell with ``train`` {tokens, labels}: one
    step (``memory`` feeds the cross layers; TrainConfig with ``tcfg``'s
    overrides), its metrics, ledger and ``m`` gathered whole (the padded
    config's reference tree).  A decode cell with ``prompt``: the prompt
    prefilled into the cell's state (``memory`` where given), then each
    column of ``decode`` through the cell's step, the logits of every
    call (each read to the host, so the walls wait for the card) and the
    walls of the whole and of the decode steps."""
    import torch
    from repro_torch.common.config import ShapeConfig, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.distributed.mesh import AxisEnv
    from repro_torch.launch import cells, dryrun
    from repro_torch.models import steps, transformer
    if p.get("full"):
        cfg = dataclasses.replace(get_config(p["arch"]),
                                  **p.get("overrides", {}))
        if p.get("layers"):
            cfg = dataclasses.replace(cfg, num_layers=p["layers"])
    else:
        cfg = _cfg(p)
    sc = ShapeConfig(*p["shape"])
    cell = cells.build_cell(p["arch"], sc, mesh, cfg_override=cfg,
                            weights=whole_weights(cfg, dev, p), device=dev,
                            cache_dtype=p.get("cache_dtype"))
    row = {"coords": dict(mesh.coords),
           "heads": [cell.cfg.num_heads, cell.cfg.num_kv_heads]}
    if p.get("trace"):
        got = dryrun.trace_cell(cell)
        row.update(flops=got["flops"], rows=got["ledger"]["rows"],
                   kept_bytes=got["kept_bytes"])
        return row
    model = cell.abstract_args[0]
    memory = (None if p.get("memory") is None
              else torch.as_tensor(p["memory"]).to(dev))
    if cell.kind == "train":
        batch = {k: torch.as_tensor(v).to(dev) for k, v in p["train"].items()}
        if memory is not None:
            batch["memory"] = memory
        # the train cell's step as build_cell makes it, at tcfg's overrides
        step = steps.make_train_step(cell.cfg, TrainConfig(
            **p.get("tcfg", {})), use_ep=cell.use_ep, mesh=mesh)
        opt = cell.abstract_args[1]
        mesh.axis_ledger.reset()
        opt, met = step(model, opt, batch)
        specs = transformer.local_specs(cell.cfg, AxisEnv.from_mesh(mesh))
        row.update(metrics={k: float(v) for k, v in met.items()},
                   train_ledger=mesh.axis_ledger.summary(),
                   m=_whole_tree(cell.cfg, opt["m"], mesh, specs))
        return row
    state = cell.abstract_args[1]
    prompt = torch.as_tensor(p["prompt"]).to(dev)
    b, s = prompt.shape
    prefill = steps.make_prefill_step(cell.cfg, sc.seq_len,
                                      use_ep=cell.use_ep, mesh=mesh)
    t0 = time.perf_counter()
    state, last = prefill(model, prompt, memory=memory, state=state)
    logits = [_np(last)]
    toks = torch.as_tensor(p["decode"]).to(dev)
    t1 = time.perf_counter()
    for j in range(toks.shape[1]):
        pos = torch.full((b, 1), s + j, dtype=torch.int32, device=dev)
        state, lg = cell.fn(model, state, toks[:, j:j + 1], pos)
        logits.append(_np(lg))
    row.update(logits=np.stack(logits), wall_s=time.perf_counter() - t0,
               decode_s=time.perf_counter() - t1,
               state_bytes=sum(t.numel() * t.element_size()
                               for layer in state for t in layer.values()
                               if torch.is_tensor(t)))
    return row


def _np_state(state: list) -> list:
    """A decode state's tensors (one dict a layer) as numpy copies."""
    return [{n: np.array(_np(t)) for n, t in layer.items()
             if not isinstance(t, int)} for layer in state]


def ledger_delta(after: dict, before: dict) -> dict:
    """The calls and bytes an ``AxisLedger``'s ``by_axis`` booked between
    two readings (``summary()["by_axis"]``), by axis label (labels with
    none left out)."""
    out = {}
    for axis, r in after.items():
        b = before.get(axis, {"calls": 0, "bytes": 0})
        if r["calls"] > b["calls"]:
            out[axis] = {k: r[k] - b[k] for k in ("calls", "bytes")}
    return out


def _np_tree(tree: dict) -> dict:
    """A nested dict of tensors as numpy arrays."""
    from repro_torch.models.layers import tree_map
    return tree_map(_np, tree)


def _whole_tree(cfg, named: dict, mesh, specs) -> dict:
    """A dict of this rank's tensors keyed by parameter name, as the
    reference's tree of whole numpy arrays."""
    from repro_torch.checkpoint.checkpoint import gather_tree
    from repro_torch.models import transformer
    tree = transformer.tree_from_weights(cfg, {n: t.detach()
                                               for n, t in named.items()})
    from repro_torch.models.layers import tree_map
    return tree_map(_np, gather_tree(tree, mesh, specs))


def _job_restore(mesh, dev, p: dict) -> dict:
    """``checkpoint.restore`` of ``dir`` onto the mesh with the model's
    ``param_specs`` (``specs`` "param") or ``local_specs`` ("local"): each
    rank's blocks, and whether each equals the slice of the saved leaf."""
    import torch
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.distributed.mesh import AxisEnv, block_slices
    from repro_torch.models import transformer
    from repro_torch.models.layers import tree_leaves, tree_map
    cfg = _cfg(p)
    env = AxisEnv.from_mesh(mesh)
    specs = (transformer.param_specs(cfg, env) if p.get("specs") == "param"
             else transformer.local_specs(cfg, env))
    template = tree_map(lambda d: 0, transformer.model_defs(cfg))
    tree, step = ckpt.restore(p["dir"], template, device=dev, mesh=mesh,
                              specs=specs)
    whole, _ = ckpt.restore(p["dir"], template, device="cpu")
    equal, shapes = [], {}
    spec_of = dict(tree_leaves(specs))
    for path, blk in tree_leaves(tree):
        want = dict(tree_leaves(whole))[path]
        sl = block_slices(mesh, want.shape, spec_of[path])
        equal.append(bool(torch.equal(blk.cpu(), want[sl])))
        shapes["/".join(path)] = list(blk.shape)
    return {"step": step, "all_equal": all(equal), "leaves": len(equal),
            "shapes": shapes, "device": str(next(
                t for _, t in tree_leaves(tree)).device)}


def _job_save(mesh, dev, p: dict) -> dict:
    """The model of ``tree`` (or drawn from ``seed``) over the mesh, its
    whole tree gathered from the ranks' blocks and written to ``dir`` at
    step ``step`` by rank 0."""
    import torch
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.models import transformer
    cfg = _cfg(p)
    model = _draw(cfg, mesh, dev, p)
    specs = transformer.mesh_specs(cfg, mesh)
    tree = _whole_tree(cfg, dict(model.named_parameters()), mesh, specs)
    if mesh.rank == 0:
        ckpt.save(p["dir"], p.get("step", 1), tree)
    torch.distributed.barrier()
    return {"blocks": {n: list(t.shape) for n, t in model.named_parameters()
                       if "ffn" in n}}


def _job_shard(mesh, dev, p: dict) -> dict:
    """``shard_leaf`` of the whole array ``x`` under each of ``specs``
    (lists of entries): this rank's blocks."""
    import torch
    from repro_torch.distributed.mesh import Spec, shard_leaf
    x = torch.as_tensor(p["x"])
    return {"coords": mesh.coords, "blocks": [
        shard_leaf(mesh, x, Spec(*(tuple(e) if isinstance(e, list) else e
                                   for e in spec))).numpy()
        for spec in p["specs"]]}


def _job_many(mesh, dev, p: dict) -> list:
    """Each ``(job, payload)`` of ``jobs`` in turn, on one world, each on
    its payload's ``device`` where it names one."""
    import torch
    out = []
    for job, payload in p["jobs"]:
        mesh.axis_ledger.reset()
        d = torch.device(payload["device"]) if "device" in payload else dev
        out.append(_resolve(job)(mesh, d, payload))
    return out


JOBS = {"ep_fn": _job_ep_fn, "model": _job_model, "restore": _job_restore,
        "save": _job_save, "shard": _job_shard, "many": _job_many,
        "cell": _job_cell}


def _resolve(job):
    return JOBS[job] if isinstance(job, str) else job


# ---------------------------------------------------------------------------
# the world
# ---------------------------------------------------------------------------

def _rank_main(rank: int, world: int, init_file: str, shape: tuple,
               axes: tuple, device: str, job: str, payload: dict,
               group_timeout: int, out) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{init_file}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=group_timeout))
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(0)
            torch.backends.cuda.matmul.allow_tf32 = False
        from repro_torch.distributed.mesh import make_mesh
        mesh = make_mesh(shape, axes)
        res = _resolve(job)(mesh, dev, payload)
        from repro_torch.kernels.extract import kernel as ek
        from repro_torch.kernels.fused_cnf_join import kernel as ck
        from repro_torch.kernels.threshold_sweep import kernel as sk
        launches = {"cnf_join": ck.launches["cnf_join"],
                    "compact": ek.launches["compact"], **sk.launches}
        dist.barrier()
        dist.destroy_process_group()
        out.put((rank, {"result": res, "launches": launches}, None))
    except Exception as e:          # reported, and the world fails
        out.put((rank, None, f"{type(e).__name__}: {e}\n"
                             f"{traceback.format_exc()}"))


def run_world(shape: tuple, job: str, payload: dict, *, device: str = "cpu",
              axes: tuple = AXES, timeout: float = 600.0,
              launches: list = None, group_timeout: int = None) -> list:
    """Spawn the world of a ``shape`` mesh over ``axes`` (default
    ``("data", "model")``), run ``job`` (a name in ``JOBS``, or a
    module-level function the ranks can import) on every rank with
    ``payload`` and return the ranks' results in rank order.
    ``launches``, when given, receives each rank's launch counts of the
    join kernels (read as its job ends).  ``group_timeout``: the seconds
    the world's groups wait for a peer (default ``timeout`` - 10, within
    30..300)."""
    import torch.multiprocessing as mp
    n = int(np.prod(shape))
    tmp = tempfile.mkdtemp(prefix="ep_world_")
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    if group_timeout is None:
        group_timeout = int(max(30, min(300, timeout - 10)))
    procs = [ctx.Process(target=_rank_main, args=(
        r, n, os.path.join(tmp, "rendezvous"), tuple(shape), tuple(axes),
        device, job, payload, group_timeout, out)) for r in range(n)]
    for proc in procs:
        proc.start()
    got, errors = {}, {}
    t0 = time.time()
    try:
        while len(got) + len(errors) < n:
            left = timeout - (time.time() - t0)
            try:
                r, res, err = out.get(timeout=max(left, 0.1))
            except queue_mod.Empty:
                break
            if err is None:
                got[r] = res
            else:
                errors[r] = err
        for proc in procs:
            proc.join(timeout=max(1.0, timeout - (time.time() - t0)))
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
        shutil.rmtree(tmp, ignore_errors=True)
    missing = [r for r in range(n) if r not in got and r not in errors]
    if errors or missing:
        raise RuntimeError(
            f"world {tuple(shape)} job {getattr(job, '__name__', job)}: "
            f"ranks {sorted(errors)} failed, "
            f"{missing} reported nothing within {timeout:.0f} s\n"
            + "\n".join(f"rank {r}: {e}" for r, e in sorted(errors.items())))
    if launches is not None:
        launches.extend(got[r]["launches"] for r in range(n))
    return [got[r]["result"] for r in range(n)]
