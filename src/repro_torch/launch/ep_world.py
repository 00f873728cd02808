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
  * ``model``: a smoke MoE model over the mesh with ``use_ep``: a
    prefill, teacher-forced decode steps, and a train step;
  * ``restore``: a checkpoint restored onto the mesh;
  * ``save``: a model's tree gathered from the ranks' blocks and written
    by rank 0;
  * ``shard``: ``shard_leaf`` blocks of an array under several specs;
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
    """The payload's smoke config of ``arch`` with its ``dtype`` and
    ``capacity_factor`` overrides."""
    from repro_torch.configs import get_smoke
    cfg = get_smoke(p["arch"])
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


def _draw(cfg, mesh, dev, p: dict):
    """The model over the mesh: drawn from ``seed`` on the CPU and this
    rank's blocks kept, or this rank's blocks of the whole ``tree``
    (numpy, the reference's layout)."""
    import torch
    from repro_torch.distributed.mesh import AxisEnv, shard_leaf
    from repro_torch.models import transformer
    from repro_torch.models.transformer import _zip_map
    if p.get("tree") is not None:
        specs = transformer.local_specs(cfg, AxisEnv.from_mesh(mesh))
        tree = _zip_map(lambda a, s: shard_leaf(
            mesh, torch.as_tensor(a), s).clone().to(dev), p["tree"], specs)
        return transformer.Transformer(cfg, transformer.weights_from_tree(
            cfg, tree, mesh))
    return transformer.init_params(
        cfg, torch.Generator().manual_seed(p.get("seed", 0)), "cpu",
        mesh=mesh).to(dev)


def _job_model(mesh, dev, p: dict) -> dict:
    """An MoE model over the mesh with ``use_ep`` (``_draw``).
    ``prompt`` (B, S) prefilled into a cache of ``capacity`` slots, then
    each column of ``decode`` (B, n) decoded in turn (teacher-forced).
    ``train`` {tokens, labels}: one ``make_train_step(use_ep=True)`` step
    after (AdamW at ``TrainConfig()``).  Returns the prefill's last
    logits, every decode step's, the MoE layers' router ids and dropped
    choices a call (prefill calls first), the cache after the last step,
    the collective ledger of the prefill and decode, the train metrics and
    the optimizer's ``m`` gathered whole (the reference's tree)."""
    import torch
    from repro_torch.common.config import TrainConfig
    from repro_torch.distributed.mesh import AxisEnv
    from repro_torch.models import moe, steps, transformer
    from repro_torch.optim import adamw
    cfg = _cfg(p)
    model = _draw(cfg, mesh, dev, p)
    calls = []
    hooks = [b.ffn.register_forward_hook(lambda mod, i, o: calls.append(
        (mod.stats["ids"].cpu().numpy(), int(mod.stats["dropped"]))))
        for b in model.layers if isinstance(b.ffn, moe.MoEFFN)]
    mesh.axis_ledger.reset()
    prompt = torch.as_tensor(p["prompt"]).to(dev)
    b, s = prompt.shape
    prefill = steps.make_prefill_step(cfg, p.get("capacity", s + 16),
                                      use_ep=True, mesh=mesh)
    state, last = prefill(model, prompt)
    row = {"prefill_calls": len(calls), "prefill": _np(last)}
    decode = steps.make_decode_step(cfg, use_ep=True, mesh=mesh)
    toks = torch.as_tensor(p.get("decode", np.zeros((b, 0), np.int64))).to(dev)
    logits = []
    for j in range(toks.shape[1]):
        pos = torch.full((b, 1), s + j, dtype=torch.int32, device=dev)
        state, lg = decode(model, state, toks[:, j:j + 1], pos)
        logits.append(_np(lg))
    row["decode"] = np.stack(logits) if logits else None
    row["cache"] = [{n: _np(t) for n, t in layer.items()
                     if torch.is_tensor(t)} for layer in state]
    row["ledger"] = mesh.axis_ledger.summary()
    for h in hooks:
        h.remove()
    row["ids"] = [c[0] for c in calls]
    row["dropped"] = [c[1] for c in calls]
    del state
    if p.get("train") is not None:
        tcfg = TrainConfig()
        opt = adamw.init_opt_state(dict(model.named_parameters()))
        step = steps.make_train_step(cfg, tcfg, use_ep=True, mesh=mesh)
        batch = {k: torch.as_tensor(v).to(dev) for k, v in p["train"].items()}
        opt, met = step(model, opt, batch)
        row["metrics"] = {k: float(v) for k, v in met.items()}
        specs = transformer.local_specs(cfg, AxisEnv.from_mesh(mesh))
        row["m"] = _whole_tree(cfg, opt["m"], mesh, specs)
    return row


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
    from repro_torch.distributed.mesh import AxisEnv
    from repro_torch.models import transformer
    cfg = _cfg(p)
    model = _draw(cfg, mesh, dev, p)
    specs = transformer.local_specs(cfg, AxisEnv.from_mesh(mesh))
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
        "save": _job_save, "shard": _job_shard, "many": _job_many}


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
              launches: list = None) -> list:
    """Spawn the world of a ``shape`` mesh over ``axes`` (default
    ``("data", "model")``), run ``job`` (a name in ``JOBS``, or a
    module-level function the ranks can import) on every rank with
    ``payload`` and return the ranks' results in rank order.
    ``launches``, when given, receives each rank's launch counts of the
    join kernels (read as its job ends)."""
    import torch.multiprocessing as mp
    n = int(np.prod(shape))
    tmp = tempfile.mkdtemp(prefix="ep_world_")
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
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
