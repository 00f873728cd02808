"""Step functions: loss / train_step / prefill_step / decode_step.

Each step takes the ``Transformer`` where the reference takes its parameter
tree.  The serving steps run under ``torch.inference_mode``; the train step
takes gradients with ``torch.autograd`` and updates the model's parameters
and the optimizer state in place.  ``use_ep``, ``mesh`` and
``sp_constraint`` go to the forward as in the reference (an MoE model's
FFNs expert-parallel over a model mesh, ``Transformer.forward``).
"""

from __future__ import annotations

import torch
from torch.func import functional_call

from repro_torch.common.config import ModelConfig, TrainConfig
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.mesh import AxisEnv
from repro_torch.models import transformer
from repro_torch.models.layers import tree_leaves
from repro_torch.optim import adamw


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Token-mean CE.  logits: (B, S, V) f32, labels: (B, S) int (-1 =
    pad), written as the reference writes it (``F.cross_entropy`` rounds
    elsewhere)."""
    mask = labels >= 0
    safe = torch.clamp(labels, min=0).long()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (logz - ll) * mask
    return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1)


def loss_fn(model, batch: dict, params: dict = None, *, use_ep=False,
            mesh=None, sp_constraint=None):
    """(ce + aux, {"ce", "aux"}) of ``model`` on ``batch`` (``tokens``,
    ``labels``, and ``memory`` for the cross layers where the batch has
    one); with ``params`` (name -> tensor) the model runs on those tensors
    in place of its own parameters."""
    args = (batch["tokens"],)
    kw = {"memory": batch.get("memory"), "use_ep": use_ep, "mesh": mesh,
          "sp_constraint": sp_constraint}
    logits, _, aux = (model(*args, **kw) if params is None
                      else functional_call(model, params, args, kw))
    ce = cross_entropy(logits, batch["labels"])
    return ce + aux, {"ce": ce, "aux": aux}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, *, use_ep=False,
                    mesh=None, sp_constraint=None):
    """Returns train_step(model, opt_state, batch) -> (opt_state, metrics).

    The model's parameters and ``opt_state`` (``adamw.init_opt_state``) are
    updated in place; ``metrics`` holds ``ce``, ``aux``, ``loss``,
    ``grad_norm`` and ``lr`` as 0-dim tensors.  As the reference's:
    gradient accumulation over ``tcfg.microbatch`` rows (summed in order,
    then divided by the count), ``grads_dtype="bfloat16"`` (the gradient
    is taken with respect to bf16 copies of the parameters whose reference
    leaf is f32 and at least 2-D), ``grad_compression`` applied before the
    update.  A parameter the forward does not reach (``frontend_proj``
    under token ids, ``memory_proj`` without a memory) gets a zero
    gradient, as ``jax.grad`` gives it.

    Over a ``mesh`` of more than one rank every rank runs the step on the
    whole batch (with ``use_ep`` its MoE leaves hold its blocks,
    ``transformer.local_specs``; without, the model is whole on every
    rank).  So the gradient of a whole leaf is already the whole batch's,
    the same on every rank, and nothing reduces it (the reference's pjit
    splits the batch and sums them); a block keeps its own gradient; the
    global norm sums each block's squares over the axes it is sharded
    on.  ``grad_compression``
    ``int8`` needs a leaf's absmax over all its blocks and is refused for
    sharded leaves.
    """
    lr_fn = adamw.cosine_schedule(tcfg)
    leaves = transformer.reference_leaves(cfg)
    order = [n for _, _, names in leaves for n in names]
    bf16 = {n for _, d, names in leaves for n in names
            if tcfg.grads_dtype == "bfloat16" and len(d.shape) >= 2}
    world = mesh is not None and mesh.size > 1
    sharded = {}                 # name -> axes its block is sharded over
    if world and use_ep:
        specs = dict(tree_leaves(transformer.local_specs(
            cfg, AxisEnv.from_mesh(mesh))))
        sharded = {n: specs[path].all_axes() for path, _, names in leaves
                   for n in names if specs[path].all_axes()}
        if sharded and tcfg.grad_compression == "int8":
            raise ValueError("grad_compression int8 takes each leaf's absmax;"
                             " over expert blocks that needs a max across "
                             "ranks, which the model mesh does not do")
    fwd_kw = {"use_ep": use_ep, "mesh": mesh, "sp_constraint": sp_constraint}

    def train_step(model, opt_state, batch):
        params = dict(model.named_parameters())
        params = {n: params[n] for n in order}           # reference order
        diff = {n: (p.detach().to(torch.bfloat16).requires_grad_()
                    if n in bf16 and p.dtype == torch.float32 else p)
                for n, p in params.items()}
        for t in diff.values():
            t.grad = None
        b, mbs = batch["tokens"].shape[0], tcfg.microbatch
        nmb = b // mbs if mbs and mbs < b else 0
        with torch.enable_grad():
            for i in range(max(nmb, 1)):
                part = ({k: v[i * mbs:(i + 1) * mbs] for k, v in batch.items()}
                        if nmb else batch)
                loss_i, met_i = loss_fn(model, part, diff if bf16 else None,
                                        **fwd_kw)
                loss_i.backward()
                met_i = {k: v.detach() for k, v in met_i.items()}
                if i == 0:
                    loss, metrics = loss_i.detach(), met_i
                else:
                    loss = loss + loss_i.detach()
                    metrics = {k: metrics[k] + met_i[k] for k in metrics}
        grads = {}
        for n, t in diff.items():
            grads[n] = torch.zeros_like(t) if t.grad is None else t.grad
            t.grad = None
        if nmb:
            loss = loss / nmb
            metrics = {k: v / nmb for k, v in metrics.items()}
            for g in grads.values():
                g.div_(nmb)
        if tcfg.grad_compression != "none":
            for _, _, names in leaves:          # a reference leaf at a time
                _compress(grads, names, tcfg.grad_compression)
        norm = _global_norm(grads, sharded, mesh) if sharded else None
        _, opt_state, opt_metrics = adamw.adamw_update(
            params, grads, opt_state, tcfg, lr_fn, norm=norm)
        return opt_state, dict(metrics, loss=loss, **opt_metrics)

    return train_step


def _global_norm(grads: dict, sharded: dict, mesh) -> torch.Tensor:
    """The whole tree's norm: the whole leaves' f32 squares in order, then
    the blocks' squares summed over the axes each is sharded on."""
    with torch.no_grad():
        total = adamw.global_norm(
            {n: g for n, g in grads.items() if n not in sharded}) ** 2
        parts: dict = {}
        for n, axes in sharded.items():
            sq = torch.sum(torch.square(grads[n].float()))
            parts[axes] = parts.get(axes, 0) + sq
        for axes, sq in parts.items():
            total = total + coll.axis_all_reduce(sq, mesh, axes, "norm")
        return torch.sqrt(total)


def _compress(grads: dict, names: list, mode: str) -> None:
    """Quantize and dequantize, in ``grads``, the gradients of one
    reference leaf: a scanned leaf's layers are stacked, so that int8's
    absmax scale is the whole leaf's, as in the reference."""
    whole = grads[names[0]] if len(names) == 1 else torch.stack(
        [grads[n] for n in names])
    payload, deq = adamw.compress_grads({"g": whole}, mode)
    back = deq(payload)["g"]
    for i, n in enumerate(names):
        grads[n] = back if len(names) == 1 else back[i]


def make_prefill_step(cfg: ModelConfig, capacity: int, *, use_ep=False,
                      mesh=None, sp_constraint=None):
    """prefill_step(model, tokens[, valid_from, positions, memory]) ->
    (state, last_logits); ``state`` is the decode state from
    ``transformer.init_state`` (a KV cache of ``capacity`` slots, the SSM
    layers' zeros) on the tokens' device.  ``memory`` feeds the cross
    layers (the reference's ``prefill_step`` takes it third; here it is a
    keyword, after the serving engine's positional arguments)."""

    @torch.inference_mode()
    def prefill_step(model, tokens, valid_from=None, positions=None,
                     memory=None):
        b = tokens.shape[0]
        state = transformer.init_state(cfg, b, capacity, tokens.device)
        logits, new_state, _ = model(tokens, positions=positions, state=state,
                                     valid_from=valid_from, memory=memory,
                                     use_ep=use_ep, mesh=mesh,
                                     sp_constraint=sp_constraint)
        return new_state, logits[:, -1]

    return prefill_step


def make_decode_step(cfg: ModelConfig, *, use_ep=False, mesh=None):
    """decode_step(model, state, token, pos[, valid_from]) -> (state,
    logits); token: (B, 1) int; pos: (B, 1) positions.  The state's KV
    cache is written in place.  As the reference's, it passes no memory:
    a decode step's cross layers attend to zeros."""

    @torch.inference_mode()
    def decode_step(model, state, token, pos, valid_from=None):
        logits, new_state, _ = model(token, positions=pos, state=state,
                                     valid_from=valid_from, use_ep=use_ep,
                                     mesh=mesh)
        return new_state, logits[:, -1]

    return decode_step


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)
