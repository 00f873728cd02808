"""AdamW with f32 moments, gradient clipping, a cosine schedule and optional
gradient compression, as the reference's ``optim/adamw.py`` computes them.

State = ``{"m", "v", "step"}``: ``m`` and ``v`` are flat dicts of f32
tensors keyed like the parameters, ``step`` an int32 0-dim tensor.  Every
tree here is a flat dict of tensors keyed by parameter name.  The schedule,
the bias corrections and ``lr`` are f32 tensors computed op by op in the
reference's order (``cosine_schedule`` says where ``lr`` may differ by an
ulp);
``torch.optim.AdamW`` divides ``sqrt(v) / sqrt(bc2) + eps`` and rounds
elsewhere, so it is not used.

``adamw_update`` works in place: it takes the global norm first, then for
each leaf in turn scales the gradient (the clip), updates ``m``, ``v`` and
the parameter in place and drops the gradient.  A step so never holds a
second full copy of the parameters, gradients or moments: one leaf-sized
scratch buffer at a time.
"""

from __future__ import annotations

import math

import torch

from repro_torch.common.config import TrainConfig


def cosine_schedule(cfg: TrainConfig):
    """lr(step): linear warmup to ``learning_rate``, then a cosine decay to
    a tenth of it at ``total_steps``; f32 math on a tensor step.

    The f32 ops are those the compiled reference runs: XLA folds the
    reference's ``learning_rate * step / warmup`` into ``step *
    (learning_rate / warmup)``, its division by ``total - warmup`` into a
    product with the f32 reciprocal, and the last product and sum into one
    fused multiply-add (emulated in f64), so the port computes those forms.
    The cosine of the f32 angle is the correctly rounded f32 value
    (computed in f64); the reference's is the host libm's ``cosf`` on the
    CPU, which differs from it for about 1 % of f32 arguments (torch's f32
    ``cos`` for about 5 %).  Past the warmup ``lr`` may so differ from the
    reference's by one ulp."""
    f32 = torch.float32
    warm_rate = (torch.tensor(cfg.learning_rate, dtype=f32)
                 / max(cfg.warmup_steps, 1))
    inv_span = 1 / torch.tensor(max(cfg.total_steps - cfg.warmup_steps, 1),
                                dtype=f32)
    # the f32 constants of 0.1 * lr + 0.9 * lr * 0.5 * (1 + cos), widened
    floor = float(torch.tensor(0.1 * cfg.learning_rate, dtype=f32))
    scale = float(torch.tensor(0.9 * cfg.learning_rate * 0.5, dtype=f32))

    def lr(step):
        step = torch.as_tensor(step).to(f32)
        warm = step * warm_rate.to(step.device)
        t = (step - cfg.warmup_steps) * inv_span.to(step.device)
        t = torch.clamp(t, 0.0, 1.0)
        cos_pt = torch.cos((t * math.pi).double()).to(f32)
        cos = ((1 + cos_pt).double() * scale + floor).to(f32)
        return torch.where(step < cfg.warmup_steps, warm, cos)
    return lr


def init_opt_state(params: dict) -> dict:
    """Zero f32 moments keyed like ``params`` and a zero int32 step, on the
    parameters' device."""
    dev = next(iter(params.values())).device
    return {
        "m": {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()},
        "v": {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum, leaf by leaf in the dict's order, of each leaf's
    f32 sum of squares."""
    total = 0
    with torch.no_grad():
        for g in tree.values():
            total = total + torch.sum(torch.square(g.float()))
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: dict, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, in f32, as a
    new dict; the norm).  ``adamw_update`` applies the same scale leaf by
    leaf in place instead."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return {n: g.float() * scale for n, g in grads.items()}, norm


def compress_grads(grads: dict, mode: str):
    """Quantize gradients for a cross-shard reduction.  Returns (payload,
    deq).  fp16: a cast; int8: per-leaf absmax symmetric quantization;
    'none' is the identity."""
    if mode == "none":
        return grads, lambda x: x
    if mode == "fp16":
        return ({n: g.to(torch.float16) for n, g in grads.items()},
                lambda t: {n: g.to(torch.float32) for n, g in t.items()})
    if mode == "int8":
        scales = {n: torch.clamp(torch.max(torch.abs(g.float())), min=1e-12) / 127.0
                  for n, g in grads.items()}
        q = {n: torch.clamp(torch.round(g.float() / scales[n]), -127, 127
                            ).to(torch.int8) for n, g in grads.items()}

        def deq(t):
            return {n: g.to(torch.float32) * scales[n] for n, g in t.items()}
        return q, deq
    raise ValueError(mode)


def adamw_update(params: dict, grads: dict, opt_state: dict, cfg: TrainConfig,
                 lr_fn=None, norm: torch.Tensor = None):
    """One AdamW step, in place.  Returns (params, opt_state, metrics), the
    first two being the objects passed in.

    ``grads`` is consumed: each gradient is scaled in place, reused as
    scratch and removed from the dict once its parameter is updated.  Per
    leaf, the reference's op order: ``m = b1*m + (1-b1)*g``, ``v = b2*v +
    (1-b2)*g^2``, ``p -= lr * (m/bc1 / (sqrt(v/bc2) + eps) + wd*p)``.
    ``norm``, when given, is the gradients' global norm (over a model mesh
    the whole tree's, not this rank's blocks')."""
    with torch.no_grad():
        gnorm = global_norm(grads) if norm is None else norm
        scale = _clip_scale(gnorm, cfg.grad_clip)
        opt_state["step"].add_(1)
        step = opt_state["step"].to(torch.float32)
        lr = (lr_fn or cosine_schedule(cfg))(opt_state["step"])
        b1, b2, eps, wd = cfg.b1, cfg.b2, cfg.eps, cfg.weight_decay
        bc1 = 1.0 - b1 ** step
        bc2 = 1.0 - b2 ** step
        for name, p in params.items():
            g = grads.pop(name).to(torch.float32)
            g.mul_(scale)
            m, v = opt_state["m"][name], opt_state["v"][name]
            t = torch.mul(g, 1 - b1)
            m.mul_(b1).add_(t)
            torch.square(g, out=t)
            v.mul_(b2).add_(t.mul_(1 - b2))
            torch.div(m, bc1, out=g)                 # mh
            torch.div(v, bc2, out=t)                 # vh
            g.div_(t.sqrt_().add_(eps))
            p32 = p if p.dtype == torch.float32 else p.float()
            g.add_(torch.mul(p32, wd, out=t)).mul_(lr)
            p32.sub_(g)
            if p32 is not p:
                p.copy_(p32)
            del g, t
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
