"""Core layer primitives: parameter definitions, norms, FFNs, embeddings.

Parameters are declared once as ``ParamDef`` (shape + logical dim names +
initializer); the same declaration yields materialized weights (whole,
or this rank's block of each leaf over a model mesh), a matching tree of
sharding specs (``spec_tree``), ``meta``-device stand-ins
(``abstract_tree``) and exact parameter counts, in the JAX package's tree
layout (``models/transformer`` maps that layout onto its modules).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple
    logical: tuple              # logical dim names, same length as shape
    init: str = "normal"        # normal | zeros | ones | scaled_normal
    scale: float = 1.0
    dtype: str = "float32"

    def initialize(self, generator: torch.Generator, device,
                   dtype: str = None, block: tuple = None) -> torch.Tensor:
        """``normal * scale / sqrt(fan_in)`` drawn from ``generator`` (which
        must live on ``device``), or zeros or ones.  ``fan_in`` is the first
        dim, as in the reference: for a scanned leaf that is the number of
        periods.  The draw and the scaling are f32 (in place: one f32
        scratch the size of the leaf), then rounded once to ``dtype``
        (default: the definition's), so a leaf drawn in bf16 equals the f32
        leaf cast to bf16.  With ``block`` (a slice a dim) the whole leaf is
        drawn, so the generator advances as for the whole, and only the
        block is kept, copied out of the f32 scratch."""
        dt = getattr(torch, dtype or self.dtype)
        shape = self.shape if block is None else tuple(
            sl.stop - sl.start for sl in block)
        if self.init == "zeros":
            return torch.zeros(shape, dtype=dt, device=device)
        if self.init == "ones":
            return torch.ones(shape, dtype=dt, device=device)
        fan_in = self.shape[0] if len(self.shape) > 1 else max(self.shape[0], 1)
        std = self.scale / math.sqrt(fan_in)
        x = torch.randn(self.shape, generator=generator, device=device,
                        dtype=torch.float32)
        x.mul_(std)
        if block is None:
            return x.to(dt)
        return torch.empty(shape, dtype=dt, device=device).copy_(x[block])


ParamTree = dict  # nested dict of ParamDef / tensors


def tree_leaves(tree: dict, prefix: tuple = ()):
    """``(path, leaf)`` for every non-dict leaf of a nested dict, depth
    first in insertion order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from tree_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def tree_map(fn, tree: dict) -> dict:
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def init_tree(defs: ParamTree, generator: torch.Generator, device,
              dtype: str = None, blocks: ParamTree = None) -> ParamTree:
    """Materialize a tree of ParamDef into tensors, drawn in leaf order,
    each leaf in ``dtype`` (default: its definition's) as it is drawn.
    ``blocks`` (the same tree of per-dim slices) keeps one block of each
    leaf: the values the whole draw has there."""
    if blocks is None:
        return tree_map(lambda d: d.initialize(generator, device, dtype), defs)
    return {k: init_tree(v, generator, device, dtype, blocks[k])
            if isinstance(v, dict)
            else v.initialize(generator, device, dtype, blocks[k])
            for k, v in defs.items()}


def spec_tree(defs: ParamTree, env) -> ParamTree:
    """Each leaf's logical dims resolved to a ``Spec`` on ``env`` (an
    ``AxisEnv``)."""
    return tree_map(lambda d: env.resolve(d.logical), defs)


def abstract_tree(defs: ParamTree) -> ParamTree:
    """Each leaf as a ``meta``-device tensor of its shape and dtype."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=getattr(torch, d.dtype),
                                          device="meta"), defs)


def count_tree(defs: ParamTree) -> int:
    return int(sum(int(np.prod(d.shape)) for _, d in tree_leaves(defs)))


def stack_defs(defs: ParamTree, n: int) -> ParamTree:
    """Prepend a scan (layers) dim to every ParamDef in the tree."""
    return tree_map(
        lambda d: ParamDef((n,) + d.shape, (None,) + d.logical, d.init,
                           d.scale, d.dtype), defs)


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The norm in f32, or in f64 under f64 compute."""
    dt = x.dtype
    hi = torch.promote_types(dt, torch.float32)
    x = x.to(hi)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.to(hi)).to(dt)


class _Silu(torch.autograd.Function):
    """g * logistic(g), the logistic op by op as the reference's graph has
    it (it lowers to 1 / (1 + exp(-g))), each op rounded to g's dtype: a
    fused silu rounds once, and in bf16 the port would no longer equal the
    reference run op by op.  The backward is the logistic's own, s (1 - s),
    as the reference differentiates it: differentiating the ops instead
    gives 0 * exp(-g) = 0 * inf = NaN below g = -88."""

    @staticmethod
    def forward(ctx, g):
        s = torch.reciprocal(1 + torch.exp(-g))
        ctx.save_for_backward(g, s)
        return g * s

    @staticmethod
    def backward(ctx, grad):
        g, s = ctx.saved_tensors
        return grad * s + grad * g * (s * (1 - s))


def silu(g: torch.Tensor) -> torch.Tensor:
    """silu with the reference's rounding and its finite gradient
    (``_Silu``)."""
    return _Silu.apply(g)


def swiglu(x: torch.Tensor, w_gate, w_up, w_down, compute_dtype) -> torch.Tensor:
    g = torch.einsum("...d,df->...f", x, w_gate.to(compute_dtype))
    u = torch.einsum("...d,df->...f", x, w_up.to(compute_dtype))
    return torch.einsum("...f,fd->...d", silu(g) * u, w_down.to(compute_dtype))


def dense_ffn_defs(d_model: int, d_ff: int) -> ParamTree:
    return {
        "w_gate": ParamDef((d_model, d_ff), ("fsdp", "tp")),
        "w_up": ParamDef((d_model, d_ff), ("fsdp", "tp")),
        "w_down": ParamDef((d_ff, d_model), ("tp", "fsdp")),
    }


def embedding_defs(vocab: int, d_model: int) -> ParamTree:
    return {"embedding": ParamDef((vocab, d_model), ("tp", "fsdp"), scale=1.0)}


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0.0:
        return logits
    return cap * torch.tanh(logits / cap)


# ---------------------------------------------------------------------------
# modules: parameters named and shaped as the reference's leaves
# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    """``rms_norm`` over a 1-D weight (the reference leaf ``ln1`` etc.)."""

    def __init__(self, weight: torch.Tensor, eps: float):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.eps = eps

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)


class DenseFFN(nn.Module):
    """SwiGLU over ``w_gate``, ``w_up``, ``w_down`` (the reference's
    ``ffn`` subtree), each cast to ``compute_dtype`` at use."""

    def __init__(self, weights: dict, compute_dtype: torch.dtype):
        super().__init__()
        for name in ("w_gate", "w_up", "w_down"):
            setattr(self, name, nn.Parameter(weights[name]))
        self.compute_dtype = compute_dtype

    def forward(self, x):
        return swiglu(x, self.w_gate, self.w_up, self.w_down,
                      self.compute_dtype)
