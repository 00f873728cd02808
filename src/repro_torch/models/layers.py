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

from repro_torch.distributed import collectives as coll


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


def _swiglu_hidden(x: torch.Tensor, w_gate, w_up, compute_dtype):
    g = torch.einsum("...d,df->...f", x, w_gate.to(compute_dtype))
    u = torch.einsum("...d,df->...f", x, w_up.to(compute_dtype))
    return silu(g) * u


def swiglu(x: torch.Tensor, w_gate, w_up, w_down, compute_dtype) -> torch.Tensor:
    return torch.einsum("...f,fd->...d",
                        _swiglu_hidden(x, w_gate, w_up, compute_dtype),
                        w_down.to(compute_dtype))


def row_parallel_sum(part: torch.Tensor, mesh, env,
                     dtype: torch.dtype) -> torch.Tensor:
    """The sum over ``env.tp`` of this rank's f32 partial product (a
    row-split output projection's, its operands widened from ``dtype``,
    so unrounded), rounded once to ``dtype``: as a world of one's product
    accumulates in f32 and rounds once, but for the order of the f32
    additions.  Its cotangent is summed over ``tp`` too
    (``collectives.psum``)."""
    return coll.psum(part, mesh, env.tp, "tp").to(dtype)


def swiglu_tp(x: torch.Tensor, w: dict, compute_dtype, mesh,
              env) -> torch.Tensor:
    """``swiglu`` on this rank's blocks over a model mesh, the body of the
    train cell's sharded dense FFN: ``x`` (B_l, S, d) this rank's rows,
    ``w`` the blocks as this rank reads them (``read_blocks``: the
    ``fsdp`` dims gathered), ``w_gate`` / ``w_up`` (d, d_ff / tp) and
    ``w_down`` (d_ff / tp, d).  The rank computes its chunk of d_ff, and
    the partial products of ``w_down`` are summed over ``tp``
    (``row_parallel_sum``, the partials in f32)."""
    h = _swiglu_hidden(x, w["w_gate"], w["w_up"], compute_dtype)
    part = torch.einsum("...f,fd->...d", h.float(), w["w_down"].float())
    return row_parallel_sum(part, mesh, env, compute_dtype)


def read_dtype(module: nn.Module, name: str, compute_dtype) -> torch.dtype:
    """The dtype the forward reads ``module``'s leaf ``name`` in: the
    compute dtype for a weight of two or more dims, its own for a 0-d or
    1-D leaf and for one the module names in ``keep_f32`` (sLSTM's
    recurrence, the MoE router), which it reads in f32."""
    p = getattr(module, name)
    keep = getattr(module, "keep_f32", ())
    return p.dtype if p.dim() < 2 or name in keep else compute_dtype


def kept_block(module: nn.Module, name: str, d: ParamDef, mesh, env,
               dtype, local: tuple = ()) -> torch.Tensor:
    """``use_block``'s value for a call with a state (a prefill, a decode
    step), which takes no gradient, its gathers booked under ``weights``.
    The result is kept on the module until ``module``'s leaf ``name``
    changes (another tensor, or an in-place update), so the decode steps
    of a model gather its weights once: the gathers go through the host
    on the card."""
    kept = module.__dict__.setdefault("_kept", {})
    p = getattr(module, name)
    key = (p._version, p.data_ptr(), p.device, dtype)
    hit = kept.get((name, local))
    if hit is None or hit[0] is not p or hit[1] != key:
        with torch.no_grad():
            w = use_block(p.detach(), d, mesh, env, dtype, local, "weights")
        hit = kept[(name, local)] = (p, key, w)
    return hit[2]


def read_blocks(module: nn.Module, defs: dict, mesh, env, compute_dtype,
                local: tuple = (), keep: bool = False) -> dict:
    """The leaves of ``module`` that ``defs`` names as this rank's
    computation reads them over a model mesh, each in its ``read_dtype``
    with its sharded dims outside ``local`` gathered: ``use_block`` (the
    backward returns each block's gradient to its rank), or with
    ``keep`` (a call with a state) ``kept_block``, gathered once and
    kept."""
    if keep:
        return {n: kept_block(module, n, d, mesh, env,
                              read_dtype(module, n, compute_dtype), local)
                for n, d in defs.items()}
    return {n: use_block(getattr(module, n), d, mesh, env,
                         read_dtype(module, n, compute_dtype), local)
            for n, d in defs.items()}


def use_block(w: torch.Tensor, d: ParamDef, mesh, env, dtype,
              local: tuple = (), label: str = None) -> torch.Tensor:
    """A leaf as this rank's computation reads it over a model mesh of
    the train cell: ``w`` its block under ``d``'s ``param_specs`` spec,
    cast to ``dtype``, each sharded dim whose logical name is not in
    ``local`` gathered whole (the backward, a reduce-scatter, returns each
    block's share of the gradient to its rank).  The block is first
    marked replicated over the axes its spec leaves out
    (``collectives.pvary``): each of those ranks runs other rows of the
    batch, or other heads, so their gradients are summed.  Each gather is
    booked under ``label``, by default the dim's logical name."""
    spec = env.resolve(d.logical)
    rest = tuple(a for a in mesh.axis_names if a not in spec.all_axes())
    w = coll.pvary(w, mesh, rest, "replicas").to(dtype)
    for dim, name in enumerate(d.logical):
        if name is not None and name not in local and spec.axes(dim):
            w = coll.gather(w, mesh, spec.axes(dim), dim, label or name)
    return w


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
    ``ffn`` subtree), each cast to ``compute_dtype`` at use.  Over a model
    mesh the leaves hold this rank's ``param_specs`` blocks and
    ``forward_tp`` runs this rank's block (``swiglu_tp``; with ``keep``,
    a call with a state, the gathered blocks are kept)."""

    def __init__(self, weights: dict, compute_dtype: torch.dtype):
        super().__init__()
        for name in ("w_gate", "w_up", "w_down"):
            setattr(self, name, nn.Parameter(weights[name]))
        self.compute_dtype = compute_dtype

    def forward(self, x):
        return swiglu(x, self.w_gate, self.w_up, self.w_down,
                      self.compute_dtype)

    def forward_tp(self, x, mesh, env, keep=False):
        # the defs give the leaves' logical dims (their sizes unused)
        w = read_blocks(self, dense_ffn_defs(1, 1), mesh, env,
                        self.compute_dtype, ("tp",), keep)
        return swiglu_tp(x, w, self.compute_dtype, mesh, env)
