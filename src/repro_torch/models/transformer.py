"""Causal LM of the model zoo: the dense GQA transformers.

The parameter tree keeps the reference's layout: the layer stack is
decomposed into *segments*, a prefix of ``num_layers % period`` layers and
``num_layers // period`` scanned repetitions of the block-pattern period,
whose leaves carry a leading ``n_periods`` axis.  ``Transformer`` holds the
same weights unstacked, one ``Block`` a layer in layer order, and runs
them in a Python loop; ``weights_from_tree`` and ``tree_from_weights`` map
between the two layouts.  ``scan_layers`` changes nothing; ``remat``
checkpoints each block when gradients are taken (training), and changes
nothing at inference.

Only ``attn`` blocks with a dense (SwiGLU) FFN are ported, for serving and
training; MLA, cross-attention, MoE and the SSM blocks raise
``NotImplementedError`` (ROADMAP queue 1, item 6).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from repro_torch.common.config import BlockKind, FFNKind, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    DenseFFN, ParamDef, ParamTree, RMSNorm, count_tree, dense_ffn_defs,
    embedding_defs, init_tree, softcap, stack_defs, tree_leaves, tree_map,
)

_SSM = (BlockKind.MAMBA2.value, BlockKind.SLSTM.value, BlockKind.MLSTM.value)


# ---------------------------------------------------------------------------
# single block
# ---------------------------------------------------------------------------

def block_defs(cfg: ModelConfig, kind: str, ffn: str) -> ParamTree:
    d = cfg.d_model
    defs: ParamTree = {"ln1": ParamDef((d,), (None,), init="ones")}
    if kind == BlockKind.ATTN.value:
        defs["attn"] = attn.gqa_defs(cfg)
    elif kind == BlockKind.MLA.value:
        defs["attn"] = attn.mla_defs(cfg)
    elif kind == BlockKind.CROSS_ATTN.value:
        defs["attn"] = attn.cross_attn_defs(cfg)
    elif kind in _SSM:
        raise attn.not_ported(f"the {kind} block (models/ssm.py)")
    else:
        raise ValueError(kind)
    if ffn == FFNKind.DENSE.value and cfg.d_ff > 0:
        defs["ln2"] = ParamDef((d,), (None,), init="ones")
        defs["ffn"] = dense_ffn_defs(d, cfg.d_ff)
    elif ffn == FFNKind.MOE.value:
        raise attn.not_ported("the MoE FFN (models/moe.py)")
    return defs


def block_state_defs(cfg: ModelConfig, kind: str, batch: int, capacity: int) -> dict:
    if kind == BlockKind.ATTN.value:
        return attn.gqa_cache_defs(cfg, batch, capacity)
    if kind == BlockKind.MLA.value:
        return attn.mla_cache_defs(cfg, batch, capacity)
    if kind == BlockKind.CROSS_ATTN.value:
        return {}
    if kind in _SSM:
        raise attn.not_ported(f"the {kind} block's state (models/ssm.py)")
    raise ValueError(kind)


class Block(nn.Module):
    """Pre-norm residual block: ``ln1`` + GQA attention, then ``ln2`` +
    the dense FFN where the layer has one.  ``weights`` is keyed by the
    block's parameter names (``ln1.weight``, ``attn.wq``, ...)."""

    def __init__(self, cfg: ModelConfig, weights: dict,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.ln1 = RMSNorm(weights["ln1.weight"], cfg.norm_eps)
        self.attn = attn.GQAAttention(
            cfg, {n: weights[f"attn.{n}"] for n in ("wq", "wk", "wv", "wo")},
            compute_dtype)
        self.ffn = None
        if "ffn.w_gate" in weights:
            self.ln2 = RMSNorm(weights["ln2.weight"], cfg.norm_eps)
            self.ffn = DenseFFN({n: weights[f"ffn.{n}"]
                                 for n in ("w_gate", "w_up", "w_down")},
                                compute_dtype)

    def forward(self, x, positions, state=None, valid_from=None):
        h, new_state = self.attn(self.ln1(x), positions, state, valid_from)
        x = x + h
        if self.ffn is not None:
            x = x + self.ffn(self.ln2(x))
        return x, new_state


# ---------------------------------------------------------------------------
# segments: prefix + scanned periods (the reference's tree layout)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Segments:
    prefix: tuple          # tuple[(kind, ffn)] unrolled layers
    period: tuple          # tuple[(kind, ffn)] one scanned period
    n_periods: int

    @property
    def layers(self) -> list:
        """Every layer's (kind, ffn), in layer order."""
        return list(self.prefix) + list(self.period) * self.n_periods


def plan_segments(cfg: ModelConfig) -> Segments:
    pattern = cfg.pattern
    ffns = [cfg._layer_ffn(k) for k in pattern]
    if cfg.moe is not None:
        step = cfg.moe.moe_layer_step
        for i in range(len(ffns)):
            if ffns[i] == FFNKind.MOE.value and (
                    i < cfg.moe.first_dense_layers or i % step != step - 1):
                ffns[i] = FFNKind.DENSE.value
    layers = tuple(zip(pattern, ffns))
    if not cfg.scan_layers:
        return Segments(prefix=layers, period=(), n_periods=0)
    p = len(cfg.block_pattern)
    if cfg.cross_attn_every:
        p = _lcm(p, cfg.cross_attn_every)
    if cfg.moe is not None and cfg.moe.moe_layer_step > 1:
        p = _lcm(p, cfg.moe.moe_layer_step)
    # find the longest suffix that is periodic with period p
    n = len(layers)
    n_periods = 0
    while n_periods < n // p:
        cand = n - (n_periods + 1) * p
        if cand < 0:
            break
        seg = layers[cand : cand + p]
        ok = all(layers[cand + j * p : cand + (j + 1) * p] == seg
                 for j in range(n_periods + 1))
        if not ok:
            break
        n_periods += 1
    if n_periods <= 1:
        return Segments(prefix=layers, period=(), n_periods=0)
    prefix_len = n - n_periods * p
    return Segments(prefix=layers[:prefix_len], period=layers[prefix_len : prefix_len + p],
                    n_periods=n_periods)


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


# ---------------------------------------------------------------------------
# parameter tree
# ---------------------------------------------------------------------------

def model_defs(cfg: ModelConfig) -> ParamTree:
    segs = plan_segments(cfg)
    defs: ParamTree = {
        "embed": embedding_defs(cfg.vocab_size, cfg.d_model),
        "ln_f": ParamDef((cfg.d_model,), (None,), init="ones"),
        "prefix": {str(i): block_defs(cfg, k, f) for i, (k, f) in enumerate(segs.prefix)},
    }
    if segs.n_periods:
        period_defs = {str(j): block_defs(cfg, k, f) for j, (k, f) in enumerate(segs.period)}
        defs["scanned"] = stack_defs(period_defs, segs.n_periods)
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((cfg.d_model, cfg.vocab_size), ("fsdp", "tp"), scale=1.0)
    if cfg.frontend_embed_dim:
        defs["frontend_proj"] = ParamDef(
            (cfg.frontend_embed_dim, cfg.d_model), (None, "fsdp"))
    if cfg.cross_attn_every > 0 and cfg.frontend_embed_dim:
        defs["memory_proj"] = ParamDef(
            (cfg.frontend_embed_dim, cfg.d_model), (None, "fsdp"))
    return defs


def count_params(cfg: ModelConfig) -> int:
    return count_tree(model_defs(cfg))


def active_param_count(cfg: ModelConfig) -> int:
    """Params touched per token (MoE: top_k routed + shared experts only)."""
    total = count_params(cfg)
    if cfg.moe is None:
        return total
    layers = plan_segments(cfg).layers
    n_moe = sum(1 for _, f in layers if f == FFNKind.MOE.value)
    mo = cfg.moe
    inactive = (mo.num_experts - mo.top_k) * 3 * cfg.d_model * mo.expert_d_ff
    return total - n_moe * inactive


def _port_name(prefix: str, leaf: tuple) -> str:
    # a norm is an RMSNorm module: its leaf is the module's ``weight``
    name = ".".join(leaf) + (".weight" if len(leaf) == 1
                             and leaf[0].startswith("ln") else "")
    return f"{prefix}.{name}" if prefix else name


def _leaf_names(path: tuple, segs: Segments) -> list:
    """The port's names of the reference leaf at ``path``: one, or one a
    period (in period order) for a ``scanned`` leaf."""
    if path[0] == "prefix":
        return [_port_name(f"layers.{path[1]}", path[2:])]
    if path[0] == "scanned":
        n_pre, per = len(segs.prefix), len(segs.period)
        return [_port_name(f"layers.{n_pre + p * per + int(path[1])}", path[2:])
                for p in range(segs.n_periods)]
    return [_port_name("", path)]


def reference_leaves(cfg: ModelConfig) -> list:
    """``(path, ParamDef, names)`` for every leaf of the reference's tree,
    in its leaf order (``jax.tree.flatten``: dict keys sorted at every
    level): the leaf's definition (a scanned leaf's has the leading
    ``n_periods`` axis) and the port's parameter names that hold it (one a
    layer, in period order, for a scanned leaf)."""
    segs = plan_segments(cfg)
    return [(path, d, _leaf_names(path, segs))
            for path, d in sorted(tree_leaves(model_defs(cfg)))]


def weights_from_tree(cfg: ModelConfig, tree: dict) -> dict:
    """The ``Transformer``'s weights, keyed by parameter name, from a tree
    of tensors in the reference's layout (``embed/embedding``, ``ln_f``,
    ``prefix/<i>/...``, ``scanned/<j>/...`` with a leading ``n_periods``
    axis, ``unembed`` when untied).  Scanned leaves are unstacked into
    views, one a layer.  A missing or surplus leaf, or a leaf whose shape
    is not the config's, raises ``ValueError``."""
    defs = dict(tree_leaves(model_defs(cfg)))
    got = dict(tree_leaves(tree))
    missing, surplus = sorted(set(defs) - set(got)), sorted(set(got) - set(defs))
    if missing or surplus:
        raise ValueError(f"{cfg.name}: parameter tree is missing "
                         f"{['/'.join(p) for p in missing]} and has surplus "
                         f"{['/'.join(p) for p in surplus]}")
    segs = plan_segments(cfg)
    out = {}
    for path, d in defs.items():
        a = got[path]
        if tuple(a.shape) != tuple(d.shape):
            raise ValueError(f"{cfg.name}: leaf {'/'.join(path)} has shape "
                             f"{tuple(a.shape)}, want {tuple(d.shape)}")
        names = _leaf_names(path, segs)
        if path[0] == "scanned":
            out.update((n, a[p]) for p, n in enumerate(names))
        else:
            out[names[0]] = a
    return out


def tree_from_weights(cfg: ModelConfig, weights: dict) -> dict:
    """The inverse of ``weights_from_tree``: a tree in the reference's
    layout (``prefix`` present, empty where the config has no prefix
    layers) from tensors keyed by parameter name.  A scanned leaf is its
    layers stacked on a new leading ``n_periods`` axis (a copy)."""
    segs, defs = plan_segments(cfg), model_defs(cfg)
    tree = tree_map(lambda d: None, defs)
    for path, _ in tree_leaves(defs):
        names = _leaf_names(path, segs)
        node = tree
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = (torch.stack([weights[n] for n in names])
                          if path[0] == "scanned" else weights[names[0]])
    return tree


# ---------------------------------------------------------------------------
# decode state
# ---------------------------------------------------------------------------

def state_defs(cfg: ModelConfig, batch: int, capacity: int) -> dict:
    """Per-layer decode state (KV cache) as the reference lays it out:
    ``(shape, logical, dtype)`` leaves, scanned ones stacked."""
    segs = plan_segments(cfg)
    out = {"prefix": {str(i): block_state_defs(cfg, k, batch, capacity)
                      for i, (k, _) in enumerate(segs.prefix)}}
    if segs.n_periods:
        out["scanned"] = {
            str(j): {name: ((segs.n_periods,) + sd[0], (None,) + tuple(sd[1]),
                            sd[2])
                     for name, sd in block_state_defs(cfg, k, batch,
                                                      capacity).items()}
            for j, (k, _) in enumerate(segs.period)}
    else:
        out["scanned"] = None
    return out


def init_state(cfg: ModelConfig, batch: int, capacity: int, device) -> list:
    """A zeroed decode state on ``device``: one dict a layer, in layer
    order (``state_defs``' leaves unstacked), ``index`` a Python int."""
    def mk(sd):
        return 0 if sd[0] == () else torch.zeros(
            sd[0], dtype=getattr(torch, sd[2]), device=device)
    return [{name: mk(sd) for name, sd in
             block_state_defs(cfg, k, batch, capacity).items()}
            for k, _ in plan_segments(cfg).layers]


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

class Transformer(nn.Module):
    """The embedding, the blocks in layer order, ``ln_f`` and the
    unembedding (the embedding's transpose when tied).  ``weights`` is
    keyed by parameter name (``weights_from_tree``)."""

    def __init__(self, cfg: ModelConfig, weights: dict):
        super().__init__()
        model_defs(cfg)                       # raises for unported kinds
        if cfg.frontend_embed_dim:
            raise attn.not_ported("the modality frontend (frontend_embed_dim)")
        self.cfg = cfg
        self.compute_dtype = getattr(torch, cfg.dtype)
        self.embed = nn.ParameterDict(
            {"embedding": nn.Parameter(weights["embed.embedding"])})
        self.layers = nn.ModuleList()
        for i in range(cfg.num_layers):
            pre = f"layers.{i}."
            self.layers.append(Block(
                cfg, {k[len(pre):]: v for k, v in weights.items()
                      if k.startswith(pre)}, self.compute_dtype))
        self.ln_f = RMSNorm(weights["ln_f.weight"], cfg.norm_eps)
        self.unembed = (None if cfg.tie_embeddings
                        else nn.Parameter(weights["unembed"]))

    def forward(self, tokens: torch.Tensor, positions: Optional[torch.Tensor] = None,
                state: Optional[list] = None, valid_from=None):
        """tokens: (B, S) int.  Returns (logits f32 (B, S, V), new_state,
        aux_loss).  With ``state`` (``init_state``) each layer writes its
        KV cache in place.  valid_from: optional (B,) int — positions below
        it are left-pads (serving batches), masked in attention.  With
        ``cfg.remat``, when gradients are taken and there is no state, each
        block is checkpointed (``_remat``)."""
        cdt = self.compute_dtype
        emb = self.embed["embedding"]
        x = nn.functional.embedding(tokens, emb).to(cdt)
        b, s = x.shape[:2]
        if positions is None:
            positions = torch.arange(s, device=x.device)[None].expand(b, s)
        remat = self.cfg.remat and state is None and torch.is_grad_enabled()
        new_state = [] if state is not None else None
        for i, blk in enumerate(self.layers):
            if remat:
                x, st = _remat(blk, self.cfg.remat_policy, x, positions,
                               valid_from)
            else:
                x, st = blk(x, positions,
                            state[i] if state is not None else None,
                            valid_from)
            if state is not None:
                new_state.append(st)
        x = self.ln_f(x)
        # the logits in the compute dtype, then f32 (as the reference)
        if self.unembed is None:
            logits = torch.matmul(x, emb.to(cdt).T)
        else:
            logits = torch.matmul(x, self.unembed.to(cdt))
        logits = softcap(logits.float(), self.cfg.logits_softcap)
        return logits, new_state, torch.zeros((), device=x.device)


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(blk: Block, policy: str, x, positions, valid_from):
    """``blk`` under activation checkpointing, as the reference's
    ``jax.checkpoint`` a block: ``nothing_saveable`` keeps only the block's
    inputs and recomputes the rest in the backward pass; any other policy
    (``dots_saveable``) also keeps the outputs of its matrix products."""
    kw = {} if policy == "nothing_saveable" else {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, _save_dots)}
    return checkpoint(blk, x, positions, None, valid_from,
                      use_reentrant=False, **kw)


def init_params(cfg: ModelConfig, generator: torch.Generator, device) -> Transformer:
    """A ``Transformer`` with weights drawn as the reference's
    ``init_params`` draws them (``ParamDef.initialize`` per leaf of the
    reference's tree) from ``generator``, which lives on ``device``."""
    return Transformer(cfg, weights_from_tree(
        cfg, init_tree(model_defs(cfg), generator, device)))
