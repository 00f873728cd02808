"""Causal LM of the model zoo: every block kind and FFN of the reference.

The parameter tree keeps the reference's layout: the layer stack is
decomposed into *segments*, a prefix of ``num_layers % period`` layers and
``num_layers // period`` scanned repetitions of the block-pattern period,
whose leaves carry a leading ``n_periods`` axis.  ``Transformer`` holds the
same weights unstacked, one ``Block`` a layer in layer order, and runs
them in a Python loop; ``weights_from_tree`` and ``tree_from_weights`` map
between the two layouts.  ``scan_layers`` changes nothing; ``remat``
checkpoints each block when gradients are taken (training), and changes
nothing at inference.

``attn`` (GQA) and ``mla`` blocks with a dense (SwiGLU) or MoE FFN, the
gated ``cross_attn`` blocks over a memory, and the SSM blocks (``mamba2``,
``mlstm``, ``slstm``: no FFN) serve and train; the modality frontend feeds
(B, S, F) embeds through ``frontend_proj`` in place of token ids.  The
forward returns the MoE layers' aux losses summed as the reference sums
them.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from repro_torch.common.config import BlockKind, FFNKind, ModelConfig
from repro_torch.distributed.mesh import (AxisEnv, Spec, block_shape,
                                          block_slices)
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (
    DenseFFN, ParamDef, ParamTree, RMSNorm, abstract_tree, count_tree,
    dense_ffn_defs, embedding_defs, init_tree, softcap, spec_tree,
    stack_defs, tree_leaves, tree_map,
)

# the SSM kinds: (parameter defs, state defs, mixer module)
_SSM = {
    BlockKind.MAMBA2.value: (ssm_lib.mamba2_defs, ssm_lib.mamba2_state_defs,
                             ssm_lib.Mamba2Mixer),
    BlockKind.SLSTM.value: (ssm_lib.slstm_defs, ssm_lib.slstm_state_defs,
                            ssm_lib.SLSTMMixer),
    BlockKind.MLSTM.value: (ssm_lib.mlstm_defs, ssm_lib.mlstm_state_defs,
                            ssm_lib.MLSTMMixer),
}


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
        defs["mixer"] = _SSM[kind][0](cfg)
    else:
        raise ValueError(kind)
    if ffn == FFNKind.DENSE.value and cfg.d_ff > 0:
        defs["ln2"] = ParamDef((d,), (None,), init="ones")
        defs["ffn"] = dense_ffn_defs(d, cfg.d_ff)
    elif ffn == FFNKind.MOE.value:
        defs["ln2"] = ParamDef((d,), (None,), init="ones")
        defs["ffn"] = moe_lib.moe_defs(cfg)
    return defs


def block_state_defs(cfg: ModelConfig, kind: str, batch: int, capacity: int) -> dict:
    if kind == BlockKind.ATTN.value:
        return attn.gqa_cache_defs(cfg, batch, capacity)
    if kind == BlockKind.MLA.value:
        return attn.mla_cache_defs(cfg, batch, capacity)
    if kind == BlockKind.CROSS_ATTN.value:
        return {}
    if kind in _SSM:
        return _SSM[kind][1](cfg, batch)
    raise ValueError(kind)


def _sub(weights: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in weights.items()
            if k.startswith(prefix)}


class Block(nn.Module):
    """Pre-norm residual block of the layer's ``(kind, ffn)``: ``ln1`` +
    GQA (``attn``), MLA (``mla``) or cross-attention (``cross_attn``) as
    ``attn``, or an SSM ``mixer``; then ``ln2`` + the dense or MoE FFN
    where the layer has one.  ``weights`` is keyed by the block's
    parameter names (``ln1.weight``, ``attn.wq``, ``mixer.in_proj``,
    ``ffn.router``, ...).  The forward returns (x, new_state, aux), aux the
    MoE FFN's loss (None for any other block: the reference's zero), as
    the reference's ``block_forward``.  An SSM block's state is replaced
    each call, not written in place; a cross block's is passed through."""

    def __init__(self, cfg: ModelConfig, kind: str, ffn: str, weights: dict,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.kind = kind
        self.ln1 = RMSNorm(weights["ln1.weight"], cfg.norm_eps)
        if kind in _SSM:
            self.mixer = _SSM[kind][2](cfg, _sub(weights, "mixer."),
                                       compute_dtype)
        else:
            attn_cls = {BlockKind.ATTN.value: attn.GQAAttention,
                        BlockKind.MLA.value: attn.MLAAttention,
                        BlockKind.CROSS_ATTN.value: attn.CrossAttention}[kind]
            self.attn = attn_cls(cfg, _sub(weights, "attn."), compute_dtype)
        self.ffn = None
        if "ln2.weight" in weights:
            self.ln2 = RMSNorm(weights["ln2.weight"], cfg.norm_eps)
            ffn_w = _sub(weights, "ffn.")
            self.ffn = (moe_lib.MoEFFN(cfg, ffn_w, compute_dtype)
                        if ffn == FFNKind.MOE.value
                        else DenseFFN(ffn_w, compute_dtype))

    def forward(self, x, positions, state=None, valid_from=None, valid=None,
                memory=None, use_ep=False, mesh=None, env=None):
        """valid: (B, S) bool of a padded prefill (the SSM recurrences'
        identity steps); memory: (B, M, d) for a cross block, zeros
        (B, 1, d) when None, as in the reference.  With ``use_ep`` and a
        model ``mesh`` an MoE FFN runs ``moe_block_sharded`` (the
        reference's EP branch)."""
        h = self.ln1(x)
        new_state = state
        if self.kind == BlockKind.CROSS_ATTN.value:
            if memory is None:
                memory = x.new_zeros((x.shape[0], 1, x.shape[-1]))
            h = self.attn(h, memory)
        elif self.kind in _SSM:
            h, new_state = self.mixer(h, state, valid)
        else:
            h, new_state = self.attn(h, positions, state, valid_from)
        x = x + h
        aux = None
        if isinstance(self.ffn, moe_lib.MoEFFN):
            h, aux = self.ffn(self.ln2(x), use_ep, mesh, env)
            x = x + h
        elif self.ffn is not None:
            x = x + self.ffn(self.ln2(x))
        return x, new_state, aux


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


def param_specs(cfg: ModelConfig, env: AxisEnv) -> ParamTree:
    """The reference's ``param_specs``: every leaf's logical dims resolved
    on ``env`` (the layout its ``pjit`` gives the weights)."""
    return spec_tree(model_defs(cfg), env)


def abstract_params(cfg: ModelConfig) -> ParamTree:
    """Every leaf as a tensor on the ``meta`` device (shape and dtype, no
    storage): the reference's ``abstract_params``."""
    return abstract_tree(model_defs(cfg))


def local_specs(cfg: ModelConfig, env: AxisEnv) -> ParamTree:
    """The port's layout of the parameters over a model mesh: the leaves
    of each MoE ``ffn`` subtree as ``moe_block_sharded`` takes them
    (``moe.moe_param_specs``: experts over ``model`` and ``fsdp``, shared
    experts over ``fsdp``, a scanned leaf with its leading axis whole),
    every other leaf whole (``Spec`` of ``None``)."""
    specs = tree_map(lambda d: Spec(*([None] * len(d.shape))),
                     model_defs(cfg))
    if cfg.moe is None:
        return specs
    moe_spec = moe_lib.moe_param_specs(env, cfg.moe.num_shared_experts > 0)
    for seg in ("prefix", "scanned"):
        for blk in specs.get(seg, {}).values():
            if "router" not in blk.get("ffn", {}):
                continue
            lead = (None,) if seg == "scanned" else ()
            blk["ffn"] = tree_map(lambda sp: Spec(*lead, *sp), moe_spec)
    return specs


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


def weights_from_tree(cfg: ModelConfig, tree: dict, mesh=None) -> dict:
    """The ``Transformer``'s weights, keyed by parameter name, from a tree
    of tensors in the reference's layout (``embed/embedding``, ``ln_f``,
    ``prefix/<i>/...``, ``scanned/<j>/...`` with a leading ``n_periods``
    axis, ``unembed`` when untied).  Scanned leaves are unstacked into
    views, one a layer.  A missing or surplus leaf, or a leaf whose shape
    is not the config's, raises ``ValueError``.  With a model ``mesh`` the
    tree holds this rank's blocks (``local_specs``) and their shapes are
    checked."""
    defs = dict(tree_leaves(model_defs(cfg)))
    if mesh is not None:
        specs = dict(tree_leaves(local_specs(cfg, AxisEnv.from_mesh(mesh))))
        defs = {p: dataclasses.replace(d, shape=block_shape(
            mesh, d.shape, specs[p])) for p, d in defs.items()}
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
    """Per-layer decode state (KV cache, SSM state) as the reference lays
    it out: ``(shape, logical, dtype)`` leaves, scanned ones stacked."""
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


def _map_sd(fn, tree):
    """``fn`` over the ``(shape, logical, dtype)`` leaves of a
    ``state_defs`` tree (``None`` kept)."""
    if tree is None:
        return None
    return {k: _map_sd(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def state_specs(cfg: ModelConfig, env: AxisEnv, batch: int, capacity: int,
                batch_logical: Optional[str] = "batch") -> dict:
    """The decode state's specs on ``env``, the reference's
    ``state_specs``: ``batch_logical`` stands for each ``batch`` dim
    (``None`` replicates a batch that does not divide the batch axes)."""
    def mk(sd):
        return env.resolve(tuple(batch_logical if name == "batch" else name
                                 for name in sd[1]))
    return _map_sd(mk, state_defs(cfg, batch, capacity))


def abstract_state(cfg: ModelConfig, batch: int, capacity: int) -> dict:
    """The decode state's leaves as ``meta``-device tensors."""
    return _map_sd(lambda sd: torch.empty(sd[0], dtype=getattr(torch, sd[2]),
                                          device="meta"),
                   state_defs(cfg, batch, capacity))


def init_state(cfg: ModelConfig, batch: int, capacity: int, device) -> list:
    """A zeroed decode state on ``device``: one dict a layer, in layer
    order (``state_defs``' leaves unstacked), ``index`` a Python int.  An
    SSM layer's zeros are the prefill's initial state (mLSTM's m = 0,
    sLSTM's n = 0), as the reference's ``init_state``."""
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
    unembedding (the embedding's transpose when tied); with a modality
    frontend, ``frontend_proj`` (F, d) and, with cross layers, the
    ``memory_proj`` (F, d).  ``weights`` is keyed by parameter name
    (``weights_from_tree``)."""

    def __init__(self, cfg: ModelConfig, weights: dict):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = getattr(torch, cfg.dtype)
        self.embed = nn.ParameterDict(
            {"embedding": nn.Parameter(weights["embed.embedding"])})
        self.segments = plan_segments(cfg)
        self.layers = nn.ModuleList(
            Block(cfg, kind, ffn, _sub(weights, f"layers.{i}."),
                  self.compute_dtype)
            for i, (kind, ffn) in enumerate(self.segments.layers))
        self.ln_f = RMSNorm(weights["ln_f.weight"], cfg.norm_eps)
        self.unembed = (None if cfg.tie_embeddings
                        else nn.Parameter(weights["unembed"]))
        self.frontend_proj = self.memory_proj = None
        if cfg.frontend_embed_dim:
            self.frontend_proj = nn.Parameter(weights["frontend_proj"])
            if cfg.cross_attn_every > 0:
                self.memory_proj = nn.Parameter(weights["memory_proj"])

    def forward(self, tokens: torch.Tensor, positions: Optional[torch.Tensor] = None,
                state: Optional[list] = None, valid_from=None,
                memory: Optional[torch.Tensor] = None, use_ep: bool = False,
                mesh=None, sp_constraint: Optional[Callable] = None):
        """tokens: (B, S) int, or (B, S, F) frontend embeds.  Returns
        (logits f32 (B, S, V), new_state, aux_loss), the aux loss summed
        over the MoE layers as the reference sums it (the prefix's in
        order, then the scanned periods' sums).  With ``state``
        (``init_state``) each attention layer writes its cache in place
        and each SSM layer returns a new state.  valid_from: optional (B,)
        int — positions below it are left-pads (serving batches), masked
        in attention and identity in the SSM recurrences (a prefill's;
        a decode step's token is always real).  memory: optional (B, M, F)
        (projected once by ``memory_proj``; (B, M, d) without one) for the
        cross layers, which attend to zeros without it.  With
        ``cfg.remat``, when gradients are taken and there is no state, each
        block is checkpointed (``_remat``).  ``use_ep`` and ``mesh`` (a
        model mesh, ``distributed.mesh.make_mesh``) run the MoE FFNs
        expert-parallel (``moe.moe_block_sharded``: the model's MoE
        leaves hold this rank's blocks, ``init_params(mesh=)``); every
        other leaf is whole on every rank, which computes the rest of the
        model on the whole batch.  ``sp_constraint``, when given, is
        applied to the activations after the embedding and after each
        block, where the reference constrains their sharding."""
        cdt = self.compute_dtype
        emb = self.embed["embedding"]
        if tokens.ndim == 3:
            x = torch.einsum("bsf,fd->bsd", tokens.to(cdt),
                             self.frontend_proj.to(cdt))
        else:
            x = nn.functional.embedding(tokens, emb).to(cdt)
        if memory is not None and self.memory_proj is not None:
            memory = torch.einsum("bmf,fd->bmd", memory.to(cdt),
                                  self.memory_proj.to(cdt))
        b, s = x.shape[:2]
        if positions is None:
            positions = torch.arange(s, device=x.device)[None].expand(b, s)
        valid = None
        if valid_from is not None and s > 1:
            valid = (torch.arange(s, device=x.device)[None, :]
                     >= valid_from[:, None])
        if sp_constraint is not None:
            x = sp_constraint(x)
        env = AxisEnv.from_mesh(mesh) if mesh is not None else None
        remat = self.cfg.remat and state is None and torch.is_grad_enabled()
        new_state = [] if state is not None else None
        auxes = []
        for i, blk in enumerate(self.layers):
            if remat:
                x, st, aux = _remat(blk, self.cfg.remat_policy, x, positions,
                                    valid_from, valid, memory, use_ep, mesh,
                                    env)
            else:
                x, st, aux = blk(x, positions,
                                 state[i] if state is not None else None,
                                 valid_from, valid, memory, use_ep, mesh, env)
            if sp_constraint is not None:
                x = sp_constraint(x)
            auxes.append(aux)
            if state is not None:
                new_state.append(st)
        x = self.ln_f(x)
        # the logits in the compute dtype, then f32 (as the reference)
        if self.unembed is None:
            logits = torch.matmul(x, emb.to(cdt).T)
        else:
            logits = torch.matmul(x, self.unembed.to(cdt))
        logits = softcap(logits.float(), self.cfg.logits_softcap)
        return logits, new_state, self._aux_total(auxes, x.device)

    def _aux_total(self, auxes: list, device) -> torch.Tensor:
        """The prefix layers' aux added in order, then the sum over the
        scanned periods of each period's aux (its layers added in order):
        the reference's order of additions, its zeros (None here) left
        out, as adding them changes no bit."""
        segs = self.segments
        n_pre, per = len(segs.prefix), len(segs.period)
        total = torch.zeros((), device=device)
        for aux in auxes[:n_pre]:
            if aux is not None:
                total = total + aux
        periods = [_sum(auxes[n_pre + p * per:n_pre + (p + 1) * per])
                   for p in range(segs.n_periods)]
        if any(a is not None for a in periods):
            total = total + torch.sum(torch.stack(periods))
        return total


def _sum(auxes: list):
    """The non-None entries added in order, or None."""
    out = None
    for aux in auxes:
        if aux is not None:
            out = aux if out is None else out + aux
    return out


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(blk: Block, policy: str, x, positions, valid_from, valid, memory,
           use_ep=False, mesh=None, env=None):
    """``blk`` under activation checkpointing, as the reference's
    ``jax.checkpoint`` a block: ``nothing_saveable`` keeps only the block's
    inputs and recomputes the rest in the backward pass; any other policy
    (``dots_saveable``) also keeps the outputs of its matrix products.
    Returns the block's (x, state, aux)."""
    kw = {} if policy == "nothing_saveable" else {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, _save_dots)}
    return checkpoint(blk, x, positions, None, valid_from, valid, memory,
                      use_ep, mesh, env, use_reentrant=False, **kw)


def init_params(cfg: ModelConfig, generator: torch.Generator, device,
                mesh=None) -> Transformer:
    """A ``Transformer`` with weights drawn as the reference's
    ``init_params`` draws them (``ParamDef.initialize`` per leaf of the
    reference's tree) from ``generator``, which lives on ``device``.  Each
    leaf is drawn in f32 and rounded to ``cfg.param_dtype`` as it is drawn
    (the reference ignores ``param_dtype`` and keeps f32): a model too
    large for f32 on one card is drawn in bf16, leaf by leaf, with the
    values an f32 draw cast to bf16 would have.  On a model ``mesh`` each
    rank draws every leaf whole (the generator's sequence is the world-1
    one) and keeps its block (``local_specs``): the same weights as a
    world of one, each rank holding its share of the experts.  The peak is
    the kept blocks plus one whole leaf in f32."""
    defs = model_defs(cfg)
    blocks = None
    if mesh is not None:
        specs = local_specs(cfg, AxisEnv.from_mesh(mesh))
        blocks = _zip_map(lambda d, sp: block_slices(mesh, d.shape, sp),
                          defs, specs)
    return Transformer(cfg, weights_from_tree(
        cfg, init_tree(defs, generator, device, cfg.param_dtype, blocks),
        mesh))


def _zip_map(fn, a: dict, b: dict) -> dict:
    return {k: _zip_map(fn, v, b[k]) if isinstance(v, dict) else fn(v, b[k])
            for k, v in a.items()}
