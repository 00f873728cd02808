"""Attention blocks: GQA with RoPE, DeepSeek-V2's multi-head latent
attention (MLA), and the gated cross-attention of the VLM layers.

GQA and MLA run in two modes, as in the reference:
  * full sequence (no cache): causal attention over the input;
  * with a cache: k/v (MLA: the latent ``ckv`` and the rope key ``kr``)
    are written into a fixed-capacity bf16 cache in place at ``index`` and
    the queries attend over the whole capacity, unwritten slots masked by
    the causal offset (prefill and decode).
Cross-attention keeps no state: each call attends, without a mask, over
the memory it is given.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.mesh import Spec, shard_leaf
from repro_torch.models.layers import (ParamDef, ParamTree, read_blocks,
                                       rms_norm, row_parallel_sum)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S).  The half-split rotation (not
    interleaved), angles in f32, the rotation in f32 (f64 under f64
    compute)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                 # (D/2,)
    angles = positions[..., None].float() * freqs          # (B, S, D/2)
    cos = torch.cos(angles)[..., None, :]                  # (B, S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.promote_types(x.dtype, torch.float32)),
                         2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------

def gqa_defs(cfg: ModelConfig) -> ParamTree:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {
        "wq": ParamDef((d, cfg.num_heads, hd), ("fsdp", "tp", None)),
        "wk": ParamDef((d, cfg.num_kv_heads, hd), ("fsdp", "tp", None)),
        "wv": ParamDef((d, cfg.num_kv_heads, hd), ("fsdp", "tp", None)),
        "wo": ParamDef((cfg.num_heads, hd, d), ("tp", None, "fsdp")),
    }


def _sdpa(q, k, v, *, causal: bool, q_offset: int, softcap: float = 0.0,
          valid_from=None, scores_dtype=None):
    """q: (B,S,H,D) k/v: (B,T,Hkv,D) with H = G*Hkv. Grouped causal attention.

    q_offset: position offset of q[.,0] relative to k[.,0] (decode).
    valid_from: optional (B,) int — key positions < valid_from[b] are
    masked (left-padded serving batches).  Masked scores are -1e30, not
    -inf: a slot whose every key is masked (an empty serving slot) must
    give finite probabilities.
    """
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    q = q.reshape(b, s, hkv, g, d)
    sdt = scores_dtype or torch.float32
    hi = torch.promote_types(q.dtype, torch.float32)    # f64 under f64
    scores = torch.einsum("bshgd,bthd->bhgst", q.to(hi), k.to(hi))
    scores = scores / math.sqrt(d)
    if softcap > 0.0:
        scores = softcap * torch.tanh(scores / softcap)
    if causal:
        qpos = torch.arange(s, device=q.device) + q_offset
        kpos = torch.arange(t, device=q.device)
        mask = (kpos[None, :] <= qpos[:, None])[None]            # (1, S, T)
        if valid_from is not None:
            mask = mask & (kpos[None, None, :] >= valid_from[:, None, None])
        scores = scores.masked_fill(~mask[:, None, None], -1e30)
    # probs materialized in sdt (bf16 halves one of the two S^2 planes)
    probs = torch.softmax(scores, dim=-1).to(sdt)
    out = torch.einsum("bhgst,bthd->bshgd", probs, v.to(sdt))
    # v's head dim (the reference reshapes to q's, and fails where they
    # differ: MLA's absorb=False path, ROADMAP queue 3)
    return out.reshape(b, s, h, v.shape[-1]).to(v.dtype)


def _gqa_heads(params, x, positions, cfg: ModelConfig, cache, compute_dtype,
               valid_from):
    """``gqa_attention`` up to the output projection: the heads' outputs
    (B, S, H, hd) and the new cache."""
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(compute_dtype))
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(compute_dtype))
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(compute_dtype))
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    sdt = getattr(torch, cfg.attn_scores_dtype)
    new_cache = None
    if cache is None:
        out = _sdpa(q, k, v, causal=True, q_offset=0, valid_from=valid_from,
                    scores_dtype=sdt)
    else:
        idx, s = cache["index"], x.shape[1]
        ck, cv = cache["k"], cache["v"]
        if idx + s > ck.shape[1]:
            raise ValueError(f"KV cache of capacity {ck.shape[1]} cannot "
                             f"take {s} tokens at index {idx}")
        ck[:, idx:idx + s] = k.to(ck.dtype)
        cv[:, idx:idx + s] = v.to(cv.dtype)
        # unwritten cache slots are masked by the causal offset
        out = _sdpa(q, ck, cv, causal=True, q_offset=idx,
                    valid_from=valid_from, scores_dtype=sdt)
        new_cache = {"k": ck, "v": cv, "index": idx + s}
    return out, new_cache


def gqa_attention(params, x, positions, cfg: ModelConfig,
                  cache: Optional[dict] = None,
                  compute_dtype=torch.bfloat16, valid_from=None):
    """params: ``wq``, ``wk``, ``wv``, ``wo``; x: (B, S, D); positions:
    (B, S).  cache: ``{"k", "v": (B, T, Hkv, hd), "index": int}``, written
    in place.  Returns (out, new_cache)."""
    out, new_cache = _gqa_heads(params, x, positions, cfg, cache,
                                compute_dtype, valid_from)
    # with a cache ``out`` is the cache's bf16: promote as JAX does
    wo = params["wo"].to(compute_dtype)
    dt = torch.promote_types(out.dtype, wo.dtype)
    out = torch.einsum("bshk,hkd->bsd", out.to(dt), wo.to(dt))
    return out, new_cache


def gqa_attention_tp(w, x, positions, cfg: ModelConfig, mesh, env,
                     compute_dtype=torch.bfloat16, valid_from=None,
                     cache: Optional[dict] = None):
    """``gqa_attention`` on this rank's blocks over a model mesh, the body
    of the train cell's sharded attention and of the decode cell's:
    ``w`` holds the ``param_specs`` blocks as this rank reads them
    (``read_blocks``: the ``fsdp`` dims gathered), ``wq`` / ``wk`` /
    ``wv`` (d, heads / tp, hd) and ``wo`` (heads / tp, hd, d); ``x``
    (B_l, S, d) is this rank's rows with d whole, ``positions`` and
    ``valid_from`` theirs.  The rank runs its contiguous chunk of query
    heads and of KV heads, whose group map ``h // g`` is the whole
    model's because ``tp`` divides the KV heads; the partial products of
    ``wo`` are summed over ``tp`` (``row_parallel_sum``, the partial
    products in f32).  ``cache`` is this rank's block of the KV cache
    (``state_specs``: its rows, its KV heads), ``{"k", "v": (B_l, T,
    Hkv / tp, hd), "index": int}``: the rank writes its heads' keys and
    values in place and attends over its block, so no rank reads another
    rank's KV heads.  Returns (out, new_cache)."""
    out, new_cache = _gqa_heads(w, x, positions, cfg, cache, compute_dtype,
                                valid_from)
    part = torch.einsum("bshk,hkd->bsd", out.float(), w["wo"].float())
    return row_parallel_sum(part, mesh, env, compute_dtype), new_cache


def gqa_cache_defs(cfg: ModelConfig, batch: int, capacity: int) -> dict:
    """The KV cache is bf16 whatever ``cfg.dtype`` is, as in the reference."""
    hd = cfg.resolved_head_dim
    shape = (batch, capacity, cfg.num_kv_heads, hd)
    return {
        "k": (shape, ("batch", None, "tp", None), "bfloat16"),
        "v": (shape, ("batch", None, "tp", None), "bfloat16"),
        "index": ((), (), "int32"),
    }


class GQAAttention(torch.nn.Module):
    """``gqa_attention`` over parameters named and shaped as the
    reference's ``attn`` subtree.  Over a model mesh they hold this
    rank's ``param_specs`` blocks and ``forward_tp`` runs this rank's
    heads (``gqa_attention_tp``; with a cache, against its block, the
    gathered weights kept)."""

    def __init__(self, cfg: ModelConfig, weights: dict,
                 compute_dtype: torch.dtype):
        super().__init__()
        for name in ("wq", "wk", "wv", "wo"):
            setattr(self, name, torch.nn.Parameter(weights[name]))
        self.cfg = cfg
        self.compute_dtype = compute_dtype

    def params(self) -> dict:
        return {"wq": self.wq, "wk": self.wk, "wv": self.wv, "wo": self.wo}

    def forward(self, x, positions, cache=None, valid_from=None):
        return gqa_attention(self.params(), x, positions, self.cfg, cache,
                             self.compute_dtype, valid_from=valid_from)

    def forward_tp(self, x, positions, mesh, env, valid_from=None,
                   cache=None):
        w = read_blocks(self, gqa_defs(self.cfg), mesh, env,
                        self.compute_dtype, ("tp",), cache is not None)
        return gqa_attention_tp(w, x, positions, self.cfg, mesh, env,
                                self.compute_dtype, valid_from, cache)


# ---------------------------------------------------------------------------
# MLA -- multi-head latent attention (DeepSeek-V2)
# ---------------------------------------------------------------------------

def mla_defs(cfg: ModelConfig) -> ParamTree:
    d, m = cfg.d_model, cfg.mla
    qd = m.qk_nope_head_dim + m.qk_rope_head_dim
    defs = {
        # latent KV down-projection + decoupled rope key
        "w_dkv": ParamDef((d, m.kv_lora_rank), ("fsdp", "tp")),
        "w_kr": ParamDef((d, m.qk_rope_head_dim), ("fsdp", None)),
        "kv_norm": ParamDef((m.kv_lora_rank,), (None,), init="ones"),
        # up-projections from latent to per-head K(nope)/V
        "w_uk": ParamDef((m.kv_lora_rank, cfg.num_heads, m.qk_nope_head_dim), (None, "tp", None)),
        "w_uv": ParamDef((m.kv_lora_rank, cfg.num_heads, m.v_head_dim), (None, "tp", None)),
        "wo": ParamDef((cfg.num_heads, m.v_head_dim, d), ("tp", None, "fsdp")),
    }
    if m.q_lora_rank:
        defs["w_dq"] = ParamDef((d, m.q_lora_rank), ("fsdp", "tp"))
        defs["q_norm"] = ParamDef((m.q_lora_rank,), (None,), init="ones")
        defs["w_uq"] = ParamDef((m.q_lora_rank, cfg.num_heads, qd), (None, "tp", None))
    else:
        defs["wq"] = ParamDef((d, cfg.num_heads, qd), ("fsdp", "tp", None))
    return defs


def _mla_q(params, x, cfg: ModelConfig, compute_dtype):
    m = cfg.mla
    if m.q_lora_rank:
        cq = torch.einsum("bsd,dr->bsr", x, params["w_dq"].to(compute_dtype))
        cq = rms_norm(cq, params["q_norm"], cfg.norm_eps)
        return torch.einsum("bsr,rhk->bshk", cq, params["w_uq"].to(compute_dtype))
    return torch.einsum("bsd,dhk->bshk", x, params["wq"].to(compute_dtype))


def _mla_heads(params, q, ckv, kr, cfg: ModelConfig, compute_dtype,
               q_offset: int, absorb: bool, valid_from):
    """MLA from the queries q (B, S, H, qd), rope applied to their rope
    part, the normalised latent ``ckv`` (B, T, R) and the rotated rope key
    ``kr`` (B, T, Dr) to the heads' outputs (B, S, H, v), over the heads
    of ``w_uk`` / ``w_uv`` (R, H, .)."""
    m = cfg.mla
    b, s, h = q.shape[:3]
    t = ckv.shape[1]
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    sdt = getattr(torch, cfg.attn_scores_dtype)
    w_uk = params["w_uk"].to(compute_dtype)
    w_uv = params["w_uv"].to(compute_dtype)
    if absorb:
        # fold W_uk into q: q_lat (B,S,H,R); scores = q_lat . ckv + q_rope . kr
        scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
        q_lat = torch.einsum("bshk,rhk->bshr", q_nope, w_uk)
        s_nope = torch.einsum("bshr,btr->bhst", q_lat.float(), ckv.float())
        s_rope = torch.einsum("bshk,btk->bhst", q_rope.float(), kr.float())
        scores = (s_nope + s_rope) * scale
        qpos = torch.arange(s, device=q.device) + q_offset
        kpos = torch.arange(t, device=q.device)
        mask = (kpos[None, :] <= qpos[:, None])[None]            # (1, S, T)
        if valid_from is not None:
            mask = mask & (kpos[None, None, :] >= valid_from[:, None, None])
        scores = scores.masked_fill(~mask[:, None], -1e30)
        probs = torch.softmax(scores, dim=-1).to(sdt)
        # out = probs @ V = probs @ (ckv W_uv): the combine in the latent too
        o_lat = torch.einsum("bhst,btr->bshr", probs, ckv.to(sdt))
        return torch.einsum("bshr,rhv->bshv", o_lat.to(compute_dtype), w_uv)
    # with a cache ckv and kr are its bf16: promote as JAX does
    dt = torch.promote_types(ckv.dtype, compute_dtype)
    k_nope = torch.einsum("btr,rhk->bthk", ckv.to(dt), w_uk.to(dt))
    v = torch.einsum("btr,rhv->bthv", ckv.to(dt), w_uv.to(dt))
    k = torch.cat([k_nope, kr[:, :, None, :].to(dt).expand(
        b, t, h, m.qk_rope_head_dim)], dim=-1)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    return _sdpa(qf, k, v, causal=True, q_offset=q_offset,
                 valid_from=valid_from, scores_dtype=sdt)


def _rope_q(q, positions, cfg: ModelConfig):
    """q (B, S, H, qd) with RoPE applied to its rope part."""
    n = cfg.mla.qk_nope_head_dim
    return torch.cat([q[..., :n], apply_rope(q[..., n:], positions,
                                             cfg.rope_theta)], dim=-1)


def _rope_k(kr, positions, cfg: ModelConfig):
    return apply_rope(kr[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]


def mla_attention(params, x, positions, cfg: ModelConfig,
                  cache: Optional[dict] = None, compute_dtype=torch.bfloat16,
                  absorb: bool = True, valid_from=None):
    """DeepSeek-V2 attention; the cache holds only the latent (kv_lora_rank)
    and the rope key (qk_rope_head_dim) of each token.

    cache: ``{"ckv": (B, T, R), "kr": (B, T, Dr), "index": int}``, written
    in place.  absorb=True scores the queries against the latent directly
    (W_uk folded into q, W_uv applied after the latent combine; the
    block's path); absorb=False materializes K and V per head (the paper's
    form).  Returns (out, new_cache)."""
    s = x.shape[1]
    q = _rope_q(_mla_q(params, x, cfg, compute_dtype), positions, cfg)
    ckv = torch.einsum("bsd,dr->bsr", x, params["w_dkv"].to(compute_dtype))
    ckv = rms_norm(ckv, params["kv_norm"], cfg.norm_eps)
    kr = _rope_k(torch.einsum("bsd,dk->bsk", x,
                              params["w_kr"].to(compute_dtype)),
                 positions, cfg)
    new_cache = None
    q_offset = 0
    if cache is not None:
        idx, c_kv, c_kr = cache["index"], cache["ckv"], cache["kr"]
        if idx + s > c_kv.shape[1]:
            raise ValueError(f"MLA cache of capacity {c_kv.shape[1]} cannot "
                             f"take {s} tokens at index {idx}")
        c_kv[:, idx:idx + s] = ckv.to(c_kv.dtype)
        c_kr[:, idx:idx + s] = kr.to(c_kr.dtype)
        ckv, kr, q_offset = c_kv, c_kr, idx
        new_cache = {"ckv": c_kv, "kr": c_kr, "index": idx + s}
    out = _mla_heads(params, q, ckv, kr, cfg, compute_dtype, q_offset,
                     absorb, valid_from)
    wo = params["wo"].to(compute_dtype)
    dt = torch.promote_types(out.dtype, wo.dtype)
    out = torch.einsum("bshv,hvd->bsd", out.to(dt), wo.to(dt))
    return out, new_cache


def mla_attention_tp(w, x, positions, cfg: ModelConfig, mesh, env,
                     compute_dtype=torch.bfloat16, valid_from=None,
                     cache: Optional[dict] = None):
    """``mla_attention`` (absorb=True) on this rank's blocks over a model
    mesh, the body of the train cell's sharded MLA and of the decode
    cell's: ``w`` the blocks as this rank reads them (``read_blocks``:
    every ``fsdp`` dim gathered; the norms whole), ``x`` (B_l, S, d) this
    rank's rows with d whole, ``positions`` and ``valid_from`` theirs.
    The heads run over ``tp``: ``w_uq`` / ``w_uk`` / ``w_uv`` (R, H / tp,
    .) and ``wq`` (d, H / tp, qd) are this rank's heads, and the partial
    products of ``wo`` (H / tp, v, d) are summed over ``tp``
    (``row_parallel_sum``).  The latent projections ``w_dkv`` / ``w_dq``
    (d, R / tp) give this rank's columns of the latent, which are
    gathered over ``tp`` into the whole (B_l, S, R) that ``kv_norm`` /
    ``q_norm`` normalise and every head reads: at the train cell's shapes
    that activation is smaller than the weights' ``tp`` dim, and its
    gather's backward (a reduce-scatter) sums the heads' cotangents.

    ``cache`` is this rank's block of the latent cache (``state_specs``):
    ``ckv`` (B_l, T, R / tp), its columns of the normalised latent, and
    ``kr`` (B_l, T, Dr) whole over ``tp``.  The new tokens' columns and
    rope keys are written in place at ``index``.  This rank's heads read
    every latent column of every cached token, so the written slots of
    the other ranks' columns are gathered for the call (booked under
    ``latent_cache``) and dropped after it: between calls each rank holds
    its columns alone (PERF.md weighs this against partial scores summed
    over ``tp``).  Returns (out, new_cache)."""
    cdt = compute_dtype

    def latent(proj, norm):
        part = torch.einsum("bsd,dr->bsr", x, w[proj])
        whole = coll.gather(part, mesh, env.tp, 2, "tp")
        return rms_norm(whole, w[norm], cfg.norm_eps)

    if cfg.mla.q_lora_rank:
        q = torch.einsum("bsr,rhk->bshk", latent("w_dq", "q_norm"),
                         w["w_uq"])
    else:
        q = torch.einsum("bsd,dhk->bshk", x, w["wq"])
    q = _rope_q(q, positions, cfg)
    ckv = latent("w_dkv", "kv_norm")
    kr = _rope_k(torch.einsum("bsd,dk->bsk", x, w["w_kr"]), positions, cfg)
    new_cache, q_offset = None, 0
    if cache is not None:
        idx, c_kv, c_kr = cache["index"], cache["ckv"], cache["kr"]
        s = x.shape[1]
        if idx + s > c_kv.shape[1]:
            raise ValueError(f"MLA cache of capacity {c_kv.shape[1]} cannot "
                             f"take {s} tokens at index {idx}")
        mine = shard_leaf(mesh, ckv, Spec(None, None, env.resolve(("tp",))[0]))
        c_kv[:, idx:idx + s] = mine.to(c_kv.dtype)
        c_kr[:, idx:idx + s] = kr.to(c_kr.dtype)
        ckv = ckv.to(c_kv.dtype)
        if idx:
            ckv = torch.cat([coll.gather(c_kv[:, :idx], mesh, env.tp, 2,
                                         "latent_cache"), ckv], dim=1)
        kr, q_offset = c_kr[:, :idx + s], idx
        new_cache = {"ckv": c_kv, "kr": c_kr, "index": idx + s}
    heads = {"w_uk": w["w_uk"], "w_uv": w["w_uv"]}
    out = _mla_heads(heads, q, ckv, kr, cfg, cdt, q_offset, True, valid_from)
    part = torch.einsum("bshv,hvd->bsd", out.float(), w["wo"].float())
    return row_parallel_sum(part, mesh, env, cdt), new_cache


def mla_cache_defs(cfg: ModelConfig, batch: int, capacity: int) -> dict:
    """The latent and rope-key cache, bf16 whatever ``cfg.dtype`` is."""
    m = cfg.mla
    return {
        "ckv": ((batch, capacity, m.kv_lora_rank), ("batch", None, "tp"), "bfloat16"),
        "kr": ((batch, capacity, m.qk_rope_head_dim), ("batch", None, None), "bfloat16"),
        "index": ((), (), "int32"),
    }


class MLAAttention(torch.nn.Module):
    """``mla_attention`` (absorb=True, as the reference's block calls it)
    over parameters named and shaped as the reference's MLA ``attn``
    subtree (``kv_norm`` and ``q_norm`` plain 1-D parameters).  Over a
    model mesh they hold this rank's ``param_specs`` blocks and
    ``forward_tp`` runs this rank's heads (``mla_attention_tp``; with a
    cache, against its block, the gathered weights kept)."""

    def __init__(self, cfg: ModelConfig, weights: dict,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.names = tuple(mla_defs(cfg))
        for name in self.names:
            setattr(self, name, torch.nn.Parameter(weights[name]))
        self.cfg = cfg
        self.compute_dtype = compute_dtype

    def params(self) -> dict:
        return {n: getattr(self, n) for n in self.names}

    def forward(self, x, positions, cache=None, valid_from=None):
        return mla_attention(self.params(), x, positions, self.cfg, cache,
                             self.compute_dtype, valid_from=valid_from)

    def forward_tp(self, x, positions, mesh, env, valid_from=None,
                   cache=None):
        w = read_blocks(self, mla_defs(self.cfg), mesh, env,
                        self.compute_dtype, ("tp",), cache is not None)
        return mla_attention_tp(w, x, positions, self.cfg, mesh, env,
                                self.compute_dtype, valid_from, cache)


# ---------------------------------------------------------------------------
# Cross-attention (VLM / audio memory)
# ---------------------------------------------------------------------------

def cross_attn_defs(cfg: ModelConfig) -> ParamTree:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {
        "wq": ParamDef((d, cfg.num_heads, hd), ("fsdp", "tp", None)),
        "wk": ParamDef((d, cfg.num_kv_heads, hd), ("fsdp", "tp", None)),
        "wv": ParamDef((d, cfg.num_kv_heads, hd), ("fsdp", "tp", None)),
        "wo": ParamDef((cfg.num_heads, hd, d), ("tp", None, "fsdp")),
        # 0 at init: a fresh cross layer adds nothing to the stream
        "gate": ParamDef((), (), init="zeros"),
    }


def cross_attention(params, x, memory, cfg: ModelConfig,
                    compute_dtype=torch.bfloat16):
    """Non-causal GQA of x (B, S, D) over ``memory`` (B, M, D), the
    precomputed patch or frame embeddings; the output scaled by
    tanh(gate), the gate read in f32."""
    out = _cross_heads(params, x, memory, compute_dtype)
    out = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(compute_dtype))
    return torch.tanh(params["gate"].float()).to(out.dtype) * out


def _cross_heads(params, x, memory, compute_dtype):
    mem = memory.to(compute_dtype)
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(compute_dtype))
    k = torch.einsum("bmd,dhk->bmhk", mem, params["wk"].to(compute_dtype))
    v = torch.einsum("bmd,dhk->bmhk", mem, params["wv"].to(compute_dtype))
    return _sdpa(q, k, v, causal=False, q_offset=0)


def cross_attention_tp(w, x, memory, cfg: ModelConfig, mesh, env,
                       compute_dtype=torch.bfloat16):
    """``cross_attention`` on this rank's blocks over a model mesh, the
    body of the train cell's sharded cross layer: ``gqa_attention_tp``'s
    heads over ``tp`` (``w`` the blocks as this rank reads them, ``wq`` /
    ``wk`` / ``wv`` / ``wo`` with ``fsdp`` gathered, the partial products
    of ``wo`` summed over ``tp``), its keys and values from ``memory``
    (B_l, M, d), this rank's rows of it as ``x`` (B_l, S, d) holds its
    rows, and no mask.  ``tanh(gate)`` scales the sum after it is rounded
    to the compute dtype, the reference's order; the 0-d ``gate`` is
    whole on every rank."""
    out = _cross_heads(w, x, memory, compute_dtype)
    part = torch.einsum("bshk,hkd->bsd", out.float(), w["wo"].float())
    out = row_parallel_sum(part, mesh, env, compute_dtype)
    return torch.tanh(w["gate"].float()).to(out.dtype) * out


class CrossAttention(torch.nn.Module):
    """``cross_attention`` over parameters named and shaped as the
    reference's cross ``attn`` subtree (``gate`` a 0-d parameter).  Over a
    model mesh they hold this rank's ``param_specs`` blocks and
    ``forward_tp`` runs this rank's heads (``cross_attention_tp``; with
    ``keep``, a call with a state, the gathered blocks kept)."""

    def __init__(self, cfg: ModelConfig, weights: dict,
                 compute_dtype: torch.dtype):
        super().__init__()
        for name in ("wq", "wk", "wv", "wo", "gate"):
            setattr(self, name, torch.nn.Parameter(weights[name]))
        self.cfg = cfg
        self.compute_dtype = compute_dtype

    def params(self) -> dict:
        return {"wq": self.wq, "wk": self.wk, "wv": self.wv, "wo": self.wo,
                "gate": self.gate}

    def forward(self, x, memory):
        return cross_attention(self.params(), x, memory, self.cfg,
                               self.compute_dtype)

    def forward_tp(self, x, memory, mesh, env, keep=False):
        w = read_blocks(self, cross_attn_defs(self.cfg), mesh, env,
                        self.compute_dtype, ("tp",), keep)
        return cross_attention_tp(w, x, memory, self.cfg, mesh, env,
                                  self.compute_dtype)
