"""Attention blocks: GQA with RoPE (ported); MLA and cross-attention wait
for their slices (ROADMAP queue 1, item 6) and raise ``NotImplementedError``.

GQA runs in two modes, as in the reference:
  * full sequence (no cache): causal attention over the input;
  * with a cache: k/v are written into a fixed-capacity bf16 KV cache in
    place at ``index`` and the queries attend over the whole capacity,
    unwritten slots masked by the causal offset (prefill and decode).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.models.layers import ParamDef, ParamTree


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue 1, item 6)")


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S).  The half-split rotation (not
    interleaved), angles in f32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                 # (D/2,)
    angles = positions[..., None].float() * freqs          # (B, S, D/2)
    cos = torch.cos(angles)[..., None, :]                  # (B, S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
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
    scores = torch.einsum("bshgd,bthd->bhgst", q.float(), k.float())
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
    return out.reshape(b, s, h, d).to(v.dtype)


def gqa_attention(params, x, positions, cfg: ModelConfig,
                  cache: Optional[dict] = None,
                  compute_dtype=torch.bfloat16, valid_from=None):
    """params: ``wq``, ``wk``, ``wv``, ``wo``; x: (B, S, D); positions:
    (B, S).  cache: ``{"k", "v": (B, T, Hkv, hd), "index": int}``, written
    in place.  Returns (out, new_cache)."""
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
    # with a cache ``out`` is the cache's bf16: promote as JAX does
    wo = params["wo"].to(compute_dtype)
    dt = torch.promote_types(out.dtype, wo.dtype)
    out = torch.einsum("bshk,hkd->bsd", out.to(dt), wo.to(dt))
    return out, new_cache


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
    reference's ``attn`` subtree."""

    def __init__(self, cfg: ModelConfig, weights: dict,
                 compute_dtype: torch.dtype):
        super().__init__()
        for name in ("wq", "wk", "wv", "wo"):
            setattr(self, name, torch.nn.Parameter(weights[name]))
        self.cfg = cfg
        self.compute_dtype = compute_dtype

    def forward(self, x, positions, cache=None, valid_from=None):
        params = {"wq": self.wq, "wk": self.wk, "wv": self.wv, "wo": self.wo}
        return gqa_attention(params, x, positions, self.cfg, cache,
                             self.compute_dtype, valid_from=valid_from)


# ---------------------------------------------------------------------------
# not ported yet
# ---------------------------------------------------------------------------

def mla_defs(cfg: ModelConfig):
    raise not_ported("MLA attention")


def mla_attention(*args, **kwargs):
    raise not_ported("MLA attention")


def mla_cache_defs(cfg: ModelConfig, batch: int, capacity: int):
    raise not_ported("MLA attention")


def cross_attn_defs(cfg: ModelConfig):
    raise not_ported("cross-attention")


def cross_attention(*args, **kwargs):
    raise not_ported("cross-attention")
