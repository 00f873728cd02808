"""Mixture-of-Experts FFN: the reference's single-device path.

Per-token top-k routing (f32 logits and softmax, the Switch load-balance
term and the router z-loss), the chosen tokens gathered into fixed-capacity
per-expert buffers in order of arrival (a choice past ``capacity`` is
dropped), a SwiGLU per expert over its buffer, and the weighted outputs
combined back per token, plus the shared experts through a dense SwiGLU.

The combine is deterministic: where the reference scatter-adds the (E, C)
output rows into the tokens (``.at[tok_idx].add``, which on the CPU adds a
token's rows in slot order, ascending expert, in the compute dtype), the
port gathers each token's rows through a (T, k) map from the token to its
slots and adds them in ascending expert order in the compute dtype; a
dropped choice adds a zero row.  ``index_add_`` on CUDA adds with atomics,
in an order, and so to a bf16 sum, that changes from run to run.

The expert-parallel paths (``moe_ffn_ep*``, ``moe_block_sharded``) wait for
the model mesh (ROADMAP queue 1, item 6.6).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.common.config import ModelConfig, MoEConfig
from repro_torch.models.layers import DenseFFN, ParamDef, ParamTree, silu, swiglu


def moe_defs(cfg: ModelConfig) -> ParamTree:
    mo = cfg.moe
    d = cfg.d_model
    defs = {
        "router": ParamDef((d, mo.num_experts), (None, None), scale=0.1),
        "w_gate": ParamDef((mo.num_experts, d, mo.expert_d_ff), ("expert", "fsdp", None)),
        "w_up": ParamDef((mo.num_experts, d, mo.expert_d_ff), ("expert", "fsdp", None)),
        "w_down": ParamDef((mo.num_experts, mo.expert_d_ff, d), ("expert", None, "fsdp")),
    }
    if mo.num_shared_experts > 0:
        ff = mo.shared_d_ff * mo.num_shared_experts
        defs["shared"] = {
            "w_gate": ParamDef((d, ff), ("fsdp", None)),
            "w_up": ParamDef((d, ff), ("fsdp", None)),
            "w_down": ParamDef((ff, d), (None, "fsdp")),
        }
    return defs


def top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last dim: the k largest values, descending,
    and their indices, equal values taken lower index first
    (``torch.topk`` leaves the order of ties unspecified)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router(params, x_flat, mo: MoEConfig):
    """x_flat: (T, d) -> weights (T, k), ids (T, k), aux_loss scalar."""
    logits = torch.einsum("td,de->te", x_flat.float(), params["router"].float())
    # jax.nn.softmax op by op: exp(x - max) / sum
    e_x = torch.exp(logits - logits.amax(dim=-1, keepdim=True).detach())
    probs = e_x / torch.sum(e_x, dim=-1, keepdim=True)
    weights, ids = top_k(probs, mo.top_k)
    weights = weights / torch.clamp(torch.sum(weights, dim=-1, keepdim=True),
                                    min=1e-9)
    # load-balance loss (Switch): E * sum_e f_e * p_e, over every choice,
    # dropped ones too
    e = mo.num_experts
    counts = torch.bincount(ids.reshape(-1), minlength=e).float()
    frac_tokens = counts / torch.clamp(torch.sum(counts), min=1.0)
    frac_probs = torch.mean(probs, dim=0)
    aux = mo.router_aux_loss_coef * e * torch.sum(frac_tokens * frac_probs)
    aux = aux + mo.router_z_loss_coef * torch.mean(
        torch.logsumexp(logits, dim=-1) ** 2)
    return weights, ids, aux


def _expert_ffn(w_gate, w_up, w_down, x, compute_dtype):
    """x: (E, C, d); weights: (E, d, ff) / (E, ff, d)."""
    g = torch.einsum("ecd,edf->ecf", x, w_gate.to(compute_dtype))
    u = torch.einsum("ecd,edf->ecf", x, w_up.to(compute_dtype))
    return torch.einsum("ecf,efd->ecd", silu(g) * u, w_down.to(compute_dtype))


def _capacity_gather(x_flat, flat_ids, flat_w, num_buckets, capacity):
    """Gather token copies into (num_buckets, capacity, d) buffers.

    flat_ids / flat_w: (N,) the T tokens' k choices, token-major.  A
    choice's slot in its bucket is its order of arrival (a cumsum over the
    N choices); a choice at or past ``capacity`` is dropped.  Returns
    (buf, tok_idx, w_buf, slot): empty slots hold zeros and carry
    ``tok_idx == T``; ``slot`` (N,) is each choice's row in the flattened
    (num_buckets * capacity) buffer, ``num_buckets * capacity`` for a
    dropped one.
    """
    t, d = x_flat.shape
    n = flat_ids.shape[0]
    dev = x_flat.device
    onehot = nn.functional.one_hot(flat_ids, num_buckets)            # (N, B)
    pos = torch.sum((torch.cumsum(onehot, dim=0) - 1) * onehot, dim=1)  # (N,)
    valid = pos < capacity
    # slot -> choice (n where empty); the extra bucket takes the drops
    b_idx = torch.where(valid, flat_ids, num_buckets)
    p_idx = torch.where(valid, pos, 0)
    choice = torch.full((num_buckets + 1, capacity), n, dtype=torch.long,
                        device=dev)
    choice[b_idx, p_idx] = torch.arange(n, device=dev)
    choice = choice[:num_buckets]
    tok_idx = choice // (n // t)                         # n // k == t: empty
    buf = torch.cat([x_flat, x_flat.new_zeros(1, d)])[tok_idx]
    w_buf = torch.cat([flat_w, flat_w.new_zeros(1)])[choice]
    slot = torch.where(valid, flat_ids * capacity + pos,
                       num_buckets * capacity)
    return buf, tok_idx, w_buf, slot


def _combine(y, slot, ids):
    """out (T, d): each token's rows of ``y`` (E, C, d), added in ascending
    expert order in y's dtype, a dropped choice adding a zero row.
    slot: (T * k,) from ``_capacity_gather``; ids: (T, k)."""
    e, c, d = y.shape
    t, k = ids.shape
    rows = torch.cat([y.reshape(e * c, d), y.new_zeros(1, d)])
    # a token's k experts are distinct: argsort orders them ascending
    slot = torch.gather(slot.reshape(t, k), 1, torch.argsort(ids, dim=-1))
    out = rows[slot[:, 0]]
    for j in range(1, k):
        out = out + rows[slot[:, j]]
    return out


def moe_ffn_dense(params, x, cfg: ModelConfig, compute_dtype=torch.bfloat16,
                  stats: Optional[dict] = None):
    """Single-shard capacity-based MoE.  x: (B, S, d) -> (out, aux).  Every
    token of ``x`` is routed, left-pads too, and the capacity follows T =
    B * S.  ``stats``, when given, receives the router's ``ids`` (T, k),
    ``load`` (E,) the choices per expert, drops included, ``dropped`` the
    dropped choices (tensors on x's device; nothing is synchronised) and
    the ``capacity``."""
    mo = cfg.moe
    b, s, d = x.shape
    x_flat = x.reshape(-1, d)
    t = x_flat.shape[0]
    weights, ids, aux = _router(params, x_flat, mo)
    flat_ids = ids.reshape(-1)
    flat_w = weights.reshape(-1).to(compute_dtype)
    capacity = max(int(math.ceil(t * mo.top_k / mo.num_experts * mo.capacity_factor)), 4)
    buf, _, w_buf, slot = _capacity_gather(x_flat, flat_ids, flat_w,
                                           mo.num_experts, capacity)
    y = _expert_ffn(params["w_gate"], params["w_up"], params["w_down"], buf,
                    compute_dtype)
    y = y * w_buf[..., None]
    out = _combine(y, slot, ids).reshape(b, s, d)
    if mo.num_shared_experts > 0:
        sh = params["shared"]
        out = out + swiglu(x, sh["w_gate"], sh["w_up"], sh["w_down"],
                           compute_dtype)
    if stats is not None:
        with torch.no_grad():
            stats["ids"] = ids.detach()
            stats["load"] = torch.bincount(flat_ids, minlength=mo.num_experts)
            stats["dropped"] = torch.sum(slot == mo.num_experts * capacity)
            stats["capacity"] = capacity
    return out, aux


class MoEFFN(nn.Module):
    """``moe_ffn_dense`` over parameters named and shaped as the
    reference's MoE ``ffn`` subtree: ``router`` (d, E), ``w_gate`` /
    ``w_up`` (E, d, ff), ``w_down`` (E, ff, d) and, with shared experts,
    ``shared.{w_gate,w_up,w_down}``.  ``stats`` holds the last call's
    routing (``moe_ffn_dense``'s ``stats``)."""

    # read in f32 by the router whatever the compute dtype: ServeEngine
    # leaves it uncast
    keep_f32 = ("router",)

    def __init__(self, cfg: ModelConfig, weights: dict,
                 compute_dtype: torch.dtype):
        super().__init__()
        for name in ("router", "w_gate", "w_up", "w_down"):
            setattr(self, name, nn.Parameter(weights[name]))
        self.shared = None
        if cfg.moe.num_shared_experts > 0:
            self.shared = DenseFFN({n: weights[f"shared.{n}"]
                                    for n in ("w_gate", "w_up", "w_down")},
                                   compute_dtype)
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.stats = {}

    def forward(self, x):
        params = {"router": self.router, "w_gate": self.w_gate,
                  "w_up": self.w_up, "w_down": self.w_down}
        if self.shared is not None:
            params["shared"] = {"w_gate": self.shared.w_gate,
                                "w_up": self.shared.w_up,
                                "w_down": self.shared.w_down}
        return moe_ffn_dense(params, x, self.cfg, self.compute_dtype,
                             stats=self.stats)
