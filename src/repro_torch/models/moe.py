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
in an order, and so to a bf16 sum, that changes from run to run.  The
expert-parallel paths combine the same way, in the order of the
reference's scatter there (its slot order: destination rank, then order of
arrival).

The expert-parallel paths run over a model mesh (``distributed/mesh.py``:
a ``JoinMesh`` made with ``make_mesh`` over ``("data", "model")`` or the
production axes), one process a rank: ``moe_ffn_ep`` (tokens sharded over
``model``, dispatched to the ranks of their experts by ``all_to_all``),
``moe_ffn_ep_replicated`` (tokens replicated over ``model``; each rank
computes its own experts' choices, ``psum``), ``moe_ffn_ep_replicated_
dsharded`` (decode without weight gathers: partial products on a d-slice,
``psum`` over ``fsdp``) and ``moe_block_sharded``, which does by hand what
the reference's ``shard_map`` does: it slices this rank's block of the
(replicated) activations, hands the body the rank's weight blocks
(``moe_param_specs``), all-gathers the output back and reduces ``aux``.
The collectives and their backward passes are ``distributed/
collectives.py``'s.  The reference's own faults on these paths, and what
the port does there (ROADMAP queue 3): at a decode it splits the tokens
over ``batch`` while the decode body's ``psum`` over ``fsdp``, which
shares ``data``, adds partial products of different tokens, and its
``pmean`` of ``aux`` over ``batch + fsdp`` names ``data`` twice (it
raises); the port keeps a decode's tokens whole over the ``fsdp`` axes,
so the ``psum`` adds one token's parts, and averages ``aux`` over the
axes its tokens are split on.  At ``model`` 1 the reference's
``shard_map`` cannot prove its outputs replicated (it raises; the port
runs the dense body).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.common.config import ModelConfig, MoEConfig
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.mesh import Spec
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
    N choices); a choice at or past ``capacity`` is dropped, and so is a
    choice of bucket ``num_buckets`` (out of range: the reference's
    scatter drops it).  Returns
    (buf, tok_idx, w_buf, slot): empty slots hold zeros and carry
    ``tok_idx == T``; ``slot`` (N,) is each choice's row in the flattened
    (num_buckets * capacity) buffer, ``num_buckets * capacity`` for a
    dropped one.
    """
    t, d = x_flat.shape
    n = flat_ids.shape[0]
    dev = x_flat.device
    onehot = nn.functional.one_hot(flat_ids, num_buckets + 1)[:, :num_buckets]
    pos = torch.sum((torch.cumsum(onehot, dim=0) - 1) * onehot, dim=1)  # (N,)
    valid = (pos < capacity) & (flat_ids < num_buckets)
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
    """out (T, d): each token's rows of ``y`` (B, C, d), added in slot
    order (ascending bucket, then position: the reference's scatter-add
    order; for experts as buckets, ascending expert) in y's dtype, a
    dropped choice adding a zero row after them.  slot: (T * k,) from
    ``_capacity_gather``; ids: the router's (T, k) choices."""
    e, c, d = y.shape
    t, k = ids.shape
    rows = torch.cat([y.reshape(e * c, d), y.new_zeros(1, d)])
    slot = torch.sort(slot.reshape(t, k), dim=1).values
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


# ---------------------------------------------------------------------------
# expert parallelism over a model mesh
# ---------------------------------------------------------------------------

def _place(values, slot, n: int):
    """(n,) with ``values[i]`` at ``slot[i]`` and zeros elsewhere; slot
    ``n`` (a dropped choice) is discarded.  Slots below ``n`` are unique."""
    out = values.new_zeros(n + 1)
    out[slot] = values
    return out[:n]


def _shared(params, x, compute_dtype):
    sh = params["shared"]
    return swiglu(x, sh["w_gate"], sh["w_up"], sh["w_down"], compute_dtype)


def _local_stats(stats, ids, num_experts, dropped, capacity):
    if stats is not None:
        with torch.no_grad():
            stats["ids"] = ids.detach()
            stats["load"] = torch.bincount(ids.reshape(-1),
                                           minlength=num_experts)
            stats["dropped"] = dropped
            stats["capacity"] = capacity


def moe_ffn_ep_replicated(params, x, cfg: ModelConfig, mesh,
                          axis_name: str = "model",
                          compute_dtype=torch.bfloat16,
                          stats: Optional[dict] = None):
    """EP path for token sets *replicated* over the expert axis: each rank
    routes every local token but keeps only the choices of its own experts
    (``w_gate`` etc. hold this rank's (E_loc, d, ff) block); the outputs
    are ``psum``-combined over the axis.  The reference's ``moe_ffn_ep_
    replicated``; its ``moe_block_sharded`` never takes it (a decode with
    ``model`` > 1 goes to ``moe_ffn_ep_replicated_dsharded``)."""
    mo = cfg.moe
    axes = (axis_name,)
    my = mesh.axis_index(axes)
    e_loc = params["w_gate"].shape[0]
    b, s, d = x.shape
    x_flat = x.reshape(-1, d)
    t = x_flat.shape[0]
    weights, ids, aux = _router(params, x_flat, mo)
    flat_ids = ids.reshape(-1)
    flat_w = weights.reshape(-1).to(compute_dtype)
    mine = (flat_ids // e_loc) == my
    local_ids = torch.where(mine, flat_ids % e_loc, e_loc)
    cap = max(int(math.ceil(t * mo.top_k / mo.num_experts * mo.capacity_factor)), 4)
    buf, _, w_buf, slot = _capacity_gather(x_flat, local_ids, flat_w, e_loc, cap)
    y = _expert_ffn(params["w_gate"], params["w_up"], params["w_down"], buf,
                    compute_dtype)
    y = y * w_buf[..., None]
    out = coll.psum(_combine(y, slot, ids), mesh, axes, "model")
    out = out.reshape(b, s, d)
    if mo.num_shared_experts > 0:
        out = out + _shared(params, x, compute_dtype)
    _local_stats(stats, ids, mo.num_experts,
                 torch.sum(mine & (slot == e_loc * cap)), cap)
    return out, aux


def moe_ffn_ep(params, x, cfg: ModelConfig, mesh, axis_name: str = "model",
               compute_dtype=torch.bfloat16, stats: Optional[dict] = None):
    """Expert-parallel MoE body.  x: (B_loc, S_loc, d), this rank's tokens;
    the expert weights this rank's (E_loc, d, ff) block; router and shared
    weights whole.  Each choice goes to a fixed-capacity buffer of its
    expert's rank (``send_cap`` a rank, order of arrival), the buffers are
    exchanged by ``all_to_all`` with each choice's local expert id and
    weight, bucketed again per local expert (``cap2``: an empty slot of a
    send buffer arrives as a choice of local expert 0 with weight 0 and
    takes a slot there, as in the reference), computed, and sent back.
    ``stats["dropped"]``: this rank's choices dropped at its send buffers
    and the received ones dropped at its experts."""
    mo = cfg.moe
    axes = (axis_name,)
    ways = mesh.axis_size(axes)
    e_loc = params["w_gate"].shape[0]
    b, s, d = x.shape
    x_flat = x.reshape(-1, d)
    t = x_flat.shape[0]
    weights, ids, aux = _router(params, x_flat, mo)
    flat_ids = ids.reshape(-1)
    flat_w = weights.reshape(-1).to(compute_dtype)

    # dispatch to destination ranks
    dest = flat_ids // e_loc
    send_cap = max(int(math.ceil(t * mo.top_k / ways * mo.capacity_factor)), 4)
    send, _, w_send, slot = _capacity_gather(x_flat, dest, flat_w, ways,
                                             send_cap)
    r = ways * send_cap
    le_send = _place((flat_ids % e_loc).to(torch.int32), slot, r)
    recv = coll.alltoall(send, mesh, axes, "model")
    le_recv = coll.alltoall(le_send.reshape(ways, send_cap), mesh, axes,
                            "model")
    w_recv = coll.alltoall(w_send, mesh, axes, "model")

    # local expert compute
    recv_flat = recv.reshape(r, d)
    le_flat = le_recv.reshape(r).long()
    w_flat = w_recv.reshape(r)
    cap2 = max(int(math.ceil(r / e_loc * mo.capacity_factor)), 4)
    ebuf, _, w_ebuf, slot2 = _capacity_gather(recv_flat, le_flat, w_flat,
                                              e_loc, cap2)
    y = _expert_ffn(params["w_gate"], params["w_up"], params["w_down"], ebuf,
                    compute_dtype)
    y = y * w_ebuf[..., None]
    # back to the receive layout: each received slot's row, or zeros
    y_recv = torch.cat([y.reshape(-1, d), y.new_zeros(1, d)])[slot2]
    y_send = coll.alltoall(y_recv.reshape(ways, send_cap, d), mesh, axes,
                           "model")

    # combine
    out = _combine(y_send, slot, ids).reshape(b, s, d)
    if mo.num_shared_experts > 0:
        out = out + _shared(params, x, compute_dtype)
    if stats is not None:
        dropped = (torch.sum(slot == r)
                   + torch.sum((w_flat != 0) & (slot2 == e_loc * cap2)))
        _local_stats(stats, ids, mo.num_experts, dropped, (send_cap, cap2))
    return out, aux


def moe_ffn_ep_replicated_dsharded(params, x, cfg: ModelConfig, mesh,
                                   axis_name, fsdp_axes,
                                   compute_dtype=torch.bfloat16,
                                   stats: Optional[dict] = None):
    """Decode-path EP without weight gathers.  The expert and shared
    weights stay sharded on their d_model dim over ``fsdp_axes``: each rank
    multiplies its d-slice of the (few) tokens by its slice of the weights,
    the partial gate and up products are ``psum``-ed over ``fsdp_axes`` in
    one call, the expert outputs over ``axis_name``, and the d-slices of
    the output all-gathered.  The tokens must be the same on every rank of
    ``fsdp_axes`` (the reference's ``moe_block_sharded`` hands it tokens
    sharded over ``batch``, which shares ``data`` with ``fsdp``: ROADMAP
    queue 3; the port's keeps them whole there)."""
    mo = cfg.moe
    axes = (axis_name,)
    fsdp_axes = tuple(fsdp_axes)
    my = mesh.axis_index(axes)
    e_loc, d_loc = params["w_gate"].shape[0], params["w_gate"].shape[1]
    b, s, d = x.shape
    x_flat = x.reshape(-1, d)
    t = x_flat.shape[0]
    weights, ids, aux = _router(params, x_flat, mo)
    flat_ids = ids.reshape(-1)
    flat_w = weights.reshape(-1).to(compute_dtype)
    mine = (flat_ids // e_loc) == my
    local_ids = torch.where(mine, flat_ids % e_loc, e_loc)
    cap = max(int(math.ceil(t * mo.top_k / mo.num_experts * mo.capacity_factor)), 4)

    # this rank's d-slice of the tokens (flattened fsdp index, data-major)
    fi = mesh.axis_index(fsdp_axes)
    x_loc = x_flat[:, fi * d_loc:(fi + 1) * d_loc]
    buf, _, w_buf, slot = _capacity_gather(x_loc.to(compute_dtype), local_ids,
                                           flat_w, e_loc, cap)
    g = torch.einsum("ecd,edf->ecf", buf, params["w_gate"].to(compute_dtype))
    u = torch.einsum("ecd,edf->ecf", buf, params["w_up"].to(compute_dtype))
    if fsdp_axes:
        gu = coll.psum(torch.stack([g, u]), mesh, fsdp_axes, "fsdp")
        g, u = gu[0], gu[1]
    h = silu(g) * u
    y = torch.einsum("ecf,efd->ecd", h, params["w_down"].to(compute_dtype))
    y = y * w_buf[..., None]                              # (E_loc, cap, d_loc)
    out_loc = coll.psum(_combine(y, slot, ids), mesh, axes, "model")

    if mo.num_shared_experts > 0:
        sh = params["shared"]
        xs = x_loc.to(compute_dtype)
        gs = torch.einsum("td,df->tf", xs, sh["w_gate"].to(compute_dtype))
        us = torch.einsum("td,df->tf", xs, sh["w_up"].to(compute_dtype))
        if fsdp_axes:
            gus = coll.psum(torch.stack([gs, us]), mesh, fsdp_axes, "fsdp")
            gs, us = gus[0], gus[1]
        ys = torch.einsum("tf,fd->td", silu(gs) * us,
                          sh["w_down"].to(compute_dtype))
        out_loc = out_loc + ys
    out = coll.gather(out_loc, mesh, fsdp_axes, 1, "fsdp") if fsdp_axes \
        else out_loc
    _local_stats(stats, ids, mo.num_experts,
                 torch.sum(mine & (slot == e_loc * cap)), cap)
    return out.reshape(b, s, d), aux


def _ways(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= mesh.shape.get(a, 1)
    return n


def _axspec(axes):
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def _gather(x, mesh, axes, dim):
    """The reference's ``_gather``: all-gathers over ``axes`` (the last
    first, so the result is in flattened order, the first axis major), here
    in one call over the tuple."""
    return coll.gather(x, mesh, tuple(axes), dim, "fsdp")


def moe_param_specs(env, shared: bool) -> dict:
    """``moe_block_sharded``'s spec of each leaf of the MoE ``ffn`` subtree:
    the router whole, the experts over ``model`` and their d_model dim over
    ``fsdp``, the shared experts' d_model dim over ``fsdp``."""
    fs = _axspec(env.fsdp)
    out = {"router": Spec(None, None), "w_gate": Spec("model", fs, None),
           "w_up": Spec("model", fs, None), "w_down": Spec("model", None, fs)}
    if shared:
        out["shared"] = {"w_gate": Spec(fs, None), "w_up": Spec(fs, None),
                         "w_down": Spec(None, fs)}
    return out


def moe_block_sharded(params, x, cfg: ModelConfig, mesh, env,
                      compute_dtype=torch.bfloat16,
                      stats: Optional[dict] = None):
    """The reference's ``shard_map`` wrapper, by hand.  ``params`` hold
    this rank's blocks (``moe_param_specs``); ``x`` (B, S, d) is whole on
    every rank.  This rank's block of x is taken by ``x_spec`` (the batch
    over ``env.batch`` where it divides -- at a decode only over the
    batch axes that are not ``fsdp`` axes, since the decode body sums
    partial products over ``fsdp`` --, the sequence over ``model`` when
    it divides and S > 1); FSDP-sharded weight dims are gathered in the
    compute dtype in the body; the body is the all-to-all path when the
    sequence is split over ``model`` (train, prefill), the decode path
    without weight gathers when it is not and ``model`` > 1, else the
    dense path; the output is all-gathered back to the whole (B, S, d) and
    ``aux`` is the ``pmean`` over the axes its tokens vary over.  The
    backward passes of the slicing and the gather are ``shard_map``'s
    (``collectives.shard_in`` / ``gather_out``), and each replicated
    weight's cotangent is summed over the axes it is replicated on
    (``collectives.pvary``)."""
    model_ways = mesh.shape.get("model", 1)
    b, s, d = x.shape
    sp_ok = s % model_ways == 0 and s >= model_ways and s > 1
    decode = (not sp_ok) and model_ways > 1
    fs = tuple(env.fsdp)
    bw = _ways(mesh, env.batch)
    batch_ax = env.batch if (b % max(bw, 1) == 0 and b >= bw) else ()
    if decode:
        # the decode body psums partial products over fsdp, so every fsdp
        # rank must hold the same tokens: the batch is not split over the
        # axes it shares with fsdp (the reference splits it, and its psum
        # adds different tokens: ROADMAP queue 3)
        batch_ax = tuple(a for a in batch_ax if a not in fs)
    x_spec = Spec(_axspec(batch_ax), "model" if sp_ok else None, None)
    labels = ("batch", "model", None, "replicas")
    pspec = moe_param_specs(env, "shared" in params)

    def enter(p, spec):
        rest = tuple(a for a in mesh.axis_names if a not in spec.all_axes())
        return coll.pvary(p, mesh, rest, "replicas")

    pl = {k: enter(v, pspec[k]) for k, v in params.items() if k != "shared"}
    if "shared" in params:
        pl["shared"] = {k: enter(v, pspec["shared"][k])
                        for k, v in params["shared"].items()}
    x_l = coll.shard_in(x, mesh, x_spec, labels)

    if decode:
        # decode: keep weights sharded; activation-flow partial sums
        out, aux = moe_ffn_ep_replicated_dsharded(
            pl, x_l, cfg, mesh, "model", fs, compute_dtype, stats)
        vary = tuple(batch_ax)      # aux varies only where the tokens do
    else:
        if fs:
            cdt = compute_dtype
            pl["w_gate"] = _gather(pl["w_gate"].to(cdt), mesh, fs, 1)
            pl["w_up"] = _gather(pl["w_up"].to(cdt), mesh, fs, 1)
            pl["w_down"] = _gather(pl["w_down"].to(cdt), mesh, fs, 2)
            if "shared" in pl:
                sh = pl["shared"]
                pl["shared"] = {
                    "w_gate": _gather(sh["w_gate"].to(cdt), mesh, fs, 0),
                    "w_up": _gather(sh["w_up"].to(cdt), mesh, fs, 0),
                    "w_down": _gather(sh["w_down"].to(cdt), mesh, fs, 1)}
        if sp_ok and model_ways > 1:
            out, aux = moe_ffn_ep(pl, x_l, cfg, mesh, "model", compute_dtype,
                                  stats)
            vary = tuple(batch_ax) + ("model",)
        elif model_ways > 1:
            out, aux = moe_ffn_ep_replicated(pl, x_l, cfg, mesh, "model",
                                             compute_dtype, stats)
            vary = tuple(batch_ax)
        else:
            out, aux = moe_ffn_dense(pl, x_l, cfg, compute_dtype, stats)
            vary = tuple(batch_ax)
    if vary:
        aux = coll.pmean(aux, mesh, vary,
                         "batch+model" if "model" in vary else "batch")
    out = coll.gather_out(out, mesh, x_spec, labels)
    return out, coll.replicated(aux, mesh.size)


class MoEFFN(nn.Module):
    """``moe_ffn_dense`` over parameters named and shaped as the
    reference's MoE ``ffn`` subtree: ``router`` (d, E), ``w_gate`` /
    ``w_up`` (E, d, ff), ``w_down`` (E, ff, d) and, with shared experts,
    ``shared.{w_gate,w_up,w_down}``.  ``stats`` holds the last call's
    routing (``moe_ffn_dense``'s ``stats``; on a mesh, this rank's).  On
    a model mesh the parameters hold this rank's blocks
    (``moe_param_specs``) and a call with ``use_ep`` runs
    ``moe_block_sharded``."""

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

    def forward(self, x, use_ep: bool = False, mesh=None, env=None):
        params = {"router": self.router, "w_gate": self.w_gate,
                  "w_up": self.w_up, "w_down": self.w_down}
        if self.shared is not None:
            params["shared"] = {"w_gate": self.shared.w_gate,
                                "w_up": self.shared.w_up,
                                "w_down": self.shared.w_down}
        if use_ep and mesh is not None:
            return moe_block_sharded(params, x, self.cfg, mesh, env,
                                     self.compute_dtype, stats=self.stats)
        return moe_ffn_dense(params, x, self.cfg, self.compute_dtype,
                             stats=self.stats)
