"""State-space and recurrent blocks: Mamba2 (chunked SSD) and xLSTM's
mLSTM (stabilized, chunked) and sLSTM (a loop over time).

Training and prefill run the chunked-parallel forms: quadratic within a
fixed ``chunk``, a loop over the chunks carrying the state across them.
Decode runs the O(1) recurrent update.  All state math is f32; the
projections run in the compute dtype, as in the reference.  (Under a
float64 compute dtype, which only the tests' noise floors use, the state
math is f64 too.)

Every product of three or more operands is contracted pairwise, in the
order its comment gives, so that no intermediate is larger than
(B, nc, c, c, H): the reference's four-operand einsums, taken at once,
would build (B, nc, c, c, H, P) or (B, nc, c, H, P, Q) (8.6 GB each at
zamba2's and xlstm's training shapes).  The summation order differs from
XLA's either way.

The initial states are the reference's, two of them on purpose: a forward
without a state (training, the full forward) starts mLSTM's stabilizer at
m = -inf and sLSTM's normalizer at n = 1; a prefill starts from
``transformer.init_state``, all zeros (m = 0, n = 0).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.common.config import ModelConfig
from repro_torch.distributed.mesh import shard_leaf, unshard_leaf
from repro_torch.models.layers import (ParamDef, ParamTree, read_blocks,
                                       rms_norm, silu)


def _state_dtype(dtype: torch.dtype) -> torch.dtype:
    """f32 for the state math, f64 under f64 compute."""
    return torch.promote_types(dtype, torch.float32)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) at every x (``F.softplus``
    switches to x past its threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: -softplus(-x)."""
    return -_softplus(-x)


# ---------------------------------------------------------------------------
# Mamba2 (SSD), single B/C group
# ---------------------------------------------------------------------------

def _mamba_dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = s.num_heads or (d_in // s.head_dim)
    return d_in, nh, s.head_dim, s.state_dim


def mamba2_defs(cfg: ModelConfig) -> ParamTree:
    s = cfg.ssm
    d = cfg.d_model
    d_in, nh, p, n = _mamba_dims(cfg)
    conv_ch = d_in + 2 * n
    return {
        "in_proj": ParamDef((d, 2 * d_in + 2 * n + nh), ("fsdp", "tp")),
        "conv_w": ParamDef((s.conv_dim, conv_ch), (None, "tp"), scale=0.5),
        "conv_b": ParamDef((conv_ch,), ("tp",), init="zeros"),
        "A_log": ParamDef((nh,), (None,), init="ones"),
        "D": ParamDef((nh,), (None,), init="ones"),
        "dt_bias": ParamDef((nh,), (None,), init="zeros"),
        "norm": ParamDef((d_in,), ("tp",), init="ones"),
        "out_proj": ParamDef((d_in, d), ("tp", "fsdp")),
    }


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv.  x: (B, S, C), w: (K, C), state: (B, K-1, C)
    or None (zeros).  The K shifted products are added in order i = 0..K-1,
    op by op, as the reference's Python ``sum`` adds them (not
    ``F.conv1d``, which would round bf16 otherwise).  Returns (out, the
    last K-1 inputs as the new state)."""
    k, s = w.shape[0], x.shape[1]
    pad = (x.new_zeros((x.shape[0], k - 1, x.shape[2])) if state is None
           else state.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)
    out = xp[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i]
    new_state = xp[:, -(k - 1):] if k > 1 else pad[:, :0]
    return out + b, new_state


def _tril(c: int, device) -> torch.Tensor:
    return torch.ones((c, c), dtype=torch.bool, device=device).tril()


def _ssd_chunked(xh, dt, a_log, bmat, cmat, chunk, h0=None):
    """Chunked SSD scan.  xh: (B, S, H, P), dt: (B, S, H), bmat/cmat:
    (B, S, N), S a multiple of ``chunk``.  Returns y (B, S, H, P) and the
    last state (B, H, N, P)."""
    b, s, h, p = xh.shape
    n = bmat.shape[-1]
    nc, c = s // chunk, chunk
    f32 = _state_dtype(xh.dtype)
    xh = xh.to(f32).reshape(b, nc, c, h, p)
    dt = dt.to(f32).reshape(b, nc, c, h)
    bm = bmat.to(f32).reshape(b, nc, c, n)
    cm = cmat.to(f32).reshape(b, nc, c, n)
    a = -torch.exp(a_log.to(f32))                       # (H,) negative
    cum = torch.cumsum(dt * a, dim=2)                   # inclusive log-decay
    # intra-chunk: L[i, j] = exp(cum_i - cum_j) for i >= j, -inf masked
    # before the exp
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, nc, c_i, c_j, H)
    li = li.masked_fill(~_tril(c, xh.device)[None, None, :, :, None],
                        float("-inf"))
    scores = torch.einsum("bkin,bkjn->bkij", cm, bm)    # (B, nc, c, c)
    # y_intra = sum_j scores_ij L_ijh dt_jh x_jhp, as (scores L) then
    # (dt x), then one batched product over j
    w = scores[..., None] * torch.exp(li)               # (B, nc, c, c, H)
    y_intra = torch.einsum("bkijh,bkjhp->bkihp", w, dt[..., None] * xh)
    # chunk end states: sum_c (decay_to_end dt)_ch B_cn x_chp
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)   # (B, nc, c, H)
    state_k = torch.einsum("bkcn,bkchp->bkhnp", bm,
                           (decay_to_end * dt)[..., None] * xh)
    chunk_decay = torch.exp(cum[:, :, -1, :])           # (B, nc, H)
    h_prev = (torch.zeros((b, h, n, p), dtype=f32, device=xh.device)
              if h0 is None else h0.to(f32))
    prevs = []
    for k in range(nc):
        prevs.append(h_prev)
        h_prev = h_prev * chunk_decay[:, k, :, None, None] + state_k[:, k]
    h_prevs = torch.stack(prevs, dim=1)                 # (B, nc, H, N, P)
    # y_inter = (C h_prev) exp(cum)
    y_inter = (torch.einsum("bkcn,bkhnp->bkchp", cm, h_prevs)
               * torch.exp(cum)[..., None])
    return (y_intra + y_inter).reshape(b, s, h, p), h_prev


def mamba2_forward(params, x, cfg: ModelConfig, state=None,
                   compute_dtype=torch.bfloat16, valid=None):
    """x: (B, S, d).  state: None (train / full forward from zero) or
    ``{"conv": (B, K-1, C), "ssm": (B, H, N, P)}``: with S > 1 a prefill
    (chunked, from the state), with S == 1 the recurrent step.  valid:
    optional (B, S) bool; invalid (left-pad) steps are identity in the
    recurrence (their conv input and dt zeroed).  Returns (out, new state,
    replaced, not written in place)."""
    s_cfg = cfg.ssm
    d_in, nh, p, n = _mamba_dims(cfg)
    bsz, seq, _ = x.shape
    f32 = _state_dtype(compute_dtype)
    proj = torch.einsum("bsd,de->bse", x, params["in_proj"].to(compute_dtype))
    z, xr, bmat, cmat, dt = torch.split(proj, [d_in, d_in, n, n, nh], dim=-1)
    conv_in = torch.cat([xr, bmat, cmat], dim=-1)
    if valid is not None:
        # pads zeroed: the conv windows see exactly the zero boundary
        conv_in = conv_in * valid.to(conv_in.dtype)[:, :, None]
    conv_out, new_conv = _causal_conv(
        conv_in, params["conv_w"].to(compute_dtype),
        params["conv_b"].to(compute_dtype),
        None if state is None else state["conv"])
    conv_out = silu(conv_out)
    xr = conv_out[..., :d_in]
    bmat = conv_out[..., d_in:d_in + n]
    cmat = conv_out[..., d_in + n:]
    dt = _softplus(dt.to(f32) + params["dt_bias"].to(f32))
    if valid is not None:
        dt = dt * valid.to(f32)[:, :, None]
    xh = xr.reshape(bsz, seq, nh, p)

    if state is None or seq > 1:
        h0 = None if state is None else state["ssm"]
        pad = (-seq) % s_cfg.chunk          # a prefill computes whole chunks
        xh_p, dt_p, b_p, c_p = (F.pad(xh, (0, 0, 0, 0, 0, pad)),
                                F.pad(dt, (0, 0, 0, pad)),
                                F.pad(bmat, (0, 0, 0, pad)),
                                F.pad(cmat, (0, 0, 0, pad))) if pad else \
            (xh, dt, bmat, cmat)
        y, h_last = _ssd_chunked(xh_p, dt_p, params["A_log"], b_p, c_p,
                                 s_cfg.chunk, h0)
        y = y[:, :seq]
    else:
        # the recurrent single step
        h = state["ssm"].to(f32)                        # (B, H, N, P)
        a = -torch.exp(params["A_log"].to(f32))
        da = torch.exp(dt[:, 0] * a)                    # (B, H)
        # dt_h B_n x_hp, as (dt x) then the outer product with B
        upd = ((dt[:, 0, :, None] * xh[:, 0].to(f32))[:, :, None, :]
               * bmat[:, 0].to(f32)[:, None, :, None])
        h_last = h * da[:, :, None, None] + upd
        y = torch.einsum("bn,bhnp->bhp", cmat[:, 0].to(f32), h_last)[:, None]

    y = y + params["D"].to(f32)[None, None, :, None] * xh.to(f32)
    y = y.reshape(bsz, seq, d_in).to(compute_dtype)
    y = rms_norm(y * silu(z), params["norm"], cfg.norm_eps)
    out = torch.einsum("bse,ed->bsd", y, params["out_proj"].to(compute_dtype))
    return out, {"conv": new_conv.to(f32), "ssm": h_last}


def mamba2_state_defs(cfg: ModelConfig, batch: int) -> dict:
    s = cfg.ssm
    d_in, nh, p, n = _mamba_dims(cfg)
    return {
        "conv": ((batch, s.conv_dim - 1, d_in + 2 * n), ("batch", None, "tp"), "float32"),
        "ssm": ((batch, nh, n, p), ("batch", "tp", None, None), "float32"),
    }


# ---------------------------------------------------------------------------
# xLSTM -- mLSTM (matrix memory, chunked parallel) and sLSTM (a scan)
# ---------------------------------------------------------------------------

def _xlstm_dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = cfg.num_heads
    return d_in, nh, d_in // nh


def mlstm_defs(cfg: ModelConfig) -> ParamTree:
    d = cfg.d_model
    d_in, nh, p = _xlstm_dims(cfg)
    return {
        "w_up": ParamDef((d, 2 * d_in), ("fsdp", "tp")),
        "w_q": ParamDef((d_in, d_in), ("fsdp", "tp")),
        "w_k": ParamDef((d_in, d_in), ("fsdp", "tp")),
        "w_v": ParamDef((d_in, d_in), ("fsdp", "tp")),
        "w_if": ParamDef((d_in, 2 * nh), ("tp", None), scale=0.1),
        "b_if": ParamDef((2 * nh,), (None,), init="zeros"),
        "skip": ParamDef((d_in,), ("tp",), init="ones"),
        "norm": ParamDef((d_in,), ("tp",), init="ones"),
        "w_down": ParamDef((d_in, d), ("tp", "fsdp")),
    }


def _mlstm_chunked(q, k, v, ig, fg, chunk, state=None):
    """Stabilized chunked mLSTM.  q, k, v: (B, S, H, P); ig / fg: the raw
    gate pre-activations (B, S, H).  Returns y (B, S, H, P) and the state
    ``{"C": (B, H, P, P), "n": (B, H, P), "m": (B, H)}``."""
    b, s, h, p = q.shape
    nc, c = s // chunk, chunk
    f32 = _state_dtype(q.dtype)
    q, k, v = (t.to(f32).reshape(b, nc, c, h, p) for t in (q, k, v))
    logf = _log_sigmoid(fg.to(f32)).reshape(b, nc, c, h)
    logi = ig.to(f32).reshape(b, nc, c, h)
    cf = torch.cumsum(logf, dim=2)                      # inclusive
    # intra-chunk log weights D[i, j] = cf_i - cf_j + logi_j (i >= j),
    # -inf masked before any exp
    dmat = cf[:, :, :, None, :] - cf[:, :, None, :, :] + logi[:, :, None, :, :]
    dmat = dmat.masked_fill(~_tril(c, q.device)[None, None, :, :, None],
                            float("-inf"))
    # amax: a tie's gradient split evenly, as jnp.max splits it
    m_intra = torch.amax(dmat, dim=3)                   # (B, nc, c, H)
    if state is None:
        c_prev = torch.zeros((b, h, p, p), dtype=f32, device=q.device)
        n_prev = torch.zeros((b, h, p), dtype=f32, device=q.device)
        m_prev = torch.full((b, h), float("-inf"), dtype=f32, device=q.device)
    else:
        c_prev, n_prev, m_prev = (state[n].to(f32) for n in ("C", "n", "m"))

    # per-chunk summaries for the recurrence
    decay_to_end = cf[:, :, -1:, :] - cf + logi         # weight of j into the end state
    m_loc = torch.amax(decay_to_end, dim=2)             # (B, nc, H)
    w_end = torch.exp(decay_to_end - m_loc[:, :, None, :])
    # kv = sum_c w_end k v^T, as (w_end k) then one product over c
    kv = torch.einsum("bkchp,bkchq->bkhpq", w_end[..., None] * k, v)
    kn = torch.einsum("bkch,bkchp->bkhp", w_end, k)
    dec = cf[:, :, -1, :]
    prevs = []
    for i in range(nc):
        prevs.append((c_prev, n_prev, m_prev))
        # torch.maximum splits a tie's gradient evenly, as jnp.maximum
        m_new = torch.maximum(m_prev + dec[:, i], m_loc[:, i])
        scale_old = torch.exp(m_prev + dec[:, i] - m_new)[:, :, None]
        scale_loc = torch.exp(m_loc[:, i] - m_new)[:, :, None]
        c_prev = c_prev * scale_old[..., None] + kv[:, i] * scale_loc[..., None]
        n_prev = n_prev * scale_old + kn[:, i] * scale_loc
        m_prev = m_new
    c_prevs, n_prevs, m_prevs = (torch.stack(t, dim=1) for t in zip(*prevs))

    # intra + inter with a joint stabilizer
    m_inter = m_prevs[:, :, None, :] + cf               # (B, nc, c, H)
    m_tot = torch.maximum(torch.maximum(m_intra, m_inter),
                          torch.full((), -1e30, dtype=f32, device=q.device))
    w_intra = torch.exp(dmat - m_tot[:, :, :, None, :])  # (B, nc, c, c, H)
    w_inter = torch.exp(m_inter - m_tot)
    qs = q / math.sqrt(p)
    # scores and w_intra combined first, then one product over j with v
    sw = torch.einsum("bkihp,bkjhp->bkijh", qs, k) * w_intra
    y_intra = torch.einsum("bkijh,bkjhq->bkihq", sw, v)
    den_intra = torch.sum(sw, dim=3)
    # (q C_prev) and (q n_prev), each then scaled by w_inter
    y_inter = (torch.einsum("bkchp,bkhpq->bkchq", qs, c_prevs)
               * w_inter[..., None])
    den_inter = torch.einsum("bkchp,bkhp->bkch", qs, n_prevs) * w_inter
    den = torch.maximum(torch.abs(den_intra + den_inter), torch.exp(-m_tot))
    y = (y_intra + y_inter) / den[..., None]
    return y.reshape(b, s, h, p), {"C": c_prev, "n": n_prev, "m": m_prev}


def _mlstm_step(q, k, v, ig, fg, state):
    """One-token stabilized mLSTM update.  q, k, v: (B, H, P); ig / fg:
    (B, H)."""
    f32 = _state_dtype(q.dtype)
    q, k, v = q.to(f32), k.to(f32), v.to(f32)
    p = q.shape[-1]
    logf = _log_sigmoid(fg.to(f32))
    logi = ig.to(f32)
    c_p, n_p, m_p = (state[n].to(f32) for n in ("C", "n", "m"))
    m_new = torch.maximum(logf + m_p, logi)
    sf = torch.exp(logf + m_p - m_new)[..., None]
    si = torch.exp(logi - m_new)[..., None]
    c_new = c_p * sf[..., None] + si[..., None] * (k[..., :, None] * v[..., None, :])
    n_new = n_p * sf + si * k
    qs = q / math.sqrt(p)
    num = torch.einsum("bhp,bhpq->bhq", qs, c_new)
    den = torch.maximum(torch.abs(torch.einsum("bhp,bhp->bh", qs, n_new)),
                        torch.exp(-m_new))
    return num / den[..., None], {"C": c_new, "n": n_new, "m": m_new}


def mlstm_forward(params, x, cfg: ModelConfig, state=None,
                  compute_dtype=torch.bfloat16, valid=None):
    """mLSTM block.  x: (B, S, d).  valid: (B, S) bool; pads are identity
    (input gate -1e30, forget gate 30).  A prefill runs chunks of
    ``min(chunk, S)``, the last one padded."""
    d_in, nh, p = _xlstm_dims(cfg)
    b, s, _ = x.shape
    f32 = _state_dtype(compute_dtype)
    up = torch.einsum("bsd,de->bse", x, params["w_up"].to(compute_dtype))
    xm, z = torch.chunk(up, 2, dim=-1)
    q, k, v = (torch.einsum("bse,ef->bsf", xm, params[w].to(compute_dtype))
               .reshape(b, s, nh, p) for w in ("w_q", "w_k", "w_v"))
    gates = torch.einsum("bse,eg->bsg", xm, params["w_if"].to(compute_dtype))
    gates = gates.to(f32) + params["b_if"].to(f32)
    ig, fg = gates[..., :nh], gates[..., nh:]
    if valid is not None:
        vmask = valid[:, :, None]
        ig = torch.where(vmask, ig, -1e30)      # no input at pads
        fg = torch.where(vmask, fg, 30.0)       # no decay at pads

    if s == 1 and state is not None:
        y, new_state = _mlstm_step(q[:, 0], k[:, 0], v[:, 0], ig[:, 0],
                                   fg[:, 0], state)
        y = y[:, None]
    else:
        chunk = min(cfg.ssm.chunk if cfg.ssm else 256, s)
        pad = (-s) % chunk
        if pad:
            q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
            # pads: i -> 0 (no input), f -> 1 (no decay of the carried state)
            ig = F.pad(ig, (0, 0, 0, pad), value=-1e30)
            fg = F.pad(fg, (0, 0, 0, pad), value=30.0)
        y, new_state = _mlstm_chunked(q, k, v, ig, fg, chunk, state)
        y = y[:, :s]
    y = y.reshape(b, s, d_in).to(compute_dtype)
    y = y + params["skip"].to(compute_dtype)[None, None, :] * xm
    y = rms_norm(y, params["norm"], cfg.norm_eps)
    y = y * silu(z)
    out = torch.einsum("bse,ed->bsd", y, params["w_down"].to(compute_dtype))
    return out, new_state


def mlstm_state_defs(cfg: ModelConfig, batch: int) -> dict:
    _, nh, p = _xlstm_dims(cfg)
    return {
        "C": ((batch, nh, p, p), ("batch", None, "tp", None), "float32"),
        "n": ((batch, nh, p), ("batch", None, "tp"), "float32"),
        "m": ((batch, nh), ("batch", None), "float32"),
    }


def slstm_defs(cfg: ModelConfig) -> ParamTree:
    d = cfg.d_model
    nh = cfg.num_heads
    p = d // nh
    return {
        # tp on head_dim (always divisible), not on the small head count
        "w_in": ParamDef((d, 4, nh, p), ("fsdp", None, None, "tp")),
        "r": ParamDef((nh, p, 4, p), (None, "tp", None, None), scale=0.5),
        "b": ParamDef((4, nh, p), (None, None, "tp"), init="zeros"),
        "norm": ParamDef((d,), (None,), init="ones"),
        "w_out": ParamDef((d, d), ("fsdp", "tp")),
    }


def slstm_forward(params, x, cfg: ModelConfig, state=None,
                  compute_dtype=torch.bfloat16, valid=None):
    """sLSTM block: a Python loop over time, as the reference's
    ``lax.scan`` is a loop, about 20 small ops a step.  x: (B, S, d).  The
    recurrence weights ``r`` and ``b`` are read in f32 whatever the
    compute dtype.  valid: (B, S) bool; pads carry the state through."""
    d = cfg.d_model
    nh = cfg.num_heads
    p = d // nh
    b, s, _ = x.shape
    f32 = _state_dtype(compute_dtype)
    wx = torch.einsum("bsd,dghp->bsghp", x,
                      params["w_in"].to(compute_dtype)).to(f32)
    wx = wx + params["b"].to(f32)[None, None]
    r = params["r"].to(f32)
    if state is None:
        h = torch.zeros((b, nh, p), dtype=f32, device=x.device)
        c = torch.zeros_like(h)
        n = torch.ones_like(h)
        m = torch.zeros_like(h)
    else:
        h, c, n, m = (state[k].to(f32) for k in ("h", "c", "n", "m"))
    n_min = torch.full((), 1e-6, dtype=f32, device=x.device)
    hs = []
    for t in range(s):
        g = wx[:, t] + torch.einsum("bhp,hpgq->bghq", h, r)   # (B, 4, H, P)
        zt = torch.tanh(g[:, 0])
        it = g[:, 1]
        ot = torch.sigmoid(g[:, 3])
        lfm = _log_sigmoid(g[:, 2]) + m
        m_new = torch.maximum(lfm, it)
        i_s = torch.exp(it - m_new)
        f_s = torch.exp(lfm - m_new)
        c_new = f_s * c + i_s * zt
        n_new = torch.maximum(f_s * n + i_s, n_min)
        h_new = ot * c_new / n_new
        if valid is None:
            h, c, n, m = h_new, c_new, n_new, m_new
        else:
            vm = valid[:, t, None, None]                 # pads carry through
            h, c, n, m = (torch.where(vm, h_new, h), torch.where(vm, c_new, c),
                          torch.where(vm, n_new, n), torch.where(vm, m_new, m))
        hs.append(h)
    y = torch.stack(hs, dim=1).reshape(b, s, d).to(compute_dtype)
    y = rms_norm(y, params["norm"], cfg.norm_eps)
    out = torch.einsum("bsd,de->bse", y, params["w_out"].to(compute_dtype))
    return out, {"h": h, "c": c, "n": n, "m": m}


def slstm_state_defs(cfg: ModelConfig, batch: int) -> dict:
    nh = cfg.num_heads
    p = cfg.d_model // nh
    sd = ((batch, nh, p), ("batch", None, "tp"), "float32")
    return {"h": sd, "c": sd, "n": sd, "m": sd}


# ---------------------------------------------------------------------------
# modules: parameters named and shaped as the reference's ``mixer`` subtree
# ---------------------------------------------------------------------------

class _Mixer(nn.Module):
    """A block's ``mixer``: its forward over parameters named as the
    reference's leaves.  forward(x, state=None, valid=None) -> (out, new
    state).

    Over a model mesh the leaves hold this rank's ``param_specs`` blocks.
    No split of a mixer's work follows them: Mamba2's ``tp`` block of
    ``in_proj`` cuts across the packed z | x | B | C | dt and its gated
    norm runs over the whole d_in; mLSTM's ``w_up`` block is the x or the
    z half, its norm over the whole d_in; sLSTM's ``tp`` dim is the head
    dim its recurrence mixes at every step.  So every leaf is gathered
    whole for a call, in the dtype the forward reads it in
    (``layers.read_dtype``): ``forward_rows`` (no state) gathers them in
    each call, the backward returning each block's gradient to its rank;
    ``forward_state`` (a prefill or decode) gathers them once and keeps
    them (``layers.kept_block``).  Both run the mixer on this rank's rows of
    the batch, so the values it computes with are a world of one's."""

    defs = staticmethod(mamba2_defs)
    state_defs = staticmethod(mamba2_state_defs)
    fn = staticmethod(mamba2_forward)

    def __init__(self, cfg: ModelConfig, weights: dict,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.names = tuple(self.defs(cfg))
        for name in self.names:
            setattr(self, name, nn.Parameter(weights[name]))
        self.cfg = cfg
        self.compute_dtype = compute_dtype

    def forward(self, x, state=None, valid=None):
        params = {n: getattr(self, n) for n in self.names}
        return self.fn(params, x, self.cfg, state, self.compute_dtype,
                       valid=valid)

    def forward_rows(self, x, valid, mesh, env):
        params = read_blocks(self, self.defs(self.cfg), mesh, env,
                             self.compute_dtype)
        return self.fn(params, x, self.cfg, None, self.compute_dtype,
                       valid=valid)[0]

    def forward_state(self, x, state, valid, mesh, env):
        """(out, this rank's block of the new state) of this rank's rows
        ``x`` and ``state``, its block of the layer's state
        (``state_specs``: its rows, its ``tp`` columns).  The state's
        ``tp`` dims cut across the recurrence as the weights' do, so the
        blocks are gathered over ``tp`` for the call (booked under
        ``ssm_state``; the state does not grow with the sequence), the
        mixer runs, and this rank's block of the new state is kept."""
        params = read_blocks(self, self.defs(self.cfg), mesh, env,
                             self.compute_dtype, keep=True)
        specs = {n: env.resolve(tuple(None if a == "batch" else a
                                      for a in sd[1]))
                 for n, sd in self.state_defs(self.cfg, 1).items()}
        whole = {n: unshard_leaf(mesh, state[n], specs[n], "ssm_state")
                 for n in specs}
        out, new = self.fn(params, x, self.cfg, whole, self.compute_dtype,
                           valid=valid)
        return out, {n: shard_leaf(mesh, t, specs[n]) for n, t in new.items()}


class Mamba2Mixer(_Mixer):
    pass


class MLSTMMixer(_Mixer):
    defs = staticmethod(mlstm_defs)
    state_defs = staticmethod(mlstm_state_defs)
    fn = staticmethod(mlstm_forward)


class SLSTMMixer(_Mixer):
    defs = staticmethod(slstm_defs)
    state_defs = staticmethod(slstm_state_defs)
    fn = staticmethod(slstm_forward)
    # the recurrence reads these in f32 whatever the compute dtype:
    # ServeEngine leaves them uncast
    keep_f32 = ("r", "b")
