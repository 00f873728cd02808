"""The SSM blocks (Mamba2, mLSTM, sLSTM): the port's functions against the
JAX package's, on inputs and parameters made from a seed with numpy.

The configs are zamba2's and xlstm's smoke configs (chunk 32); sequences
of 70 cross two chunk boundaries and end in a padded chunk.  Every 1-D
parameter the reference initializes to a constant (``A_log``, ``D``,
``dt_bias``, ``conv_b``, the gate biases, the norms) is drawn at random
instead, so that each term is live.  The reference runs op by op (not
jitted), each op rounding to its dtype as the port's eager ops do.

Tolerances, of the reference's max |x|: outputs and states 1e-4 in
float32 (the port contracts the reference's three- and four-operand
einsums pairwise, in another summation order), 3e-2 in bfloat16;
gradients (``jax.grad`` against autograd, float32) 1e-3 of each leaf's
max |g|, and no gradient may hold a NaN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as ref_get_smoke
from repro.models import ssm as ref_ssm
from repro_torch.configs import get_smoke
from repro_torch.models import ssm

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
GRAD_TOL = 1e-3
# (defs, forward, state defs) of each block kind, reference and port
KINDS = {
    "mamba2": ("zamba2-1.2b", (ref_ssm.mamba2_defs, ref_ssm.mamba2_forward,
                               ref_ssm.mamba2_state_defs),
               (ssm.mamba2_defs, ssm.mamba2_forward, ssm.mamba2_state_defs)),
    "mlstm": ("xlstm-350m", (ref_ssm.mlstm_defs, ref_ssm.mlstm_forward,
                             ref_ssm.mlstm_state_defs),
              (ssm.mlstm_defs, ssm.mlstm_forward, ssm.mlstm_state_defs)),
    "slstm": ("xlstm-350m", (ref_ssm.slstm_defs, ref_ssm.slstm_forward,
                             ref_ssm.slstm_state_defs),
              (ssm.slstm_defs, ssm.slstm_forward, ssm.slstm_state_defs)),
}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _t(a, dtype=None):
    t = torch.tensor(np.asarray(a, np.float32))
    return t if dtype is None else t.to(dtype)


def _params(kind, seed=0):
    """(cfg pair, numpy parameters): the defs' shapes, normal draws scaled
    as the reference's init, 1-D leaves random around their init."""
    arch, (ref_defs, _, _), (defs, _, _) = KINDS[kind]
    ref_cfg, cfg = ref_get_smoke(arch), get_smoke(arch)
    assert {k: (d.shape, d.init, d.scale) for k, d in ref_defs(ref_cfg).items()} \
        == {k: (d.shape, d.init, d.scale) for k, d in defs(cfg).items()}
    rng = np.random.default_rng(seed)
    out = {}
    for name, d in defs(cfg).items():
        if len(d.shape) == 1:
            base = {"ones": 1.0, "zeros": 0.0}.get(d.init, 0.0)
            out[name] = (base + 0.3 * rng.normal(size=d.shape)).astype(np.float32)
        else:
            out[name] = (rng.normal(size=d.shape) * d.scale
                         / np.sqrt(d.shape[0])).astype(np.float32)
    if kind == "slstm":
        out["b"] = (0.3 * rng.normal(size=out["b"].shape)).astype(np.float32)
    return ref_cfg, cfg, out


def _state(kind, cfg, batch, seed=None):
    """Zeros as ``init_state`` makes them, or random (seed) for a step."""
    defs = KINDS[kind][2][2](cfg, batch)
    rng = np.random.default_rng(seed)
    out = {}
    for n, (shape, _, _) in defs.items():
        out[n] = (np.zeros(shape, np.float32) if seed is None
                  else rng.normal(size=shape).astype(np.float32))
    if seed is not None and kind == "slstm":
        out["n"] = np.abs(out["n"]) + 0.5          # a normalizer is >= 1e-6
    return out


def _x(cfg, b=2, s=70, seed=1):
    return (np.random.default_rng(seed).normal(size=(b, s, cfg.d_model))
            ).astype(np.float32)


def _run_both(kind, params, x, state, dtype, valid=None):
    ref_cfg, cfg = ref_get_smoke(KINDS[kind][0]), get_smoke(KINDS[kind][0])
    ref_fn, fn = KINDS[kind][1][1], KINDS[kind][2][1]
    want, want_st = ref_fn(
        {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(x, JDT[dtype]), ref_cfg,
        None if state is None else {k: jnp.asarray(v) for k, v in state.items()},
        JDT[dtype], valid=None if valid is None else jnp.asarray(valid))
    got, got_st = fn(
        {k: _t(v) for k, v in params.items()}, _t(x, TDT[dtype]), cfg,
        None if state is None else {k: _t(v) for k, v in state.items()},
        TDT[dtype], valid=None if valid is None else torch.as_tensor(valid))
    return (got, got_st), (want, want_st)


def _check(got, want, tol, what):
    (y, st), (wy, wst) = got, want
    assert y.dtype == TDT["bfloat16" if tol > TOL["float32"] else "float32"]
    assert _rel(y, wy) <= tol, f"{what}: out {_rel(y, wy)}"
    assert sorted(st) == sorted(wst)
    for k in st:
        assert st[k].dtype == torch.float32, k
        assert tuple(st[k].shape) == tuple(wst[k].shape), k
        assert _rel(st[k], wst[k]) <= tol, f"{what}: state {k} {_rel(st[k], wst[k])}"


# --------------------------------------------------------------------------
# the pieces
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("carry", [False, True])
def test_causal_conv(carry, dtype):
    """The K shifted products added in order; with a (B, K-1, C) carry the
    window starts in it.  Equal bits in both dtypes: the same ops in the
    same order."""
    rng = np.random.default_rng(3)
    b, s, c, k = 2, 70, 160, 4
    x, w, bias = (rng.normal(size=sh).astype(np.float32)
                  for sh in ((b, s, c), (k, c), (c,)))
    st = rng.normal(size=(b, k - 1, c)).astype(np.float32) if carry else None
    jd, td = JDT[dtype], TDT[dtype]
    want, want_st = ref_ssm._causal_conv(
        jnp.asarray(x, jd), jnp.asarray(w, jd), jnp.asarray(bias, jd),
        None if st is None else jnp.asarray(st))
    got, got_st = ssm._causal_conv(_t(x, td), _t(w, td), _t(bias, td),
                                   None if st is None else _t(st))
    assert got.dtype == td and got_st.shape == (b, k - 1, c)
    assert np.array_equal(got.float().numpy(), np.asarray(want, np.float32))
    assert np.array_equal(got_st.float().numpy(), np.asarray(want_st, np.float32))


def _ssd_inputs(seed=4, b=2, s=96, h=8, p=16, n=16):
    rng = np.random.default_rng(seed)
    xh = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h)))).astype(np.float32)
    a_log = (0.3 * rng.normal(size=h)).astype(np.float32)
    bm, cm = (rng.normal(size=(b, s, n)).astype(np.float32) for _ in range(2))
    h0 = rng.normal(size=(b, h, n, p)).astype(np.float32)
    return xh, dt, a_log, bm, cm, h0


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked(with_h0):
    """Three chunks of 32, with and without a carried-in state."""
    xh, dt, a_log, bm, cm, h0 = _ssd_inputs()
    args = (xh, dt, a_log, bm, cm)
    want, want_h = ref_ssm._ssd_chunked(*map(jnp.asarray, args), 32,
                                        jnp.asarray(h0) if with_h0 else None)
    got, got_h = ssm._ssd_chunked(*map(_t, args), 32,
                                  _t(h0) if with_h0 else None)
    assert _rel(got, want) <= TOL["float32"]
    assert _rel(got_h, want_h) <= TOL["float32"]


def test_ssd_chunked_gradients():
    xh, dt, a_log, bm, cm, h0 = _ssd_inputs(s=64)
    args = (xh, dt, a_log, bm, cm, h0)
    cot = np.random.default_rng(5).normal(size=xh.shape).astype(np.float32)
    cot_h = np.random.default_rng(6).normal(size=h0.shape).astype(np.float32)

    def ref_loss(*a):
        y, h = ref_ssm._ssd_chunked(*a[:5], 32, a[5])
        return jnp.sum(y * cot) + jnp.sum(h * cot_h)
    want = jax.grad(ref_loss, argnums=tuple(range(6)))(*map(jnp.asarray, args))
    ts = [_t(a).requires_grad_() for a in args]
    y, h = ssm._ssd_chunked(*ts[:5], 32, ts[5])
    (torch.sum(y * _t(cot)) + torch.sum(h * _t(cot_h))).backward()
    for t, w in zip(ts, want):
        assert not torch.isnan(t.grad).any()
        assert _rel(t.grad, w) <= GRAD_TOL


def test_state_defs_match_reference():
    for kind, (arch, ref, port) in KINDS.items():
        assert port[2](get_smoke(arch), 3) == ref[2](ref_get_smoke(arch), 3)


# --------------------------------------------------------------------------
# the blocks, in their three modes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("mode", ["full", "prefill", "decode"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_block_forward(kind, mode, dtype):
    """``full``: no state (training; mLSTM's m = -inf, sLSTM's n = 1);
    ``prefill``: 70 tokens from ``init_state``'s zeros; ``decode``: one
    token from a random state (the same state into both)."""
    ref_cfg, cfg, params = _params(kind)
    if mode == "decode":
        x, state = _x(cfg, s=1), _state(kind, cfg, 2, seed=7)
    else:
        x, state = _x(cfg), None if mode == "full" else _state(kind, cfg, 2)
    got, want = _run_both(kind, params, x, state, dtype)
    _check(got, want, TOL[dtype], f"{kind} {mode} {dtype}")


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_block_left_padded_valid(kind):
    """A left-padded prefill (row 0's first 9 steps pads, row 1 none) from
    ``init_state``: pads are identity steps, so row 0's state and last
    outputs equal those of its real tokens alone."""
    ref_cfg, cfg, params = _params(kind)
    x = _x(cfg)
    valid = np.ones((2, 70), bool)
    valid[0, :9] = False
    got, want = _run_both(kind, params, x, _state(kind, cfg, 2), "float32",
                          valid=valid)
    _check(got, want, TOL["float32"], f"{kind} valid")
    alone, _ = _run_both(kind, params, x[:1, 9:], _state(kind, cfg, 1),
                         "float32")
    y, st = got
    assert _rel(y[:1, -1], alone[0][:, -1]) <= TOL["float32"]
    for k in st:
        assert _rel(st[k][:1], alone[1][k]) <= TOL["float32"], k


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_decode_chain_equals_prefill(kind):
    """Prefill 69 tokens, then one decode step, against a prefill of all
    70 (the port's own; the recurrent step and the chunked form compute
    one function)."""
    _, cfg, params = _params(kind)
    fn = KINDS[kind][2][1]
    p = {k: _t(v) for k, v in params.items()}
    x = _t(_x(cfg))
    zeros = {k: _t(v) for k, v in _state(kind, cfg, 2).items()}
    _, st = fn(p, x[:, :69], cfg, zeros, torch.float32)
    y1, st1 = fn(p, x[:, 69:], cfg, st, torch.float32)
    y70, st70 = fn(p, x, cfg, zeros, torch.float32)
    assert _rel(y1[:, 0], y70[:, -1].numpy()) <= TOL["float32"]
    for k in st1:
        assert _rel(st1[k], st70[k].numpy()) <= TOL["float32"], k


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_block_gradients(kind):
    """Training's form (no state): the gradients of every parameter and of
    the input, against ``jax.grad``, float32; none holds a NaN (mLSTM's
    first chunk carries m = -inf; the masks are -inf before the exp)."""
    ref_cfg, cfg, params = _params(kind)
    x = _x(cfg, s=70 if kind != "slstm" else 24)
    cot = np.random.default_rng(8).normal(size=x.shape).astype(np.float32)
    ref_fn, fn = KINDS[kind][1][1], KINDS[kind][2][1]
    names = sorted(params)

    def ref_loss(p, xx):
        return jnp.sum(ref_fn(p, xx, ref_cfg, None, jnp.float32)[0] * cot)
    gp, gx = jax.grad(ref_loss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    p = {k: _t(v).requires_grad_() for k, v in params.items()}
    xt = _t(x).requires_grad_()
    torch.sum(fn(p, xt, cfg, None, torch.float32)[0] * _t(cot)).backward()
    for k in names:
        assert not torch.isnan(p[k].grad).any(), k
        assert _rel(p[k].grad, gp[k]) <= GRAD_TOL, f"{k}: {_rel(p[k].grad, gp[k])}"
    assert not torch.isnan(xt.grad).any()
    assert _rel(xt.grad, gx) <= GRAD_TOL


@pytest.mark.parametrize("initial", ["forward", "init_state"])
def test_slstm_initial_states_differ_as_the_reference(initial):
    """The two initial states are the reference's: from none (n = 1) and
    from ``init_state`` (n = 0) the block computes different outputs, each
    the reference's."""
    ref_cfg, cfg, params = _params("slstm")
    x = _x(cfg, s=12)
    state = None if initial == "forward" else _state("slstm", cfg, 2)
    got, want = _run_both("slstm", params, x, state, "float32")
    _check(got, want, TOL["float32"], initial)
    other, _ = _run_both("slstm", params, x,
                         _state("slstm", cfg, 2) if state is None else None,
                         "float32")
    assert _rel(got[0], other[0].numpy()) > 1e-3


def test_mlstm_from_no_state_starts_at_minus_inf():
    """mLSTM without a state starts its stabilizer at -inf, from
    ``init_state`` at 0: the outputs agree (the stabilizer cancels) and the
    carried m differs, each as the reference's.  The input gates are
    pushed to -50, so the carried-in m (0 or -inf) wins the stabilizer."""
    _, cfg, params = _params("mlstm")
    params["b_if"][:cfg.num_heads] -= 50.0
    x = _x(cfg)
    none, want_none = _run_both("mlstm", params, x, None, "float32")
    zero, want_zero = _run_both("mlstm", params, x, _state("mlstm", cfg, 2),
                                "float32")
    assert _rel(none[1]["m"], want_none[1]["m"]) <= TOL["float32"]
    assert _rel(zero[1]["m"], want_zero[1]["m"]) <= TOL["float32"]
    assert _rel(none[0], zero[0].numpy()) <= TOL["float32"]
    assert not torch.equal(none[1]["m"], zero[1]["m"])


def test_softplus_has_no_threshold():
    """``jax.nn.softplus`` is logaddexp(x, 0) at every x; ``F.softplus``
    returns x past 20.  The port's equals the reference's past it too."""
    x = np.array([-40.0, -3.0, 0.0, 5.0, 19.9, 20.5, 30.0, 90.0], np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = ssm._softplus(_t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)
    np.testing.assert_allclose(ssm._log_sigmoid(_t(x)).numpy(),
                               np.asarray(jax.nn.log_sigmoid(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-30)


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_silu_gradient_is_the_reference_far_below_zero(dtype):
    """silu's gradient equals ``jax.grad(jax.nn.silu)`` bit for bit, down to
    -200, where differentiating 1 / (1 + exp(-g)) op by op gives 0 * inf =
    NaN: the random full-width zamba2's pre-activations reach below -88."""
    from repro_torch.models.layers import silu
    x = np.array([-200, -100, -89, -50, -3, 0, 2, 50, 100], np.float32)
    want = jax.vmap(jax.grad(jax.nn.silu))(jnp.asarray(x, JDT[dtype]))
    t = _t(x, TDT[dtype]).requires_grad_()
    out = silu(t)
    out.sum().backward()
    assert np.array_equal(out.detach().float().numpy(),
                          np.asarray(jax.nn.silu(jnp.asarray(x, JDT[dtype])),
                                     np.float32))
    assert np.array_equal(t.grad.float().numpy(), np.asarray(want, np.float32))
