"""The MoE FFN (``models/moe.py``'s single-device path): the port against
the JAX package.

The same router and expert weights (the reference's ``init_tree`` over its
``moe_defs``) and the same activations, made from a seed with numpy, go
through the reference's ``_router``, ``_capacity_gather`` and
``moe_ffn_dense`` and the port's.  Cases: top-1 with one shared expert
(llama4-maverick's smoke config), top-2 with two shared experts
(deepseek-v2's), and heavy drops (deepseek-v2's at ``capacity_factor``
0.5, so that about half the choices are dropped).

Tolerances, and why:

* router ids: equal in float32.  The router's init scale is 0.1, so its
  probabilities are near uniform and its top-k margins small; a flipped
  choice would move the capacity slots of every later token, so ids are
  compared directly, not only through the output.  In bfloat16 the router
  still runs in f32 on the same bf16 activations, and the ids are equal
  here too.
* router weights and aux: 1e-6 and 1e-5 relative (f32 sums in another
  order).
* ``_capacity_gather``: buffers, ``tok_idx`` and ``w_buf`` bit for bit (a
  gather copies, it does not round).
* ``moe_ffn_dense``: 1e-5 of max |out| in float32 (the expert products are
  f32 GEMMs summed in another order); 3e-2 in bfloat16.  Its gradients,
  through autograd against ``jax.grad`` of the same scalar: 1e-4 of each
  leaf's max |g| in float32 (top-1's router: see the test).
* the combine: the reference's ``.at[tok_idx].add`` in bfloat16, bit for
  bit, on the same expert outputs (the port adds a token's rows in the
  same order, ascending expert).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as ref_get_smoke
from repro.models import moe as ref_moe
from repro.models.layers import init_tree as ref_init_tree
from repro_torch.configs import get_smoke
from repro_torch.models import moe

CASES = {
    "top1-shared1": ("llama4-maverick-400b-a17b", {}),
    "top2-shared2": ("deepseek-v2-236b", {}),
    "heavy-drops": ("deepseek-v2-236b", {"capacity_factor": 0.5}),
}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(case, dtype="float32"):
    arch, moe_kw = CASES[case]
    out = []
    for get in (ref_get_smoke, get_smoke):
        cfg = get(arch)
        out.append(dataclasses.replace(
            cfg, dtype=dtype, moe=dataclasses.replace(cfg.moe, **moe_kw)))
    return out


def _setup(case, dtype="float32", b=3, s=11, seed=0):
    """(ref cfg, port cfg, reference params, port params, x as numpy in
    the compute dtype's values)."""
    ref_cfg, cfg = _cfgs(case, dtype)
    params = jax.tree.map(np.asarray, ref_init_tree(
        ref_moe.moe_defs(ref_cfg), jax.random.PRNGKey(seed)))
    x = np.random.default_rng(seed + 1).normal(
        size=(b, s, cfg.d_model)).astype(np.float32)
    jdt, _ = DTYPES[dtype]
    x = np.array(jnp.asarray(x).astype(jdt).astype(jnp.float32))
    tparams = jax.tree.map(lambda a: torch.as_tensor(np.array(a)), params)
    return ref_cfg, cfg, params, tparams, x


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / (np.abs(want).max() + 1e-30))


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_defs_match_reference(case):
    ref_cfg, cfg = _cfgs(case)
    got = jax.tree.map(lambda d: (d.shape, d.logical, d.init, d.scale),
                       moe.moe_defs(cfg))
    want = jax.tree.map(lambda d: (d.shape, d.logical, d.init, d.scale),
                        ref_moe.moe_defs(ref_cfg),
                        is_leaf=lambda d: hasattr(d, "logical"))
    assert got == want


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_router_matches_reference(case, dtype):
    ref_cfg, cfg, params, tparams, x = _setup(case, dtype)
    jdt, tdt = DTYPES[dtype]
    x_flat = x.reshape(-1, cfg.d_model)
    w_ref, ids_ref, aux_ref = ref_moe._router(
        params, jnp.asarray(x_flat).astype(jdt), ref_cfg.moe)
    w, ids, aux = moe._router(tparams, torch.as_tensor(x_flat).to(tdt),
                              cfg.moe)
    assert ids.dtype == torch.int64 and tuple(ids.shape) == ids_ref.shape
    assert np.array_equal(ids.numpy(), np.asarray(ids_ref))
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), rtol=1e-6,
                               atol=1e-7)
    assert abs(float(aux) / float(aux_ref) - 1) <= 1e-5
    assert float(aux) > 0.0


def test_top_k_takes_ties_lower_index_first():
    """Equal values come out in ascending index order, as ``lax.top_k``
    gives them."""
    rng = np.random.default_rng(3)
    x = rng.integers(0, 4, (64, 12)).astype(np.float32) / 4
    for k in (1, 2, 5, 12):
        vals, idx = moe.top_k(torch.as_tensor(x), k)
        want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
        assert np.array_equal(idx.numpy(), np.asarray(want_i)), k
        assert np.array_equal(vals.numpy(), np.asarray(want_v)), k


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_capacity_gather_bit_for_bit(case, dtype):
    """Order-of-arrival slots, drops past ``capacity`` (``tok_idx == T``),
    the gathered buffers and weights: equal to the reference's bits."""
    ref_cfg, cfg, params, tparams, x = _setup(case, dtype)
    jdt, tdt = DTYPES[dtype]
    mo = cfg.moe
    x_flat = x.reshape(-1, cfg.d_model)
    t = x_flat.shape[0]
    _, ids_ref, _ = ref_moe._router(params, jnp.asarray(x_flat).astype(jdt),
                                    ref_cfg.moe)
    w, ids, _ = moe._router(tparams, torch.as_tensor(x_flat).to(tdt), mo)
    cap = max(int(np.ceil(t * mo.top_k / mo.num_experts * mo.capacity_factor)), 4)
    flat_w = np.asarray(w.detach().reshape(-1).to(tdt).float())
    buf_r, tok_r, wb_r = ref_moe._capacity_gather(
        jnp.asarray(x_flat).astype(jdt), ids_ref.reshape(-1),
        jnp.asarray(flat_w).astype(jdt), mo.num_experts, cap)
    buf, tok, wb, slot = moe._capacity_gather(
        torch.as_tensor(x_flat).to(tdt), ids.reshape(-1),
        torch.as_tensor(flat_w).to(tdt), mo.num_experts, cap)
    assert buf.dtype == tdt and wb.dtype == tdt
    assert np.array_equal(buf.float().numpy(),
                          np.asarray(buf_r.astype(jnp.float32)))
    assert np.array_equal(tok.numpy(), np.asarray(tok_r))
    assert np.array_equal(wb.float().numpy(),
                          np.asarray(wb_r.astype(jnp.float32)))
    # each kept choice's slot holds its token; a dropped one points past
    # the buffer
    kept = slot < mo.num_experts * cap
    n_kept = int(kept.sum())
    assert n_kept == int((tok < t).sum())
    flat_tok = torch.arange(t * mo.top_k) // mo.top_k
    assert torch.equal(tok.reshape(-1)[slot[kept]], flat_tok[kept])
    if case == "heavy-drops":
        assert n_kept < 0.75 * t * mo.top_k


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_ffn_dense_matches_reference(case, dtype):
    ref_cfg, cfg, params, tparams, x = _setup(case, dtype)
    jdt, tdt = DTYPES[dtype]
    want, aux_ref = jax.jit(
        lambda p, xx: ref_moe.moe_ffn_dense(p, xx, ref_cfg, jdt)).lower(
        params, jnp.asarray(x).astype(jdt)).compile(
        compiler_options={"xla_allow_excess_precision": False})(
        params, jnp.asarray(x).astype(jdt))
    stats = {}
    with torch.no_grad():
        got, aux = moe.moe_ffn_dense(tparams, torch.as_tensor(x).to(tdt),
                                     cfg, tdt, stats=stats)
    assert got.dtype == tdt and tuple(got.shape) == x.shape
    tol = 1e-5 if dtype == "float32" else 3e-2
    err = _rel(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    assert err <= tol, err
    assert abs(float(aux) / float(aux_ref) - 1) <= 1e-5
    t, mo = x.shape[0] * x.shape[1], cfg.moe
    assert int(stats["load"].sum()) == t * mo.top_k
    assert int(stats["dropped"]) == int(np.sum(
        np.asarray(_ref_tok_idx(ref_cfg, params, x, jdt)) == t)) - (
        stats["capacity"] * mo.num_experts - t * mo.top_k)
    if case == "heavy-drops":
        assert int(stats["dropped"]) > t * mo.top_k // 4


def _ref_tok_idx(ref_cfg, params, x, jdt):
    """The reference's ``tok_idx`` for ``x`` (T where a slot is empty)."""
    mo = ref_cfg.moe
    x_flat = jnp.asarray(x.reshape(-1, x.shape[-1])).astype(jdt)
    t = x_flat.shape[0]
    w, ids, _ = ref_moe._router(params, x_flat, mo)
    cap = max(int(np.ceil(t * mo.top_k / mo.num_experts * mo.capacity_factor)), 4)
    return ref_moe._capacity_gather(x_flat, ids.reshape(-1),
                                    w.reshape(-1).astype(jdt),
                                    mo.num_experts, cap)[1]


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_ffn_dense_gradients_match_reference(case):
    """d/d(params, x) of sum(out * c) + aux, through autograd and through
    ``jax.grad``: every leaf within 1e-4 of its max |g| (f32)."""
    ref_cfg, cfg, params, tparams, x = _setup(case)
    c = np.random.default_rng(9).normal(size=x.shape).astype(np.float32)

    def ref_loss(p, xx):
        out, aux = ref_moe.moe_ffn_dense(p, xx, ref_cfg, jnp.float32)
        return jnp.sum(out * c) + aux
    g_ref = jax.grad(ref_loss, argnums=(0, 1))(params, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_() for k, v in
              _flat(tparams).items()}
    xt = torch.as_tensor(x).requires_grad_()
    out, aux = moe.moe_ffn_dense(_nest(leaves), xt, cfg, torch.float32)
    (torch.sum(out * torch.as_tensor(c)) + aux).backward()
    want = _flat(jax.tree.map(np.asarray, g_ref[0]))
    top1 = cfg.moe.top_k == 1
    for k, t in leaves.items():
        if not (top1 and k == "router"):
            assert _rel(t.grad.numpy(), want[k]) <= 1e-4, k
    assert _rel(xt.grad.numpy(), np.asarray(g_ref[1])) <= 1e-4
    if top1:
        # a top-1 weight renormalises to w / w == 1: its part of the
        # router's gradient is 0 up to each package's rounding residue,
        # and only aux's part is exact.  That part within 1e-4; the port's
        # residue no larger than 4x the reference's.
        aux_ref = np.asarray(jax.grad(lambda p: ref_moe.moe_ffn_dense(
            p, jnp.asarray(x), ref_cfg, jnp.float32)[1])(params)["router"])
        r = tparams["router"].clone().requires_grad_()
        moe.moe_ffn_dense(dict(tparams, router=r), torch.as_tensor(x), cfg,
                          torch.float32)[1].backward()
        assert _rel(r.grad.numpy(), aux_ref) <= 1e-4
        resid_ref = np.abs(want["router"] - aux_ref).max()
        resid = float((leaves["router"].grad - r.grad).abs().max())
        assert resid <= 4 * resid_ref + 1e-4 * np.abs(aux_ref).max()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def _nest(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        *head, last = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return tree


@pytest.mark.parametrize("k", [1, 2, 6])
def test_combine_equals_reference_scatter_add_in_bf16(k):
    """The (T, k) slot map adds a token's rows in ascending expert order in
    bf16: bit for bit the reference's ``.at[tok_idx].add(..., mode="drop")``
    over the same (E, C, d) rows, with drops."""
    rng = np.random.default_rng(k)
    e, t, d = 8, 40, 16
    ids = np.stack([rng.permutation(e)[:k] for _ in range(t)]).astype(np.int32)
    cap = max(int(np.ceil(t * k / e * 0.75)), 4)       # some drops
    x = rng.normal(size=(t, d)).astype(np.float32)
    _, tok_r, _ = ref_moe._capacity_gather(
        jnp.asarray(x), jnp.asarray(ids.reshape(-1)),
        jnp.ones(t * k, jnp.float32), e, cap)
    _, _, _, slot = moe._capacity_gather(
        torch.as_tensor(x), torch.as_tensor(ids.reshape(-1)).long(),
        torch.ones(t * k), e, cap)
    y = rng.normal(size=(e, cap, d)).astype(np.float32) * 3
    yb = jnp.asarray(y).astype(jnp.bfloat16)
    want = jax.jit(lambda yy, ti: jnp.zeros((t + 1, d), yy.dtype).at[
        ti.reshape(-1)].add(yy.reshape(-1, d), mode="drop")[:t]).lower(
        yb, tok_r).compile(
        compiler_options={"xla_allow_excess_precision": False})(yb, tok_r)
    got = moe._combine(torch.as_tensor(y).to(torch.bfloat16), slot,
                       torch.as_tensor(ids).long())
    assert got.dtype == torch.bfloat16
    assert int((slot == e * cap).sum()) > 0 or k == 1
    assert np.array_equal(got.float().numpy(),
                          np.asarray(want.astype(jnp.float32)))


def test_moe_module_keeps_reference_names():
    """``MoEFFN``'s parameters carry the reference subtree's names, the
    shared experts under ``shared.``; the router is marked to stay f32."""
    _, cfg, _, tparams, x = _setup("top2-shared2")
    weights = {k.replace("/", "."): v for k, v in _flat(tparams).items()}
    mod = moe.MoEFFN(cfg, weights, torch.float32)
    assert sorted(n for n, _ in mod.named_parameters()) == sorted(weights)
    assert mod.keep_f32 == ("router",)
    with torch.no_grad():
        out, aux = mod(torch.as_tensor(x))
        want, want_aux = moe.moe_ffn_dense(tparams, torch.as_tensor(x), cfg,
                                           torch.float32)
    assert torch.equal(out, want) and torch.equal(aux, want_aux)
    assert mod.stats["capacity"] == max(int(np.ceil(
        33 * 2 / 8 * cfg.moe.capacity_factor)), 4)
