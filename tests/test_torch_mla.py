"""MLA, DeepSeek-V2's multi-head latent attention: the port against the JAX
package.

The same weights (the reference's ``init_tree`` over its ``mla_defs``) and
the same activations, made from a seed with numpy, go through the
reference's ``mla_attention`` and the port's, with and without
``q_lora_rank`` (the low-rank ``w_dq``/``q_norm``/``w_uq`` query or the
full-rank ``wq``), without a cache and with one (a prefill of a left-padded
batch with ``valid_from``, then a decode step into the same cache).

``absorb=True`` is the block's path.  ``absorb=False``, the paper's form,
fails in the reference whenever ``v_head_dim`` differs from
``qk_nope_head_dim + qk_rope_head_dim``, as in both DeepSeek-V2 configs:
its ``_sdpa`` reshapes the output to q's head dim
(``src/repro/models/attention.py:87``; ROADMAP queue 3).  So absorb=False
is held to the reference on a config whose dims agree, and on DeepSeek's
dims to the port's absorb=True (the two are the same product regrouped).

Tolerances: 1e-4 of max |out| in float32 (f32 GEMMs summed in another
order), 3e-2 in bfloat16; the bf16 caches ``ckv`` and ``kr`` equal the
reference's bit for bit, or, in float32, where an element rounded the
other way to bf16, the step is held to 3e-2 (the same rule as
``tests/test_torch_models.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as ref_get_smoke
from repro.models import attention as ref_attn
from repro.models.layers import init_tree as ref_init_tree
from repro_torch.configs import get_smoke
from repro_torch.models import attention as attn

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# MLA dims: DeepSeek-V2's smoke config, its full-rank-q variant, and one
# whose v_head_dim equals qk_nope + qk_rope (where the reference's
# absorb=False runs)
VARIANTS = {"q_lora": {}, "full_rank_q": {"q_lora_rank": 0},
            "v_eq_qk": {"v_head_dim": 48},
            "v_eq_qk_full_rank_q": {"v_head_dim": 48, "q_lora_rank": 0}}


def _cfgs(variant, dtype="float32"):
    out = []
    for get in (ref_get_smoke, get_smoke):
        cfg = get("deepseek-v2-236b")
        out.append(dataclasses.replace(
            cfg, dtype=dtype,
            mla=dataclasses.replace(cfg.mla, **VARIANTS[variant])))
    return out


def _setup(variant, dtype, b=3, s=9, seed=0):
    ref_cfg, cfg = _cfgs(variant, dtype)
    params = jax.tree.map(np.asarray, ref_init_tree(
        ref_attn.mla_defs(ref_cfg), jax.random.PRNGKey(seed)))
    jdt, _ = DT[dtype]
    x = np.random.default_rng(seed + 1).normal(
        size=(b, s + 1, cfg.d_model)).astype(np.float32)
    x = np.array(jnp.asarray(x).astype(jdt).astype(jnp.float32))
    tparams = {k: torch.as_tensor(np.array(v)) for k, v in params.items()}
    return ref_cfg, cfg, params, tparams, x


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / (np.abs(want).max() + 1e-30))


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_mla_defs_match_reference(variant):
    ref_cfg, cfg = _cfgs(variant)
    got = {k: (d.shape, d.logical, d.init, d.scale)
           for k, d in attn.mla_defs(cfg).items()}
    want = {k: (d.shape, d.logical, d.init, d.scale)
            for k, d in ref_attn.mla_defs(ref_cfg).items()}
    assert got == want
    assert ("wq" in got) == (cfg.mla.q_lora_rank == 0)
    assert attn.mla_cache_defs(cfg, 2, 7) == \
        ref_attn.mla_cache_defs(ref_cfg, 2, 7)


def _run_both(variant, dtype, absorb, cached):
    """(port out, reference out, cache flips, port cache, reference cache)
    of one call: no cache, or a prefill of ``s`` left-padded tokens and a
    decode of token ``s`` (both compared, the decode's returned)."""
    ref_cfg, cfg, params, tparams, x = _setup(variant, dtype)
    jdt, tdt = DT[dtype]
    b, s1, _ = x.shape
    s = s1 - 1
    if not cached:
        pos = np.broadcast_to(np.arange(s1)[None], (b, s1)).astype(np.int32)
        want, _ = _compiled(lambda p, xx, pp: ref_attn.mla_attention(
            p, xx, pp, ref_cfg, None, jdt, absorb=absorb), params,
            jnp.asarray(x).astype(jdt), jnp.asarray(pos))
        with torch.no_grad():
            got, _ = attn.mla_attention(
                tparams, torch.as_tensor(x).to(tdt), torch.as_tensor(pos),
                cfg, None, tdt, absorb=absorb)
        return got, want, 0
    vf = np.array([0, 3, s], np.int32)[:b]             # the last: all pad
    logical = np.maximum(np.arange(s)[None] - vf[:, None], 0).astype(np.int32)
    cap = s + 4
    ref_cache = {k: jnp.zeros(sd[0], sd[2]) for k, sd in
                 ref_attn.mla_cache_defs(ref_cfg, b, cap).items()}
    ref_cache["index"] = jnp.int32(0)
    cache = {k: (0 if k == "index" else torch.zeros(sd[0], dtype=torch.bfloat16))
             for k, sd in attn.mla_cache_defs(cfg, b, cap).items()}

    def ref_call(p, xx, pp, c, v):
        return ref_attn.mla_attention(p, xx, pp, ref_cfg, c, jdt,
                                      absorb=absorb, valid_from=v)
    outs, flips = [], []
    for sl, pos in ((slice(0, s), logical),
                    (slice(s, s + 1), (s - vf)[:, None].astype(np.int32))):
        want, ref_cache = _compiled(ref_call, params,
                                    jnp.asarray(x[:, sl]).astype(jdt),
                                    jnp.asarray(pos), ref_cache,
                                    jnp.asarray(vf))
        with torch.no_grad():
            got, cache = attn.mla_attention(
                tparams, torch.as_tensor(x[:, sl]).to(tdt),
                torch.as_tensor(pos), cfg, cache, tdt, absorb=absorb,
                valid_from=torch.as_tensor(vf))
        flips.append(sum(int(np.sum(_f32(ref_cache[n])
                                    != cache[n].float().numpy()))
                         for n in ("ckv", "kr")))
        outs.append((got, want))
        assert cache["index"] == int(ref_cache["index"])
    assert cache["ckv"].dtype == cache["kr"].dtype == torch.bfloat16
    # an all-pad slot still gives finite outputs (masked at -1e30, not -inf)
    for got, want in outs:
        assert bool(torch.all(torch.isfinite(got.float())))
        err = _rel(got.float().numpy(), _f32(want))
        bound = TOL[dtype] if flips[-1] == 0 else max(TOL[dtype], 3e-2)
        assert err <= bound, (err, flips)
    return outs[-1][0], outs[-1][1], flips[-1]


@pytest.mark.parametrize("cached", [False, True], ids=["no_cache", "cache"])
@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("variant", ["q_lora", "full_rank_q"])
def test_mla_absorbed_matches_reference(variant, dtype, cached):
    got, want, _ = _run_both(variant, dtype, True, cached)
    if not cached:
        assert _rel(got.float().numpy(), _f32(want)) <= TOL[dtype]


@pytest.mark.parametrize("cached", [False, True], ids=["no_cache", "cache"])
@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("variant", ["v_eq_qk", "v_eq_qk_full_rank_q"])
def test_mla_paper_path_matches_reference(variant, dtype, cached):
    """absorb=False where the reference runs it (v_head_dim == qk dims)."""
    got, want, _ = _run_both(variant, dtype, False, cached)
    if not cached:
        assert _rel(got.float().numpy(), _f32(want)) <= TOL[dtype]


@pytest.mark.parametrize("variant", ["q_lora", "full_rank_q"])
def test_mla_paper_path_equals_absorbed_on_deepseek_dims(variant):
    """On DeepSeek's dims (v_head_dim 32 != 48) the reference's absorb=False
    raises; the port's equals its absorb=True (f32, 1e-5), with and
    without a cache."""
    ref_cfg, cfg, params, tparams, x = _setup(variant, "float32")
    b, s1, _ = x.shape
    pos = np.broadcast_to(np.arange(s1)[None], (b, s1)).astype(np.int32)
    with pytest.raises(TypeError, match="reshape"):
        ref_attn.mla_attention(params, jnp.asarray(x), jnp.asarray(pos),
                               ref_cfg, None, jnp.float32, absorb=False)
    vf = torch.tensor([0, 2, 4])
    outs = {}
    for absorb in (True, False):
        cache = {k: (0 if k == "index" else torch.zeros(sd[0], dtype=torch.bfloat16))
                 for k, sd in attn.mla_cache_defs(cfg, b, s1 + 2).items()}
        with torch.no_grad():
            full, _ = attn.mla_attention(
                tparams, torch.as_tensor(x), torch.as_tensor(pos), cfg, None,
                torch.float32, absorb=absorb)
            pre, cache = attn.mla_attention(
                tparams, torch.as_tensor(x[:, :-1]),
                torch.as_tensor(pos[:, :-1]), cfg, cache, torch.float32,
                absorb=absorb, valid_from=vf)
            dec, _ = attn.mla_attention(
                tparams, torch.as_tensor(x[:, -1:]),
                torch.as_tensor(pos[:, -1:]), cfg, cache, torch.float32,
                absorb=absorb, valid_from=vf)
        outs[absorb] = (full, pre, dec)
    for a, c in zip(outs[True], outs[False]):
        assert a.shape == c.shape == (b, a.shape[1], cfg.d_model)
        assert _rel(c.numpy(), a.numpy()) <= 1e-5


def test_mla_cache_overflow_raises():
    _, cfg, _, tparams, x = _setup("q_lora", "float32")
    cache = {k: (0 if k == "index" else torch.zeros(sd[0], dtype=torch.bfloat16))
             for k, sd in attn.mla_cache_defs(cfg, 3, 4).items()}
    pos = torch.zeros((3, 10), dtype=torch.int32)
    with pytest.raises(ValueError, match="capacity 4"):
        attn.mla_attention(tparams, torch.as_tensor(x), pos, cfg, cache,
                           torch.float32)


def test_mla_module_keeps_reference_names():
    """``MLAAttention`` holds the reference's leaf names (``kv_norm`` and
    ``q_norm`` as plain 1-D parameters) and computes ``mla_attention``."""
    _, cfg, _, tparams, x = _setup("q_lora", "float32")
    mod = attn.MLAAttention(cfg, tparams, torch.float32)
    assert sorted(n for n, _ in mod.named_parameters()) == sorted(tparams)
    assert mod.kv_norm.ndim == 1 and mod.q_norm.ndim == 1
    pos = torch.arange(x.shape[1])[None].expand(x.shape[0], -1)
    with torch.no_grad():
        got, _ = mod(torch.as_tensor(x), pos)
        want, _ = attn.mla_attention(tparams, torch.as_tensor(x), pos, cfg,
                                     None, torch.float32)
    assert torch.equal(got, want)
