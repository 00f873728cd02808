"""Gated cross-attention and the modality frontend: the port against the
JAX package, on inputs made from a seed with numpy.

A cross layer's gate is 0 at init (``tanh(0) = 0``), and a wrong cross path
would then still give the right answer.  So every case here sets each gate
to a nonzero value (0.5 unless said) in the converted weights.

Tolerances, of the reference's max |x|: 1e-4 in float32, 3e-2 in
bfloat16; gradients (``jax.grad`` against autograd, float32) 1e-3 of each
leaf's max |g|, and no gradient may hold a NaN.  The model-level cases run
llama-3.2-vision's smoke config (5 layers, the last a cross layer, memory
of 16 patch embeddings of dimension 24), the reference compiled without
excess precision (``tests/test_torch_models.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as ref_get_smoke
from repro.models import attention as ref_attn
from repro.models import steps as ref_steps
from repro.models import transformer as ref_tr
from repro_torch.configs import get_smoke
from repro_torch.convert import model_params_from_numpy
from repro_torch.models import attention as attn
from repro_torch.models import steps, transformer as tr
from test_torch_models import _compiled, _rel

ARCH = "llama-3.2-vision-90b"
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
GRAD_TOL = 1e-3
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _gated(tree, value=0.5):
    """``tree`` (numpy, the reference's layout) with every cross layer's
    gate set to ``value`` (a scanned gate: each period's)."""
    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            elif path[-1:] == ("attn",) and k == "gate":
                node[k] = np.full(np.shape(v), value, np.float32)
    walk(tree, ())
    return tree


def _layer_inputs(cfg, seed=0, b=2, s=9, m=16):
    rng = np.random.default_rng(seed)
    params = {n: (rng.normal(size=d.shape) / np.sqrt(d.shape[0])
                  ).astype(np.float32)
              for n, d in attn.cross_attn_defs(cfg).items() if d.shape}
    params["gate"] = np.float32(0.5)
    x = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    mem = rng.normal(size=(b, m, cfg.d_model)).astype(np.float32)
    return params, x, mem


def test_cross_attn_defs_match_reference():
    cfg, ref_cfg = get_smoke(ARCH), ref_get_smoke(ARCH)
    got = {k: (d.shape, d.init) for k, d in attn.cross_attn_defs(cfg).items()}
    want = {k: (d.shape, d.init) for k, d in
            ref_attn.cross_attn_defs(ref_cfg).items()}
    assert got == want and got["gate"] == ((), "zeros")


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_cross_attention_matches_reference(dtype):
    cfg, ref_cfg = get_smoke(ARCH), ref_get_smoke(ARCH)
    params, x, mem = _layer_inputs(cfg)
    want = ref_attn.cross_attention(
        {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(x, JDT[dtype]), jnp.asarray(mem), ref_cfg, JDT[dtype])
    got = attn.cross_attention(
        {k: torch.tensor(v) for k, v in params.items()},
        torch.tensor(x).to(TDT[dtype]), torch.tensor(mem), cfg, TDT[dtype])
    assert got.dtype == TDT[dtype]
    assert _rel(got.float().numpy(), want) <= TOL[dtype]
    assert float(np.abs(np.asarray(want, np.float32)).max()) > 0.1


def test_gate_scales_the_output():
    """tanh(gate) scales the whole output: a zero gate adds exactly
    nothing, and gates 0.5 and -0.5 give opposite outputs."""
    cfg = get_smoke(ARCH)
    params, x, mem = _layer_inputs(cfg)
    p = {k: torch.tensor(v) for k, v in params.items()}
    args = (torch.tensor(x), torch.tensor(mem), cfg, torch.float32)
    pos = attn.cross_attention(p, *args)
    assert torch.equal(attn.cross_attention(dict(p, gate=torch.tensor(-0.5)),
                                            *args), -pos)
    zero = attn.cross_attention(dict(p, gate=torch.tensor(0.0)), *args)
    assert not zero.any() and pos.abs().max() > 0.1


def test_cross_attention_gradients():
    cfg, ref_cfg = get_smoke(ARCH), ref_get_smoke(ARCH)
    params, x, mem = _layer_inputs(cfg)
    cot = np.random.default_rng(9).normal(size=x.shape).astype(np.float32)

    def ref_loss(p, xx, mm):
        return jnp.sum(ref_attn.cross_attention(p, xx, mm, ref_cfg,
                                                jnp.float32) * cot)
    gp, gx, gm = jax.grad(ref_loss, argnums=(0, 1, 2))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
        jnp.asarray(mem))
    p = {k: torch.tensor(v).requires_grad_() for k, v in params.items()}
    xt, mt = (torch.tensor(a).requires_grad_() for a in (x, mem))
    torch.sum(attn.cross_attention(p, xt, mt, cfg, torch.float32)
              * torch.tensor(cot)).backward()
    for k in params:
        assert not torch.isnan(p[k].grad).any(), k
        assert _rel(p[k].grad.numpy(), gp[k]) <= GRAD_TOL, k
    assert _rel(xt.grad.numpy(), gx) <= GRAD_TOL
    assert _rel(mt.grad.numpy(), gm) <= GRAD_TOL
    assert float(p["gate"].grad) != 0.0


# --------------------------------------------------------------------------
# the model: memory_proj, memory=None, frontend embeds
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vision():
    """(reference params (gates 0.5), port model, f32), per dtype."""
    out = {}
    for dtype in TOL:
        ref_cfg = dataclasses.replace(ref_get_smoke(ARCH), dtype=dtype)
        cfg = dataclasses.replace(get_smoke(ARCH), dtype=dtype)
        tree = _gated(jax.tree.map(np.asarray, ref_tr.init_params(
            ref_cfg, jax.random.PRNGKey(0))))
        params = jax.tree.map(jnp.asarray, tree)
        out[dtype] = (ref_cfg, cfg, params,
                      model_params_from_numpy(cfg, tree, device="cpu"))
    return out


def _inputs(cfg, b=2, s=12, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    mem = (rng.normal(size=(b, cfg.cross_attn_memory_len,
                            cfg.frontend_embed_dim)) * 0.5).astype(np.float32)
    embeds = rng.normal(size=(b, s, cfg.frontend_embed_dim)).astype(np.float32)
    return toks, mem, embeds


@pytest.mark.parametrize("case", ["memory", "no_memory", "frontend_embeds",
                                  "embeds_and_memory"])
@pytest.mark.parametrize("dtype", sorted(TOL))
def test_model_forward_matches_reference(vision, dtype, case):
    """The forward over token ids or (B, S, F) embeds through
    ``frontend_proj``, with a memory projected once by ``memory_proj`` or
    without one (the cross layer attends to zeros (B, 1, d))."""
    ref_cfg, cfg, params, model = vision[dtype]
    toks, mem, embeds = _inputs(cfg)
    inp = embeds if "embeds" in case else toks
    memory = None if case in ("no_memory", "frontend_embeds") else mem
    want = _compiled(lambda p, t, m: ref_tr.forward(p, t, ref_cfg,
                                                    memory=m)[0],
                     params, jnp.asarray(inp),
                     None if memory is None else jnp.asarray(memory))
    with torch.no_grad():
        got = model(torch.as_tensor(inp), memory=None if memory is None
                    else torch.as_tensor(memory))[0]
    assert _rel(got.numpy(), want) <= TOL[dtype], _rel(got.numpy(), want)


def test_memory_changes_the_logits(vision):
    """With the gates at 0.5 the memory path is live: logits with a memory
    differ from logits without one (and at gate 0 they would not)."""
    _, cfg, _, model = vision["float32"]
    toks, mem, _ = _inputs(cfg)
    with torch.no_grad():
        a = model(torch.as_tensor(toks), memory=torch.as_tensor(mem))[0]
        b = model(torch.as_tensor(toks))[0]
    assert _rel(a.numpy(), b.numpy()) > 1e-3


def test_prefill_with_memory_matches_reference(vision):
    """prefill_step with a memory, as the reference's (it takes it third;
    the port's takes it as a keyword)."""
    ref_cfg, cfg, params, model = vision["float32"]
    toks, mem, _ = _inputs(cfg)
    st, got = steps.make_prefill_step(cfg, 16)(
        model, torch.as_tensor(toks), memory=torch.as_tensor(mem))
    _, want = _compiled(ref_steps.make_prefill_step(ref_cfg, 16), params,
                        jnp.asarray(toks), jnp.asarray(mem))
    assert _rel(got.numpy(), want) <= TOL["float32"]
    assert len(st) == cfg.num_layers and st[-1] == {}


def test_model_gradients_with_memory_and_embeds(vision):
    """The loss over frontend embeds with a memory: every parameter's
    gradient (``frontend_proj``, ``memory_proj``, the gate included)
    against ``jax.grad`` of the reference's loss; none holds a NaN."""
    ref_cfg, cfg, params, model = vision["float32"]
    toks, mem, embeds = _inputs(cfg)
    labels = np.roll(toks, -1, axis=1)
    batch = {"tokens": embeds, "labels": labels, "memory": mem}
    want = jax.grad(lambda p: ref_steps.loss_fn(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, ref_cfg)[0])(params)
    model.zero_grad()
    loss, _ = steps.loss_fn(model, {k: torch.as_tensor(v)
                                    for k, v in batch.items()})
    loss.backward()
    # a parameter the forward does not reach (the embedding, under embeds)
    # has no gradient here, a zero one in the reference (and in the train
    # step, which fills it in)
    got = {n: torch.zeros_like(p) if p.grad is None else p.grad
           for n, p in model.named_parameters()}
    grads = tr.weights_from_tree(cfg, jax.tree.map(
        lambda a: torch.tensor(np.asarray(a)), want))
    assert not grads["embed.embedding"].any()
    for n, g in grads.items():
        assert not torch.isnan(got[n]).any(), n
        assert _rel(got[n].numpy(), g.numpy()) <= GRAD_TOL, \
            f"{n}: {_rel(got[n].numpy(), g.numpy())}"
    model.zero_grad()
