"""The model zoo's MoE configs, llama4-maverick (GQA attention, top-1 MoE
every other layer, one shared expert) and deepseek-v2 (MLA attention, a
dense first layer, then top-2 MoE with two shared experts): the port
against the JAX package at smoke size, on the reference's weights carried
across by ``convert.model_params_from_numpy``.

Tolerances, and why:

* logits of forward, prefill and decode: 1e-4 of max |logit| in float32,
  3e-2 in bfloat16, the dense configs' rule (``tests/test_torch_models.py``:
  the reference compiled without excess precision; an f32 step whose bf16
  cache rounded an element the other way held to 3e-2).  In bfloat16 the
  configs run with a ``capacity_factor`` that drops nothing (E / k): the
  router then sees activations that differ from the reference's by bf16
  rounding, and a flipped choice must not move other tokens' slots.
* router ids of every MoE layer: equal in float32 (routing is sensitive
  to ulps: a flipped choice moves the capacity slots of every later
  token).  In bfloat16 an id may differ only where the reference's top-k
  margin, (p_k - p_k+1) / p_k, is below bf16's epsilon 2^-7; the tests
  count such ids.
* ``ServeEngine``: the reference engine's greedy tokens (float32).
* one train step: ``tests/test_torch_train.py``'s tolerances, aux within
  1e-5 relative (float32).  A bfloat16 step (no-drop capacity) is held to
  the bf16 tolerance 3e-2 in loss, aux and ``grad_norm``, but its
  gradients (read through ``m``) only to 1e-1 of each leaf's max: the
  two packages' bf16 gradients of deepseek-v2's smoke model lie a few
  percent of max |g| apart, above the dense configs' 3e-2, while the
  reference's own bf16 gradients lie farther still from its f32 ones
  (the test checks that ordering and prints both distances).
* checkpoints: every leaf bit for bit, both ways.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as ref_ckpt
from repro.common.config import TrainConfig as RefTrainConfig
from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke as ref_get_smoke
from repro.launch.serve import serve as ref_serve
from repro.models import attention as ref_attn
from repro.models import moe as ref_moe
from repro.models import steps as ref_steps
from repro.models import transformer as ref_tr
from repro.models.layers import rms_norm as ref_rms_norm
from repro.optim import adamw as ref_adamw
from repro.serving.engine import Request as RefRequest
from repro.serving.engine import ServeEngine as RefServeEngine
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.common.config import TrainConfig
from repro_torch.configs import get_config, get_smoke
from repro_torch.convert import (
    model_params_from_numpy, model_tree_to_numpy, opt_state_from_numpy,
    opt_state_to_numpy,
)
from repro_torch.launch.serve import serve
from repro_torch.models import moe, steps, transformer as tr
from repro_torch.optim import adamw
from repro_torch.serving.engine import Request, ServeEngine
from test_torch_models import _compiled, _converted, _rel
from test_torch_train import (
    TOL as TRAIN_TOL, _batch, _check_params_step1, _leaf_err, _port_step,
    _ref_step, _run_train,
)

MOE = ["llama4-maverick-400b-a17b", "deepseek-v2-236b"]
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
BF16_EPS = 2.0 ** -7
# full width, cut in depth to fit one card: (layers, parameters)
FULL_WIDTH = {"deepseek-v2-236b": (4, 13_302_912_000),
              "llama4-maverick-400b-a17b": (2, 18_553_267_200)}


def _no_drop(cfg):
    mo = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        mo, capacity_factor=mo.num_experts / mo.top_k))


def _pair(arch, dtype, no_drop=False):
    out = [dataclasses.replace(get(arch), dtype=dtype)
           for get in (ref_get_smoke, get_smoke)]
    return [_no_drop(c) for c in out] if no_drop else out


def _cache_names(cfg):
    return ("ckv", "kr") if cfg.block_pattern == ("mla",) else ("k", "v")


def _cache_flips(cfg, state, ref_state) -> int:
    segs = tr.plan_segments(cfg)
    names = _cache_names(cfg)
    ref = [ref_state["prefix"][str(i)] for i in range(len(segs.prefix))]
    ref += [{n: ref_state["scanned"][str(j)][n][p] for n in names}
            for p in range(segs.n_periods) for j in range(len(segs.period))]
    return sum(int(np.sum(np.asarray(r[n], np.float32)
                          != ours[n].float().numpy()))
               for ours, r in zip(state, ref) for n in names)


def _port_ids(model) -> list:
    """The last call's router ids of each MoE layer, in layer order."""
    return [blk.ffn.stats["ids"].numpy() for blk in model.layers
            if isinstance(blk.ffn, moe.MoEFFN)]


def _ref_layers(ref_cfg, params):
    segs = ref_tr.plan_segments(ref_cfg)
    out = [(params["prefix"][str(i)], k, f)
           for i, (k, f) in enumerate(segs.prefix)]
    for p in range(segs.n_periods):
        for j, (k, f) in enumerate(segs.period):
            out.append((jax.tree.map(lambda a: a[p], params["scanned"][str(j)]),
                        k, f))
    return out


def _ref_ids(ref_cfg, params, toks) -> tuple:
    """The reference's router ids of each MoE layer over ``toks`` (run
    layer by layer, op by op) and each token's top-k margin there."""
    cdt = jnp.dtype(ref_cfg.dtype)
    mo = ref_cfg.moe
    x = params["embed"]["embedding"].astype(cdt)[jnp.asarray(toks)]
    b, s = toks.shape
    pos = jnp.broadcast_to(jnp.arange(s)[None], (b, s))
    ids, margins = [], []
    for lp, kind, ffn in _ref_layers(ref_cfg, params):
        if ffn == "moe":
            h = ref_rms_norm(x, lp["ln1"], ref_cfg.norm_eps)
            fn = (ref_attn.mla_attention if kind == "mla"
                  else ref_attn.gqa_attention)
            h2 = ref_rms_norm(x + fn(lp["attn"], h, pos, ref_cfg, None, cdt)[0],
                              lp["ln2"], ref_cfg.norm_eps)
            flat = h2.reshape(-1, ref_cfg.d_model)
            ids.append(np.asarray(ref_moe._router(lp["ffn"], flat, mo)[1]))
            probs = np.asarray(jax.nn.softmax(
                flat.astype(jnp.float32) @ lp["ffn"]["router"], axis=-1))
            top = -np.sort(-probs, axis=-1)
            margins.append((top[:, mo.top_k - 1] - top[:, mo.top_k])
                           / top[:, mo.top_k - 1])
        x = ref_tr.block_forward(lp, x, pos, ref_cfg, kind, ffn, None, None,
                                 cdt, False)[0]
    return ids, margins


def _differing_ids(got, want, margins, dtype) -> int:
    """Ids that differ, each only where the top-k margin allows it."""
    n = 0
    for g, w, m in zip(got, want, margins):
        rows = np.any(g != w, axis=-1)
        if dtype == "float32":
            assert not rows.any(), f"f32 router ids differ: {np.flatnonzero(rows)}"
        assert np.all(m[rows] < BF16_EPS), m[rows]
        n += int((g != w).sum())
    return n


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("arch", MOE)
def test_forward_prefill_decode_match_reference(arch, dtype):
    ref_cfg, cfg = _pair(arch, dtype, no_drop=dtype == "bfloat16")
    params, model = _converted(ref_cfg, cfg)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    tol = TOL[dtype]
    with torch.no_grad():
        got, _, aux = model(torch.as_tensor(toks))
    want, _, want_aux = _compiled(lambda p, t: ref_tr.forward(p, t, ref_cfg),
                                  params, jnp.asarray(toks))
    assert _rel(got.numpy(), want) <= tol, _rel(got.numpy(), want)
    assert abs(float(aux) / float(want_aux) - 1) <= 1e-5 * (
        1 if dtype == "float32" else 3e3)
    ref_ids, margins = _ref_ids(ref_cfg, params, toks)
    n_moe = sum(f == "moe" for _, f in tr.plan_segments(cfg).layers)
    assert len(ref_ids) == n_moe == 2
    differ = _differing_ids(_port_ids(model), ref_ids, margins, dtype)
    print(f"{arch} {dtype}: {differ} router ids differ")
    s, cap, b = 15, 19, toks.shape[0]
    state, got = steps.make_prefill_step(cfg, cap)(model, torch.as_tensor(toks[:, :s]))
    ref_state, want = _compiled(ref_steps.make_prefill_step(ref_cfg, cap),
                                params, jnp.asarray(toks[:, :s]))
    for what in ("prefill", "decode"):
        if what == "decode":
            state, got = steps.make_decode_step(cfg)(
                model, state, torch.as_tensor(toks[:, s:s + 1]),
                torch.full((b, 1), s, dtype=torch.int32))
            ref_state, want = _compiled(
                ref_steps.make_decode_step(ref_cfg), params, ref_state,
                jnp.asarray(toks[:, s:s + 1]), jnp.full((b, 1), s, jnp.int32))
        flips = _cache_flips(cfg, state, ref_state)
        bound = tol if flips == 0 else max(tol, TOL["bfloat16"])
        err = _rel(got.numpy(), want)
        assert err <= bound, f"{what}: {err} ({flips} cache flips)"


@pytest.mark.parametrize("arch", MOE)
def test_serve_engine_tokens_match_reference(arch):
    """The reference ServeEngine and the port's on the same converted
    weights (float32, the config's capacity_factor): two waves, ragged
    prompts, an empty slot, mixed budgets -- the same greedy tokens."""
    ref_cfg, cfg = _pair(arch, "float32")
    params, model = _converted(ref_cfg, cfg, seed=7)
    rng = np.random.default_rng(5)
    lens, budgets = (3, 7, 11, 5, 9), (6, 6, 3, 5, 6)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in lens]
    want = RefServeEngine(ref_cfg, params, batch_slots=3, capacity=32).run(
        [RefRequest(p, max_new_tokens=m) for p, m in zip(prompts, budgets)])
    got = ServeEngine(cfg, model, batch_slots=3, capacity=32).run(
        [Request(p, max_new_tokens=m) for p, m in zip(prompts, budgets)])
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]


@pytest.mark.parametrize("arch", MOE)
def test_serve_engine_keeps_the_router_f32(arch):
    """In bf16 serving every >= 2-D weight is cast once, but the router
    (read in f32) stays f32, so the served model routes as the reference's
    uncast tree does."""
    cfg = get_smoke(arch)
    model = tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ServeEngine(cfg, model, batch_slots=2, capacity=16)
    for name, p in model.named_parameters():
        want = (torch.float32 if p.ndim < 2 or name.endswith(".router")
                else torch.bfloat16)
        assert p.dtype == want, name


@pytest.mark.parametrize("arch", MOE)
def test_serve_launcher_report_matches_reference(arch):
    got = serve(arch, n_requests=3, max_new=3, batch_slots=2, device="cpu")
    want = ref_serve(arch, n_requests=3, max_new=3, batch_slots=2)
    assert sorted(got) == sorted(want)
    assert got["requests"] == want["requests"] == 3
    assert got["tokens_generated"] == want["tokens_generated"] == 9


@pytest.mark.parametrize("arch", MOE)
def test_count_params_match_reference(arch):
    for port, ref in ((get_config, ref_get_config), (get_smoke, ref_get_smoke)):
        assert tr.count_params(port(arch)) == ref_tr.count_params(ref(arch))
        assert tr.active_param_count(port(arch)) == \
            ref_tr.active_param_count(ref(arch))
    layers, n = FULL_WIDTH[arch]
    cut = dataclasses.replace(get_config(arch), num_layers=layers)
    assert tr.count_params(cut) == n == ref_tr.count_params(
        dataclasses.replace(ref_get_config(arch), num_layers=layers))
    assert tr.active_param_count(cut) == ref_tr.active_param_count(
        dataclasses.replace(ref_get_config(arch), num_layers=layers))


@pytest.mark.parametrize("arch", MOE)
def test_segments_and_state_match_reference(arch):
    """The layer plan (prefix, scanned period), the cache leaves (MLA's
    ``ckv``/``kr``, bf16) and ``init_state`` unstacked one dict a layer,
    at smoke size and at the full-width cut."""
    layers, _ = FULL_WIDTH[arch]
    for port, ref in ((get_smoke(arch), ref_get_smoke(arch)),
                      (dataclasses.replace(get_config(arch), num_layers=layers),
                       dataclasses.replace(ref_get_config(arch),
                                           num_layers=layers))):
        assert dataclasses.astuple(tr.plan_segments(port)) == \
            dataclasses.astuple(ref_tr.plan_segments(ref))
        assert tr.state_defs(port, 3, 20) == ref_tr.state_defs(ref, 3, 20)
    cfg = get_smoke(arch)
    state = tr.init_state(cfg, 3, 20, "cpu")
    assert len(state) == cfg.num_layers
    for layer in state:
        assert layer["index"] == 0
        for n in _cache_names(cfg):
            assert layer[n].dtype == torch.bfloat16 and layer[n].shape[:2] == (3, 20)


@pytest.mark.parametrize("arch", MOE)
def test_tree_from_weights_inverts_weights_from_tree(arch):
    """Nested ``ffn/shared/*``, the MLA leaves and the scanned 4-D expert
    stacks: the port's weights restack into the reference's tree, leaf for
    leaf and in its flatten order, and the model's parameter names are the
    reference leaves' port names."""
    ref_cfg, cfg = _pair(arch, "float32")
    ref = jax.tree.map(np.asarray, ref_tr.init_params(
        ref_cfg, jax.random.PRNGKey(0)))
    tree = jax.tree.map(lambda a: torch.tensor(np.array(a)), ref)
    back = tr.tree_from_weights(cfg, tr.weights_from_tree(cfg, tree))
    for got, want in zip(ckpt._flatten(back), jax.tree.leaves(ref)):
        assert got.shape == want.shape and np.array_equal(got.numpy(), want)
    assert any(len(d.shape) == 4 for _, d, _ in tr.reference_leaves(cfg))
    names = [n for _, _, ns in tr.reference_leaves(cfg) for n in ns]
    model = tr.Transformer(cfg, tr.weights_from_tree(cfg, tree))
    assert sorted(names) == sorted(n for n, _ in model.named_parameters())
    assert any(".ffn.shared." in n for n in names)
    paths = [tuple(k.key for k in p)
             for p, _ in jax.tree_util.tree_flatten_with_path(ref)[0]]
    assert [p for p, _, _ in tr.reference_leaves(cfg)] == paths


@pytest.mark.parametrize("arch", MOE)
def test_decode_matches_full_forward(arch):
    """prefill + decode == full forward with a capacity that drops nothing
    (the reference's test, on the port's own weights)."""
    cfg = _no_drop(dataclasses.replace(get_smoke(arch), dtype="float32"))
    model = tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    b, s = 2, 33
    tokens = torch.randint(0, cfg.vocab_size, (b, s),
                           generator=torch.Generator().manual_seed(1))
    state, _ = steps.make_prefill_step(cfg, s + 4)(model, tokens[:, : s - 1])
    _, dec = steps.make_decode_step(cfg)(
        model, state, tokens[:, s - 1:s],
        torch.full((b, 1), s - 1, dtype=torch.int32))
    with torch.no_grad():
        full, _, _ = model(tokens)
    assert _rel(dec.numpy(), full[:, -1].numpy()) < 0.15
    assert all(int(blk.ffn.stats["dropped"]) == 0 for blk in model.layers
               if isinstance(blk.ffn, moe.MoEFFN))


@pytest.mark.parametrize("arch", MOE)
def test_init_in_bf16_equals_f32_draw_cast(arch):
    """``param_dtype`` bf16 draws each leaf in f32 and rounds it once: the
    same bits as the f32 model cast to bf16 (how the full-width models are
    drawn on the card)."""
    cfg = get_smoke(arch)
    f32 = tr.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    bf = tr.init_params(dataclasses.replace(cfg, param_dtype="bfloat16"),
                        torch.Generator().manual_seed(3), "cpu")
    want = dict(f32.named_parameters())
    for n, p in bf.named_parameters():
        assert p.dtype == torch.bfloat16
        assert torch.equal(p, want[n].to(torch.bfloat16)), n


@pytest.mark.parametrize("arch", MOE)
def test_init_params_fan_in_rule(arch):
    """The reference's fan_in = shape[0]: a scanned expert stack's std is
    1/sqrt(n_periods), the prefix's 1/sqrt(E), MLA's ``wo``
    1/sqrt(num_heads), the router's 0.1/sqrt(d)."""
    cfg = get_smoke(arch)
    model = tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    segs = tr.plan_segments(cfg)
    for path, d, names in tr.reference_leaves(cfg):
        if d.init != "normal" or int(np.prod(d.shape)) < 2000:
            continue
        stacked = torch.stack([dict(model.named_parameters())[n].detach()
                               for n in names]) if path[0] == "scanned" \
            else dict(model.named_parameters())[names[0]].detach()
        std = d.scale / np.sqrt(d.shape[0])
        assert abs(float(stacked.std()) / std - 1) < 0.1, path
        if path[0] == "scanned":
            assert d.shape[0] == segs.n_periods


_TRAIN = {f"{a}-float32": (a, "float32", {}) for a in MOE}
_TRAIN["deepseek-v2-236b-bfloat16"] = ("deepseek-v2-236b", "bfloat16", {})
_TRAIN["llama4-microbatch2-of-4"] = ("llama4-maverick-400b-a17b", "float32",
                                     {"microbatch": 2})


@pytest.mark.parametrize("case", sorted(_TRAIN))
def test_train_step_matches_reference(case):
    arch, dtype, kw = _TRAIN[case]
    ref_cfg, cfg = _pair(arch, dtype, no_drop=dtype == "bfloat16")
    params = ref_tr.init_params(ref_cfg, jax.random.PRNGKey(0))
    batch = _batch(cfg)
    p_ref, o_ref, (m_ref,) = _ref_step(
        ref_cfg, RefTrainConfig(total_steps=10, warmup_steps=2, **kw),
        params, batch)
    p_got, o_got, (m_got,) = _port_step(
        cfg, TrainConfig(total_steps=10, warmup_steps=2, **kw),
        jax.tree.map(np.asarray, params), batch)
    tol = dict(TRAIN_TOL[dtype])
    if dtype == "bfloat16":
        tol["grad"] = 1e-1                    # module docstring
    assert m_got["lr"].tobytes() == np.float32(m_ref["lr"]).tobytes()
    for k in ("loss", "grad_norm"):
        err = abs(float(m_got[k]) - float(m_ref[k])) / abs(float(m_ref[k]))
        assert err <= tol[k], f"{k}: {err}"
    assert float(m_ref["aux"]) > 0 and np.isfinite(float(m_got["aux"]))
    aux_tol = 1e-5 if dtype == "float32" else tol["loss"]
    assert abs(float(m_got["aux"]) / float(m_ref["aux"]) - 1) <= aux_tol
    assert max(_leaf_err(o_got["m"], o_ref["m"])) <= tol["grad"]
    assert max(_leaf_err(o_got["v"], o_ref["v"])) <= 2 * tol["grad"]
    _check_params_step1(p_got, p_ref, o_got["m"], o_ref["m"],
                        float(m_ref["lr"]), tol["grad"])
    if dtype == "bfloat16":
        _, o32, _ = _ref_step(
            dataclasses.replace(ref_cfg, dtype="float32"),
            RefTrainConfig(total_steps=10, warmup_steps=2, **kw), params,
            batch)
        apart = max(_leaf_err(o_got["m"], o_ref["m"]))
        from_f32 = max(_leaf_err(jax.tree.map(np.asarray, o_ref["m"]),
                                 o32["m"]))
        print(f"{case}: bf16 m, port vs reference {apart:.4f}, "
              f"reference bf16 vs f32 {from_f32:.4f} of max")
        assert apart < from_f32


@pytest.mark.parametrize("arch", MOE)
def test_remat_equals_no_remat(arch):
    """Checkpointed MoE/MLA blocks recompute the same routing: the loss
    (aux included) and every gradient equal bit for bit."""
    base = dataclasses.replace(get_smoke(arch), dtype="float32")
    batch = {k: torch.as_tensor(v) for k, v in _batch(base).items()}
    out = {}
    for remat in (False, True):
        cfg = dataclasses.replace(base, remat=remat)
        model = tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        loss, met = steps.loss_fn(model, batch)
        loss.backward()
        out[remat] = (loss.detach(), met["aux"].detach(),
                      {n: p.grad for n, p in model.named_parameters()})
    assert torch.equal(out[False][0], out[True][0])
    assert torch.equal(out[False][1], out[True][1]) and float(out[True][1]) > 0
    assert all(torch.equal(g, out[True][2][n]) for n, g in out[False][2].items())


@pytest.mark.parametrize("arch", MOE)
def test_checkpoints_restore_both_ways(arch, tmp_path):
    """A checkpoint the reference writes restores in the port, and one the
    port writes (as ``launch.train`` does) restores in the reference, every
    leaf bit for bit; the restored state trains on in either package."""
    from repro_torch.launch.train import _state_tree
    ref_cfg, cfg = _pair(arch, "float32")
    batch = _batch(cfg)
    params = ref_tr.init_params(ref_cfg, jax.random.PRNGKey(0))
    opt = ref_adamw.init_opt_state(params)
    tcfg = dict(total_steps=8, warmup_steps=1)
    params, opt, _ = jax.jit(ref_steps.make_train_step(
        ref_cfg, RefTrainConfig(**tcfg)))(
        params, opt, {k: jnp.asarray(v) for k, v in batch.items()})
    d = str(tmp_path / "ref")
    ref_ckpt.save(d, 1, (params, opt))
    template = (jax.tree.map(lambda a: 0, params), jax.tree.map(lambda a: 0, opt))
    (p_tree, o_tree), step = ckpt.restore(d, template, device="cpu")
    assert step == 1
    model = model_params_from_numpy(
        cfg, jax.tree.map(lambda t: t.numpy(), p_tree), device="cpu")
    popt = opt_state_from_numpy(cfg, jax.tree.map(lambda t: t.numpy(), o_tree),
                                device="cpu")
    for got, want in zip(ckpt._flatten((model_tree_to_numpy(cfg, model),
                                        opt_state_to_numpy(cfg, popt))),
                         jax.tree.leaves((params, opt))):
        assert np.array_equal(got, np.asarray(want))
    popt, met = steps.make_train_step(cfg, TrainConfig(**tcfg))(
        model, popt, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert int(popt["step"]) == 2 and np.isfinite(float(met["loss"]))
    d2 = str(tmp_path / "port")
    ckpt.save(d2, 2, _state_tree(cfg, model, popt))
    (rp, ro), step = ref_ckpt.restore(d2, (params, opt))
    assert step == 2
    for got, want in zip(jax.tree.leaves((rp, ro)), ckpt._flatten(
            (model_tree_to_numpy(cfg, model), opt_state_to_numpy(cfg, popt)))):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    _, ro3, met = jax.jit(ref_steps.make_train_step(
        ref_cfg, RefTrainConfig(**tcfg)))(
        jax.tree.map(jnp.asarray, rp), jax.tree.map(jnp.asarray, ro),
        {k: jnp.asarray(v) for k, v in batch.items()})
    assert int(ro3["step"]) == 3 and np.isfinite(float(met["loss"]))


@pytest.mark.parametrize("arch", MOE)
def test_train_cli_fails_then_resumes(arch, tmp_path):
    """``python -m repro_torch.launch.train --arch <moe> --smoke --device
    cpu``: a ``--fail-at`` run leaves its checkpoints, a plain run resumes
    from the last and ends with a finite loss."""
    ck = str(tmp_path / "ck")
    common = ["--arch", arch, "--smoke", "--steps", "6", "--batch", "2",
              "--seq", "32", "--device", "cpu", "--checkpoint-dir", ck,
              "--checkpoint-every", "2"]
    proc = _run_train(*common, "--fail-at", "5")
    assert proc.returncode != 0 and "SimulatedFailure" in proc.stderr
    proc = _run_train(*common)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "resumed from checkpoint step 4" in proc.stdout
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert np.isfinite(out["loss"]) and out["steps"] == 6
    assert out["params"] == tr.count_params(get_smoke(arch))


@pytest.mark.parametrize("arch", MOE)
def test_forward_and_train_step_in_the_smoke_dtype(arch):
    """The reference's smoke-arch test on the port: bf16 compute, f32
    masters, one forward and one train step; aux > 0 and finite."""
    cfg = get_smoke(arch)
    model = tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 32),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        logits, _, aux = model(tokens)
    assert logits.shape == (2, 32, cfg.vocab_size)
    assert bool(torch.all(torch.isfinite(logits)))
    assert 0 < float(aux) < 1
    opt = adamw.init_opt_state(dict(model.named_parameters()))
    _, met = steps.make_train_step(cfg, TrainConfig(total_steps=4))(
        model, opt, {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)})
    assert np.isfinite(float(met["loss"])) and float(met["grad_norm"]) > 0
    assert 0 < float(met["aux"]) < 1
