"""The model zoo's training step: the port against the JAX package.

The same weights (the reference's ``init_params``, carried across by
``convert.model_params_from_numpy``) and the same batch, made from a seed
with numpy, go through the reference's jitted ``make_train_step`` and the
port's, for the five dense ``("attn",)`` configs at smoke size.  The
reference is compiled with ``xla_allow_excess_precision`` off, as in
``tests/test_torch_models.py``.

Tolerances (``TOL``), per reference leaf (a scanned leaf with its layers
stacked), of the leaf's max |x|:

* loss: 1e-5 relative in float32, 3e-2 in bfloat16; ``lr``: equal bits.
* gradients, read through ``m`` after one step (``m = (1 - b1) * g`` after
  the clip): 1e-3 of the leaf's max |m| in float32, 3e-2 in bfloat16;
  ``v`` (``~ g^2``) twice that; ``grad_norm`` to the same relative
  tolerance.  Two float32 evaluations of these random models sit about
  1e-4 apart by themselves: the reference's gradients are up to 1.5e-4 of
  max |g| from a float64 evaluation, the port's up to 1.0e-4, and the two
  up to 2.3e-4 from each other (starcoder2's smoke config; the card and
  the CPU up to 5.1e-4, ``grad_norm`` 1.0e-4 apart).  The reference draws
  a scanned leaf with fan_in = n_periods, so attention is near a hard
  argmax and amplifies rounding.
* parameters: step 1 of AdamW is ``p -= lr * (g / (|g| + eps) + wd * p)``,
  a sign function of ``g``.  Where |g| exceeds the gradient tolerance (the
  sign cannot differ) the parameters agree to 1e-2 * lr plus 2 ulp of
  |p|; elsewhere a sign may flip, moving an element by at most 2 * lr.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import TrainConfig as RefTrainConfig
from repro.configs import get_smoke as ref_get_smoke
from repro.models import steps as ref_steps
from repro.models import transformer as ref_tr
from repro.optim import adamw as ref_adamw
from repro_torch.checkpoint.checkpoint import _flatten
from repro_torch.common.config import TrainConfig
from repro_torch.configs import get_smoke
from repro_torch.convert import (
    model_params_from_numpy, model_tree_to_numpy, opt_state_to_numpy,
)
from repro_torch.models import steps, transformer as tr
from repro_torch.optim import adamw

DENSE = ["phi4-mini-3.8b", "mistral-nemo-12b", "minitron-8b",
         "starcoder2-3b", "musicgen-medium"]
TOL = {"float32": {"loss": 1e-5, "grad_norm": 1e-3, "grad": 1e-3},
       "bfloat16": {"loss": 3e-2, "grad_norm": 3e-2, "grad": 3e-2}}
ULP2 = 2.0 ** -22                  # 2 ulp of float32, relative


def _pair(arch, dtype):
    return (dataclasses.replace(ref_get_smoke(arch), dtype=dtype),
            dataclasses.replace(get_smoke(arch), dtype=dtype))


def _batch(cfg, b=4, s=16, seed=1):
    """Tokens and next-token labels; the first row's first 3 labels are
    pads (-1)."""
    tok = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    labels = tok[:, 1:].copy()
    labels[0, :3] = -1
    return {"tokens": tok[:, :-1], "labels": labels}


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def _ref_step(ref_cfg, ref_tcfg, params, batch, n=1):
    """``n`` reference train steps from a fresh optimizer state; returns
    (params, opt_state, metrics of each step) as numpy trees."""
    opt = ref_adamw.init_opt_state(params)
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    fn = _compiled(ref_steps.make_train_step(ref_cfg, ref_tcfg),
                   params, opt, batch)
    mets = []
    for _ in range(n):
        params, opt, met = fn(params, opt, batch)
        mets.append(jax.tree.map(np.asarray, met))
    return jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, opt), mets


def _port_step(cfg, tcfg, tree, batch, n=1):
    model = model_params_from_numpy(cfg, tree, device="cpu")
    opt = adamw.init_opt_state(dict(model.named_parameters()))
    step = steps.make_train_step(cfg, tcfg)
    mets = []
    for _ in range(n):
        opt, met = step(model, opt, {k: torch.as_tensor(v)
                                     for k, v in batch.items()})
        mets.append({k: v.numpy() for k, v in met.items()})
    return model_tree_to_numpy(cfg, model), opt_state_to_numpy(cfg, opt), mets


def _leaf_err(got, want):
    """Max |got - want| over max |want|, for each leaf of two trees."""
    return [float(np.abs(g - w).max() / (np.abs(w).max() + 1e-30))
            for g, w in zip(_flatten(got), jax.tree.leaves(want))]


def _check_params_step1(got, want, m_got, m_want, lr, tol):
    """The parameter rule of the module docstring, per reference leaf."""
    for p, q, mg, mw in zip(_flatten(got), jax.tree.leaves(want),
                            _flatten(m_got), jax.tree.leaves(m_want)):
        d = np.abs(p - q)
        ulp = ULP2 * np.abs(q)
        sure = (np.abs(mw) > tol * np.abs(mw).max()) & \
            (np.abs(mg - mw) <= tol * np.abs(mw).max())
        assert np.all(d[sure] <= 1e-2 * lr + ulp[sure]), \
            f"{float((d[sure] - ulp[sure]).max() / lr)} lr where g is sure"
        assert np.all(d <= 2 * lr + ulp), f"{float((d - ulp).max() / lr)} lr"


def test_cross_entropy_with_pad_labels():
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(3, 7, 11)) * 4).astype(np.float32)
    labels = rng.integers(0, 11, (3, 7)).astype(np.int32)
    labels[0, :4] = -1
    labels[2, 6] = -1
    got = steps.cross_entropy(torch.as_tensor(logits), torch.as_tensor(labels))
    want = np.asarray(ref_steps.cross_entropy(jnp.asarray(logits),
                                              jnp.asarray(labels)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    # every label a pad: the count is clamped to 1, the loss is 0
    pads = -np.ones((3, 7), np.int32)
    assert float(steps.cross_entropy(torch.as_tensor(logits),
                                     torch.as_tensor(pads))) == 0.0
    assert float(ref_steps.cross_entropy(jnp.asarray(logits),
                                         jnp.asarray(pads))) == 0.0


_CASES = {f"{a}-float32": (a, "float32", {}) for a in DENSE}
_CASES.update({
    "phi4-mini-3.8b-bfloat16": ("phi4-mini-3.8b", "bfloat16", {}),
    "microbatch2-of-4": ("mistral-nemo-12b", "float32", {"microbatch": 2}),
    "grads-bfloat16": ("phi4-mini-3.8b", "float32",
                       {"grads_dtype": "bfloat16"}),
    "grads-bfloat16-compute-bfloat16": ("starcoder2-3b", "bfloat16",
                                        {"grads_dtype": "bfloat16"}),
    "compression-fp16": ("phi4-mini-3.8b", "float32",
                         {"grad_compression": "fp16"}),
})


@pytest.mark.parametrize("case", sorted(_CASES))
def test_train_step_matches_reference(case):
    arch, dtype, kw = _CASES[case]
    ref_cfg, cfg = _pair(arch, dtype)
    params = ref_tr.init_params(ref_cfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    batch = _batch(cfg)
    p_ref, o_ref, (m_ref,) = _ref_step(
        ref_cfg, RefTrainConfig(total_steps=10, warmup_steps=2, **kw),
        params, batch)
    p_got, o_got, (m_got,) = _port_step(
        cfg, TrainConfig(total_steps=10, warmup_steps=2, **kw), tree, batch)
    tol = dict(TOL[dtype])
    if kw.get("grads_dtype") == "bfloat16":     # the gradients are bf16
        tol.update(grad=TOL["bfloat16"]["grad"],
                   grad_norm=TOL["bfloat16"]["grad_norm"])
    assert sorted(m_got) == sorted(m_ref) == \
        ["aux", "ce", "grad_norm", "loss", "lr"]
    assert m_got["lr"].tobytes() == np.float32(m_ref["lr"]).tobytes()
    for k in ("loss", "grad_norm"):
        err = abs(float(m_got[k]) - float(m_ref[k])) / abs(float(m_ref[k]))
        assert err <= tol[k], f"{k}: {err}"
    assert int(o_got["step"]) == int(o_ref["step"]) == 1
    assert max(_leaf_err(o_got["m"], o_ref["m"])) <= tol["grad"]
    assert max(_leaf_err(o_got["v"], o_ref["v"])) <= 2 * tol["grad"]
    _check_params_step1(p_got, p_ref, o_got["m"], o_ref["m"],
                        float(m_ref["lr"]), tol["grad"])


def test_train_step_int8_compression_matches_reference():
    """int8: per reference leaf one absmax scale.  An element whose
    gradient lies near a rounding boundary may quantize to the
    neighbouring level in the other package: ``m`` may differ by one
    quantum (1/127 of the leaf's max) there, and must agree to the float32
    tolerance on all but 0.1 % of the elements."""
    kw = {"grad_compression": "int8"}
    ref_cfg, cfg = _pair("phi4-mini-3.8b", "float32")
    params = ref_tr.init_params(ref_cfg, jax.random.PRNGKey(0))
    batch = _batch(cfg)
    p_ref, o_ref, (m_ref,) = _ref_step(
        ref_cfg, RefTrainConfig(total_steps=10, warmup_steps=2, **kw),
        params, batch)
    p_got, o_got, (m_got,) = _port_step(
        cfg, TrainConfig(total_steps=10, warmup_steps=2, **kw),
        jax.tree.map(np.asarray, params), batch)
    tol = TOL["float32"]
    for k in ("loss", "grad_norm"):
        assert abs(float(m_got[k]) / float(m_ref[k]) - 1) <= tol[k]
    off, total = 0, 0
    for g, w in zip(_flatten(o_got["m"]), jax.tree.leaves(o_ref["m"])):
        mx = np.abs(w).max()
        d = np.abs(g - w)
        assert d.max() <= mx * (1 / 127 + tol["grad"])
        off += int((d > tol["grad"] * mx).sum())
        total += d.size
    assert off <= 1e-3 * total, f"{off} of {total} elements off by a quantum"
    _check_params_step1(p_got, p_ref, o_got["m"], o_ref["m"],
                        float(m_ref["lr"]), tol["grad"])


@pytest.mark.parametrize("policy", ["nothing_saveable", "dots_saveable"])
def test_remat_equals_no_remat(policy):
    """Checkpointed blocks recompute the same ops on the same inputs: the
    loss, every gradient and the updated parameters are equal bit for
    bit."""
    base = dataclasses.replace(get_smoke("mistral-nemo-12b"), dtype="float32")
    batch = {k: torch.as_tensor(v) for k, v in _batch(base).items()}
    out = {}
    for remat in (False, True):
        cfg = dataclasses.replace(base, remat=remat, remat_policy=policy)
        model = tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        loss, _ = steps.loss_fn(model, batch)
        loss.backward()
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        opt = adamw.init_opt_state(dict(model.named_parameters()))
        _, met = steps.make_train_step(cfg, TrainConfig(total_steps=4))(
            model, opt, batch)
        out[remat] = (loss.detach(), grads, met["loss"],
                      {n: p.detach() for n, p in model.named_parameters()})
    (l0, g0, ml0, p0), (l1, g1, ml1, p1) = out[False], out[True]
    assert torch.equal(l0, l1) and torch.equal(ml0, ml1)
    assert all(torch.equal(g0[n], g1[n]) for n in g0)
    assert all(torch.equal(p0[n], p1[n]) for n in p0)


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "mistral-nemo-12b",
                                  "unscanned"])
def test_tree_from_weights_inverts_weights_from_tree(arch):
    """Tied (phi4) and untied (mistral) embeddings, and an unscanned
    layout (every layer under ``prefix``): the port's weights restack into
    the reference's tree, leaf for leaf and in its flatten order."""
    if arch == "unscanned":
        ref_cfg, cfg = (dataclasses.replace(c, scan_layers=False) for c in
                        _pair("phi4-mini-3.8b", "float32"))
    else:
        ref_cfg, cfg = _pair(arch, "float32")
    ref = jax.tree.map(np.asarray, ref_tr.init_params(
        ref_cfg, jax.random.PRNGKey(0)))
    tree = jax.tree.map(lambda a: torch.tensor(np.array(a)), ref)
    back = tr.tree_from_weights(cfg, tr.weights_from_tree(cfg, tree))
    assert jax.tree.structure(jax.tree.map(np.asarray, back)) == \
        jax.tree.structure(ref)
    for got, want in zip(_flatten(back), jax.tree.leaves(ref)):
        assert got.shape == want.shape and np.array_equal(got.numpy(), want)
    # the port's parameter names in the reference's leaf order
    names = [n for _, _, ns in tr.reference_leaves(cfg) for n in ns]
    model = tr.Transformer(cfg, tr.weights_from_tree(cfg, tree))
    assert sorted(names) == sorted(n for n, _ in model.named_parameters())
    paths = [tuple(k.key for k in p)
             for p, _ in jax.tree_util.tree_flatten_with_path(ref)[0]]
    assert [p for p, _, _ in tr.reference_leaves(cfg)] == paths


@pytest.mark.parametrize("arch", DENSE)
def test_forward_and_train_step(arch):
    """The reference's smoke-arch test on the port: the smoke config's
    own dtype, one forward and one train step on the CPU."""
    cfg = get_smoke(arch)
    model = tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    b, s = 2, 32
    tokens = torch.randint(0, cfg.vocab_size, (b, s),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        logits, _, aux = model(tokens)
    assert logits.shape == (b, s, cfg.vocab_size)
    assert bool(torch.all(torch.isfinite(logits))), "NaN/Inf in logits"
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = adamw.init_opt_state(dict(model.named_parameters()))
    _, met = steps.make_train_step(cfg, TrainConfig(total_steps=4))(
        model, opt, {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)})
    assert np.isfinite(float(met["loss"]))
    assert float(met["grad_norm"]) > 0.0
    delta = sum(float(torch.sum(torch.abs(p.detach() - before[n])))
                for n, p in model.named_parameters())
    assert delta > 0.0


def _run_train(*args, timeout=240):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args], cwd=root,
        env=env, capture_output=True, text=True, timeout=timeout)


def test_train_cli_fails_then_resumes(tmp_path):
    """``python -m repro_torch.launch.train --device cpu --smoke``: a
    ``--fail-at`` run leaves its last checkpoint, a plain run resumes from
    it and ends with a finite loss and the reference's report keys."""
    ck = str(tmp_path / "ck")
    common = ["--arch", "starcoder2-3b", "--smoke", "--steps", "6",
              "--batch", "2", "--seq", "32", "--device", "cpu",
              "--checkpoint-dir", ck, "--checkpoint-every", "2"]
    proc = _run_train(*common, "--fail-at", "5")
    assert proc.returncode != 0 and "SimulatedFailure" in proc.stderr
    assert sorted(os.listdir(ck)) == ["step_00000002", "step_00000004"]
    proc = _run_train(*common)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "resumed from checkpoint step 4" in proc.stdout
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert sorted(out) == ["loss", "params", "steps"]
    assert np.isfinite(out["loss"]) and out["steps"] == 6
    assert out["params"] == tr.count_params(get_smoke("starcoder2-3b"))
    proc = _run_train(*common, "--mesh", "single")
    assert proc.returncode != 0 and "6.6" in proc.stderr
