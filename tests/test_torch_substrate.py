"""The training substrate of the port against the JAX package: checkpoints
(atomicity, rotation, the reference's format in both directions),
fault-tolerant restart, the optimizer and its schedule.

Tolerances: the optimizer on identical inputs within 1e-6 of each leaf's
max |x| (XLA's and torch's ``pow`` may round a bias correction an ulp
apart, and XLA fuses products and sums into multiply-adds), ``lr`` with
equal bits (the schedule's own test says where it may differ by an ulp).  Training across the packages is held to
``tests/test_torch_train.py``'s float32 tolerances: loss 1e-5 relative,
``grad_norm`` 1e-3, ``m`` 1e-3 of its leaf's max, and parameters within
``2.5 * lr`` a step (AdamW's ``|m_hat| / sqrt(v_hat)`` stays under 1.2 for
b1 0.9, b2 0.95; past step 1 the update is a ratio of moments, so an
element whose gradient is near its tolerance may move by a fair part of
``lr`` between two f32 evaluations).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as ref_ckpt
from repro.common.config import TrainConfig as RefTrainConfig
from repro.configs import get_smoke as ref_get_smoke
from repro.models import steps as ref_steps
from repro.models import transformer as ref_tr
from repro.optim import adamw as ref_adamw
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.common.config import TrainConfig
from repro_torch.configs import get_smoke
from repro_torch.convert import (
    model_params_from_numpy, model_tree_to_numpy, opt_state_from_numpy,
    opt_state_to_numpy,
)
from repro_torch.models import steps
from repro_torch.optim import adamw

ULP2 = 2.0 ** -22                  # 2 ulp of float32, relative


# --------------------------------------------------------------------------
# checkpointing (the reference's tests on the port)
# --------------------------------------------------------------------------

def test_checkpoint_roundtrip_and_rotation(tmp_path):
    d = str(tmp_path / "ck")
    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": {"c": torch.ones(4)}}
    for step in (10, 20, 30, 40):
        ckpt.save(d, step, tree, keep=2)
    assert ckpt.latest_step(d) == 40
    names = sorted(os.listdir(d))
    assert names == ["step_00000030", "step_00000040"]    # rotation kept 2
    restored, step = ckpt.restore(d, tree)
    assert step == 40
    assert torch.equal(restored["a"], tree["a"])
    assert torch.equal(restored["b"]["c"], tree["b"]["c"])


def test_checkpoint_atomicity_no_partial_reads(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, {"w": torch.zeros(8)})
    # a stale .tmp dir (simulated crash mid-write) must be invisible
    os.makedirs(os.path.join(d, "step_00000002.tmp"))
    assert ckpt.latest_step(d) == 1


def test_checkpoint_incompatible_template_rejected(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 5, {"w": torch.zeros(8)})
    with pytest.raises(ValueError):
        ckpt.restore(d, {"w": torch.zeros(8), "extra": torch.zeros(2)})


def test_restore_onto_a_mesh_waits_for_the_model_mesh(tmp_path):
    """The reference reshards a restore onto a mesh (its elastic restore);
    the port has no model mesh yet and says so."""
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, {"w": torch.arange(16.0).reshape(4, 4)})
    with pytest.raises(NotImplementedError, match="6.6"):
        ckpt.restore(d, {"w": 0}, mesh=object(), specs={"w": None})
    restored, _ = ckpt.restore(d, {"w": 0}, device="cpu")
    assert torch.equal(restored["w"], torch.arange(16.0).reshape(4, 4))


def test_checkpoint_leaf_order_is_jax_flatten_order():
    """Sorted dict keys at every level (``"10"`` before ``"2"``), tuples
    in order, ``None`` an empty subtree."""
    tree = ({"b": {"10": 1, "2": 2, "0": 3}, "a": (4, None, 5)},
            {"step": 6, "m": [7, 8]})
    assert ckpt._flatten(tree) == jax.tree.leaves(tree)
    back = ckpt._unflatten(tree, iter(ckpt._flatten(tree)))
    assert back == tree and list(back[0]) == ["b", "a"]


# --------------------------------------------------------------------------
# fault-tolerant training
# --------------------------------------------------------------------------

def test_train_restart_after_injected_failure(tmp_path):
    """The reference's restart test (``xlstm-350m``, slow there) on a
    dense smoke arch, in process."""
    from repro_torch.launch.train import SimulatedFailure, train
    d = str(tmp_path / "ck")
    kw = dict(steps_n=12, batch=2, seq=32, ckpt_dir=d, ckpt_every=4,
              log_every=100, device="cpu")
    with pytest.raises(SimulatedFailure):
        train("phi4-mini-3.8b", fail_at=9, **kw)
    assert ckpt.latest_step(d) == 8            # progress survived the crash
    out = train("phi4-mini-3.8b", **kw)        # resumes at 8, finishes
    assert np.isfinite(out["loss"])
    assert ckpt.latest_step(d) == 12


# --------------------------------------------------------------------------
# optimizer
# --------------------------------------------------------------------------

def test_adamw_decreases_loss_quadratic():
    tcfg = TrainConfig(learning_rate=0.1, warmup_steps=1, total_steps=50,
                       weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    opt = adamw.init_opt_state(params)
    for _ in range(50):
        g = {"w": 2 * params["w"]}           # grad of sum(w^2)
        params, opt, _ = adamw.adamw_update(params, g, opt, tcfg)
    assert float(torch.sum(torch.square(params["w"]))) < 0.1


def test_grad_compression_roundtrip():
    g = {"a": torch.tensor([0.5, -1.5, 2.0]), "b": torch.tensor([[1e-3, -1e-3]])}
    for mode in ("fp16", "int8"):
        payload, deq = adamw.compress_grads(g, mode)
        back = deq(payload)
        for k in g:
            np.testing.assert_allclose(back[k].numpy(), g[k].numpy(),
                                       atol=0.02 if mode == "int8" else 1e-3)
        want = jax.tree.map(np.asarray, ref_adamw.compress_grads(
            {k: jnp.asarray(v.numpy()) for k, v in g.items()}, mode)[0])
        for k in g:
            assert np.array_equal(payload[k].numpy(), want[k])


def test_grad_clip():
    g = {"w": torch.full((4,), 100.0)}
    clipped, norm = adamw.clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(200.0)
    assert float(adamw.global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)


_SCHEDULES = [dict(total_steps=50, warmup_steps=5),
              dict(total_steps=12, warmup_steps=1, learning_rate=1e-3),
              dict(total_steps=6, warmup_steps=1),
              dict(total_steps=1000, warmup_steps=100)]


@pytest.mark.parametrize("i", range(len(_SCHEDULES)))
def test_cosine_schedule_matches_reference(i):
    """Every step from 0 past the end against the compiled reference:
    equal f32 bits through the warmup; past it, at most one ulp apart and
    equal on all but 1 % of the steps, or one step (the reference's cosine
    is the host libm's ``cosf``, the port's the correctly rounded one; they
    differ for about 1 % of arguments)."""
    kw = _SCHEDULES[i]
    lr, ref = (adamw.cosine_schedule(TrainConfig(**kw)),
               jax.jit(ref_adamw.cosine_schedule(RefTrainConfig(**kw))))
    n = kw["total_steps"] + 3
    got = np.array([lr(torch.tensor(s, dtype=torch.int32)).numpy()
                    for s in range(n)])
    want = np.array([np.asarray(ref(jnp.int32(s))) for s in range(n)])
    assert got.dtype == want.dtype == np.float32
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32))
    w = kw["warmup_steps"]
    assert not ulps[:w].any() and ulps.max() <= 1
    assert (ulps[w:] > 0).sum() <= max(1, 0.01 * (n - w))


@pytest.mark.parametrize("clip", [True, False])
def test_adamw_update_matches_reference_over_10_steps(clip):
    """Random trees, random gradients each step (norm ≈ 170, clipped to
    1, or ≈ 0.02, unclipped), a learning rate through warmup and decay:
    params, ``m``, ``v`` within 1e-6 of each leaf's max, the step, norm
    and ``lr`` each step."""
    rng = np.random.default_rng(3)
    shapes = {"a": (5, 7), "b": (3,), "c": (2, 3, 4)}
    kw = dict(total_steps=10, warmup_steps=3)
    tcfg, ref_tcfg = TrainConfig(**kw), RefTrainConfig(**kw)
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    params = {k: torch.tensor(v) for k, v in p0.items()}
    opt = adamw.init_opt_state(params)
    ref_p = {k: jnp.asarray(v) for k, v in p0.items()}
    ref_o = ref_adamw.init_opt_state(ref_p)
    upd = jax.jit(lambda p, g, o: ref_adamw.adamw_update(p, g, o, ref_tcfg))
    scale = 30.0 if clip else 3e-3
    for _ in range(10):
        g = {k: (rng.normal(size=s) * scale).astype(np.float32)
             for k, s in shapes.items()}
        params, opt, met = adamw.adamw_update(
            params, {k: torch.tensor(v) for k, v in g.items()}, opt, tcfg)
        ref_p, ref_o, ref_met = upd(ref_p, {k: jnp.asarray(v)
                                            for k, v in g.items()}, ref_o)
        assert int(opt["step"]) == int(ref_o["step"])
        assert met["lr"].numpy().tobytes() == np.asarray(ref_met["lr"]).tobytes()
        assert abs(float(met["grad_norm"]) / float(ref_met["grad_norm"]) - 1) \
            <= 1e-6
        assert (float(met["grad_norm"]) > 1.0) == clip
        for got, want in ((params, ref_p), (opt["m"], ref_o["m"]),
                          (opt["v"], ref_o["v"])):
            for k in shapes:
                w = np.asarray(want[k])
                assert np.abs(got[k].numpy() - w).max() <= \
                    1e-6 * np.abs(w).max(), k


# --------------------------------------------------------------------------
# checkpoints across the packages
# --------------------------------------------------------------------------

_ARCH = "phi4-mini-3.8b"


def _cfgs():
    return (dataclasses.replace(ref_get_smoke(_ARCH), dtype="float32"),
            dataclasses.replace(get_smoke(_ARCH), dtype="float32"))


def _batch(cfg):
    tok = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (4, 17)).astype(np.int32)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:].copy()}


_TCFG = dict(total_steps=8, warmup_steps=1)


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """The reference trains 2 steps and saves; the port restores them and
    trains steps 3 and 4; the reference's own 4 steps agree."""
    ref_cfg, cfg = _cfgs()
    batch = _batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = ref_tr.init_params(ref_cfg, jax.random.PRNGKey(0))
    opt = ref_adamw.init_opt_state(params)
    fn = jax.jit(ref_steps.make_train_step(ref_cfg, RefTrainConfig(**_TCFG))
                 ).lower(params, opt, jb).compile(
        compiler_options={"xla_allow_excess_precision": False})
    d = str(tmp_path / "ck")
    ref_mets = []
    for step in range(4):
        params, opt, met = fn(params, opt, jb)
        ref_mets.append(jax.tree.map(np.asarray, met))
        if step == 1:
            ref_ckpt.save(d, 2, (params, opt))
    template = (jax.tree.map(lambda a: 0, params),
                jax.tree.map(lambda a: 0, opt))
    (p_tree, o_tree), step = ckpt.restore(d, template, device="cpu")
    assert step == 2 and o_tree["step"].dtype == torch.int32
    model = model_params_from_numpy(
        cfg, jax.tree.map(lambda t: t.numpy(), p_tree), device="cpu")
    popt = opt_state_from_numpy(cfg, jax.tree.map(lambda t: t.numpy(), o_tree),
                                device="cpu")
    train_step = steps.make_train_step(cfg, TrainConfig(**_TCFG))
    lrs = 0.0
    for want in ref_mets[2:]:
        popt, met = train_step(model, popt, {k: torch.as_tensor(v)
                                             for k, v in batch.items()})
        assert met["lr"].numpy().tobytes() == np.float32(want["lr"]).tobytes()
        assert abs(float(met["loss"]) / float(want["loss"]) - 1) <= 1e-5
        assert abs(float(met["grad_norm"]) / float(want["grad_norm"]) - 1) \
            <= 1e-3
        lrs += float(want["lr"])
    assert int(popt["step"]) == int(opt["step"]) == 4
    got_o = opt_state_to_numpy(cfg, popt)
    for g, w in zip(ckpt._flatten(got_o["m"]), jax.tree.leaves(opt["m"])):
        w = np.asarray(w)
        assert np.abs(g - w).max() <= 1e-3 * np.abs(w).max()
    for g, w in zip(ckpt._flatten(model_tree_to_numpy(cfg, model)),
                    jax.tree.leaves(params)):
        w = np.asarray(w)
        assert np.all(np.abs(g - w) <= 2.5 * lrs + ULP2 * np.abs(w))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    """The port trains 2 steps and saves (as ``launch.train`` does); the
    reference's ``restore`` reads every leaf back exactly, and its train
    step continues from it."""
    from repro_torch.launch.train import _state_tree
    ref_cfg, cfg = _cfgs()
    batch = _batch(cfg)
    params = jax.tree.map(np.asarray, ref_tr.init_params(
        ref_cfg, jax.random.PRNGKey(0)))
    model = model_params_from_numpy(cfg, params, device="cpu")
    popt = adamw.init_opt_state(dict(model.named_parameters()))
    train_step = steps.make_train_step(cfg, TrainConfig(**_TCFG))
    for _ in range(2):
        popt, _ = train_step(model, popt, {k: torch.as_tensor(v)
                                           for k, v in batch.items()})
    d = str(tmp_path / "ck")
    ckpt.save(d, 2, _state_tree(cfg, model, popt))
    ref_template = (params, ref_adamw.init_opt_state(params))
    (rp, ro), step = ref_ckpt.restore(d, ref_template)
    assert step == 2
    want_p, want_o = model_tree_to_numpy(cfg, model), opt_state_to_numpy(cfg, popt)
    assert jax.tree.structure(rp) == jax.tree.structure(want_p)
    for got, want in zip(jax.tree.leaves((rp, ro)),
                         ckpt._flatten((want_p, want_o))):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert int(ro["step"]) == 2
    _, ro3, met = jax.jit(ref_steps.make_train_step(
        ref_cfg, RefTrainConfig(**_TCFG)))(
        jax.tree.map(jnp.asarray, rp), jax.tree.map(jnp.asarray, ro),
        {k: jnp.asarray(v) for k, v in batch.items()})
    assert int(ro3["step"]) == 3 and np.isfinite(float(met["loss"]))
