"""The training path of the zoo's SSM and cross-attention configs
(zamba2, xlstm, llama-3.2-vision) at smoke size: the port against the JAX
package.

One train step on the reference's converted weights (llama-vision's cross
gates 0.5, a memory in the batch) is held to ``tests/test_torch_train.py``'s
tolerances: loss 1e-5 relative in float32, 3e-2 in bfloat16; ``lr`` equal
bits; ``grad_norm`` and the gradients, read through ``m``, 1e-3 of each
leaf's max in float32.  In bfloat16 the gradients are held to 1e-1, as
``tests/test_torch_models_moe.py`` holds deepseek-v2's: zamba2's port and
reference lie 0.043 of max |m| apart, the reference's own bf16 gradients
1.94 from its f32 ones (the test checks that ordering).  The step-1
parameter rule is ``test_torch_train``'s, with one premise made explicit:
its "sure" elements, where the step is the sign of g, are those where
|g| also exceeds 100 * eps (AdamW's eps 1e-8); below that the step is
g / (|g| + eps), no sign.  zamba2's scanned Mamba2 leaves have gradients
of max |g| ~ 2e-5, whose smallest elements lie there.
A checkpoint either package writes restores in the other, leaf for leaf.
The reference's ``slow`` training tests, ported at smoke size:
``test_forward_and_train_step`` (``tests/test_smoke_archs.py``, with a
memory for llama-vision) and the restart after an injected failure on
xlstm-350m (``tests/test_substrate.py``).
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
from repro_torch.launch.train import SimulatedFailure, _state_tree, train
from repro_torch.models import steps, transformer as tr
from repro_torch.optim import adamw
from test_torch_cross_attn import _gated
from test_torch_models_ssm import ARCHS, SSM_ARCHS, _memory, _pair
from test_torch_train import (
    TOL, _batch, _check_params_step1, _leaf_err, _port_step, _ref_step,
    _run_train,
)


def _train_batch(cfg, b=4, s=16):
    """``_batch`` (tokens, labels with pads), and a memory for the cross
    layers."""
    batch = _batch(cfg, b=b, s=s)
    mem = _memory(cfg, b)
    if mem is not None:
        batch["memory"] = mem
    return batch


def _check_params(got, want, m_got, m_want, lr, tol, b1=0.9, eps=1e-8):
    """``test_torch_train._check_params_step1`` on the elements whose step
    is a sign (|g| = |m| / (1 - b1) >= 100 eps); every element within
    ``2 * lr`` plus 2 ulp."""
    def signed(m):
        return [np.where(np.abs(a) >= 100 * eps * (1 - b1), a, 0.0)
                for a in m]
    _check_params_step1(got, want, signed(ckpt._flatten(m_got)),
                        signed(jax.tree.leaves(m_want)), lr, tol)


def _ref_params(ref_cfg, seed=0):
    return jax.tree.map(jnp.asarray, _gated(jax.tree.map(
        np.asarray, ref_tr.init_params(ref_cfg, jax.random.PRNGKey(seed)))))


_CASES = {f"{a}-float32": (a, "float32") for a in ARCHS}
_CASES["zamba2-1.2b-bfloat16"] = ("zamba2-1.2b", "bfloat16")


@pytest.mark.parametrize("case", sorted(_CASES))
def test_train_step_matches_reference(case):
    arch, dtype = _CASES[case]
    ref_cfg, cfg = _pair(arch, dtype)
    params = _ref_params(ref_cfg)
    batch = _train_batch(cfg)
    p_ref, o_ref, (m_ref,) = _ref_step(
        ref_cfg, RefTrainConfig(total_steps=10, warmup_steps=2), params, batch)
    p_got, o_got, (m_got,) = _port_step(
        cfg, TrainConfig(total_steps=10, warmup_steps=2),
        jax.tree.map(np.asarray, params), batch)
    tol = dict(TOL[dtype])
    if dtype == "bfloat16":
        tol["grad"] = 1e-1                    # module docstring
    assert m_got["lr"].tobytes() == np.float32(m_ref["lr"]).tobytes()
    for k in ("loss", "grad_norm"):
        err = abs(float(m_got[k]) - float(m_ref[k])) / abs(float(m_ref[k]))
        assert err <= tol[k], f"{k}: {err}"
    m_err = max(_leaf_err(o_got["m"], o_ref["m"]))
    assert not any(np.isnan(a).any() for a in ckpt._flatten(o_got["m"]))
    assert m_err <= tol["grad"], m_err
    assert max(_leaf_err(o_got["v"], o_ref["v"])) <= 2 * tol["grad"]
    _check_params(p_got, p_ref, o_got["m"], o_ref["m"], float(m_ref["lr"]),
                  tol["grad"])
    if dtype == "bfloat16":
        _, o32, _ = _ref_step(
            dataclasses.replace(ref_cfg, dtype="float32"),
            RefTrainConfig(total_steps=10, warmup_steps=2), params, batch)
        from_f32 = max(_leaf_err(jax.tree.map(np.asarray, o_ref["m"]),
                                 o32["m"]))
        print(f"{case}: bf16 m, port vs reference {m_err:.4f}, reference "
              f"bf16 vs f32 {from_f32:.4f} of max")
        assert m_err < from_f32


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_restore_both_ways(arch, tmp_path):
    """A checkpoint the reference writes restores in the port, and one the
    port writes (as ``launch.train`` does) restores in the reference, every
    leaf bit for bit -- the SSM ``mixer`` leaves, the 0-d cross gate,
    ``frontend_proj`` and ``memory_proj`` included; the restored state
    trains on in either package."""
    ref_cfg, cfg = _pair(arch, "float32")
    batch = _train_batch(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    params = _ref_params(ref_cfg)
    opt = ref_adamw.init_opt_state(params)
    tcfg = dict(total_steps=8, warmup_steps=1)
    ref_step = jax.jit(ref_steps.make_train_step(ref_cfg, RefTrainConfig(**tcfg)))
    params, opt, _ = ref_step(params, opt, jbatch)
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
    _, ro3, met = ref_step(jax.tree.map(jnp.asarray, rp),
                           jax.tree.map(jnp.asarray, ro), jbatch)
    assert int(ro3["step"]) == 3 and np.isfinite(float(met["loss"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_train_step(arch):
    """The reference's smoke-arch test (``slow`` there) on the port: the
    smoke config's own dtype (bf16 compute, f32 masters), one forward and
    one train step on the CPU, with a memory for llama-vision's cross
    layers; every parameter moves, ``frontend_proj`` (unused under token
    ids) by weight decay alone."""
    cfg = get_smoke(arch)
    model = tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    b, s = 2, 32
    tokens = torch.randint(0, cfg.vocab_size, (b, s),
                           generator=torch.Generator().manual_seed(1))
    mem = _memory(cfg, b)
    memory = None if mem is None else torch.as_tensor(mem)
    with torch.no_grad():
        logits, _, _ = model(tokens, memory=memory)
    assert logits.shape == (b, s, cfg.vocab_size)
    assert bool(torch.all(torch.isfinite(logits))), "NaN/Inf in logits"
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    if memory is not None:
        batch["memory"] = memory
    opt = adamw.init_opt_state(dict(model.named_parameters()))
    _, met = steps.make_train_step(cfg, TrainConfig(total_steps=4))(
        model, opt, batch)
    assert np.isfinite(float(met["loss"])) and float(met["grad_norm"]) > 0.0
    moved = {n: float(torch.sum(torch.abs(p.detach() - before[n])))
             for n, p in model.named_parameters()}
    assert sum(moved.values()) > 0.0
    # every >= 1-element leaf with a nonzero value moves (decay or gradient)
    assert all(v > 0 for n, v in moved.items() if before[n].abs().sum() > 0)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_remat_equals_no_remat(arch):
    """Checkpointed SSM blocks recompute the same scans: the loss and every
    gradient equal bit for bit."""
    base = dataclasses.replace(get_smoke(arch), dtype="float32")
    batch = {k: torch.as_tensor(v) for k, v in _batch(base).items()}
    out = {}
    for remat in (False, True):
        cfg = dataclasses.replace(base, remat=remat)
        model = tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        loss, _ = steps.loss_fn(model, batch)
        loss.backward()
        out[remat] = (loss.detach(),
                      {n: p.grad for n, p in model.named_parameters()})
    assert torch.equal(out[False][0], out[True][0])
    assert all(torch.equal(g, out[True][1][n]) for n, g in out[False][1].items())


def test_train_restart_after_injected_failure(tmp_path):
    """The reference's restart test on its own arch, xlstm-350m (``slow``
    there): a crash at step 9 leaves the step-8 checkpoint, a rerun resumes
    there and finishes 12 steps with a finite loss."""
    d = str(tmp_path / "ck")
    with pytest.raises(SimulatedFailure):
        train("xlstm-350m", steps_n=12, batch=2, seq=32, ckpt_dir=d,
              ckpt_every=4, fail_at=9, log_every=100, device="cpu")
    assert ckpt.latest_step(d) == 8
    out = train("xlstm-350m", steps_n=12, batch=2, seq=32, ckpt_dir=d,
                ckpt_every=4, log_every=100, device="cpu")
    assert np.isfinite(out["loss"]) and ckpt.latest_step(d) == 12


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "llama-3.2-vision-90b"])
def test_train_cli(arch, tmp_path):
    """``python -m repro_torch.launch.train --arch <arch> --smoke --device
    cpu``: the reference's report keys, a finite loss, the smoke config's
    parameter count."""
    proc = _run_train("--arch", arch, "--smoke", "--steps", "3", "--batch",
                      "2", "--seq", "32", "--device", "cpu",
                      "--checkpoint-dir", str(tmp_path / "ck"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert sorted(out) == ["loss", "params", "steps"]
    assert np.isfinite(out["loss"]) and out["steps"] == 3
    assert out["params"] == tr.count_params(get_smoke(arch))
