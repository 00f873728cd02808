"""The model zoo's training path on the card against the CPU.

These tests need a CUDA device and skip without one.  The file imports
neither jax nor the JAX package, so it runs on a GPU machine that has only
the port's dependencies:

    python -m pytest -q tests/test_torch_train_cuda.py

One set of float32 weights, drawn on the CPU and copied to the card, takes
two train steps on each device from the same batch (TF32 off).  Held to
``tests/test_torch_train.py``'s float32 tolerances: loss 1e-5 relative,
``grad_norm`` 1e-3, ``lr`` equal, ``m`` within 1e-3 of each parameter's
max |m|; parameters within ``2.5 * lr`` a step (AdamW's
``|m_hat| / sqrt(v_hat)`` stays under 1.2 for b1 0.9, b2 0.95; past step
1 the update is a ratio of moments, so an element whose gradient is near
its tolerance may move by a fair part of ``lr`` between two f32
evaluations).  ``launch.train --device cuda``
then fails at an injected step and resumes from its checkpoint.
``chip_smoke.py`` phase 10 runs the same checks over all five dense smoke
configs.
"""

import copy
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.common.config import TrainConfig
from repro_torch.configs import get_smoke
from repro_torch.models import steps, transformer
from repro_torch.optim import adamw

ULP2 = 2.0 ** -22                  # 2 ulp of float32, relative


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "mistral-nemo-12b"])
def test_card_step_matches_cpu_step(cuda_device, arch):
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    cpu = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    models = {"cpu": cpu, "cuda": copy.deepcopy(cpu).to(cuda_device)}
    tok = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 17))
    tcfg = TrainConfig(total_steps=4, warmup_steps=1)
    out = {}
    for dev, model in models.items():
        opt = adamw.init_opt_state(dict(model.named_parameters()))
        batch = {"tokens": torch.as_tensor(tok[:, :-1], device=dev),
                 "labels": torch.as_tensor(tok[:, 1:], device=dev)}
        step = steps.make_train_step(cfg, tcfg)
        mets = []
        for _ in range(2):
            opt, met = step(model, opt, batch)
            mets.append({k: v.cpu() for k, v in met.items()})
        out[dev] = (mets, {n: v.cpu() for n, v in opt["m"].items()},
                    {n: p.detach().cpu() for n, p in model.named_parameters()})
    (mc, m_c, p_c), (mg, m_g, p_g) = out["cpu"], out["cuda"]
    lrs = 0.0
    for a, b in zip(mg, mc):
        assert torch.equal(a["lr"], b["lr"])
        assert abs(float(a["loss"]) / float(b["loss"]) - 1) <= 1e-5
        assert abs(float(a["grad_norm"]) / float(b["grad_norm"]) - 1) <= 1e-3
        lrs += float(b["lr"])
    for n in p_c:
        mx = float(m_c[n].abs().max())
        assert float((m_g[n] - m_c[n]).abs().max()) <= 1e-3 * mx, n
        d, ulp = (p_g[n] - p_c[n]).abs(), ULP2 * p_c[n].abs()
        assert bool(torch.all(d <= 2.5 * lrs + ulp)), n


def _run_train(*args):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args], cwd=root,
        env=env, capture_output=True, text=True, timeout=300)


def test_launch_train_on_the_card_resumes(cuda_device, tmp_path):
    ck = str(tmp_path / "ck")
    common = ["--arch", "phi4-mini-3.8b", "--smoke", "--steps", "6",
              "--batch", "2", "--seq", "32", "--device", "cuda",
              "--checkpoint-dir", ck, "--checkpoint-every", "2"]
    proc = _run_train(*common, "--fail-at", "5")
    assert proc.returncode != 0 and "SimulatedFailure" in proc.stderr
    assert sorted(os.listdir(ck)) == ["step_00000002", "step_00000004"]
    proc = _run_train(*common)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "resumed from checkpoint step 4" in proc.stdout
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert np.isfinite(out["loss"]) and out["steps"] == 6
