"""The model zoo's serving path on the card against the CPU.

These tests need a CUDA device and skip without one.  The file imports
neither jax nor the JAX package, so it runs on a GPU machine that has only
the port's dependencies:

    python -m pytest -q tests/test_torch_models_cuda.py

One set of float32 weights, drawn on the CPU and moved to the card, serves
a wave of three ragged prompts through ``ServeEngine`` on both devices: the
greedy tokens must be equal, and the wave's prefill logits must agree to
1e-4 of max |logit|, or to the bf16 tolerance 3e-2 where an element of the
bf16 KV cache rounded the other way on the two devices (two f32 GEMMs
summing in another order).  ``chip_smoke.py`` phase 9 runs the same check
over all five dense smoke configs.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.common.config import ModelConfig
from repro_torch.configs import get_smoke
from repro_torch.models import steps, transformer
from repro_torch.serving.engine import Request, ServeEngine, pad_wave

_TINY = ModelConfig(
    name="tiny-serve", num_layers=2, d_model=32, num_heads=2, num_kv_heads=2,
    d_ff=64, vocab_size=61, max_seq_len=64, rope_theta=10000.0,
    dtype="float32", param_dtype="float32", remat=False)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.parametrize("which", ["tiny", "phi4-mini-smoke"])
def test_card_matches_cpu(cuda_device, which):
    cfg = _TINY if which == "tiny" else dataclasses.replace(
        get_smoke("phi4-mini-3.8b"), dtype="float32")
    cpu = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    models = {"cpu": cpu, "cuda": copy.deepcopy(cpu).to(cuda_device)}
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (3, 7, 11)]
    wave = [torch.as_tensor(a) for a in pad_wave(prompts, 3)]
    toks, pre = {}, {}
    for dev, model in models.items():
        eng = ServeEngine(cfg, model, batch_slots=3, capacity=32)
        toks[dev] = [r.out_tokens for r in eng.run(
            [Request(p, max_new_tokens=6) for p in prompts])]
        pre[dev] = steps.make_prefill_step(cfg, 32)(
            model, *[a.to(model.embed["embedding"].device) for a in wave])
    assert toks["cuda"] == toks["cpu"]
    flips = sum(int((a[n].cpu() != b[n]).sum())
                for a, b in zip(pre["cuda"][0], pre["cpu"][0])
                for n in ("k", "v"))
    got, want = pre["cuda"][1].cpu(), pre["cpu"][1]
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= (1e-4 if flips == 0 else 3e-2), (err, flips)
