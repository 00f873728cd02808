"""The SSM blocks (mamba2, mLSTM, sLSTM) and gated cross-attention on the
card against the CPU.

These tests need a CUDA device and skip without one.  The file imports
neither jax nor the JAX package, so it runs on a GPU machine that has only
the port's dependencies:

    python -m pytest -q tests/test_torch_models_ssm_cuda.py

For zamba2's, xlstm's and llama-3.2-vision's smoke configs in float32 (TF32
off), weights drawn on the CPU and copied to the card (llama-vision's
cross gates set to 0.5, a memory from a seed): the forward's logits and a
prefill's within 1e-4 of max |logit| (3e-2 where an element of zamba2's
bf16 KV cache rounded the other way) -- or, where it is larger, twice the
config's own float32 noise floor, the CPU forward's distance from a
float64 one (xlstm's chaotic smoke model: its reference lies 1.5e-4 from
float64 on the CPU) -- a ``ServeEngine`` wave's greedy tokens equal, and
none of the three join kernels launched (their counts stay 0).
``chip_smoke.py`` phase 9 (SSM) runs the same checks and the full-size
models.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.kernels.extract import kernel as ek
from repro_torch.kernels.fused_cnf_join import kernel as ck
from repro_torch.kernels.threshold_sweep import kernel as sk
from repro_torch.models import steps, transformer
from repro_torch.serving.engine import Request, ServeEngine, pad_wave

ARCHS = ["zamba2-1.2b", "xlstm-350m", "llama-3.2-vision-90b"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _rel(got, want) -> float:
    want = want.float().cpu()
    return float((got.float().cpu() - want).abs().max()
                 / (want.abs().max() + 1e-9))


def _join_launches() -> int:
    return ck.launches["cnf_join"] + ek.launches["compact"] + sum(
        sk.launches.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_config_card_matches_cpu(cuda_device, arch):
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    cpu = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        for blk in cpu.layers:
            if blk.kind == "cross_attn":
                blk.attn.gate.fill_(0.5)
    card = copy.deepcopy(cpu).to(cuda_device)
    rng = np.random.default_rng(1)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 70)))
    mem = None
    if cfg.cross_attn_every:
        mem = torch.as_tensor(rng.normal(size=(
            2, cfg.cross_attn_memory_len, cfg.frontend_embed_dim)),
            dtype=torch.float32)
    c64 = dataclasses.replace(cfg, dtype="float64")
    f64 = transformer.Transformer(c64, {n: p.detach().double()
                                        for n, p in cpu.named_parameters()})
    before = _join_launches()
    with torch.no_grad():
        want = cpu(toks, memory=mem)[0]
        got = card(toks.to(cuda_device), memory=None if mem is None
                   else mem.to(cuda_device))[0]
        floor = _rel(want, f64(toks, memory=None if mem is None
                               else mem.double())[0])
    assert _rel(got, want) <= max(1e-4, 2 * floor), (_rel(got, want), floor)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (3, 7, 40)]
    wave = [torch.as_tensor(a) for a in pad_wave(prompts, 3)]
    out, pre = {}, {}
    for dev, model in (("cpu", cpu), ("cuda", card)):
        eng = ServeEngine(cfg, model, batch_slots=3, capacity=64)
        out[dev] = [r.out_tokens for r in eng.run(
            [Request(p, max_new_tokens=6) for p in prompts])]
        pre[dev] = steps.make_prefill_step(cfg, 64)(
            model, *[a.to(model.embed["embedding"].device) for a in wave])
    assert out["cuda"] == out["cpu"]
    flips = sum(int((a[n].cpu() != b[n]).sum())
                for a, b in zip(pre["cuda"][0], pre["cpu"][0])
                for n in ("k", "v") if n in a)
    assert _rel(pre["cuda"][1], pre["cpu"][1]) <= (1e-4 if flips == 0 else 3e-2)
    assert _join_launches() == before
