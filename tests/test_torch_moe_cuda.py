"""The MoE FFN and MLA attention on the card against the CPU.

These tests need a CUDA device and skip without one.  The file imports
neither jax nor the JAX package, so it runs on a GPU machine that has only
the port's dependencies:

    python -m pytest -q tests/test_torch_moe_cuda.py

* The combine: the port adds each token's expert rows through a (T, k)
  slot map, in ascending expert order, in the compute dtype.  On the card
  that is deterministic and equal bit for bit to the CPU's (a bf16 add
  rounds the same on both), where ``index_add_`` adds with atomics in an
  order that changes from run to run.
* One smoke forward of each MoE config (llama4-maverick: GQA + top-1 MoE;
  deepseek-v2: MLA + top-2 MoE), float32, TF32 off, with a capacity that
  drops nothing: weights drawn on the CPU and copied to the card, logits
  within 1e-4 of max |logit|, the aux loss within 1e-5 relative, and the
  greedy tokens of a ``ServeEngine`` wave equal.  ``chip_smoke.py`` phase
  9 runs the same checks and the full-width models.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.models import moe, transformer
from repro_torch.serving.engine import Request, ServeEngine


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.parametrize("k", [1, 6])
def test_combine_is_deterministic_and_equals_cpu(cuda_device, k):
    gen = torch.Generator().manual_seed(k)
    e, t, d = 160, 416, 512
    ids = torch.stack([torch.randperm(e, generator=gen)[:k] for _ in range(t)])
    cap = max(int(np.ceil(t * k / e * 1.25)), 4)
    x = torch.randn(t, d, generator=gen)
    *_, slot = moe._capacity_gather(x, ids.reshape(-1), torch.ones(t * k), e,
                                    cap)
    y = (torch.randn(e, cap, d, generator=gen) * 3).to(torch.bfloat16)
    want = moe._combine(y, slot, ids)
    got = [moe._combine(y.to(cuda_device), slot.to(cuda_device),
                        ids.to(cuda_device)).cpu() for _ in range(3)]
    assert all(torch.equal(g, want) for g in got)


@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b",
                                  "deepseek-v2-236b"])
def test_smoke_forward_card_matches_cpu(cuda_device, arch):
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    mo = cfg.moe
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        mo, capacity_factor=mo.num_experts / mo.top_k))
    cpu = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card = copy.deepcopy(cpu).to(cuda_device)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 24)))
    with torch.no_grad():
        want, _, want_aux = cpu(toks)
        got, _, aux = card(toks.to(cuda_device))
    err = float((got.cpu() - want).abs().max() / want.abs().max())
    assert err <= 1e-4, err
    assert abs(float(aux) / float(want_aux) - 1) <= 1e-5
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (3, 7, 11)]
    toks = {}
    for dev, model in (("cpu", cpu), ("cuda", card)):
        eng = ServeEngine(cfg, model, batch_slots=3, capacity=32)
        toks[dev] = [r.out_tokens for r in eng.run(
            [Request(p, max_new_tokens=6) for p in prompts])]
    assert toks["cuda"] == toks["cpu"]
