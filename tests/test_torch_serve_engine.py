"""The port's ServeEngine: the reference's tier-1 engine tests on the port,
and its tokens against the reference engine's on the same weights.

Wave left-padding / ``valid_from`` masking and eos early-exit truncation
are pinned on a tiny float32 transformer (``_TINY``, the reference test's
config); the port's engine must then give the reference ``ServeEngine``'s
greedy tokens for the same converted weights, and ``launch.serve`` the
reference launcher's report.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.common.config import ModelConfig as RefModelConfig
from repro.configs import get_smoke as ref_get_smoke
from repro.launch.serve import serve as ref_serve
from repro.models import transformer as ref_tr
from repro.serving.engine import Request as RefRequest
from repro.serving.engine import ServeEngine as RefServeEngine
from repro_torch.common.config import ModelConfig
from repro_torch.configs import get_smoke
from repro_torch.convert import model_params_from_numpy
from repro_torch.launch.serve import serve
from repro_torch.models import transformer as tr
from repro_torch.serving.engine import Request, ServeEngine

_TINY = ModelConfig(
    name="tiny-serve", num_layers=2, d_model=32, num_heads=2, num_kv_heads=2,
    d_ff=64, vocab_size=61, max_seq_len=64, rope_theta=10000.0,
    dtype="float32", param_dtype="float32", remat=False)


@pytest.fixture(scope="module")
def tiny():
    return _TINY, tr.init_params(_TINY, torch.Generator().manual_seed(0), "cpu")


def _solo(cfg, model, prompt, max_new, eos_id=-1):
    eng = ServeEngine(cfg, model, batch_slots=1, capacity=48)
    r = Request(prompt, max_new_tokens=max_new, eos_id=eos_id)
    eng.run([r])
    return r.out_tokens


def test_wave_left_padding_matches_solo_runs(tiny):
    """Ragged prompts share one left-padded wave; valid_from masking makes
    each slot's decode identical to an unpadded single-request run."""
    cfg, model = tiny
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (3, 7, 11)]                    # forces 8 & 4 pad cols
    eng = ServeEngine(cfg, model, batch_slots=3, capacity=48)
    reqs = [Request(p, max_new_tokens=6) for p in prompts]
    eng.run(reqs)
    for p, r in zip(prompts, reqs):
        assert r.out_tokens == _solo(cfg, model, p, 6), \
            "padded slot diverged from solo decode"


def test_partial_wave_ignores_empty_slots(tiny):
    """Empty slots (valid_from = all-pad) must not perturb live ones."""
    cfg, model = tiny
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (4, 9)]
    eng = ServeEngine(cfg, model, batch_slots=4, capacity=48)  # 2 empty
    reqs = [Request(p, max_new_tokens=5) for p in prompts]
    eng.run(reqs)
    for p, r in zip(prompts, reqs):
        assert r.out_tokens == _solo(cfg, model, p, 5)


def test_eos_truncates_and_wave_exits_early(tiny):
    """A slot whose last token is eos stops collecting; once every slot is
    done the wave stops stepping (greedy decode is deterministic, so the
    eos id is learned from an eos-free reference run)."""
    cfg, model = tiny
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, cfg.vocab_size, size=5).astype(np.int32)
    free = _solo(cfg, model, prompt, 8)                # no eos: full budget
    assert len(free) == 8
    eos = free[2]                                      # truncate after 3 tokens

    eng = ServeEngine(cfg, model, batch_slots=1, capacity=48)
    r = Request(prompt, max_new_tokens=8, eos_id=eos)
    eng.run([r])
    cut = free.index(eos) + 1
    assert r.out_tokens == free[:cut]                  # truncated at first eos
    assert r.out_tokens[-1] == eos
    # early exit: the wave stopped decoding once the slot was done
    full_eng = ServeEngine(cfg, model, batch_slots=1, capacity=48)
    full_eng.run([Request(prompt, max_new_tokens=8)])
    assert eng.steps_executed < full_eng.steps_executed


def test_request_resubmission_does_not_leak_decode_state(tiny):
    """A Request run a second time (retry, or reuse across engines) must
    decode from scratch, not return its old tokens."""
    cfg, model = tiny
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, cfg.vocab_size, size=5).astype(np.int32)
    eng = ServeEngine(cfg, model, batch_slots=1, capacity=48)
    r = Request(prompt, max_new_tokens=6)
    eng.run([r])
    first = list(r.out_tokens)
    assert len(first) == 6
    eng.run([r])                                       # resubmit the object
    assert r.out_tokens == first                       # identical fresh run
    eng2 = ServeEngine(cfg, model, batch_slots=2, capacity=48)
    eng2.run([r])                                      # reuse across engines
    assert r.out_tokens == first


def test_mixed_budgets_truncate_per_slot(tiny):
    """A short-budget slot stops at max_new_tokens while the wave keeps
    decoding for its longer-budget peers."""
    cfg, model = tiny
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=6).astype(np.int32)
               for _ in range(2)]
    eng = ServeEngine(cfg, model, batch_slots=2, capacity=48)
    short = Request(prompts[0], max_new_tokens=2)
    long = Request(prompts[1], max_new_tokens=7)
    eng.run([short, long])
    assert len(short.out_tokens) == 2
    assert len(long.out_tokens) == 7
    assert short.out_tokens == _solo(cfg, model, prompts[0], 2)
    assert long.out_tokens == _solo(cfg, model, prompts[1], 7)


def test_engine_casts_weights_to_the_compute_dtype_once():
    """A bf16 model's >= 2-D weights are cast in place at construction
    (the values every forward uses); the 1-D norm weights stay f32."""
    cfg = dataclasses.replace(_TINY, dtype="bfloat16")
    model = tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    want = {n: p.detach().to(torch.bfloat16) for n, p in model.named_parameters()
            if p.ndim >= 2}
    ServeEngine(cfg, model, batch_slots=2, capacity=16)
    for name, p in model.named_parameters():
        if p.ndim >= 2:
            assert p.dtype == torch.bfloat16 and torch.equal(p, want[name])
        else:
            assert p.dtype == torch.float32


@pytest.mark.parametrize("which", ["tiny", "phi4-mini-smoke"])
def test_tokens_match_reference_engine(which):
    """The reference ServeEngine and the port's, on the same converted
    weights (float32): two waves, ragged prompts, an empty slot, mixed
    budgets and an eos — the same greedy tokens."""
    if which == "tiny":
        ref_cfg = RefModelConfig(**dataclasses.asdict(_TINY))
        cfg = _TINY
    else:
        ref_cfg = dataclasses.replace(ref_get_smoke("phi4-mini-3.8b"),
                                      dtype="float32")
        cfg = dataclasses.replace(get_smoke("phi4-mini-3.8b"), dtype="float32")
    params = ref_tr.init_params(ref_cfg, jax.random.PRNGKey(7))
    model = model_params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                    device="cpu")
    rng = np.random.default_rng(5)
    lens, budgets = (3, 7, 11, 5, 9), (6, 6, 3, 5, 6)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in lens]
    ref_eng = RefServeEngine(ref_cfg, params, batch_slots=3, capacity=32)
    want = ref_eng.run([RefRequest(p, max_new_tokens=m)
                        for p, m in zip(prompts, budgets)])
    eos = want[1].out_tokens[2]
    before = ref_eng.steps_executed
    want = ref_eng.run([RefRequest(p, max_new_tokens=m, eos_id=eos)
                        for p, m in zip(prompts, budgets)])
    eng = ServeEngine(cfg, model, batch_slots=3, capacity=32)
    got = eng.run([Request(p, max_new_tokens=m, eos_id=eos)
                   for p, m in zip(prompts, budgets)])
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert eng.steps_executed == ref_eng.steps_executed - before


def test_serve_launcher_report_matches_reference():
    got = serve("phi4-mini-3.8b", n_requests=3, max_new=3, batch_slots=2,
                device="cpu")
    want = ref_serve("phi4-mini-3.8b", n_requests=3, max_new=3,
                     batch_slots=2)
    assert sorted(got) == sorted(want)
    assert got["requests"] == want["requests"] == 3
    assert got["tokens_generated"] == want["tokens_generated"] == 9


def test_serve_launcher_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the cuda path would run")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve("phi4-mini-3.8b", n_requests=1, max_new=1)
