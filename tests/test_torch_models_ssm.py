"""The model zoo's SSM and cross-attention configs at smoke size: zamba2
(Mamba2 blocks with an attention + FFN block every third layer), xlstm
(mLSTM / sLSTM, no FFN) and llama-3.2-vision (GQA with a gated cross layer
every fifth, a frontend of dimension 24).  The port against the JAX
package on the reference's weights carried across by
``convert.model_params_from_numpy``; llama-vision's cross gates set to 0.5
in the converted weights (a zero gate would hide a wrong cross path).

Tolerances, of max |logit|: forward, prefill and decode 1e-4 in float32,
3e-2 in bfloat16 (``tests/test_torch_models.py``'s rule: the reference
compiled without excess precision; an f32 step whose bf16 KV cache, in
zamba2's attention layers, rounded an element the other way held to
3e-2), or the reference's own floor where that is larger, measured in
the case: in float32 the smaller of its distance from a float64
evaluation (the port's, in f64 compute throughout but rope's angles) and
its largest distance from itself on weights nudged one ulp (two draws),
in bfloat16 the distance between its two compilations (XLA's default,
which keeps f32 inside bf16 fusions, and op by op).  The smoke
models are chaotic (the reference draws a scanned leaf with fan_in =
n_periods: std 0.71 at 2 periods), so a single rounding flip grows along
the 70 tokens: xlstm's f32 reference lies 1.5e-4 from float64, its two
bf16 compilations 0.14 apart (zamba2's 0.20), the port 1.2e-4 and 3e-2
from it.  What bounds the port tightly is the layer-by-layer check: each
block, fed the reference block's input, gives its output to 1e-4 (f32)
or 3e-2 (bf16) of the block's largest change of the stream.  The SSM
states are f32 in both packages, held to 1e-3 of each leaf's max in f32.
``ServeEngine``: the reference engine's greedy tokens, in float32, and in
bfloat16 against the reference's steps compiled without excess precision
(its engine's jit keeps f32 inside fusions): equal, the bf16 logits equal
bit for bit.

The reference's ``slow`` serving tests, ported here at smoke size:
``test_engine_padded_batch_equals_single`` (``tests/test_substrate.py``)
and ``test_decode_matches_full_forward`` (``tests/test_smoke_archs.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke as ref_get_smoke
from repro.launch.serve import serve as ref_serve
from repro.models import steps as ref_steps
from repro.models import transformer as ref_tr
from repro.serving.engine import Request as RefRequest
from repro.serving.engine import ServeEngine as RefServeEngine
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.convert import model_params_from_numpy
from repro_torch.launch.serve import serve
from repro_torch.models import steps, transformer as tr
from repro_torch.serving.engine import Request, ServeEngine
from test_torch_cross_attn import _gated
from test_torch_models import _compiled, _rel

ARCHS = ["zamba2-1.2b", "xlstm-350m", "llama-3.2-vision-90b"]
SSM_ARCHS = ARCHS[:2]
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# full size, and llama-vision cut in depth for one card: (layers, params)
FULL = {"zamba2-1.2b": (38, 1_352_519_680), "xlstm-350m": (24, 405_345_376),
        "llama-3.2-vision-90b": (20, 19_235_414_020)}


def _pair(arch, dtype):
    return (dataclasses.replace(ref_get_smoke(arch), dtype=dtype),
            dataclasses.replace(get_smoke(arch), dtype=dtype))


def _converted(ref_cfg, cfg, seed=0):
    """The reference's ``init_params`` (cross gates 0.5) and the port's
    model on the same weights."""
    tree = _gated(jax.tree.map(np.asarray, ref_tr.init_params(
        ref_cfg, jax.random.PRNGKey(seed))))
    return (jax.tree.map(jnp.asarray, tree),
            model_params_from_numpy(cfg, tree, device="cpu"))


def _memory(cfg, b, seed=2):
    if not cfg.cross_attn_every:
        return None
    return (np.random.default_rng(seed).normal(
        size=(b, cfg.cross_attn_memory_len, cfg.frontend_embed_dim)) * 0.5
            ).astype(np.float32)


def _ref_layer_states(cfg, ref_state) -> list:
    """The reference's state tree, one dict a layer in layer order."""
    segs = tr.plan_segments(cfg)
    out = [ref_state["prefix"][str(i)] for i in range(len(segs.prefix))]
    out += [{n: a[p] for n, a in ref_state["scanned"][str(j)].items()}
            for p in range(segs.n_periods) for j in range(len(segs.period))]
    return out


def _compare_states(cfg, state, ref_state, tol) -> int:
    """Each SSM layer's state within ``tol`` of the reference's (of each
    leaf's max); returns the KV-cache elements that differ."""
    flips = 0
    for ours, ref in zip(state, _ref_layer_states(cfg, ref_state)):
        assert sorted(ours) == sorted(ref)
        for n, a in ours.items():
            if n == "index":
                assert a == int(ref[n])
            elif n in ("k", "v"):
                flips += int(np.sum(np.asarray(ref[n], np.float32)
                                    != a.float().numpy()))
            else:
                assert a.dtype == torch.float32
                assert _rel(a.numpy(), ref[n]) <= tol, f"state {n}"
    return flips


def _nudged(params, seed):
    """The reference's weights, each f32 element moved one ulp up or down
    (the side drawn from ``seed``): another draw of the f32 rounding."""
    rng = np.random.default_rng(seed)

    def one(a):
        a = np.asarray(a)
        if a.dtype != np.float32:
            return jnp.asarray(a)
        side = np.where(rng.random(a.shape) < 0.5, -np.inf, np.inf)
        return jnp.asarray(np.nextafter(a, side.astype(np.float32)))
    return jax.tree.map(one, params)


def _floor(ref_cfg, cfg, params, toks, mem, want) -> float:
    """The reference's own noise on this forward (module docstring).  In
    bfloat16 its distance from its compilation with XLA's default excess
    precision.  In float32 the smaller of two measures: its distance from
    the port's float64 evaluation, and its largest distance from itself on
    weights nudged one ulp (seeds 1 and 2), which the port's code does not
    reach, so that a fault of the port cannot widen its own tolerance."""
    args = (jnp.asarray(toks), None if mem is None else jnp.asarray(mem))

    def fwd(p, t, m):
        return ref_tr.forward(p, t, ref_cfg, memory=m)[0]
    if ref_cfg.dtype == "bfloat16":
        return _rel(jax.jit(fwd)(params, *args), want)
    drawn = max(_rel(_compiled(fwd, _nudged(params, seed), *args), want)
                for seed in (1, 2))
    c64 = dataclasses.replace(cfg, dtype="float64")
    m64 = tr.Transformer(c64, tr.weights_from_tree(c64, jax.tree.map(
        lambda a: torch.tensor(np.asarray(a, np.float64)), params)))
    with torch.no_grad():
        f64 = m64(torch.as_tensor(toks), memory=None if mem is None
                  else torch.as_tensor(mem, dtype=torch.float64))[0]
    return min(drawn, _rel(want, f64.numpy()))


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_reference(arch, dtype):
    """70 tokens (three chunks of 32, the last padded): the forward (with a
    memory for llama-vision), a prefill of 69 (with the memory) and the
    decode of the 70th (no memory, as the reference's decode step), each
    with its state against the reference's; held to the tolerance or the
    reference's own floor (module docstring)."""
    ref_cfg, cfg = _pair(arch, dtype)
    params, model = _converted(ref_cfg, cfg)
    b, s, cap = 2, 69, 74
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    mem = _memory(cfg, b)
    tmem = None if mem is None else torch.as_tensor(mem)
    jmem = None if mem is None else jnp.asarray(mem)
    with torch.no_grad():
        got = model(torch.as_tensor(toks), memory=tmem)[0]
    want = _compiled(lambda p, t, m: ref_tr.forward(p, t, ref_cfg, memory=m)[0],
                     params, jnp.asarray(toks), jmem)
    floor = _floor(ref_cfg, cfg, params, toks, mem, want)
    tol = max(TOL[dtype], floor)
    print(f"{arch} {dtype}: forward {_rel(got.numpy(), want)}, the "
          f"reference's floor {floor}")
    assert _rel(got.numpy(), want) <= tol, \
        f"forward: {_rel(got.numpy(), want)} (floor {floor})"
    state, got = steps.make_prefill_step(cfg, cap)(
        model, torch.as_tensor(toks[:, :s]), memory=tmem)
    ref_state, want = _compiled(ref_steps.make_prefill_step(ref_cfg, cap),
                                params, jnp.asarray(toks[:, :s]), jmem)
    for what in ("prefill", "decode"):
        if what == "decode":
            state, got = steps.make_decode_step(cfg)(
                model, state, torch.as_tensor(toks[:, s:]),
                torch.full((b, 1), s, dtype=torch.int32))
            ref_state, want = _compiled(
                ref_steps.make_decode_step(ref_cfg), params, ref_state,
                jnp.asarray(toks[:, s:]), jnp.full((b, 1), s, jnp.int32))
        flips = _compare_states(cfg, state, ref_state,
                                tol if dtype == "bfloat16" else 1e-3)
        bound = tol if flips == 0 else max(tol, TOL["bfloat16"])
        err = _rel(got.numpy(), want)
        assert err <= bound, f"{what}: {err} ({flips} cache flips)"


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("arch", ARCHS)
def test_blocks_match_reference_layer_by_layer(arch, dtype):
    """Each block fed the reference block's input (its output the next
    block's input, teacher-forced; llama-vision's cross layer with the
    projected memory): within 1e-4 (f32) or 3e-2 (bf16) of the largest
    change the block makes to the stream.  The reference runs op by op."""
    ref_cfg, cfg = _pair(arch, dtype)
    params, model = _converted(ref_cfg, cfg)
    cd = jnp.dtype(dtype)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 70))
    mem = _memory(cfg, 2)
    if mem is not None:
        mem = jnp.einsum("bmf,fd->bmd", jnp.asarray(mem, cd),
                         params["memory_proj"].astype(cd))
    x = params["embed"]["embedding"].astype(cd)[jnp.asarray(toks)]
    pos = jnp.broadcast_to(jnp.arange(70)[None], (2, 70))
    segs = ref_tr.plan_segments(ref_cfg)
    layers = [params["prefix"][str(i)] for i in range(len(segs.prefix))]
    layers += [jax.tree.map(lambda a: a[p], params["scanned"][str(j)])
               for p in range(segs.n_periods) for j in range(len(segs.period))]
    for i, (lp, (kind, ffn)) in enumerate(zip(layers,
                                              tr.plan_segments(cfg).layers)):
        want = ref_tr.block_forward(lp, x, pos, ref_cfg, kind, ffn, None, mem,
                                    cd, False)[0]
        with torch.no_grad():
            got = model.layers[i](
                torch.tensor(np.asarray(x, np.float32)).to(TDT[dtype]),
                torch.tensor(np.asarray(pos)), memory=None if mem is None
                else torch.tensor(np.asarray(mem, np.float32)).to(TDT[dtype]))[0]
        delta = np.abs(np.asarray(want, np.float32) - np.asarray(x, np.float32))
        err = float(np.abs(got.float().numpy() - np.asarray(want, np.float32)).max()
                    / delta.max())
        assert err <= TOL[dtype], f"layer {i} ({kind}): {err}"
        x = want


def _prompts(cfg, lens, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
            for n in lens]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_tokens_match_reference(arch):
    """The reference ServeEngine and the port's on the same converted
    weights (float32): two waves, ragged prompts (left pads run through
    the SSM recurrences as identity steps), an empty slot, mixed budgets
    -- the same greedy tokens."""
    ref_cfg, cfg = _pair(arch, "float32")
    params, model = _converted(ref_cfg, cfg, seed=7)
    prompts = _prompts(cfg, (3, 7, 40, 5, 9))
    budgets = (6, 6, 3, 5, 6)
    want = RefServeEngine(ref_cfg, params, batch_slots=3, capacity=64).run(
        [RefRequest(p, max_new_tokens=m) for p, m in zip(prompts, budgets)])
    got = ServeEngine(cfg, model, batch_slots=3, capacity=64).run(
        [Request(p, max_new_tokens=m) for p, m in zip(prompts, budgets)])
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]


def _exact_ref_engine(ref_cfg, params, slots, capacity):
    """The reference's ``ServeEngine`` with its prefill and decode steps
    compiled without excess precision (its own jit keeps f32 inside bf16
    fusions), one compilation per argument shapes."""
    eng = RefServeEngine(ref_cfg, params, batch_slots=slots, capacity=capacity)
    for attr, make in (("_prefill", ref_steps.make_prefill_step(ref_cfg, capacity)),
                       ("_decode", ref_steps.make_decode_step(ref_cfg))):
        cache = {}

        def step(*args, _make=make, _cache=cache):
            key = tuple(np.shape(a) for a in jax.tree.leaves(args[1:]))
            if key not in _cache:
                _cache[key] = jax.jit(_make).lower(*args).compile(
                    compiler_options={"xla_allow_excess_precision": False})
            return _cache[key](*args)
        setattr(eng, attr, step)
    return eng


def test_bf16_engine_keeps_the_slstm_recurrence_f32():
    """A bf16 ``ServeEngine`` casts every >= 2-D weight it reads in bf16,
    but sLSTM's ``r`` and ``b`` (read in f32 by the recurrence) stay f32.
    Its greedy tokens are then the reference's (uncast weights), whose
    steps run op by op.  Were ``r`` and ``b`` rounded to bf16, the served
    logits would differ from those of the uncast model."""
    ref_cfg, cfg = _pair("xlstm-350m", "bfloat16")
    params, model = _converted(ref_cfg, cfg, seed=3)
    _, uncast = _converted(ref_cfg, cfg, seed=3)
    eng = ServeEngine(cfg, model, batch_slots=3, capacity=48)
    kept = []
    for name, p in model.named_parameters():
        path, _, leaf = name.rpartition(".")
        owner = model.get_submodule(path)
        f32 = p.ndim < 2 or leaf in getattr(owner, "keep_f32", ())
        assert p.dtype == (torch.float32 if f32 else torch.bfloat16), name
        kept += [name] if p.ndim >= 2 and f32 else []
    assert kept == [f"layers.{i}.mixer.{n}" for i in (1, 3) for n in ("r", "b")]
    prompts = _prompts(cfg, (4, 9, 13))
    want = _exact_ref_engine(ref_cfg, params, 3, 48).run(
        [RefRequest(p, max_new_tokens=6) for p in prompts])
    got = eng.run([Request(p, max_new_tokens=6) for p in prompts])
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    # the served model computes what the uncast one does, bit for bit; with
    # r and b rounded to bf16 it would not
    toks = torch.as_tensor(_prompts(cfg, (24,), seed=6)[0])[None]
    rounded = _converted(ref_cfg, cfg, seed=3)[1]
    with torch.no_grad():
        for n, p in rounded.named_parameters():
            if n.endswith((".mixer.r", ".mixer.b")):
                p.data = p.data.to(torch.bfloat16)
        out = [m(toks)[0] for m in (model, uncast, rounded)]
    assert torch.equal(out[0], out[1]) and not torch.equal(out[1], out[2])


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_report_matches_reference(arch):
    got = serve(arch, n_requests=3, max_new=3, batch_slots=2, device="cpu")
    want = ref_serve(arch, n_requests=3, max_new=3, batch_slots=2)
    assert sorted(got) == sorted(want)
    assert got["requests"] == want["requests"] == 3
    assert got["tokens_generated"] == want["tokens_generated"] == 9


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_engine_padded_batch_equals_single(arch):
    """The reference's test (``tests/test_substrate.py``, ``slow`` there) on
    the port's own weights: a padded wave gives each request's solo
    tokens."""
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    model = tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompts = _prompts(cfg, (4, 7, 11), seed=0)
    reqs = [Request(p, max_new_tokens=5) for p in prompts]
    ServeEngine(cfg, model, batch_slots=3, capacity=48).run(reqs)
    for p, r in zip(prompts, reqs):
        r1 = Request(p, max_new_tokens=5)
        ServeEngine(cfg, model, batch_slots=1, capacity=48).run([r1])
        assert r1.out_tokens == r.out_tokens


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(arch):
    """The reference's test (``tests/test_smoke_archs.py``, ``slow`` there)
    on the port's own weights: prefill 32 + decode the 33rd against a full
    forward, < 0.15 of max |logit|.  The prefill starts from ``init_state``
    (sLSTM's n = 0), the forward from none (n = 1), as in the reference.
    llama-vision's decode passes no memory, so the forward has none
    either."""
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    model = tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    b, s = 2, 33
    tokens = torch.randint(0, cfg.vocab_size, (b, s),
                           generator=torch.Generator().manual_seed(1))
    state, _ = steps.make_prefill_step(cfg, s + 4)(model, tokens[:, :s - 1])
    _, dec = steps.make_decode_step(cfg)(
        model, state, tokens[:, s - 1:s],
        torch.full((b, 1), s - 1, dtype=torch.int32))
    with torch.no_grad():
        full, _, _ = model(tokens)
    err = _rel(dec.numpy(), full[:, -1].numpy())
    assert err < 0.15, f"decode/full relative mismatch {err}"


@pytest.mark.parametrize("arch", ARCHS)
def test_segments_and_state_match_reference(arch):
    """The layer plan at smoke and full size (zamba2: a prefix of 2 and 6
    periods of 6; xlstm: 12 periods of 2; llama-vision: periods of 5, the
    last layer of each a cross layer), the state leaves (SSM states f32,
    cross layers none) and ``init_state`` one dict a layer."""
    for port, ref in ((get_smoke(arch), ref_get_smoke(arch)),
                      (get_config(arch), ref_get_config(arch))):
        assert dataclasses.astuple(tr.plan_segments(port)) == \
            dataclasses.astuple(ref_tr.plan_segments(ref))
        assert tr.state_defs(port, 3, 20) == ref_tr.state_defs(ref, 3, 20)
    segs = tr.plan_segments(get_config(arch))
    want = {"zamba2-1.2b": (2, 6, 6), "xlstm-350m": (0, 2, 12),
            "llama-3.2-vision-90b": (0, 5, 20)}[arch]
    assert (len(segs.prefix), len(segs.period), segs.n_periods) == want
    if arch == "llama-3.2-vision-90b":
        assert [k for k, _ in segs.period] == ["attn"] * 4 + ["cross_attn"]
    cfg = get_smoke(arch)
    state = tr.init_state(cfg, 3, 20, "cpu")
    assert len(state) == cfg.num_layers
    for (kind, _), layer in zip(tr.plan_segments(cfg).layers, state):
        if kind == "cross_attn":
            assert layer == {}
        elif kind != "attn":
            assert all(t.dtype == torch.float32 and t.shape[0] == 3
                       and not t.any() for t in layer.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_match_reference(arch):
    for port, ref in ((get_config, ref_get_config), (get_smoke, ref_get_smoke)):
        assert tr.count_params(port(arch)) == ref_tr.count_params(ref(arch))
    layers, n = FULL[arch]
    cut = dataclasses.replace(get_config(arch), num_layers=layers)
    assert tr.count_params(cut) == n == ref_tr.count_params(
        dataclasses.replace(ref_get_config(arch), num_layers=layers))
    if arch == "llama-3.2-vision-90b":
        assert tr.count_params(dataclasses.replace(
            get_config(arch), num_layers=10)) == 10_678_870_018


@pytest.mark.parametrize("arch", ARCHS)
def test_tree_from_weights_inverts_weights_from_tree(arch):
    """The new leaves -- ``mixer/*``, a 0-d ``attn/gate`` (a scanned one
    ``(n_periods,)``), ``frontend_proj`` and ``memory_proj`` -- restack
    into the reference's tree leaf for leaf, in its flatten order, and
    name the model's parameters."""
    ref_cfg, cfg = _pair(arch, "float32")
    ref = jax.tree.map(np.asarray, ref_tr.init_params(
        ref_cfg, jax.random.PRNGKey(0)))
    tree = jax.tree.map(lambda a: torch.tensor(np.array(a)), ref)
    back = tr.tree_from_weights(cfg, tr.weights_from_tree(cfg, tree))
    for got, want in zip(ckpt._flatten(back), jax.tree.leaves(ref)):
        assert got.shape == want.shape and np.array_equal(got.numpy(), want)
    names = [n for _, _, ns in tr.reference_leaves(cfg) for n in ns]
    model = tr.Transformer(cfg, tr.weights_from_tree(cfg, tree))
    assert sorted(names) == sorted(n for n, _ in model.named_parameters())
    paths = [tuple(k.key for k in p)
             for p, _ in jax.tree_util.tree_flatten_with_path(ref)[0]]
    assert [p for p, _, _ in tr.reference_leaves(cfg)] == paths
    if arch == "llama-3.2-vision-90b":
        assert {"frontend_proj", "memory_proj", "layers.4.attn.gate"} <= set(names)
        assert model.layers[4].attn.gate.shape == ()
        full = tr.reference_leaves(get_config(arch))
        gate = [d for p, d, _ in full if p[-2:] == ("attn", "gate")]
        assert [d.shape for d in gate] == [(20,)]
    else:
        assert any(".mixer." in n for n in names)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_config_builds(arch):
    """``init_params`` and ``Transformer`` build every smoke config of the
    zoo (no kind is left unported); the full configs' parameter trees
    resolve."""
    cfg = get_smoke(arch)
    model = tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert len(model.layers) == cfg.num_layers
    assert tr.count_params(get_config(arch)) > 0


def test_param_counts_match_published_sizes():
    """The reference's published-size check (``tests/test_smoke_archs.py``,
    ``slow`` there) on the port's configs, with its MoE active-parameter
    check."""
    expect = {"deepseek-v2-236b": (236, 0.10),
              "llama4-maverick-400b-a17b": (400, 0.12),
              "mistral-nemo-12b": (12, 0.15), "phi4-mini-3.8b": (3.8, 0.15),
              "zamba2-1.2b": (1.2, 0.3), "xlstm-350m": (0.35, 0.35),
              "llama-3.2-vision-90b": (90, 0.15)}
    for arch, (bn, tol) in expect.items():
        n = tr.count_params(get_config(arch)) / 1e9
        assert abs(n - bn) / bn < tol, f"{arch}: {n:.1f}B vs published {bn}B"
    na = tr.active_param_count(get_config("deepseek-v2-236b")) / 1e9
    assert 15 < na < 30, f"deepseek active params {na:.1f}B != ~21B"
