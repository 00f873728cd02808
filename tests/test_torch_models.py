"""The model zoo's dense GQA transformers: the port against the JAX package.

The same weights (the reference's ``init_params``, carried across by
``convert.model_params_from_numpy``) and the same tokens, made from a seed
with numpy, go through the reference's ``forward`` / prefill / decode and
the port's, for the five dense ``("attn",)`` configs at smoke size.
Tolerances, of max |logit|: 1e-4 in float32, 3e-2 in bfloat16.

The reference is compiled with ``xla_allow_excess_precision`` off, so that
each op rounds to its dtype as its graph says (the port's eager ops do the
same).  By default XLA keeps f32 inside its bf16 fusions, and the
compiled reference then differs from its own op-by-op run by more than
the bf16 tolerance on these random weights.

The KV cache is bf16 whatever the compute dtype.  Two f32 values that
differ in their last bits (two GEMMs summing in another order) can round
to neighbouring bf16 values, and such a flip can move later logits by
more than 1e-4.  So a float32 prefill or decode is held to
1e-4 when its cache equals the reference's bit for bit, and to the bf16
tolerance when a cache element was rounded the other way: the logits then
rest on a bf16 difference.
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

from repro.common.config import ModelConfig as RefModelConfig
from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke as ref_get_smoke
from repro.models import steps as ref_steps
from repro.models import transformer as ref_tr
from repro_torch.common.config import ModelConfig
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.convert import model_params_from_numpy
from repro_torch.models import steps, transformer as tr

DENSE = ["phi4-mini-3.8b", "mistral-nemo-12b", "minitron-8b",
         "starcoder2-3b", "musicgen-medium"]
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / (np.abs(want).max() + 1e-9))


def _pair(arch, dtype):
    """(reference config, port config) of ``arch``'s smoke size."""
    return (dataclasses.replace(ref_get_smoke(arch), dtype=dtype),
            dataclasses.replace(get_smoke(arch), dtype=dtype))


def _converted(ref_cfg, cfg, seed=0):
    params = ref_tr.init_params(ref_cfg, jax.random.PRNGKey(seed))
    return params, model_params_from_numpy(
        cfg, jax.tree.map(np.asarray, params), device="cpu")


def _compiled(fn, *args):
    """``fn(*args)`` compiled without excess precision (module docstring)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _cache_flips(cfg, state, ref_state) -> int:
    """Elements of the port's per-layer KV cache that differ from the
    reference's state tree (scanned leaves stacked by period)."""
    segs = tr.plan_segments(cfg)
    ref = [ref_state["prefix"][str(i)] for i in range(len(segs.prefix))]
    ref += [{n: ref_state["scanned"][str(j)][n][p] for n in ("k", "v")}
            for p in range(segs.n_periods) for j in range(len(segs.period))]
    return sum(int(np.sum(np.asarray(r[n], np.float32)
                          != ours[n].float().numpy()))
               for ours, r in zip(state, ref) for n in ("k", "v"))


def _check_against_reference(params, ref_cfg, model, cfg, toks, s, tol):
    """Forward over ``toks``, prefill of the first ``s`` tokens and the
    decode of token ``s``, each within ``tol`` of max |logit| (the bf16
    tolerance for a step whose cache differs from the reference's).
    Returns the cache flips after prefill and after decode."""
    b = toks.shape[0]
    cap = s + 4
    with torch.no_grad():
        got = model(torch.as_tensor(toks))[0].numpy()
    want = _compiled(lambda p, t: ref_tr.forward(p, t, ref_cfg)[0],
                     params, jnp.asarray(toks))
    assert _rel(got, want) <= tol, f"forward: {_rel(got, want)}"
    flips = []
    state, got = steps.make_prefill_step(cfg, cap)(
        model, torch.as_tensor(toks[:, :s]))
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
        assert got.dtype == torch.float32
        flips.append(_cache_flips(cfg, state, ref_state))
        bound = tol if flips[-1] == 0 else max(tol, TOL["bfloat16"])
        err = _rel(got, want)
        assert err <= bound, f"{what}: {err} ({flips[-1]} cache flips)"
    return flips


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_forward_prefill_decode_match_reference(arch, dtype):
    ref_cfg, cfg = _pair(arch, dtype)
    params, model = _converted(ref_cfg, cfg)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    _check_against_reference(params, ref_cfg, model, cfg, toks, 15,
                             TOL[dtype])


@pytest.mark.parametrize("arch", DENSE)
def test_count_params_match_reference(arch):
    for port, ref in ((get_config, ref_get_config), (get_smoke, ref_get_smoke)):
        assert tr.count_params(port(arch)) == ref_tr.count_params(ref(arch))
        assert tr.active_param_count(port(arch)) == \
            ref_tr.active_param_count(ref(arch))
    if arch == "phi4-mini-3.8b":
        assert tr.count_params(get_config(arch)) == 3_836_021_760


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_config_matches_assignment(arch):
    """The port's FULL config carries the exact assigned hyperparameters
    (the reference's test, on the port's copy), field for field the
    reference's config, and resolves to the port's own classes."""
    assigned = {
        "deepseek-v2-236b": dict(num_layers=60, d_model=5120, num_heads=128,
                                 vocab_size=102400),
        "llama4-maverick-400b-a17b": dict(num_layers=48, d_model=5120,
                                          num_heads=40, num_kv_heads=8,
                                          vocab_size=202048),
        "musicgen-medium": dict(num_layers=48, d_model=1536, num_heads=24,
                                num_kv_heads=24, d_ff=6144, vocab_size=2048),
        "mistral-nemo-12b": dict(num_layers=40, d_model=5120, num_heads=32,
                                 num_kv_heads=8, d_ff=14336, vocab_size=131072),
        "phi4-mini-3.8b": dict(num_layers=32, d_model=3072, num_heads=24,
                               num_kv_heads=8, d_ff=8192, vocab_size=200064),
        "minitron-8b": dict(num_layers=32, d_model=4096, num_heads=32,
                            num_kv_heads=8, d_ff=16384, vocab_size=256000),
        "starcoder2-3b": dict(num_layers=30, d_model=3072, num_heads=24,
                              num_kv_heads=2, d_ff=12288, vocab_size=49152),
        "llama-3.2-vision-90b": dict(num_layers=100, d_model=8192, num_heads=64,
                                     num_kv_heads=8, d_ff=28672,
                                     vocab_size=128256),
        "zamba2-1.2b": dict(num_layers=38, d_model=2048, num_heads=32,
                            d_ff=8192, vocab_size=32000),
        "xlstm-350m": dict(num_layers=24, d_model=1024, num_heads=4, d_ff=0,
                           vocab_size=50304),
    }[arch]
    cfg = get_config(arch)
    for k, v in assigned.items():
        assert getattr(cfg, k) == v, f"{arch}.{k}: {getattr(cfg, k)} != {v}"
    if arch == "deepseek-v2-236b":
        assert cfg.mla.kv_lora_rank == 512
        assert cfg.moe.num_experts == 160 and cfg.moe.top_k == 6
        assert cfg.moe.num_shared_experts == 2
    if arch == "llama4-maverick-400b-a17b":
        assert cfg.moe.num_experts == 128 and cfg.moe.top_k == 1
    if arch == "zamba2-1.2b":
        assert cfg.ssm.state_dim == 64
    for port, ref in ((get_config, ref_get_config), (get_smoke, ref_get_smoke)):
        assert type(port(arch)) is ModelConfig
        assert port(arch).__module__ == "repro_torch.common.config"
        assert dataclasses.asdict(port(arch)) == dataclasses.asdict(ref(arch))


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_full_forward(arch):
    """prefill + decode == full forward (within cache-quantization noise),
    the reference's test on the port's own weights."""
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    model = tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    b, s = 2, 33
    tokens = torch.randint(0, cfg.vocab_size, (b, s),
                           generator=torch.Generator().manual_seed(1))
    state, _ = steps.make_prefill_step(cfg, s + 4)(model, tokens[:, : s - 1])
    pos = torch.full((b, 1), s - 1, dtype=torch.int32)
    _, dec_logits = steps.make_decode_step(cfg)(
        model, state, tokens[:, s - 1 : s], pos)
    with torch.no_grad():
        full, _, _ = model(tokens)
    err = _rel(dec_logits, full[:, -1])
    assert err < 0.15, f"decode/full relative mismatch {err}"


def test_init_params_draws_the_reference_distribution():
    """Leaf for leaf the reference's shapes and init rule: ones for the
    norms, normal * scale / sqrt(fan_in) elsewhere, where a scanned leaf's
    fan_in is its first (n_periods) dim, as in the reference."""
    cfg = get_smoke("phi4-mini-3.8b")
    ref = jax.tree.map(np.asarray, ref_tr.init_params(
        ref_get_smoke("phi4-mini-3.8b"), jax.random.PRNGKey(0)))
    got = dict(tr.init_params(cfg, torch.Generator().manual_seed(0),
                              "cpu").named_parameters())
    want = tr.weights_from_tree(cfg, jax.tree.map(
        lambda a: torch.tensor(np.array(a)), ref))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name].detach()
        assert g.shape == w.shape and g.dtype == w.dtype == torch.float32
        if name.endswith("weight"):                      # the norms
            assert torch.equal(g, w), name
    for path in (("scanned", "0", "attn", "wq"), ("embed", "embedding")):
        leaf = ref
        for k in path:
            leaf = leaf[k]
        std = 1.0 / np.sqrt(leaf.shape[0])
        assert abs(leaf.std() / std - 1) < 0.1
    stacked = torch.stack([got[f"layers.{i}.attn.wq"] for i in range(3)])
    assert abs(float(stacked.detach().std()) * np.sqrt(3) - 1) < 0.1


_SMALL = ModelConfig(name="t", num_layers=2, d_model=16, num_heads=2,
                     num_kv_heads=1, d_ff=24, vocab_size=40, dtype="float32",
                     rope_theta=10000.0, remat=False)
_LAYOUTS = {"one_layer": dict(num_layers=1, tie_embeddings=True),
            "unscanned": dict(scan_layers=False)}


@pytest.mark.parametrize("kind", sorted(_LAYOUTS))
def test_converter_layouts(kind):
    """A one-layer or unscanned config puts its layers under ``prefix``
    (the dense configs put theirs under ``scanned``): it loads and gives
    the reference's logits."""
    cfg = dataclasses.replace(_SMALL, **_LAYOUTS[kind])
    ref_cfg = RefModelConfig(**dataclasses.asdict(cfg))
    params, model = _converted(ref_cfg, cfg, seed=3)
    assert "scanned" not in params and len(params["prefix"]) == cfg.num_layers
    toks = np.random.default_rng(2).integers(0, 40, (2, 9)).astype(np.int32)
    with torch.no_grad():
        got = model(torch.as_tensor(toks))[0].numpy()
    want = _compiled(lambda p, t: ref_tr.forward(p, t, ref_cfg)[0],
                     params, jnp.asarray(toks))
    assert _rel(got, want) <= TOL["float32"]


@pytest.mark.parametrize("fault", ["missing", "surplus", "shape"])
def test_converter_rejects_bad_trees(fault):
    cfg = get_smoke("phi4-mini-3.8b")
    tree = jax.tree.map(np.asarray, ref_tr.init_params(
        ref_get_smoke("phi4-mini-3.8b"), jax.random.PRNGKey(0)))
    if fault == "missing":
        del tree["scanned"]["0"]["ffn"]["w_up"]
    elif fault == "surplus":
        tree["unembed"] = np.zeros((cfg.d_model, cfg.vocab_size), np.float32)
    else:
        tree["ln_f"] = np.ones(cfg.d_model + 1, np.float32)
    with pytest.raises(ValueError, match="w_up|unembed|ln_f"):
        model_params_from_numpy(cfg, tree, device="cpu")


@pytest.mark.parametrize("arch", DENSE)
def test_state_defs_match_reference(arch):
    """The KV cache (bf16 whatever the compute dtype) has the reference's
    leaves; ``init_state`` holds them unstacked, one dict a layer."""
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    ref_cfg = dataclasses.replace(ref_get_smoke(arch), dtype="float32")
    sd = tr.state_defs(cfg, 3, 20)
    assert sd == ref_tr.state_defs(ref_cfg, 3, 20)
    state = tr.init_state(cfg, 3, 20, "cpu")
    assert len(state) == cfg.num_layers
    hd = cfg.resolved_head_dim
    for layer in state:
        assert layer["index"] == 0
        for k in ("k", "v"):
            assert layer[k].shape == (3, 20, cfg.num_kv_heads, hd)
            assert layer[k].dtype == torch.bfloat16


_IMPORTS = """
import importlib, json, pkgutil, sys
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for m in mods:
    importlib.import_module(m)
sys.path.insert(0, ".")
import chip_smoke
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.launch.serve import serve
names = [(get_config(a).name, get_smoke(a).name) for a in ARCH_IDS]
rep = serve("phi4-mini-3.8b", n_requests=2, max_new=2, device="cpu")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"bad": bad, "names": len(names), "report": rep,
                  "modules": mods}))
"""


def test_model_zoo_imports_neither_jax_nor_repro():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    proc = subprocess.run([sys.executable, "-c", _IMPORTS], cwd=root,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    assert out["names"] == len(ARCH_IDS)
    assert out["report"]["tokens_generated"] == 4
    assert {"repro_torch.models.transformer", "repro_torch.serving.engine",
            "repro_torch.configs.phi4_mini_3_8b"} <= set(out["modules"])


def test_no_port_file_names_jax_or_repro():
    """No import statement anywhere in ``src/repro_torch`` or
    ``chip_smoke.py`` (function-level ones included) names jax or the JAX
    package."""
    import ast
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    files = [os.path.join(root, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(root, "src", "repro_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    bad = []
    for f in files:
        with open(f) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            bad += [(f, n) for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert len(files) > 60 and bad == []
