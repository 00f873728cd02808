"""The dense GQA leaves over a model mesh (``models/transformer.py``'s
``local_specs`` and the tensor-parallel ``Block`` / embedding /
unembedding, ``models/steps.py``'s ``make_train_step``): the port in gloo
worlds of 2 and 4 processes against the reference's train cell on 4 XLA
host devices.

The reference runs as its dry-run's train cell builds it
(``src/repro/launch/cells.py:155-175``): ``make_train_step(cfg,
TrainConfig(), sp_constraint=...)`` jitted with ``in_shardings`` of
``param_specs`` for the parameters and ``{"m": pspecs, "v": pspecs,
"step": P()}`` for the optimizer state, and its forward under the same
shardings; one subprocess (``--xla_force_host_platform_device_count=4``)
runs every case while the port's worlds run (``launch/ep_world.py``, one
``many`` job list a world).  Configs: the phi4-mini (tied) and
mistral-nemo (untied) smoke configs in float32 on the reference's weights
from key 0, batch 8 x 16 tokens.  Meshes: (1, 2), (2, 1) and (2, 2) over
``("data", "model")`` and (2, 2, 1) over ``("pod", "data", "model")``,
where ``fsdp`` (data-major) and ``batch`` (pod-major) order the same two
axes differently.

Tolerances, those of ``tests/test_torch_moe_ep.py`` and PERF.md §2: the
forward's logits 1e-5 of max |logit|; loss 1e-5 relative; ``lr`` equal;
``grad_norm`` and every leaf of ``m`` 1e-3 of its max (f32 gradients of
the chaotic random models are good to about 1e-4 of max).  A decode over
(2, 2) runs each rank's heads against its block of the KV cache: with
f32 caches within 1e-5 of world 1, with the bf16 cache within PERF.md
§2's 3e-2 and its cache its block of world 1's within a bf16 ulp.

The last test measures the reference's own f32 floor on the two draws of
``chip_smoke.py`` phase 11 (a)'s llama4-maverick train step (its step
against its step on weights nudged one ulp) and holds the port's world-1
step to the reference's within max(1e-3, twice that floor).
"""

import dataclasses
import os
import pickle
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as ref_get_smoke
from repro.models import transformer as ref_tr
from repro_torch.common.config import TrainConfig
from repro_torch.configs import get_smoke
from repro_torch.convert import model_tree_to_numpy
from repro_torch.distributed import mesh as tmesh
from repro_torch.distributed.mesh import AxisEnv, Spec
from repro_torch.launch.ep_world import nudge_, run_world, sorted_leaves
from repro_torch.models import steps
from repro_torch.models import transformer as tr
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.optim import adamw

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ARCHS = ("phi4-mini-3.8b", "mistral-nemo-12b")
MESHES = {"1x2": ((1, 2), ("data", "model")),
          "2x1": ((2, 1), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "2x2x1": ((2, 2, 1), ("pod", "data", "model"))}
CASES = [(a, m) for a in ARCHS for m in MESHES]
INT8 = ("phi4-mini-3.8b", "2x2")
FLOOR_ARCH = "llama4-maverick-400b-a17b"


def _cfg(arch):
    return dataclasses.replace(ref_get_smoke(arch), dtype="float32")


def _leaves(tree):
    """{path: array} of a nested dict, keys sorted."""
    return dict(tree_leaves({k: tree[k] for k in sorted(tree)}))


def _rel(got, want):
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _phase11a_draws():
    """The train tokens (8 x 65) of llama4-maverick's two draws in
    ``chip_smoke.py`` phase 11 (a): its generator (seed 11) drawn in that
    phase's order -- per world (1, 2), (2, 2), per MoE config
    (llama4-maverick, deepseek-v2), the tokens (8, 72) and then the
    direct call's input (8, 4, d)."""
    rng = np.random.default_rng(11)
    draws = []
    for _ in range(2):
        for arch in ("llama4-maverick-400b-a17b", "deepseek-v2-236b"):
            cfg = get_smoke(arch)
            toks = rng.integers(0, cfg.vocab_size, (8, 72))
            rng.normal(size=(8, 4, cfg.d_model))
            if arch == FLOOR_ARCH:
                draws.append(toks[:, :65])
    return draws


_REFERENCE = r"""
import dataclasses, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.common.config import TrainConfig
from repro.configs import get_smoke
from repro.distributed.mesh import AxisEnv, axis_size, batch_spec
from repro.models import steps, transformer
from repro.optim import adamw

job = pickle.load(open(sys.argv[1], "rb"))
out = {"cells": {}, "floors": {}}


def run_step(fn, params, t):
    _, opt, met = fn(params, adamw.init_opt_state(params),
                     {"tokens": t[:, :-1], "labels": t[:, 1:]})
    return ({k: float(v) for k, v in met.items()},
            jax.tree.map(np.asarray, opt["m"]))


for key, c in job["cells"].items():
    cfg = dataclasses.replace(get_smoke(c["arch"]), dtype="float32")
    shape, axes = tuple(c["shape"]), tuple(c["axes"])
    devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    mesh = jax.sharding.Mesh(devs, axes)
    env = AxisEnv.from_mesh(mesh)
    pspecs = transformer.param_specs(cfg, env)
    params = jax.tree.map(jnp.asarray, c["params"])
    t = jnp.asarray(c["tokens"], jnp.int32)
    name = batch_spec(env, mesh, t.shape[0])
    bs = env.resolve((name,))[0] if name else None

    def ns(tree):
        return jax.tree.map(lambda s: NamedSharding(mesh, s), tree,
                            is_leaf=lambda x: isinstance(x, P))

    # launch/cells.py's train cell
    def sp_constraint(x):
        if x.ndim == 3 and x.shape[1] % max(axis_size(mesh, env.sp), 1) == 0 \
                and x.shape[1] > 1:
            return jax.lax.with_sharding_constraint(
                x, NamedSharding(mesh, P(bs, "model", None)))
        return x
    fwd = jax.jit(lambda p, x: transformer.forward(
        p, x, cfg, sp_constraint=sp_constraint)[0],
        in_shardings=(ns(pspecs), None))
    step = steps.make_train_step(cfg, TrainConfig(**c["tcfg"]),
                                 sp_constraint=sp_constraint)
    fn = jax.jit(step, in_shardings=(
        ns(pspecs), ns({"m": pspecs, "v": pspecs, "step": P()}), None))
    met, m = run_step(fn, params, t)
    one = jax.jit(lambda p, x: transformer.forward(p, x, cfg)[0])
    out["cells"][key] = {"logits": np.asarray(fwd(params, t[:, :-1])),
                         "logits_world1": np.asarray(one(params, t[:, :-1])),
                         "metrics": met, "m": m}

for key, f in job["floors"].items():
    cfg = dataclasses.replace(get_smoke(f["arch"]), dtype="float32")
    fn = jax.jit(steps.make_train_step(cfg, TrainConfig()))
    t = jnp.asarray(f["tokens"], jnp.int32)
    out["floors"][key] = {which: run_step(fn, jax.tree.map(jnp.asarray, p), t)
                          for which, p in f["params"].items()}
pickle.dump(out, open(sys.argv[2], "wb"))
"""


@pytest.fixture(scope="module")
def weights():
    """The reference's weights from key 0 of each smoke config (numpy),
    and the port's from seed 0 of llama4-maverick's (phase 11 (a)'s)."""
    out = {a: jax.tree.map(np.asarray, ref_tr.init_params(
        _cfg(a), jax.random.PRNGKey(0))) for a in ARCHS}
    cfg = dataclasses.replace(get_smoke(FLOOR_ARCH), dtype="float32")
    out[FLOOR_ARCH] = model_tree_to_numpy(cfg, tr.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    return out


@pytest.fixture(scope="module")
def tokens():
    rng = np.random.default_rng(26)
    return {a: rng.integers(0, ref_get_smoke(a).vocab_size, (8, 17))
            for a in ARCHS}


@pytest.fixture(scope="module")
def results(tmp_path_factory, weights, tokens):
    """The reference's cells (a subprocess) and the port's worlds, run at
    once: {(arch, mesh[, "int8"]): (reference, [rank results])}, and the
    reference's floor runs."""
    tmp = tmp_path_factory.mktemp("dense_tp")
    cells = {(arch, mesh): {"arch": arch, "shape": MESHES[mesh][0],
                            "axes": MESHES[mesh][1], "params": weights[arch],
                            "tokens": tokens[arch], "tcfg": {}}
             for arch, mesh in CASES}
    cells[INT8 + ("int8",)] = dict(cells[INT8],
                                   tcfg={"grad_compression": "int8"})
    nudged = tree_map(torch.tensor, weights[FLOOR_ARCH])
    nudge_(sorted_leaves(nudged), 1)
    floors = {i: {"arch": FLOOR_ARCH, "tokens": t, "params": {
        "drawn": weights[FLOOR_ARCH],
        "nudged": tree_map(lambda a: a.numpy(), nudged)}}
        for i, t in enumerate(_phase11a_draws())}
    with open(tmp / "job.pkl", "wb") as fh:
        pickle.dump({"cells": cells, "floors": floors}, fh)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO_ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") +
                          " --xla_force_host_platform_device_count=4"))
    proc = subprocess.Popen([sys.executable, "-c", _REFERENCE,
                             str(tmp / "job.pkl"), str(tmp / "ref.pkl")],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=REPO_ROOT)
    try:
        port = {}
        for mesh, (shape, axes) in MESHES.items():
            keys, jobs = [], []
            for arch in ARCHS:
                t = tokens[arch]
                base = {"arch": arch, "dtype": "float32",
                        "tree": weights[arch], "forward": t[:, :-1],
                        "train": {"tokens": t[:, :-1], "labels": t[:, 1:]}}
                keys += [(arch, mesh), (arch, mesh, "forward1")]
                jobs += [("model", base), ("model", {
                    "arch": arch, "dtype": "float32", "whole": True,
                    "tree": weights[arch], "forward": t[:, :-1]})]
                if mesh == "2x2":
                    dec = {"arch": arch, "dtype": "float32",
                           "tree": weights[arch], "prompt": t[:, :12],
                           "decode": t[:, 12:16], "capacity": 16}
                    f32 = dict(dec, cache_dtype="float32")
                    keys += [(arch, mesh, w) for w in (
                        "decode", "world1", "decode_f32", "world1_f32")]
                    jobs += [("model", d) for d in (
                        dec, dict(dec, whole=True), f32,
                        dict(f32, whole=True))]
                if (arch, mesh) == INT8:
                    keys.append((arch, mesh, "int8"))
                    jobs.append(("model", dict(base, forward=None, tcfg={
                        "grad_compression": "int8"})))
            ranks = run_world(shape, "many", {"jobs": jobs}, axes=axes,
                              timeout=300)
            for i, k in enumerate(keys):
                port[k] = [r[i] for r in ranks]
        _, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    with open(tmp / "ref.pkl", "rb") as fh:
        ref = pickle.load(fh)
    return {k: (ref["cells"].get(k), v) for k, v in port.items()}, \
        ref["floors"]


def _check_step(ref, ranks):
    want = ref["metrics"]
    ref_m = _leaves(ref["m"])
    for got in ranks:
        met = got["metrics"]
        assert abs(met["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
        assert met["lr"] == want["lr"]
        assert abs(met["grad_norm"] - want["grad_norm"]) \
            <= 1e-3 * want["grad_norm"]
        got_m = _leaves(got["m"])
        assert set(got_m) == set(ref_m)
        for path, w in ref_m.items():
            assert _rel(got_m[path], w) <= 1e-3, path


@pytest.mark.parametrize("arch,mesh", CASES)
def test_forward_and_train_step_match_reference_cell(results, arch, mesh):
    """Each rank's forward logits, and one train step's loss (1e-5
    relative), ``lr`` (equal), ``grad_norm`` and ``m`` (1e-3 of max, ``m``
    gathered whole from the ranks' blocks), against the reference's train
    cell on the same mesh.  The logits: within 1e-5 of max |logit| of the
    port's own world 1 (the whole model in the same process), and of the
    reference's cell within 1e-5 more than the two packages' world-1
    forwards lie apart on the same input: that distance alone is
    0.91·10⁻⁵ (phi4-mini) and 1.05·10⁻⁵ (mistral-nemo) on these tokens,
    the f32 GEMMs of two libraries through three chaotic layers (the
    zoo's world-1 forward tests hold 1e-4)."""
    ref, ranks = results[0][(arch, mesh)]
    for got, one in zip(ranks, results[0][(arch, mesh, "forward1")][1]):
        apart = _rel(one["forward"], ref["logits_world1"])
        assert _rel(got["forward"], one["forward"]) <= 1e-5
        assert _rel(got["forward"], ref["logits"]) <= 1e-5 + apart
    _check_step(ref, ranks)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_each_rank_holds_its_param_specs_block(results, arch, mesh):
    """Every leaf of every rank has the shape of its block under the
    reference's ``param_specs`` (the dense GQA leaves, the embedding and
    the unembedding sharded; the norms whole)."""
    _, ranks = results[0][(arch, mesh)]
    shape, axes = MESHES[mesh]
    port = types.SimpleNamespace(axis_names=axes,
                                 shape=dict(zip(axes, shape)),
                                 axis_index=lambda a: 0)
    cfg = get_smoke(arch)
    specs = dict(tree_leaves(tr.param_specs(cfg, AxisEnv.from_mesh(port))))
    want = {"/".join(p): list(tmesh.block_shape(port, d.shape, specs[p]))
            for p, d in tree_leaves(tr.model_defs(cfg))}
    assert any(w != list(d.shape) for w, (_, d) in
               zip(want.values(), tree_leaves(tr.model_defs(cfg))))
    for got in ranks:
        assert got["blocks"] == want


def test_int8_compression_matches_reference_cell(results):
    """``grad_compression="int8"`` over sharded leaves: each leaf's absmax
    is the max over its blocks (a MAX all-reduce), as the reference's pjit
    step takes it over the whole leaf; phi4-mini at (2, 2).  Loss, ``lr``
    and ``grad_norm`` as above.  ``m`` after one step is 0.1 x the clipped
    dequantized gradient, so each leaf of it lies on a grid of 255 levels,
    max |m| / 127 apart: every element of the port's (gathered whole from
    the blocks) lies on its leaf's grid within 1e-3 of a level (a block
    quantized with its own absmax would not), and its level equals the
    reference's for all but 1 % of the elements, those one level off (a
    gradient within rounding of a level's midpoint rounds to either
    side: one level is 1/127 = 7.9e-3 of max, over the 1e-3 above)."""
    ref, ranks = results[0][INT8 + ("int8",)]
    want = ref["metrics"]
    ref_m = _leaves(ref["m"])
    for got in ranks:
        met = got["metrics"]
        assert abs(met["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
        assert met["lr"] == want["lr"]
        assert abs(met["grad_norm"] - want["grad_norm"]) \
            <= 1e-3 * want["grad_norm"]
        got_m = _leaves(got["m"])
        for path, w in ref_m.items():
            lv = got_m[path] / (np.abs(got_m[path]).max() / 127)
            assert np.abs(lv - np.round(lv)).max() <= 1e-3, path
            off = np.round(lv) - np.round(w / (np.abs(w).max() / 127))
            assert np.abs(off).max() <= 1 and np.mean(off != 0) <= 0.01, \
                path
        rows = {(r["axis"], r["op"]) for r in got["train_ledger"]["rows"]}
        assert ("absmax", "all_reduce") in rows


@pytest.mark.parametrize("mesh", list(MESHES))
def test_collectives_booked_by_axis(results, mesh):
    """The train step's ledger books ``fsdp`` weight gathers (and their
    reduce-scatters) where ``fsdp`` has more than one rank, ``tp``
    all-reduces (the row-parallel sums, the embedding's rows) where
    ``model`` has, and the batch rows gathered where ``batch`` has;
    nothing over an axis of one rank."""
    shape, axes = MESHES[mesh]
    size = dict(zip(axes, shape))
    fsdp = size.get("data", 1) * size.get("pod", 1)
    for arch in ARCHS:
        for got in results[0][(arch, mesh)][1]:
            led = got["train_ledger"]
            calls = {(r["axis"], r["op"]): r["calls"] for r in led["rows"]}
            assert (calls.get(("fsdp", "all_gather"), 0) > 0) == (fsdp > 1)
            assert (calls.get(("fsdp", "reduce_scatter"), 0) > 0) \
                == (fsdp > 1)
            assert (calls.get(("tp", "all_reduce"), 0) > 0) \
                == (size["model"] > 1)
            assert (calls.get(("batch", "all_gather"), 0) > 0) == (fsdp > 1)
            assert led["by_route"]["host"]["calls"] == 0


def test_world_of_one_books_no_collective():
    """On a mesh of one rank the step computes as without a mesh: the
    same metrics, and nothing booked."""
    cfg = get_smoke("phi4-mini-3.8b")
    cfg = dataclasses.replace(cfg, dtype="float32")
    mesh = tmesh.make_mesh((1, 1), ("data", "model"))
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (4, 9)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = []
    for m in (mesh, None):
        model = tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                               mesh=m)
        opt = adamw.init_opt_state(dict(model.named_parameters()))
        mesh.axis_ledger.reset()
        _, met = steps.make_train_step(cfg, TrainConfig(), mesh=m)(
            model, opt, batch)
        out.append({k: float(v) for k, v in met.items()})
        assert mesh.axis_ledger.summary()["rows"] == []
    assert out[0] == out[1]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_over_2x2_equals_world_one_bit_for_bit(results, arch):
    """A prefill of 8 x 12 and 4 teacher-forced decode steps over (2, 2),
    each rank against its block of the KV cache (``init_state(mesh=)``:
    its rows over ``data``, its KV heads over ``tp``), its attention's
    heads and FFN's d_ff chunk over ``tp``.  (The name is kept from when
    every leaf was gathered whole and the logits equalled world 1's bit
    for bit; the ``wo`` / ``w_down`` partial products now add over
    ``tp`` in another order, and an element of the bf16 cache may round
    the other way, moving the logits by ~10⁻⁴ of max |logit|.)  With the
    caches allocated in f32 (``init_state``'s ``cache_dtype``) on the
    mesh and in world 1 in the same process, nothing rounds to bf16:
    every rank's
    logits within 1e-5 of max |logit| of world 1's and its cache its
    block of world 1's within 1e-5 of the block's max.  With the bf16
    cache: the logits within PERF.md §2's 3e-2 for an f32 step over a
    bf16 cache, the cache its block of world 1's within one bf16 ulp of
    the block's max.  The
    prefill gathers the ``fsdp`` dims of the attention and FFN blocks it
    reads and the whole embedding, once, and keeps them; no decode step
    books a weight gather, nor any other collective than the ``tp`` sums
    and the rows gathered over ``batch``."""
    cfg = get_smoke(arch)
    specs = dict(tree_leaves(tr.local_specs(cfg, AxisEnv.from_mesh(
        types.SimpleNamespace(axis_names=("data", "model"))))))
    once = _kept_gathers(cfg, specs)
    for got, want, got32, want32 in zip(
            *(results[0][(arch, "2x2", k)][1]
              for k in ("decode", "world1", "decode_f32", "world1_f32"))):
        at = _mesh_at((2, 2), ("data", "model"), got["coords"])
        for g, w, f32 in ((got, want, False), (got32, want32, True)):
            for k in ("prefill", "decode"):
                assert _rel(g[k], w[k]) <= (1e-5 if f32 else 3e-2), (
                    f32, k, _rel(g[k], w[k]))
            blocks = tr.state_blocks(cfg, [{n: torch.as_tensor(a) for n, a in
                                            layer.items()}
                                           for layer in w["cache"]], at)
            for i, (a, b) in enumerate(zip(g["cache"], blocks)):
                assert a.keys() == b.keys()
                for n in b:
                    b32 = b[n].numpy()
                    assert a[n].shape == b32.shape
                    if f32:
                        assert _rel(a[n], b32) <= 1e-5, (i, n)
                    elif n in ("k", "v", "ckv", "kr"):
                        m = float(np.abs(b32).max())
                        assert np.abs(a[n] - b32).max() <= (
                            2.0 ** (np.floor(np.log2(m)) - 7) if m else 0), (
                            i, n)
        assert once > 0 and got["prefill_ledger"]["weights"]["calls"] == once
        for led in got["step_ledgers"]:
            assert set(led) == {"tp", "batch"}, led


def _kept_gathers(cfg, specs) -> int:
    """The gathers of the weights a prefill reads (no frontend embeds):
    one a sharded dim of each leaf but the ``tp`` dims of the attention
    and dense FFN blocks, which stay this rank's."""
    n = 0
    for path, d, names in tr.reference_leaves(cfg):
        if path == ("frontend_proj",):
            continue
        split = len(path) > 2 and path[2] in ("attn", "ffn")
        n += len(names) * sum(e is not None and not (split and lg == "tp")
                              for e, lg in zip(specs[path], d.logical))
    return n


def _mesh_at(shape, axes, coords):
    """A stand-in for the rank of a ``shape`` mesh at ``coords``."""
    size = dict(zip(axes, shape))

    def index(ax):
        i = 0
        for a in ax:
            i = i * size.get(a, 1) + coords.get(a, 0)
        return i
    return types.SimpleNamespace(axis_names=axes, shape=size,
                                 size=int(np.prod(shape)), axis_index=index)


@pytest.mark.parametrize("arch", ["starcoder2-3b"])
def test_heads_tp_does_not_divide_are_refused(arch):
    """starcoder2's smoke config has one KV head: on a ``tp`` of 2 its
    GQA leaves cannot be split evenly, and ``mesh_specs``,
    ``init_params`` and ``weights_from_tree`` refuse it with a
    ``ValueError`` that names the first leaf that does not split (``wk``)
    and ``tp_pad_config`` (head padding, not ported), before drawing
    anything; at ``tp`` 1 it is accepted."""
    cfg = get_smoke(arch)
    assert cfg.num_kv_heads == 1
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": 1, "model": 2})
    with pytest.raises(ValueError, match="scanned/0/attn/wk.*tp_pad_config"):
        tr.mesh_specs(cfg, mesh)
    with pytest.raises(ValueError, match="tp_pad_config"):
        tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                       mesh=mesh)
    with pytest.raises(ValueError, match="tp_pad_config"):
        tr.weights_from_tree(cfg, {}, mesh)
    mesh.shape = {"data": 2, "model": 1}
    specs = dict(tree_leaves(tr.mesh_specs(cfg, mesh)))
    assert specs[("scanned", "0", "attn", "wk")] == Spec(None, "data",
                                                         "model", None)


def test_maverick_phase11a_floor(results, weights):
    """The reference's f32 floor on phase 11 (a)'s two draws of
    llama4-maverick's train step (capacity 1.25, 8 x 64 tokens, the
    port's weights from seed 0): its step against its step on weights
    nudged one ulp, the largest distance of a leaf of ``m`` from its max
    and of ``grad_norm``.  The port's world-1 step on the same draw lies
    within max(1e-3, twice that floor) of the reference's."""
    cfg = dataclasses.replace(get_smoke(FLOOR_ARCH), dtype="float32")
    floors = results[1]
    for i, toks in enumerate(_phase11a_draws()):
        (met, m), (met_n, m_n) = (floors[i][w] for w in ("drawn", "nudged"))
        ref_m, nud_m = _leaves(m), _leaves(m_n)
        floor = max(_rel(nud_m[p], w) for p, w in ref_m.items())
        gn_floor = abs(met_n["grad_norm"] / met["grad_norm"] - 1)
        model = tr.Transformer(cfg, tr.weights_from_tree(
            cfg, tree_map(torch.tensor, weights[FLOOR_ARCH])))
        opt = adamw.init_opt_state(dict(model.named_parameters()))
        t = torch.as_tensor(toks)
        _, got = steps.make_train_step(cfg, TrainConfig())(
            model, opt, {"tokens": t[:, :-1], "labels": t[:, 1:]})
        got_m = _leaves(tr.tree_from_weights(cfg, opt["m"]))
        err = max(_rel(got_m[p].numpy(), w) for p, w in ref_m.items())
        print(f"draw {i}: reference floor m {floor:.3e} grad_norm "
              f"{gn_floor:.3e}; port world 1 vs reference m {err:.3e}")
        assert np.isfinite(floor) and floor > 0
        assert err <= max(1e-3, 2 * floor)
        assert abs(float(got["grad_norm"]) / met["grad_norm"] - 1) \
            <= max(1e-3, 2 * gn_floor)
