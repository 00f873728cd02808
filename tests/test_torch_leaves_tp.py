"""Every leaf kind beyond the dense GQA ones over a model mesh: MLA,
cross-attention, the Mamba2 / mLSTM / sLSTM mixers and the frontend and
memory projections as their ``param_specs`` blocks
(``models/transformer.py``'s ``local_specs`` and ``Block``,
``attention.mla_attention_tp`` / ``cross_attention_tp``, the mixers'
``forward_rows``, ``layers.use_block``): the port in gloo worlds of 2 and
4 processes against the reference's train cell on 4 XLA host devices.

The reference runs as its dry-run's train cell builds it
(``src/repro/launch/cells.py:155-175``): ``make_train_step(cfg,
TrainConfig(), sp_constraint=...)`` (with ``use_ep`` and the mesh for the
MoE config) jitted with ``in_shardings`` of ``param_specs`` for the
parameters and ``{"m": pspecs, "v": pspecs, "step": P()}`` for the
optimizer state, and its forward under the same shardings; one
subprocess (``--xla_force_host_platform_device_count=4``) runs every case
while the port's worlds run (``launch/ep_world.py``, one ``many`` job
list a world).

Cases, in float32 on the reference's weights from key 0 (every cross
gate set to 0.5: at its init of 0 a cross layer adds nothing and its
projections take no gradient), a batch of 8 x 16 tokens from a numpy
seed:

* ``mla``: deepseek-v2's smoke config with a dense FFN and no MoE (MLA
  with a q LoRA alone), over (1, 2), (2, 1), (2, 2) and (2, 2, 1) =
  (pod, data, model);
* ``mla_ep``: deepseek-v2's smoke config as it is, ``use_ep`` at (1, 2)
  (MLA beside the expert-parallel MoE);
* ``vision``: llama-vision's smoke config with a memory (8, 16, 24)
  (cross-attention, ``memory_proj``);
* ``zamba``: zamba2's smoke config (Mamba2 beside GQA);
* ``xlstm``: xlstm's smoke config (mLSTM, sLSTM);

the last three over (1, 2), (2, 1) and (2, 2).

Tolerances, ``tests/test_torch_dense_tp.py``'s: the logits within 1e-5
of max |logit| of the port's own world 1, and of the reference's cell
within 1e-5 more than the two packages' world-1 forwards lie apart on
the same input; loss 1e-5 relative; ``lr`` equal; ``grad_norm`` and
every leaf of ``m`` 1e-3 of its max (f32 gradients of the chaotic
random models are good to about 1e-4 of max).  A decode over (2, 2)
runs each rank against its block of the state: with f32 caches within
1e-5 of world 1, with the bf16 caches within PERF.md §2's 3e-2 and its
caches its blocks of world 1's within a bf16 ulp.
"""

import dataclasses
import os
import pickle
import re
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as ref_get_smoke
from repro.models import transformer as ref_tr
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.distributed import mesh as tmesh
from repro_torch.distributed.mesh import AxisEnv
from repro_torch.launch.ep_world import run_world
from repro_torch.models import transformer as tr
from repro_torch.models.layers import tree_leaves, tree_map

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
MESHES = {"1x2": ((1, 2), ("data", "model")),
          "2x1": ((2, 1), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "2x2x1": ((2, 2, 1), ("pod", "data", "model"))}
DENSE = {"ffn_kind": "dense", "moe": None}
# case: (arch, config overrides, use_ep, meshes)
KINDS = {"mla": ("deepseek-v2-236b", DENSE, False,
                 ("1x2", "2x1", "2x2", "2x2x1")),
         "mla_ep": ("deepseek-v2-236b", {}, True, ("1x2",)),
         "vision": ("llama-3.2-vision-90b", {}, False, ("1x2", "2x1", "2x2")),
         "zamba": ("zamba2-1.2b", {}, False, ("1x2", "2x1", "2x2")),
         "xlstm": ("xlstm-350m", {}, False, ("1x2", "2x1", "2x2"))}
CASES = [(k, m) for k, v in KINDS.items() for m in v[3]]
DECODE = ("mla", "vision", "zamba", "xlstm")     # one config per kind
MEMORY = (8, 16, 24)
REF_PROCS = 2


def _cfg(kind, ref=False):
    arch, over = KINDS[kind][:2]
    return dataclasses.replace((ref_get_smoke if ref else get_smoke)(arch),
                               dtype="float32", **over)


def _leaves(tree):
    """{path: array} of a nested dict, keys sorted."""
    return dict(tree_leaves({k: tree[k] for k in sorted(tree)}))


def _rel(got, want):
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _moe_paths(cfg) -> set:
    """The paths of the leaves of every MoE ``ffn`` subtree."""
    defs = tr.model_defs(cfg)
    return {p for p, _ in tree_leaves(defs) if p[0] in ("prefix", "scanned")
            and p[2] == "ffn" and "router" in defs[p[0]][p[1]]["ffn"]}


def _new_kind(cfg, path) -> bool:
    """Whether ``path`` is a leaf of MLA, cross-attention, a mixer or a
    frontend projection."""
    if path[0] in ("frontend_proj", "memory_proj"):
        return True
    if path[0] not in ("prefix", "scanned"):
        return False
    segs = tr.plan_segments(cfg)
    kind = (segs.prefix if path[0] == "prefix" else segs.period)[
        int(path[1])][0]
    return path[2] == "mixer" or (path[2] == "attn" and kind != "attn")


def _fake_mesh(shape, axes=("data", "model")):
    return types.SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)),
                                 axis_index=lambda a: 0)


def _mesh_at(shape, coords, axes=("data", "model")):
    """A stand-in for the rank of a ``shape`` mesh at ``coords``."""
    size = dict(zip(axes, shape))

    def index(ax):
        i = 0
        for a in ax:
            i = i * size.get(a, 1) + coords.get(a, 0)
        return i
    return types.SimpleNamespace(axis_names=axes, shape=size,
                                 size=int(np.prod(shape)), axis_index=index)


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
out = {"cells": {}, "world1": {}}


def config(c):
    return dataclasses.replace(get_smoke(c["arch"]), dtype="float32",
                               **c["overrides"])


for kind, c in job["world1"].items():
    cfg = config(c)
    one = jax.jit(lambda p, x, m: transformer.forward(p, x, cfg,
                                                      memory=m)[0])
    t = jnp.asarray(c["tokens"], jnp.int32)
    out["world1"][kind] = np.asarray(one(jax.tree.map(jnp.asarray,
                                                      c["params"]),
                                         t[:, :-1], c["memory"]))

for key, c in job["cells"].items():
    cfg = config(c)
    shape, axes = tuple(c["shape"]), tuple(c["axes"])
    devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    mesh = jax.sharding.Mesh(devs, axes)
    env = AxisEnv.from_mesh(mesh)
    pspecs = transformer.param_specs(cfg, env)
    params = jax.tree.map(jnp.asarray, c["params"])
    t = jnp.asarray(c["tokens"], jnp.int32)
    mem = None if c["memory"] is None else jnp.asarray(c["memory"])
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
    ep = c["use_ep"]
    fwd = jax.jit(lambda p, x, m: transformer.forward(
        p, x, cfg, memory=m, use_ep=ep, mesh=mesh if ep else None,
        sp_constraint=sp_constraint)[0],
        in_shardings=(ns(pspecs), None, None))
    step = steps.make_train_step(cfg, TrainConfig(), use_ep=ep,
                                 mesh=mesh if ep else None,
                                 sp_constraint=sp_constraint)
    fn = jax.jit(step, in_shardings=(
        ns(pspecs), ns({"m": pspecs, "v": pspecs, "step": P()}), None))
    batch = {"tokens": t[:, :-1], "labels": t[:, 1:]}
    if mem is not None:
        batch["memory"] = mem
    _, opt, met = fn(params, adamw.init_opt_state(params), batch)
    out["cells"][key] = {"logits": np.asarray(fwd(params, t[:, :-1], mem)),
                         "metrics": {k: float(v) for k, v in met.items()},
                         "m": jax.tree.map(np.asarray, opt["m"])}
pickle.dump(out, open(sys.argv[2], "wb"))
"""


@pytest.fixture(scope="module")
def inputs():
    """Per kind: the reference's weights from key 0 (numpy, every cross
    gate 0.5), tokens (8, 17) and the memory (llama-vision's)."""
    rng = np.random.default_rng(27)
    out = {}
    for kind in KINDS:
        cfg = _cfg(kind, ref=True)
        params = jax.tree.map(np.asarray, ref_tr.init_params(
            cfg, jax.random.PRNGKey(0)))
        params = tree_map(np.array, params)
        for path, a in tree_leaves(params):
            if path[-1] == "gate":
                a[...] = 0.5
        out[kind] = {"params": params,
                     "tokens": rng.integers(0, cfg.vocab_size, (8, 17)),
                     "memory": (rng.normal(size=MEMORY).astype(np.float32)
                                if cfg.cross_attn_every else None)}
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory, inputs):
    """The reference's cells and world-1 logits (a subprocess) and the
    port's worlds, run at once: {(kind, mesh[, what]): (reference, [rank
    results])}, the reference's world-1 logits by kind, and the restored
    checkpoints by kind."""
    tmp = tmp_path_factory.mktemp("leaves_tp")
    # two subprocesses, the cells dealt between them in turn (one takes
    # about 110 s alone)
    job = [{"world1": {}, "cells": {}} for _ in range(REF_PROCS)]
    for kind, (arch, over, ep, _) in KINDS.items():
        base = {"arch": arch, "overrides": over, "use_ep": ep,
                **inputs[kind]}
        job[0]["world1"][kind] = base
        for mesh in KINDS[kind][3]:
            job[CASES.index((kind, mesh)) % REF_PROCS]["cells"][
                (kind, mesh)] = dict(base, shape=MESHES[mesh][0],
                                     axes=MESHES[mesh][1])
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO_ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") +
                          " --xla_force_host_platform_device_count=4"))
    procs = []
    for i, j in enumerate(job):
        with open(tmp / f"job{i}.pkl", "wb") as fh:
            pickle.dump(j, fh)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _REFERENCE, str(tmp / f"job{i}.pkl"),
             str(tmp / f"ref{i}.pkl")], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, cwd=REPO_ROOT))
    try:
        for kind in DECODE:     # world-1 checkpoints of the reference's trees
            ckpt.save(str(tmp / kind), 3,
                      tree_map(torch.tensor, inputs[kind]["params"]))
        port, restored = {}, {}
        for mesh, (shape, axes) in MESHES.items():
            keys, jobs = [], []
            for kind, (arch, over, _, meshes) in KINDS.items():
                if mesh not in meshes:
                    continue
                t, mem = inputs[kind]["tokens"], inputs[kind]["memory"]
                tree = inputs[kind]["params"]
                base = {"arch": arch, "overrides": over, "dtype": "float32",
                        "tree": tree, "memory": mem, "forward": t[:, :-1],
                        "train": {"tokens": t[:, :-1], "labels": t[:, 1:]}}
                keys += [(kind, mesh), (kind, mesh, "forward1")]
                jobs += [("model", base), ("model", {
                    "arch": arch, "overrides": over, "dtype": "float32",
                    "whole": True, "tree": tree, "memory": mem,
                    "forward": t[:, :-1]})]
                if mesh == "2x2" and kind in DECODE:
                    dec = {"arch": arch, "overrides": over,
                           "dtype": "float32", "tree": tree, "memory": mem,
                           "prompt": t[:, :12], "decode": t[:, 12:16],
                           "capacity": 16}
                    f32 = dict(dec, cache_dtype="float32")
                    keys += [(kind, mesh, w) for w in (
                        "decode", "world1", "decode_f32", "world1_f32")]
                    jobs += [("model", d) for d in (
                        dec, dict(dec, whole=True), f32,
                        dict(f32, whole=True))]
                if mesh == "1x2" and kind in DECODE:
                    keys.append((kind, mesh, "restore"))
                    jobs.append(("restore", {"arch": arch, "overrides": over,
                                             "dtype": "float32",
                                             "dir": str(tmp / kind)}))
            ranks = run_world(shape, "many", {"jobs": jobs}, axes=axes,
                              timeout=300)
            for i, k in enumerate(keys):
                (restored if k[-1] == "restore" else port)[k] = [
                    r[i] for r in ranks]
        errs = [proc.communicate(timeout=600)[1] for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    ref = {"cells": {}, "world1": {}}
    for i, (proc, err) in enumerate(zip(procs, errs)):
        assert proc.returncode == 0, err[-3000:]
        with open(tmp / f"ref{i}.pkl", "rb") as fh:
            got = pickle.load(fh)
        for k in ref:
            ref[k].update(got[k])
    return ({k: (ref["cells"].get(k), v) for k, v in port.items()},
            ref["world1"], restored)


@pytest.mark.parametrize("kind,mesh", CASES)
def test_forward_and_train_step_match_reference_cell(results, kind, mesh):
    """Each rank's forward logits, and one train step's loss (1e-5
    relative), ``lr`` (equal), ``grad_norm`` and ``m`` (1e-3 of max, ``m``
    gathered whole from the ranks' blocks), against the reference's train
    cell on the same mesh.  The logits: within 1e-5 of max |logit| of the
    port's own world 1 (the whole model in the same process), and of the
    reference's cell within 1e-5 more than the two packages' world-1
    forwards lie apart on the same input.  With ``use_ep`` the forward is
    the expert-parallel one, whose capacity drops differ from world 1's
    dense path: it is held to the reference's EP forward alone."""
    cells, world1, _ = results
    ref, ranks = cells[(kind, mesh)]
    for got, one in zip(ranks, cells[(kind, mesh, "forward1")][1]):
        apart = _rel(one["forward"], world1[kind])
        if not KINDS[kind][2]:
            assert _rel(got["forward"], one["forward"]) <= 1e-5
        assert _rel(got["forward"], ref["logits"]) <= 1e-5 + apart
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


@pytest.mark.parametrize("kind,mesh", CASES)
def test_each_rank_holds_its_param_specs_block(results, kind, mesh):
    """Every leaf of every rank has the shape of its block under the
    reference's ``param_specs`` -- MLA's, cross-attention's, the mixers'
    and the projections' included, and some of them sharded -- but an
    MoE ``ffn`` leaf, which has ``moe_param_specs``' (``local_specs``)."""
    _, ranks = results[0][(kind, mesh)]
    port = _fake_mesh(*MESHES[mesh])
    cfg, env = _cfg(kind), AxisEnv.from_mesh(port)
    param = dict(tree_leaves(tr.param_specs(cfg, env)))
    local = dict(tree_leaves(tr.local_specs(cfg, env)))
    defs = dict(tree_leaves(tr.model_defs(cfg)))
    moe = _moe_paths(cfg)
    want = {"/".join(p): list(tmesh.block_shape(
        port, d.shape, local[p] if p in moe else param[p]))
        for p, d in defs.items()}
    assert any(want["/".join(p)] != list(d.shape)
               for p, d in defs.items() if _new_kind(cfg, p))
    for got in ranks:
        assert got["blocks"] == want


@pytest.mark.parametrize("kind", DECODE)
def test_decode_over_2x2_equals_world_one_bit_for_bit(results, kind):
    """A prefill of 8 x 12 (with the memory, llama-vision) and 4
    teacher-forced decode steps over (2, 2), each rank against its block
    of the state (``init_state(mesh=)``: its rows; MLA's latent columns,
    the KV heads, the mixer states' ``tp`` columns).  (The name is kept
    from when every leaf was gathered whole and the logits equalled world
    1's bit for bit; the heads' partial products now add over ``tp`` in
    another order, and an element of a bf16 cache may round the other
    way, moving the logits by ~10⁻⁴ of max |logit|.)  With the caches
    allocated in f32 (``init_state``'s ``cache_dtype``) on the mesh and
    in world 1 in the same process, nothing rounds to bf16: every rank's
    logits within 1e-5 of max |logit| of world 1's and every leaf of its
    state its block of world 1's within 1e-5 of the block's max.  With
    the bf16 caches: the logits within PERF.md §2's 3e-2 for an f32 step
    over a bf16 cache, each cache its block of world 1's within one bf16
    ulp of the block's max (the SSM
    states are held in the f32 run: here a bf16 rounding upstream moves
    them).  The prefill gathers each weight
    once and keeps it: the ``fsdp`` dims of the attention blocks (MLA,
    GQA, cross) and the mixers', the embedding's, the unembedding's and
    the memory projection's leaves whole (the frontend projection is not read: the
    calls take token ids); no decode step books a weight gather.  MLA's
    steps gather the other ranks' latent columns of the written slots
    (``latent_cache``), the mixers' their state blocks over ``tp``
    (``ssm_state``); nothing else but the ``tp`` sums and the rows."""
    cfg = _cfg(kind)
    specs = dict(tree_leaves(tr.local_specs(cfg, AxisEnv.from_mesh(
        _fake_mesh((2, 2))))))
    once = 0
    for path, d, names in tr.reference_leaves(cfg):
        if path == ("frontend_proj",):
            continue
        split = len(path) > 2 and path[2] in ("attn", "ffn")
        once += len(names) * sum(e is not None and not (split and lg == "tp")
                                 for e, lg in zip(specs[path], d.logical))
    kinds = {k for k, _ in tr.plan_segments(cfg).layers}
    allowed = {"tp", "batch"} | ({"latent_cache"} if "mla" in kinds
                                 else set()) | (
        {"ssm_state"} if kinds & {"mamba2", "mlstm", "slstm"} else set())
    for got, want, got32, want32 in zip(
            *(results[0][(kind, "2x2", k)][1]
              for k in ("decode", "world1", "decode_f32", "world1_f32"))):
        at = _mesh_at((2, 2), got["coords"])
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
            assert "weights" not in led and set(led) <= allowed, led


@pytest.mark.parametrize("kind", DECODE)
def test_world_one_checkpoint_restores_onto_1x2(results, kind):
    """A checkpoint written by a world of one (the reference's tree)
    restores onto (1, 2) with ``local_specs``: every rank holds, leaf for
    leaf, the slice of the saved leaf its spec names, at the saved step."""
    cfg = _cfg(kind)
    port = _fake_mesh((1, 2))
    specs = dict(tree_leaves(tr.local_specs(cfg, AxisEnv.from_mesh(port))))
    want = {"/".join(p): list(tmesh.block_shape(port, d.shape, specs[p]))
            for p, d in tree_leaves(tr.model_defs(cfg))}
    for got in results[2][(kind, "1x2", "restore")]:
        assert got["step"] == 3 and got["all_equal"]
        assert got["leaves"] == len(want) and got["shapes"] == want


@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 2)])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_local_specs_equal_param_specs_outside_moe(arch, shape):
    """Over any mesh every leaf of the port's layout is the reference's
    ``param_specs`` block but the MoE ``ffn`` leaves, which keep
    ``moe.moe_param_specs`` (the expert-parallel layout); and
    ``mesh_specs`` accepts every full config on these meshes."""
    cfg = get_config(arch)
    port = _fake_mesh(shape)
    env = AxisEnv.from_mesh(port)
    local = dict(tree_leaves(tr.local_specs(cfg, env)))
    param = dict(tree_leaves(tr.param_specs(cfg, env)))
    moe = _moe_paths(cfg)
    assert set(local) == set(param)
    assert {p for p in param if local[p] != param[p]} <= moe
    assert dict(tree_leaves(tr.mesh_specs(cfg, port))) == local


@pytest.mark.parametrize("kind,leaf", [("mla", "w_uk"), ("vision", "wq")])
def test_heads_tp_does_not_divide_are_refused(kind, leaf):
    """An MLA config with 3 heads, and a cross-attention config (every
    layer a cross layer) with 3 query and 3 KV heads, on a ``tp`` of 2:
    ``mesh_specs`` and ``init_params`` refuse them with a ``ValueError``
    that names the leaf, its shape, its spec and the mesh, and points to
    ``tp_pad_config``; at ``tp`` 1 both are accepted."""
    over = {"num_heads": 3, "num_kv_heads": 3}
    if kind == "vision":
        over["cross_attn_every"] = 1
    cfg = dataclasses.replace(_cfg(kind), **over)
    mesh = _fake_mesh((1, 2))
    path, d = next((p, d) for p, d in tree_leaves(tr.model_defs(cfg))
                   if p[-1] == leaf)
    spec = tr.param_specs(cfg, AxisEnv.from_mesh(mesh))
    for k in path:
        spec = spec[k]
    assert tr.plan_segments(cfg).layers[0][0] == tr.plan_segments(
        cfg).layers[-1][0] == ("mla" if kind == "mla" else "cross_attn")
    message = (f"leaf {'/'.join(path)} of shape {tuple(d.shape)} and spec "
               f"{tuple(spec)} does not split on the mesh "
               f"{{'data': 1, 'model': 2}}")
    with pytest.raises(ValueError, match=re.escape(message) +
                       ".*tp_pad_config"):
        tr.mesh_specs(cfg, mesh)
    with pytest.raises(ValueError, match="tp_pad_config"):
        tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                       mesh=mesh)
    mesh.shape = {"data": 2, "model": 1}
    assert tr.mesh_specs(cfg, mesh)


@pytest.mark.parametrize("kind", DECODE)
def test_init_params_on_a_mesh_keeps_its_blocks(kind):
    """``init_params(mesh=)`` on (2, 2) draws the world-1 sequence and
    keeps rank 0's block of every leaf (``mesh_specs``): each of its
    parameters equals that slice of the whole draw, and a new-kind leaf
    is among the sharded ones."""
    cfg = _cfg(kind)
    mesh = _fake_mesh((2, 2))
    whole = dict(tr.init_params(cfg, torch.Generator().manual_seed(0),
                                "cpu").named_parameters())
    blocks = dict(tr.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu", mesh=mesh).named_parameters())
    specs = dict(tree_leaves(tr.mesh_specs(cfg, mesh)))
    sharded = set()
    for path, _, names in tr.reference_leaves(cfg):
        spec = specs[path][1:] if path[0] == "scanned" else specs[path]
        for n in names:
            sl = tmesh.block_slices(mesh, whole[n].shape, spec)
            assert torch.equal(blocks[n], whole[n][sl]), n
            if blocks[n].shape != whole[n].shape and _new_kind(cfg, path):
                sharded.add(path)
    assert sharded
