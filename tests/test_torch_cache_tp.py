"""The decode state over a model mesh as its ``state_specs`` blocks
(``models/transformer.py``'s ``init_state(mesh=)`` and the ``Block`` on a
call with a state; ``attention.gqa_attention_tp`` / ``mla_attention_tp``
against their cache blocks; ``ssm._Mixer.forward_state``): a prefill and
teacher-forced decode steps in the port's gloo worlds of 2 and 4
processes against the reference's decode cell on 4 XLA host devices.

The reference runs as its dry-run's decode cell builds it
(``src/repro/launch/cells.py:194-206``): the parameters placed by
``param_specs``, the state by ``state_specs`` (``batch_spec`` replicates a
batch the batch axes do not divide), ``make_decode_step(cfg)`` jitted
with ``donate_argnums=(1,)``; its prefill is ``make_prefill_step(cfg,
capacity)`` jitted on the placed parameters, its state then placed by
``state_specs``, as is every decode step's.  Two subprocesses
(``--xla_force_host_platform_device_count=4``) run every cell while the
port's worlds run (``launch/ep_world.py``, one ``many`` job list a
world).  Each rank of the port holds the block that the reference's
device at the same mesh coordinate holds (its ``addressable_shards``
entry; ranks and devices both numbered with the first axis major).

Cases, in float32 on the reference's weights from key 0 (every cross
gate 0.5), a prefill of 12 tokens into 16 slots, then 4 teacher-forced
decode steps:

* ``gqa``: phi4-mini's smoke config, a batch of 3 (the batch axes of
  (2, 1) and (2, 2) do not divide it: the state's batch is whole there);
* ``mla``: deepseek-v2's smoke config with a dense FFN (its EP decode
  raises with ``model`` > 1 in the reference, ROADMAP queue 3), batch 8;
* ``zamba``: zamba2's smoke config (Mamba2 beside GQA), batch 8 with
  left padding (``valid_from``);
* ``xlstm``: xlstm's smoke config (mLSTM, sLSTM), batch 8;
* ``vision``: llama-vision's smoke config (GQA beside cross layers),
  batch 8, prefilled with a memory (8, 16, 24);

over (1, 2), (2, 1) and (2, 2) = (data, model), and for MLA also (2, 2,
1) = (pod, data, model).

Tolerances.  The caches are bf16 in both packages whatever the compute
dtype, and a mesh sums the row-parallel partial products over ``tp`` in
another order than a world of one, so an element of a cache, or of the
bf16 attention output read from it, may round the other way and move
every later logit by ~10⁻⁴ of max |logit| (the reference's own decode
cell lies as far from its world 1).  So the mesh's arithmetic is held
tight with the caches allocated in f32 on the mesh and in world 1
(``init_state``'s ``cache_dtype``): logits within 1e-5 of max |logit|,
every state block within 1e-5 of its max.  With the bf16 caches:

* the logits within max(1e-5, twice the one-ulp floor) of the port's
  world 1, the floor the larger of the two packages' world 1 on weights
  nudged one f32 ulp (a nudge moves what a cache rounds as a mesh's
  order of sums does; 2.7e-6 to 9.8e-4 here), and of the reference's
  cell within that plus the two world-1 runs' distance and the
  reference cell's own distance from its world 1;
* each rank's state blocks, after the prefill and after the last step,
  its blocks of the port's world-1 state: a bf16 cache within one bf16
  ulp of the block's max, an f32 SSM state within 1e-5 of it, raised to
  the reference's one-ulp floor of that leaf where larger (the chaotic
  zamba2 and xlstm smoke states: the reference's world 1 on nudged
  weights); and the reference's shards within that plus the two
  packages' world-1 states' distance on the block and the reference
  cell's own distance from its world 1 (zamba2's Mamba2 states read up
  to 3.9 of the bare limit against the reference's shards without those
  two terms).
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
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.distributed.mesh import AxisEnv, block_shape
from repro_torch.launch.ep_world import nudge_, run_world, sorted_leaves
from repro_torch.models import steps
from repro_torch.models import transformer as tr
from repro_torch.models.layers import tree_leaves, tree_map

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
MESHES = {"1x2": ((1, 2), ("data", "model")),
          "2x1": ((2, 1), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "2x2x1": ((2, 2, 1), ("pod", "data", "model"))}
DENSE = {"ffn_kind": "dense", "moe": None}
THREE = ("1x2", "2x1", "2x2")
# kind: (arch, config overrides, meshes, batch)
KINDS = {"gqa": ("phi4-mini-3.8b", {}, THREE, 3),
         "mla": ("deepseek-v2-236b", DENSE, THREE + ("2x2x1",), 8),
         "zamba": ("zamba2-1.2b", {}, THREE, 8),
         "xlstm": ("xlstm-350m", {}, THREE, 8),
         "vision": ("llama-3.2-vision-90b", {}, THREE, 8)}
CASES = [(k, m) for k, v in KINDS.items() for m in v[2]]
PROMPT, STEPS, CAPACITY = 12, 4, 16
MEMORY = (8, 16, 24)
PADDED = "zamba"
REF_PROCS = 2
CACHES = ("k", "v", "ckv", "kr")          # the bf16 leaves


def _cfg(kind, ref=False):
    arch, over = KINDS[kind][:2]
    return dataclasses.replace((ref_get_smoke if ref else get_smoke)(arch),
                               dtype="float32", **over)


def _rel(got, want):
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _mesh_at(mesh, coords=None):
    """A stand-in for ``mesh``'s rank at ``coords`` (default: the
    origin), enough for ``block_shape`` and ``state_blocks``."""
    shape, axes = MESHES[mesh]
    size = dict(zip(axes, shape))
    coords = coords or {a: 0 for a in axes}

    def index(ax):
        i = 0
        for a in ax:
            i = i * size.get(a, 1) + coords.get(a, 0)
        return i
    return types.SimpleNamespace(axis_names=axes, shape=size,
                                 size=int(np.prod(shape)), axis_index=index)


def _within(got, want, name, floor=0.0, apart=0.0):
    """Whether a state block lies within its tolerance of ``want``: one
    bf16 ulp of the block's max for a cache, max(1e-5, ``floor``) of it
    for an SSM state, plus ``apart`` (absolute); and the distance, in
    those units."""
    m = float(np.abs(want).max())
    if m == 0:
        return bool(np.array_equal(got, want)), 0.0
    unit = (2.0 ** (np.floor(np.log2(m)) - 7) if name in CACHES
            else max(1e-5, floor) * m)
    d = float(np.abs(got - want).max()) / (unit + apart)
    return d <= 1.0, d


_REFERENCE = r"""
import dataclasses, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_smoke
from repro.distributed.mesh import AxisEnv, batch_spec
from repro.models import steps, transformer

job = pickle.load(open(sys.argv[1], "rb"))
out = {"cells": {}, "world1": {}}


def config(c):
    return dataclasses.replace(get_smoke(c["arch"]), dtype="float32",
                               **c["overrides"])


def layers(cfg, tree):
    # the state tree as one dict a layer in layer order (scanned leaves
    # unstacked), the index left out, in f32 (a bf16 cache's values)
    segs = transformer.plan_segments(cfg)
    out = [{n: np.asarray(a, np.float32)
            for n, a in tree["prefix"][str(i)].items() if n != "index"}
           for i in range(len(segs.prefix))]
    for p in range(segs.n_periods):
        out += [{n: np.asarray(a[p], np.float32)
                 for n, a in tree["scanned"][str(j)].items() if n != "index"}
                for j in range(len(segs.period))]
    return out


def jits(cfg, c, decode_kw={}):
    return (jax.jit(steps.make_prefill_step(cfg, c["capacity"])),
            jax.jit(steps.make_decode_step(cfg), **decode_kw))


def run(c, params, fns, place=lambda st: st, snap=lambda st: None):
    prefill, decode = fns
    t = jnp.asarray(c["tokens"], jnp.int32)
    vf = None if c["valid_from"] is None else jnp.asarray(c["valid_from"])
    mem = None if c["memory"] is None else jnp.asarray(c["memory"])
    s = c["prompt"]
    st, last = prefill(params, t[:, :s], mem, vf)
    st = place(st)
    first, logits = snap(st), [np.asarray(last)]
    for j in range(c["steps"]):
        pos = jnp.full((t.shape[0], 1), s + j, jnp.int32)
        st, lg = decode(params, st, t[:, s + j:s + j + 1], pos, vf)
        st = place(st)
        logits.append(np.asarray(lg))
    return np.stack(logits), first, snap(st)


def snap(st):
    return layers(cfg, jax.tree.map(np.asarray, st))


for kind, c in job["world1"].items():
    # world 1, and on the weights nudged one ulp (the reference's floor)
    cfg = config(c)
    fns = jits(cfg, c)
    out["world1"][kind] = {
        w: run(c, jax.tree.map(jnp.asarray, c[p]), fns, snap=snap)
        for w, p in (("plain", "params"), ("nudged", "nudged"))}

for key, c in job["cells"].items():
    cfg = config(c)
    shape, axes = tuple(c["shape"]), tuple(c["axes"])
    devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    mesh = jax.sharding.Mesh(devs, axes)
    env = AxisEnv.from_mesh(mesh)
    b = c["tokens"].shape[0]

    def ns(tree):
        return jax.tree.map(lambda s: NamedSharding(mesh, s), tree,
                            is_leaf=lambda x: isinstance(x, P))

    # launch/cells.py's decode cell: the parameters by param_specs, the
    # state by state_specs
    params = jax.device_put(jax.tree.map(jnp.asarray, c["params"]),
                            ns(transformer.param_specs(cfg, env)))
    sspecs = ns(transformer.state_specs(cfg, env, b, c["capacity"],
                                        batch_logical=batch_spec(env, mesh,
                                                                 b)))

    def shards(st):
        # each device's shard of every leaf, devices in mesh order, and
        # the shards' shapes under the state's specs
        return ([layers(cfg, jax.tree.map(
            lambda a: next(s.data for s in a.addressable_shards
                           if s.device == d), st)) for d in devs.flat],
                [{n: a.shape for n, a in l.items()} for l in layers(
                    cfg, jax.tree.map(lambda a, s: np.zeros(
                        s.shard_shape(a.shape), np.int8), st, sspecs))])

    logits, first, last = run(c, params,
                              jits(cfg, c, {"donate_argnums": (1,)}),
                              lambda st: jax.device_put(st, sspecs), shards)
    out["cells"][key] = {"logits": logits, "prefill": first[0],
                         "final": last[0], "shard_shapes": first[1]}
pickle.dump(out, open(sys.argv[2], "wb"))
"""


@pytest.fixture(scope="module")
def inputs():
    """Per kind: the reference's weights from key 0 (numpy, every cross
    gate 0.5), tokens (batch, 16), left padding and the memory where the
    case has them."""
    rng = np.random.default_rng(28)
    out = {}
    for kind, (_, _, _, batch) in KINDS.items():
        cfg = _cfg(kind, ref=True)
        params = tree_map(np.array, jax.tree.map(np.asarray, ref_tr.init_params(
            cfg, jax.random.PRNGKey(0))))
        for path, a in tree_leaves(params):
            if path[-1] == "gate":
                a[...] = 0.5
        out[kind] = {
            "params": params, "prompt": PROMPT, "steps": STEPS,
            "capacity": CAPACITY,
            "tokens": rng.integers(0, cfg.vocab_size,
                                   (batch, PROMPT + STEPS)),
            "valid_from": (rng.integers(0, 6, batch) if kind == PADDED
                           else None),
            "memory": (rng.normal(size=MEMORY).astype(np.float32)
                       if cfg.cross_attn_every else None)}
    return out


def _world1(kind, c, cache_dtype=None):
    """The port's prefill and decode steps with no mesh (a world of one,
    in this process), the caches in ``cache_dtype`` where given: the
    logits of every call and the state after the prefill and after the
    last step."""
    cfg = _cfg(kind)
    p = dict(c, arch=KINDS[kind][0], overrides=KINDS[kind][1],
             dtype="float32", tree=c["params"])
    from repro_torch.launch.ep_world import _draw
    model = _draw(cfg, None, torch.device("cpu"), p)
    t = torch.as_tensor(c["tokens"])
    vf = None if c["valid_from"] is None else torch.as_tensor(c["valid_from"])
    mem = None if c["memory"] is None else torch.as_tensor(c["memory"])
    s = c["prompt"]
    st, last = steps.make_prefill_step(cfg, c["capacity"],
                                       cache_dtype=cache_dtype)(
        model, t[:, :s], vf, memory=mem)
    copy = [{n: v.clone() if torch.is_tensor(v) else v for n, v in l.items()}
            for l in st]
    logits = [last.numpy()]
    decode = steps.make_decode_step(cfg)
    for j in range(c["steps"]):
        pos = torch.full((t.shape[0], 1), s + j, dtype=torch.int32)
        st, lg = decode(model, st, t[:, s + j:s + j + 1], pos, vf)
        logits.append(lg.numpy())
    return {"logits": np.stack(logits), "prefill": copy, "final": st}


@pytest.fixture(scope="module")
def results(tmp_path_factory, inputs):
    """The reference's cells and world-1 runs (two subprocesses) and the
    port's worlds, run at once, and the port's world 1 in this process:
    ({(kind, mesh): (reference, [rank results])}, reference world 1 by
    kind (plain and on weights nudged one ulp), port world 1 by kind, by
    (kind, "f32") with f32 caches and by (kind, "nudged") on the weights
    nudged one ulp)."""
    tmp = tmp_path_factory.mktemp("cache_tp")
    job = [{"world1": {}, "cells": {}} for _ in range(REF_PROCS)]
    nudged = {}
    for i, kind in enumerate(KINDS):
        base = dict(inputs[kind], arch=KINDS[kind][0],
                    overrides=KINDS[kind][1])
        tree = tree_map(torch.tensor, inputs[kind]["params"])
        nudge_(sorted_leaves(tree), 1)
        nudged[kind] = tree_map(lambda t: t.numpy(), tree)
        job[i % REF_PROCS]["world1"][kind] = dict(base,
                                                  nudged=nudged[kind])
        for mesh in KINDS[kind][2]:
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
        port = {}
        for mesh, (shape, axes) in MESHES.items():
            keys = [k for k in KINDS if mesh in KINDS[k][2]]
            jobs = []
            for k in keys:
                dec = {"arch": KINDS[k][0], "overrides": KINDS[k][1],
                       "dtype": "float32", "tree": inputs[k]["params"],
                       "memory": inputs[k]["memory"],
                       "valid_from": inputs[k]["valid_from"],
                       "prompt": inputs[k]["tokens"][:, :PROMPT],
                       "decode": inputs[k]["tokens"][:, PROMPT:],
                       "capacity": CAPACITY}
                jobs += [("model", dec),
                         ("model", dict(dec, cache_dtype="float32"))]
            ranks = run_world(shape, "many", {"jobs": jobs}, axes=axes,
                              timeout=300)
            for i, k in enumerate(keys):
                port[(k, mesh)] = [r[2 * i] for r in ranks]
                port[(k, mesh, "f32")] = [r[2 * i + 1] for r in ranks]
        world1 = {k: _world1(k, inputs[k]) for k in KINDS}
        world1.update({(k, "f32"): _world1(k, inputs[k], "float32")
                       for k in KINDS})
        world1.update({(k, "nudged"): _world1(k, dict(inputs[k],
                                                      params=nudged[k]))
                       for k in KINDS})
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
            ref["world1"], world1)


def _logits(row):
    return np.concatenate([row["prefill"][None], row["decode"]])


@pytest.mark.parametrize("kind,mesh", CASES)
def test_with_f32_caches_logits_equal_world_one(results, kind, mesh):
    """With the caches allocated in f32 (``init_state``'s
    ``cache_dtype``) on the mesh and in world 1, nothing is rounded to
    bf16 and the two differ by the mesh's order of sums alone: every
    rank's logits of the prefill
    and of each decode step within 1e-5 of max |logit| of world 1's, and
    its state its blocks of world 1's within 1e-5 of each block's max."""
    _, ranks = results[0][(kind, mesh, "f32")]
    cfg = _cfg(kind)
    want = results[2][(kind, "f32")]
    for r, got in enumerate(ranks):
        assert _rel(_logits(got), want["logits"]) <= 1e-5, (
            r, _rel(_logits(got), want["logits"]))
        blocks = tr.state_blocks(cfg, want["final"],
                                 _mesh_at(mesh, got["coords"]))
        for i, (a, b) in enumerate(zip(got["cache"], blocks)):
            for n in a:
                assert a[n].dtype == np.float32
                assert _rel(a[n], b[n].numpy()) <= 1e-5, (r, i, n)


@pytest.mark.parametrize("kind,mesh", CASES)
def test_logits_match_world_one_and_reference_cell(results, kind, mesh):
    """With the reference's bf16 caches every rank's logits of the
    prefill and of each decode step lie within max(1e-5, twice the
    one-ulp floor) of max |logit| of the port's world 1: the floor is the
    larger of the two packages' world 1 on weights nudged one f32 ulp,
    which, like a mesh's order of sums, moves the values a bf16 cache
    rounds by ~10⁻⁷ and so rounds some of them the other way (twice, as
    chip_smoke.py holds its chaotic smoke configs).  Against the
    reference's decode cell they lie within that plus the two packages'
    world-1 logits' distance and the reference cell's own distance from
    its world 1 (the state blocks' rule).  Every distance printed."""
    cells, ref_w1, world1 = results
    ref, ranks = cells[(kind, mesh)]
    want = world1[kind]["logits"]
    plain = ref_w1[kind]["plain"][0]
    floor = max(_rel(ref_w1[kind]["nudged"][0], plain),
                _rel(world1[(kind, "nudged")]["logits"], want))
    tol = max(1e-5, 2 * floor)
    apart = _rel(want, plain) + _rel(ref["logits"], plain)
    print(f"{kind} {mesh}: one-ulp floor {floor:.3e}, world 1 port vs "
          f"reference {_rel(want, plain):.3e}, the reference's cell vs its "
          f"world 1 {_rel(ref['logits'], plain):.3e}")
    for r, got in enumerate(ranks):
        got = _logits(got)
        print(f"  rank {r}: vs world 1 {_rel(got, want):.3e} (tolerance "
              f"{tol:.3e}), vs the reference's cell "
              f"{_rel(got, ref['logits']):.3e} ({tol + apart:.3e})")
        assert _rel(got, want) <= tol, (r, _rel(got, want), tol)
        assert _rel(got, ref["logits"]) <= tol + apart, (
            r, _rel(got, ref["logits"]), tol + apart)


@pytest.mark.parametrize("kind,mesh", CASES)
def test_state_blocks_match_reference_shards(results, kind, mesh):
    """After the prefill and after the last decode step every rank holds
    exactly the shape of the reference's shard at its mesh coordinate for
    every leaf of every layer (``NamedSharding.shard_shape``), and its
    values equal its block of the port's world-1 state (a bf16 cache
    within one bf16 ulp of the block's max, an f32 SSM state within 1e-5
    of it or the reference's one-ulp floor of the leaf where larger) and
    that shard's (within that plus the distances of the module
    docstring)."""
    cells, ref_w1, world1 = results
    ref, ranks = cells[(kind, mesh)]
    cfg = _cfg(kind)
    plain, nudged = (ref_w1[kind][w] for w in ("plain", "nudged"))
    for r, got in enumerate(ranks):
        at = _mesh_at(mesh, got["coords"])
        for t, (when, mine) in enumerate((("prefill", got["prefill_cache"]),
                                          ("final", got["cache"]))):
            whole = tr.state_blocks(cfg, world1[kind][when], at)
            ref1 = tr.state_blocks(cfg, [{n: torch.as_tensor(a) for n, a in
                                          layer.items()}
                                         for layer in plain[1 + t]], at)
            assert len(mine) == len(ref["shard_shapes"])
            for i, (layer, shapes) in enumerate(zip(mine,
                                                    ref["shard_shapes"])):
                assert {n: a.shape for n, a in layer.items()} == shapes
                for n, a in layer.items():
                    # the reference's one-ulp floor of this leaf
                    floor = _rel(nudged[1 + t][i][n], plain[1 + t][i][n])
                    w = whole[i][n]
                    w = (w.float() if w.dtype == torch.bfloat16 else w).numpy()
                    ok, d = _within(a, w, n, floor)
                    assert ok, (r, when, i, n, "world 1", d, floor)
                    # plus the two packages' world-1 states' distance
                    # there and the reference cell's own from its world 1
                    cell, one = ref[when][r][i][n], ref1[i][n].numpy()
                    apart = float(np.abs(w - one).max()
                                  + np.abs(cell - one).max())
                    ok, d = _within(a, cell, n, floor, apart)
                    assert ok, (r, when, i, n, "reference", d, floor, apart)


@pytest.mark.parametrize("kind,mesh", CASES)
def test_no_rank_gathers_a_kv_cache_or_a_weight_after_the_prefill(
        results, kind, mesh):
    """The ledger of each decode step: no weight gather (the prefill
    gathers the ``fsdp`` dims of the attention and FFN blocks it reads
    and the whole embedding, unembedding and mixer leaves, and keeps
    them); no gather of a KV cache (GQA: only the ``tp`` sums of the
    row-parallel products and the rows gathered over ``batch``); MLA
    gathers the other ranks' latent columns of the written slots for the
    step, ``B_l x index x R`` bf16 values a layer, and drops them; the
    mixers gather their fixed-size state blocks over ``tp``.  Each rank's
    state bytes are its blocks', a 1/``tp`` (and 1/batch-ways where the
    batch divides) share of world 1's for every sharded leaf."""
    cells, _, world1 = results
    _, ranks = cells[(kind, mesh)]
    cfg = _cfg(kind)
    shape, axes = MESHES[mesh]
    tp = dict(zip(axes, shape))["model"]
    segs = tr.plan_segments(cfg)
    n_mla = sum(k == "mla" for k, _ in segs.layers)
    n_ssm = sum(k in ("mamba2", "mlstm", "slstm") for k, _ in segs.layers)
    allowed = {"tp", "batch"} | ({"latent_cache"} if n_mla else set()) \
        | ({"ssm_state"} if n_ssm else set())
    for r, got in enumerate(ranks):
        assert got["prefill_ledger"].get("weights", {}).get("calls", 0) > 0
        assert "latent_cache" not in got["prefill_ledger"]
        b_l = got["cache"][0][next(iter(got["cache"][0]))].shape[0]
        for j, led in enumerate(got["step_ledgers"]):
            assert set(led) <= allowed, (j, led)
            if n_mla and tp > 1:
                assert led["latent_cache"] == {
                    "calls": n_mla,
                    "bytes": n_mla * b_l * (PROMPT + j) * cfg.mla.kv_lora_rank
                    * 2}, (j, led)
        at = _mesh_at(mesh, got["coords"])
        want = sum(int(np.prod(block_shape(at, t.shape, sp)))
                   * t.element_size()
                   for layer, specs in zip(world1[kind]["final"],
                                           tr.layer_state_specs(
                                               cfg, at, KINDS[kind][3]))
                   for n, t in layer.items() if torch.is_tensor(t)
                   for sp in (specs[n],))
        assert got["state_bytes"] == want


@pytest.mark.parametrize("mesh", THREE + ("2x2x1",))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_state_allocates_only_its_blocks(arch, mesh, monkeypatch):
    """``init_state(mesh=)`` of every full config (on the ``meta``
    device), for a batch the batch axes divide and one they do not:
    every leaf it allocates has the shape of its ``state_specs`` block,
    and no other allocation is made (the state is never allocated whole
    and sliced); with the batch of 4 some leaf of each config is smaller
    than whole."""
    cfg = get_config(arch)
    at = _mesh_at(mesh)
    env = AxisEnv.from_mesh(at)
    made = []
    zeros = torch.zeros

    def record(shape, *a, **kw):
        made.append(tuple(shape))
        return zeros(shape, *a, **kw)
    monkeypatch.setattr(tr.torch, "zeros", record)
    for batch in (4, 3):
        made.clear()
        state = tr.init_state(cfg, batch, 64, "meta", mesh=at)
        want = tr.layer_state_specs(cfg, at, batch)
        defs = [tr.block_state_defs(cfg, k, batch, 64)
                for k, _ in tr.plan_segments(cfg).layers]
        blocks = []
        for layer, specs, sd in zip(state, want, defs):
            for n, t in layer.items():
                if n == "index":
                    assert t == 0
                    continue
                blocks.append(block_shape(at, sd[n][0], specs[n]))
                assert tuple(t.shape) == blocks[-1], (n, t.shape, blocks[-1])
        # one allocation a leaf, of its block's shape, and no other
        assert made == blocks
        assert batch == 3 or any(b != sd[n][0] for b, (sd, n) in zip(
            blocks, (
            (sd, n) for sd in defs for n in sd if n != "index")))
        ways = int(np.prod([at.shape.get(a, 1) for a in env.batch]))
        rows = batch // ways if batch % ways == 0 else batch
        assert all(t.shape[0] == rows for layer in state
                   for t in layer.values() if torch.is_tensor(t))
