"""The dry-run cells (``launch/cells.py``, ``launch/dryrun.py``) against the
reference's ``build_cell``, the head padding's weights, and the trace over
an abstract mesh against a real world.

* **Every cell.**  One reference subprocess with 512 XLA host devices (as
  ``src/repro/launch/dryrun.py:1-4`` sets them) builds every (arch x
  shape) cell on ``make_production_mesh(False)`` and ``(True)``, lowering
  nothing, and returns each abstract argument's global shape, dtype, spec
  and ``shard_shape`` (a train cell's optimizer state on
  ``_opt_specs(param_specs)``, as its jit's ``in_shardings`` place it).
  The port builds the same cell for rank 0 of an ``AbstractMesh`` of the
  production shape: the same leaves, each leaf's shape, dtype and spec
  equal, the block the rank holds equal to ``shard_shape``, and the
  argument bytes equal to the reference's sum.  ``long_500k`` is a skip
  for every arch outside ``LONG_CONTEXT_ARCHS`` in both packages.
* **tp_pad_config** equals the reference's for every arch and smoke
  config at tp 1, 2, 4, 8 and 16.
* **The padded function** (f32, world 1): starcoder2-smoke (H 4, KV 1) at
  tp 2 and 4, phi4-mini-smoke (4, 2) at tp 4, a variant with H 6, KV 2 at
  tp 4 (groups of 3 become groups of 2), llama-vision-smoke at tp 4 (the
  cross layers, gates 0.5, with a memory), deepseek-v2-smoke at tp 8 (a
  padded MLA): ``tp_pad_weights``' model gives the unpadded model's logits
  within 1e-6 of max |logit|, and the reference's model on
  ``tp_pad_config(cfg)`` with the port's padded weights gives them within
  the world-1 parity tolerance of ``tests/test_torch_dense_tp.py`` (1e-5
  of max |logit|).
* **The padded cell over a world.**  gloo worlds (2, 2) and (1, 4)
  (``launch/ep_world.py``'s ``cell`` job) run cells that ``mesh_specs``
  refused before padding: a train step and a prefill of 12 tokens with 4
  decode steps against the cell's state (f32 caches).  The logits within
  1e-5 of max |logit| of the unpadded world 1 (the rule of
  ``tests/test_torch_cache_tp.py`` with f32 caches); the step's loss 1e-5
  relative; its ``m`` (the clip off, so ``m`` is the gradient's tenth)
  folded back onto the unpadded heads (a KV head's slots summed) within
  1e-3 of each leaf's max (``test_torch_dense_tp.py``'s rule for ``m``),
  and a padded query head's ``wq`` columns exactly zero.
* **Meta against real.**  A dense, an MoE (EP), an MLA (beside EP MoE)
  and an SSM smoke cell, train and decode, traced on an abstract (2, 2)
  mesh: the ledger's rows (label, op, ranks, calls, bytes) and the
  ``FlopCounterMode`` count equal rank 0's from the same step run over a
  gloo (2, 2) world.
* **The dry-run CLI** in process at one period: six cells reach ``ok``
  with their records' fields; phi4-mini ``long_500k`` is ``skipped``.

The reference subprocess and the worlds run in the background while the
in-process tests run.
"""

import dataclasses
import json
import os
import pickle
import subprocess
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke as ref_get_smoke
from repro.launch.cells import tp_pad_config as ref_tp_pad_config
from repro.models import transformer as ref_tr
from repro_torch.common.config import SHAPES, ShapeConfig, TrainConfig
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.mesh import AbstractMesh, make_production_mesh
from repro_torch.launch import cells, dryrun
from repro_torch.launch.ep_world import _cfg, run_world, whole_weights
from repro_torch.models import moe, steps
from repro_torch.models import transformer as tr
from repro_torch.models.layers import tree_map
from repro_torch.optim import adamw

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
MESH_KINDS = ("single", "multi")
CELLS = [(m, a, s) for m in MESH_KINDS for a in ARCH_IDS for s in SHAPES]
CPU = torch.device("cpu")
B, PROMPT, STEPS, SEQ = 4, 12, 4, 16
TRAIN = ("train_small", SEQ, B, "train")
DECODE = ("decode_small", SEQ, B, "decode")
H6 = {"num_heads": 6, "num_kv_heads": 2}
# the padded function at world 1: (arch, overrides, tp)
PAD_FN = {"sc2_tp2": ("starcoder2-3b", {}, 2),
          "sc2_tp4": ("starcoder2-3b", {}, 4),
          "phi4_tp4": ("phi4-mini-3.8b", {}, 4),
          "h6kv2_tp4": ("phi4-mini-3.8b", H6, 4),
          "vision_tp4": ("llama-3.2-vision-90b", {}, 4),
          "mla_tp8": ("deepseek-v2-236b", {"ffn_kind": "dense", "moe": None},
                      8)}
# padded cells over a world: (arch, overrides, mesh shape)
PAD_WORLD = {"sc2_2x2": ("starcoder2-3b", {}, (2, 2)),
             "sc2_1x4": ("starcoder2-3b", {}, (1, 4)),
             "phi4_1x4": ("phi4-mini-3.8b", {}, (1, 4)),
             "h6kv2_1x4": ("phi4-mini-3.8b", H6, (1, 4)),
             "vision_1x4": ("llama-3.2-vision-90b", {}, (1, 4))}
# meta against real on (2, 2): arch by kind
META = {"dense": "phi4-mini-3.8b", "moe": "llama4-maverick-400b-a17b",
        "mla": "deepseek-v2-236b", "ssm": "zamba2-1.2b"}
META_CASES = [(k, s) for k in META for s in ("train", "decode")]
# the dry-run CLI's cells at one period
CLI = [("phi4-mini-3.8b", "train_4k"), ("deepseek-v2-236b", "decode_32k"),
       ("zamba2-1.2b", "long_500k"), ("llama-3.2-vision-90b", "prefill_32k"),
       ("xlstm-350m", "decode_32k"), ("starcoder2-3b", "decode_32k")]


_REFERENCE = r"""
import os
os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + \
    " --xla_force_host_platform_device_count=512"
import pickle, sys
import jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.common.config import SHAPES
from repro.configs import ARCH_IDS
from repro.distributed.mesh import AxisEnv
from repro.launch.cells import _opt_specs, build_cell, cell_supported
from repro.launch.mesh import make_production_mesh
from repro.models import transformer


def name(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def entries(spec):
    return tuple(tuple(e) if isinstance(e, (tuple, list)) else e
                 for e in spec)


out = {}
for kind in ("single", "multi"):
    mesh = make_production_mesh(multi_pod=kind == "multi")
    env = AxisEnv.from_mesh(mesh)
    for arch in ARCH_IDS:
        for shape, sc in SHAPES.items():
            ok, why = cell_supported(arch, shape)
            if not ok:
                out[(kind, arch, shape)] = why
                continue
            cell = build_cell(arch, shape, mesh)
            a = cell.abstract_args
            if sc.kind == "train":
                named = {"params": a[0], "opt": a[1], "batch": a[2]}
            elif sc.kind == "prefill":
                named = {"params": a[0], "batch": dict(zip(
                    ("tokens", "memory"), a[1:]))}
            else:
                named = {"params": a[0], "state": a[1],
                         "batch": {"tokens": a[2], "positions": a[3]}}
            opt_specs = {"opt/" + name(p): s for p, s in
                         jax.tree_util.tree_flatten_with_path(
                             _opt_specs(transformer.param_specs(cell.cfg,
                                                                env)),
                             is_leaf=lambda x: isinstance(x, P))[0]}
            leaves = {}
            for path, x in jax.tree_util.tree_flatten_with_path(named)[0]:
                n = name(path)
                spec = opt_specs[n] if n in opt_specs else x.sharding.spec
                leaves[n] = (tuple(x.shape), str(x.dtype), entries(spec),
                             tuple(NamedSharding(mesh, spec).shard_shape(
                                 x.shape)))
            out[(kind, arch, shape)] = leaves
pickle.dump(out, open(sys.argv[1], "wb"))
"""


def _rel(got, want):
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _world_payloads():
    """(the (2, 2) world's jobs, the (1, 4) world's): each a list of
    ``(name, payload)``; the inputs from seed 29."""
    rng = np.random.default_rng(29)
    jobs = {(2, 2): [], (1, 4): []}
    for key, (arch, over, shape) in PAD_WORLD.items():
        cfg = dataclasses.replace(get_smoke(arch), **over)
        toks = rng.integers(0, cfg.vocab_size, (B, SEQ))
        base = {"arch": arch, "overrides": over, "dtype": "float32",
                "seed": 0, "gate": 0.5}
        if cfg.cross_attn_every:
            base["memory"] = rng.normal(size=(
                B, cfg.cross_attn_memory_len,
                cfg.frontend_embed_dim)).astype(np.float32)
        jobs[shape].append(((key, "train"), dict(
            base, shape=TRAIN, tcfg={"grad_clip": 1e9},
            train={"tokens": toks, "labels": rng.integers(
                0, cfg.vocab_size, (B, SEQ))})))
        jobs[shape].append(((key, "decode"), dict(
            base, shape=DECODE, cache_dtype="float32",
            prompt=toks[:, :PROMPT], decode=toks[:, PROMPT:])))
    for kind, arch in META.items():
        for s, shape in (("train", TRAIN), ("decode", DECODE)):
            jobs[(2, 2)].append(((kind, s), {
                "arch": arch, "dtype": "float32", "seed": 0,
                "shape": shape, "trace": True}))
    return jobs


@pytest.fixture(scope="module")
def background(tmp_path_factory):
    """The reference subprocess and the two worlds, started at once; the
    worlds in a thread.  Yields (subprocess, its output path, the thread,
    the worlds' results by job name, the payloads by job name)."""
    tmp = tmp_path_factory.mktemp("cells")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO_ROOT, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", _REFERENCE,
                             str(tmp / "ref.pkl")], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=REPO_ROOT)
    jobs = _world_payloads()
    results, errors = {}, []

    def worlds():
        try:
            for shape, named in jobs.items():
                ranks = run_world(shape, "many", {"jobs": [
                    ("cell", p) for _, p in named]}, timeout=300)
                for i, (key, _) in enumerate(named):
                    results[key] = [r[i] for r in ranks]
        except Exception as e:          # reported by the tests that wait
            errors.append(e)

    thread = threading.Thread(target=worlds, daemon=True)
    thread.start()
    payloads = {k: p for named in jobs.values() for k, p in named}
    yield proc, tmp / "ref.pkl", thread, results, errors, payloads
    if proc.poll() is None:
        proc.kill()
        proc.communicate()
    thread.join(timeout=300)


@pytest.fixture(scope="module")
def reference(background):
    proc, path = background[:2]
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    with open(path, "rb") as fh:
        return pickle.load(fh)


@pytest.fixture(scope="module")
def worlds(background):
    _, _, thread, results, errors, payloads = background
    thread.join(timeout=600)
    assert not thread.is_alive(), "the worlds did not finish"
    if errors:
        raise errors[0]
    return results, payloads


# --------------------------------------------------------------------------
# tp_pad_config
# --------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["config", "smoke"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_tp_pad_config_equals_reference(arch, which):
    """The padded heads of every config and smoke config at tp 1, 2, 4,
    8 and 16 are the reference's."""
    mine = (get_config if which == "config" else get_smoke)(arch)
    ref = (ref_get_config if which == "config" else ref_get_smoke)(arch)
    for tp in (1, 2, 4, 8, 16):
        got, want = cells.tp_pad_config(mine, tp), ref_tp_pad_config(ref, tp)
        assert (got.num_heads, got.num_kv_heads) == (
            want.num_heads, want.num_kv_heads), (arch, tp)
        assert (got is mine) == (want is ref), (arch, tp)


def test_head_layout_keeps_each_group_on_its_kv_head():
    """For every padding the configs reach, each original query head sits
    in a slot holding its own KV head, every original head exactly once."""
    for cfg in [get_config(a) for a in ARCH_IDS] + [get_smoke(a)
                                                    for a in ARCH_IDS]:
        if not {"attn", "cross_attn"} & set(cfg.pattern):
            continue
        for tp in (2, 4, 8, 16):
            c2 = cells.tp_pad_config(cfg, tp)
            h, kv, h2, kv2 = (cfg.num_heads, cfg.num_kv_heads,
                              c2.num_heads, c2.num_kv_heads)
            q_src, kv_src = cells.head_layout(h, kv, h2, kv2)
            g, g2 = h // kv, h2 // kv2
            assert sorted(s for s in q_src if s >= 0) == list(range(h))
            for p, s in enumerate(q_src):
                if s >= 0:
                    assert kv_src[p // g2] == s // g, (cfg.name, tp, p)


# --------------------------------------------------------------------------
# every cell against the reference's build_cell
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_kind,arch,shape", CELLS)
def test_cell_leaves_and_bytes_equal_reference(reference, mesh_kind, arch,
                                               shape):
    """Every argument leaf of the port's cell for rank 0 of the abstract
    production mesh has the reference's global shape, dtype and spec, its
    block is the reference's ``shard_shape``, and the argument bytes are
    the reference's per-device sum.  A skip is a skip in both."""
    want = reference[(mesh_kind, arch, shape)]
    ok, why = cells.cell_supported(arch, shape)
    mesh = make_production_mesh(multi_pod=mesh_kind == "multi",
                                abstract=True)
    if isinstance(want, str):
        assert not ok and why == want
        with pytest.raises(ValueError, match="long_500k"):
            cells.build_cell(arch, shape, mesh)
        return
    assert ok
    cell = cells.build_cell(arch, shape, mesh)
    assert set(cell.specs) == set(want)
    total = 0
    for name, (shp, dtype, spec, shard) in want.items():
        leaf = cell.specs[name]
        assert (leaf.shape, leaf.dtype, tuple(leaf.spec), leaf.block) == (
            shp, dtype, spec, shard), name
        total += int(np.prod(shard, dtype=np.int64)) * np.dtype(
            jnp.dtype(dtype)).itemsize
    assert cells.argument_bytes(cell)["total"] == total
    # the tensors the rank holds are its blocks
    model = cell.abstract_args[0]
    assert all(p.is_meta for p in model.parameters())
    held = sum(p.numel() * p.element_size() for p in model.parameters())
    assert held == cells.argument_bytes(cell)["params"]


# --------------------------------------------------------------------------
# the padded function at world 1
# --------------------------------------------------------------------------

def _padded_case(key):
    arch, over, tp = PAD_FN[key]
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32", **over)
    rng = np.random.default_rng(31)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (3, 10)))
    mem = (torch.as_tensor(rng.normal(size=(
        3, cfg.cross_attn_memory_len, cfg.frontend_embed_dim)).astype(
            np.float32)) if cfg.cross_attn_every else None)
    w = whole_weights(cfg, CPU, {"seed": 0, "gate": 0.5})
    return arch, over, tp, cfg, toks, mem, w


@pytest.mark.parametrize("key", list(PAD_FN))
def test_padded_weights_keep_the_function(key):
    """``tp_pad_weights``' model (its heads padded for ``tp``) gives the
    unpadded model's logits within 1e-6 of max |logit|, f32, world 1; the
    reference's forward on ``tp_pad_config(cfg)`` with those weights
    gives the port's padded logits within 1e-5 of max |logit|."""
    arch, over, tp, cfg, toks, mem, w = _padded_case(key)
    cfg2, w2 = cells.tp_pad_weights(cfg, w, tp)
    assert cfg2 is not cfg
    want = tr.Transformer(cfg, w)(toks, memory=mem)[0].detach().numpy()
    got = tr.Transformer(cfg2, w2)(toks, memory=mem)[0].detach().numpy()
    assert _rel(got, want) <= 1e-6, _rel(got, want)
    ref_cfg = ref_tp_pad_config(dataclasses.replace(
        ref_get_smoke(arch), dtype="float32", **over), tp)
    assert (ref_cfg.num_heads, ref_cfg.num_kv_heads) == (cfg2.num_heads,
                                                         cfg2.num_kv_heads)
    params = tree_map(lambda t: jnp.asarray(t.detach().numpy()),
                      tr.tree_from_weights(cfg2, w2))
    kw = {} if mem is None else {"memory": jnp.asarray(mem.numpy())}
    ref = np.asarray(ref_tr.forward(params, jnp.asarray(toks.numpy()),
                                    ref_cfg, **kw)[0])
    assert _rel(got, ref) <= 1e-5, _rel(got, ref)


def test_mesh_specs_still_refuses_an_unpadded_config():
    """``mesh_specs`` raises for a config whose heads ``tp`` does not
    divide, naming ``repro_torch.launch.cells.tp_pad_config``; the padded
    config it accepts."""
    mesh = AbstractMesh(("data", "model"), (1, 4))
    cfg = get_smoke("starcoder2-3b")
    with pytest.raises(ValueError, match="repro_torch.launch.cells"
                                         ".tp_pad_config"):
        tr.mesh_specs(cfg, mesh)
    tr.mesh_specs(cells.tp_pad_config(cfg, 4), mesh)


# --------------------------------------------------------------------------
# padded cells over a world against the unpadded world 1
# --------------------------------------------------------------------------

def _world1_train(p):
    cfg = _cfg(p)
    model = tr.Transformer(cfg, whole_weights(cfg, CPU, p))
    opt = adamw.init_opt_state(dict(model.named_parameters()))
    batch = {k: torch.as_tensor(v) for k, v in p["train"].items()}
    if p.get("memory") is not None:
        batch["memory"] = torch.as_tensor(p["memory"])
    opt, met = steps.make_train_step(cfg, TrainConfig(**p["tcfg"]))(
        model, opt, batch)
    return cfg, {k: float(v) for k, v in met.items()}, opt["m"]


def _world1_decode(p):
    cfg = _cfg(p)
    model = tr.Transformer(cfg, whole_weights(cfg, CPU, p))
    mem = None if p.get("memory") is None else torch.as_tensor(p["memory"])
    st, last = steps.make_prefill_step(cfg, SEQ, cache_dtype="float32")(
        model, torch.as_tensor(p["prompt"]), memory=mem)
    out = [last.numpy()]
    dec = torch.as_tensor(p["decode"])
    for j in range(dec.shape[1]):
        pos = torch.full((B, 1), PROMPT + j, dtype=torch.int32)
        st, lg = steps.make_decode_step(cfg)(model, st, dec[:, j:j + 1], pos)
        out.append(lg.numpy())
    return np.stack(out)


def _fold(cfg, cfg2, name, a):
    """A padded leaf's value (an ``m``) on the unpadded heads: query heads
    picked, a KV head's slots summed."""
    if ".attn." not in name or name.split(".")[-1] not in ("wq", "wk", "wv",
                                                           "wo"):
        return a
    q_src, kv_src = cells.head_layout(cfg.num_heads, cfg.num_kv_heads,
                                      cfg2.num_heads, cfg2.num_kv_heads)
    leaf = name.split(".")[-1]
    if leaf in ("wq", "wo"):
        at = [q_src.index(i) for i in range(cfg.num_heads)]
        return a[:, at] if leaf == "wq" else a[at]
    return np.stack([a[:, [s for s, j in enumerate(kv_src) if j == k]].sum(1)
                     for k in range(cfg.num_kv_heads)], axis=1)


@pytest.mark.parametrize("key", list(PAD_WORLD))
def test_padded_cell_decode_matches_world_one(worlds, key):
    """A padded decode cell over the world: a prefill of 12 tokens into
    its state and 4 decode steps through its step, f32 caches; every
    rank's logits within 1e-5 of max |logit| of the unpadded world 1."""
    results, payloads = worlds
    want = _world1_decode(payloads[(key, "decode")])
    cfg = _cfg(payloads[(key, "decode")])
    for r, got in enumerate(results[(key, "decode")]):
        assert got["heads"] != [cfg.num_heads, cfg.num_kv_heads]
        assert _rel(got["logits"], want) <= 1e-5, (r, _rel(got["logits"],
                                                           want))


@pytest.mark.parametrize("key", list(PAD_WORLD))
def test_padded_cell_train_step_matches_world_one(worlds, key):
    """A padded train cell over the world, one step with the clip off:
    every rank's loss within 1e-5 relative of the unpadded world 1's, its
    ``m`` folded onto the unpadded heads within 1e-3 of each leaf's max,
    and the padded query heads' ``wq`` columns untaught (exactly 0)."""
    results, payloads = worlds
    p = payloads[(key, "train")]
    cfg, met, m1 = _world1_train(p)
    for r, got in enumerate(results[(key, "train")]):
        assert abs(got["metrics"]["loss"] - met["loss"]) <= 1e-5 * abs(
            met["loss"]), r
        cfg2 = cells.tp_pad_config(cfg, dict(zip(
            ("data", "model"), PAD_WORLD[key][2]))["model"])
        named = tr.weights_from_tree(cfg2, tree_map(torch.as_tensor,
                                                    got["m"]))
        q_src, _ = cells.head_layout(cfg.num_heads, cfg.num_kv_heads,
                                     cfg2.num_heads, cfg2.num_kv_heads)
        zero = [p for p, s in enumerate(q_src) if s < 0]
        for name, want in m1.items():
            a = named[name].numpy()
            if name.endswith("attn.wq") and zero:
                assert not np.any(a[:, zero]), (r, name)
            folded = _fold(cfg, cfg2, name, a)
            assert _rel(folded, want.numpy()) <= 1e-3, (r, name)


# --------------------------------------------------------------------------
# the meta trace over an abstract mesh against a real world's rank 0
# --------------------------------------------------------------------------

def _rows(rows):
    return sorted((r["axis"], r["op"], r["ranks"], r["calls"], r["bytes"])
                  for r in rows)


@pytest.mark.parametrize("kind,step", META_CASES)
def test_meta_trace_books_what_rank_zero_books(worlds, kind, step):
    """The cell traced on ``meta`` for rank 0 of an abstract (2, 2) mesh
    books the same ledger rows (label, op, ranks, calls, bytes) and
    counts the same flops as rank 0 running the same cell for real over a
    gloo (2, 2) world (``route`` ``meta`` against ``gloo``)."""
    results, payloads = worlds
    p = payloads[(kind, step)]
    real = results[(kind, step)][0]
    mesh = AbstractMesh(("data", "model"), (2, 2))
    cell = cells.build_cell(p["arch"], ShapeConfig(*p["shape"]), mesh,
                            cfg_override=_cfg(p))
    got = dryrun.trace_cell(cell)
    assert {r["route"] for r in got["ledger"]["rows"]} == {"meta"}
    assert {r["route"] for r in real["rows"]} == {"gloo"}
    assert _rows(got["ledger"]["rows"]) == _rows(real["rows"])
    assert got["ledger"]["rows"], "no collective booked"
    assert got["flops"] == real["flops"] > 0
    assert got["kept_bytes"] == real["kept_bytes"]


def test_abstract_mesh_places_ranks_as_a_world_does():
    """An ``AbstractMesh`` at any rank answers ``axis_index`` and
    ``axis_members`` as the ``JoinMesh`` of its rank would, and a
    collective over it on a tensor off ``meta`` raises."""
    shape, axes = (2, 2, 4), ("pod", "data", "model")
    for rank in range(16):
        m = AbstractMesh(axes, shape, rank)
        c = m.coords
        assert (c["pod"] * 2 + c["data"]) * 4 + c["model"] == rank
        for ax in (("data", "pod"), ("model",), ("pod", "data")):
            members = m.axis_members(ax)
            assert members[m.axis_index(ax)] == rank
            assert all(AbstractMesh(axes, shape, r).axis_members(ax)
                       == members for r in members)
    mesh = AbstractMesh(axes, shape)
    x = torch.empty((4, 6), device="meta")
    assert coll.axis_all_gather(x, mesh, ("model",), 1, "tp").shape == (4, 24)
    assert coll.axis_reduce_scatter(x, mesh, ("pod", "data"), 0,
                                    "fsdp").shape == (1, 6)
    with pytest.raises(RuntimeError, match="meta"):
        coll.axis_all_reduce(torch.zeros(3), mesh, ("model",), "tp")
    led = mesh.axis_ledger.summary()
    assert led["by_route"]["meta"]["calls"] == 2
    assert led["by_route"]["gloo"]["calls"] == 0


def test_expert_counts_equal_bincount():
    """The MoE's expert counts (a scatter-add, which has a ``meta``
    kernel) equal ``torch.bincount`` bit for bit."""
    g = torch.Generator().manual_seed(3)
    for n in (8, 160):
        ids = torch.randint(0, n, (513, 6), generator=g)
        assert torch.equal(moe._counts(ids, n),
                           torch.bincount(ids.reshape(-1), minlength=n))


# --------------------------------------------------------------------------
# the dry-run CLI
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", CLI)
def test_dryrun_cli_cell_at_one_period(tmp_path, arch, shape):
    """``python -m repro_torch.launch.dryrun`` in process for one cell at
    one period exits 0 and writes a record with status ``ok`` and every
    field: the argument bytes (also split) equal to ``argument_bytes`` of
    the same cell, the flops and the collectives, the kept weights of a
    state call, null temp and code bytes."""
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", arch, "--shape", shape, "--layers", "period",
                     "--out-dir", str(tmp_path)])
    assert e.value.code == 0
    with open(tmp_path / "single" / f"{arch}__{shape}.json") as f:
        rec = json.load(f)
    assert rec["status"] == "ok" and rec["layers"] == dryrun.one_period(arch)
    cell = cells.build_cell(arch, shape,
                            make_production_mesh(abstract=True),
                            layers_override=dryrun.one_period(arch))
    mem = rec["memory"]
    args = cells.argument_bytes(cell)
    assert mem["argument_bytes"] == args["total"]
    assert mem["argument_bytes_by"] == {k: v for k, v in args.items()
                                        if k != "total"}
    assert rec["flops_per_device"] > 0 and rec["collective_ops"] > 0
    assert rec["collective_bytes_per_device"] == sum(
        rec["collective_by_kind"].values()) == sum(
        a["bytes"] for a in rec["collective_by_axis"].values())
    assert mem["output_bytes"] > 0
    assert (mem["kept_bytes"] > 0) == (SHAPES[shape].kind != "train")
    assert mem["temp_bytes"] is None and mem["generated_code_bytes"] is None
    if arch == "starcoder2-3b":
        assert rec["heads"] == {"config": [24, 2], "cell": [32, 16]}


def test_dryrun_cli_skips_long_context_for_full_attention(tmp_path):
    """phi4-mini ``long_500k`` is recorded as ``skipped`` with the
    reference's reason, and the run exits 0."""
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "phi4-mini-3.8b", "--shape", "long_500k",
                     "--mesh", "both", "--out-dir", str(tmp_path)])
    assert e.value.code == 0
    for kind in MESH_KINDS:
        with open(tmp_path / kind / "phi4-mini-3.8b__long_500k.json") as f:
            rec = json.load(f)
        assert rec["status"] == "skipped" and "long_500k" in rec["reason"]


def test_meta_trace_refuses_a_tensor_off_meta():
    """A trace over an abstract mesh that makes a tensor off ``meta`` is
    an error: the dry-run allocates nothing."""
    mesh = AbstractMesh(("data", "model"), (1, 2))
    cell = cells.build_cell("phi4-mini-3.8b", ShapeConfig(*DECODE), mesh,
                            cfg_override=get_smoke("phi4-mini-3.8b"))
    step = cell.fn

    def allocating(*args):
        torch.ones(2)
        return step(*args)
    cell.fn = allocating
    with pytest.raises(RuntimeError, match="meta trace"):
        dryrun.trace_cell(cell)
    cell.fn = step
    assert dryrun.trace_cell(cell)["flops"] > 0
