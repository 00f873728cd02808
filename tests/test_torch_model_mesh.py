"""The model mesh (``distributed/mesh.py``'s production mesh, ``AxisEnv``,
``Spec``, ``shard_leaf``; ``models/layers.py``'s ``spec_tree`` and
``abstract_tree``; ``models/transformer.py``'s ``param_specs``,
``state_specs``, ``abstract_params`` and ``abstract_state``), checkpoints
restored onto a mesh, and ``launch.train --mesh``: the port against the
JAX package.

Specs are compared as tuples, leaf for leaf, for all ten configs on the
host mesh and on ``AbstractMesh`` stand-ins of the production meshes
(16, 16) and (2, 16, 16).  ``shard_leaf``'s blocks are compared exactly
with the reference's addressable shards on 4 XLA host devices (a
subprocess, ``--xla_force_host_platform_device_count=4``), the port's
from gloo worlds of 2 and 4 processes (``launch/ep_world.py``), on
``(data, model)`` meshes and a ``(pod, data, model)`` mesh, where a tuple
``("data", "pod")`` flattens data-major and ``("pod", "data")`` pod-major.
"""

import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as ref_get_config
from repro.distributed import mesh as ref_mesh
from repro.models import transformer as ref_tr
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.distributed import mesh as tmesh
from repro_torch.distributed.mesh import AxisEnv, Spec
from repro_torch.launch.ep_world import run_world
from repro_torch.models import transformer as tr
from repro_torch.models.layers import tree_leaves

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
MESHES = {"host": ((1, 1), ("data", "model")),
          "single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(kind):
    shape, axes = MESHES[kind]
    ref = AbstractMesh(shape, axes)
    port = types.SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)))
    return ref, port


def _tuples(tree):
    """{path: spec as a tuple} of a nested dict of specs."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({(k,) + p: s for p, s in _tuples(v).items()})
        elif v is not None:
            out[(k,)] = tuple(v)
    return out


@pytest.mark.parametrize("kind", list(MESHES))
def test_axis_env_and_batch_spec_equal_reference(kind):
    ref, port = _meshes(kind)
    renv, penv = ref_mesh.AxisEnv.from_mesh(ref), AxisEnv.from_mesh(port)
    assert (penv.batch, penv.fsdp, penv.tp, penv.sp, penv.expert) == (
        renv.batch, renv.fsdp, renv.tp, renv.sp, renv.expert)
    for logical in [("batch", "fsdp", None), ("tp", "sp"), ("expert",),
                    (None, None), ("fsdp", "tp", "batch")]:
        assert tuple(penv.resolve(logical)) == tuple(renv.resolve(logical))
        assert isinstance(penv.resolve(logical), Spec)
    for b in (1, 2, 16, 32, 48, 64):
        assert tmesh.batch_spec(penv, port, b) == ref_mesh.batch_spec(
            renv, ref, b)
    assert tmesh.axis_size(port, penv.batch) == ref_mesh.axis_size(
        ref, renv.batch)


@pytest.mark.parametrize("kind", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_state_specs_equal_reference(arch, kind):
    """Every leaf of ``param_specs`` (full config) and of ``state_specs``
    (batch 32 and 1, capacity 64, the batch resolved as the reference's
    dry-run resolves it) equals the reference's."""
    ref, port = _meshes(kind)
    renv, penv = ref_mesh.AxisEnv.from_mesh(ref), AxisEnv.from_mesh(port)
    rcfg, cfg = ref_get_config(arch), get_config(arch)
    assert _tuples(tr.param_specs(cfg, penv)) == _tuples(
        ref_tr.param_specs(rcfg, renv))
    for b in (32, 1):
        logical = ref_mesh.batch_spec(renv, ref, b)
        want = _tuples(ref_tr.state_specs(rcfg, renv, b, 64,
                                          batch_logical=logical))
        got = _tuples(tr.state_specs(cfg, penv, b, 64, batch_logical=logical))
        assert got == want


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_and_state_shapes_and_dtypes(arch):
    """``abstract_params`` / ``abstract_state``: ``meta`` tensors with the
    reference's ``ShapeDtypeStruct`` shapes and dtypes, leaf for leaf."""
    rcfg, cfg = ref_get_config(arch), get_config(arch)

    def shapes(tree, ref):
        out = {}
        for p, a in (jax.tree_util.tree_flatten_with_path(tree)[0] if ref
                     else tree_leaves(tree)):
            key = tuple(getattr(k, "key", k) for k in p) if ref else p
            out[key] = (tuple(a.shape), str(a.dtype).replace("torch.", ""))
        return out
    got = tr.abstract_params(cfg)
    assert all(t.device.type == "meta" for _, t in tree_leaves(got))
    assert shapes(got, False) == shapes(ref_tr.abstract_params(rcfg), True)
    got = tr.abstract_state(cfg, 4, 32)
    got = {k: v for k, v in got.items() if v is not None}
    assert shapes(got, False) == shapes(ref_tr.abstract_state(rcfg, 4, 32),
                                        True)


def test_local_specs_shard_only_moe_leaves():
    """The port's layout over a mesh: each MoE ``ffn`` leaf by
    ``moe_block_sharded``'s spec (a scanned leaf with a whole leading
    axis), every other leaf whole."""
    _, port = _meshes("single")
    env = AxisEnv.from_mesh(port)
    specs = dict(tree_leaves(tr.local_specs(get_config("deepseek-v2-236b"),
                                            env)))
    sharded = {p: s for p, s in specs.items() if any(s)}
    assert sharded[("scanned", "0", "ffn", "w_gate")] == (
        None, "model", "data", None)
    assert sharded[("scanned", "0", "ffn", "w_down")] == (
        None, "model", None, "data")
    assert sharded[("scanned", "0", "ffn", "shared", "w_up")] == (
        None, "data", None)
    assert all(p[2] == "ffn" and p[3] != "router" for p in sharded)
    assert len(sharded) == 6
    dense = dict(tree_leaves(tr.local_specs(get_config("phi4-mini-3.8b"),
                                            env)))
    assert not any(any(s) for s in dense.values())


def test_production_mesh_needs_its_world():
    """On a world of one the production meshes name the world they need;
    a mesh made with ``make_mesh`` covers the world exactly."""
    with pytest.raises(ValueError, match="needs a world of 256 ranks, have 1"):
        tmesh.make_production_mesh()
    with pytest.raises(ValueError, match="needs a world of 512 ranks, have 1"):
        tmesh.make_production_mesh(multi_pod=True)
    m = tmesh.make_mesh((1, 1), ("data", "model"))
    assert m.axis_index(("data", "model")) == 0
    assert m.axis_members(("model",)) == [0]
    assert m.axis_group(("data", "model")) is None


def test_train_mesh_single_raises_the_size_error():
    """``launch.train --mesh single`` at world 1: the production mesh's
    size error, before anything is drawn."""
    from repro_torch.launch.train import train
    with pytest.raises(ValueError, match="needs a world of 256 ranks"):
        train("phi4-mini-3.8b", steps_n=1, mesh_kind="single", device="cpu")
    with pytest.raises(ValueError, match="512"):
        train("phi4-mini-3.8b", steps_n=1, mesh_kind="multi", device="cpu")


def test_elastic_restore_onto_new_mesh(tmp_path):
    """The port of ``tests/test_substrate.py``'s test: a checkpoint
    written unsharded restores onto the host mesh."""
    d = str(tmp_path / "ck")
    tree = {"w": torch.arange(16.0).reshape(4, 4)}
    ckpt.save(d, 1, tree)
    mesh = tmesh.make_host_mesh()
    restored, _ = ckpt.restore(d, tree, mesh=mesh,
                               specs={"w": Spec("data", None)})
    assert torch.equal(restored["w"], tree["w"])
    assert mesh.shape["data"] == tmesh.world_size()


# --------------------------------------------------------------------------
# blocks against the reference's shards, and checkpoints across worlds
# --------------------------------------------------------------------------

SHARD_MESHES = {(1, 2): ("data", "model"), (2, 2): ("data", "model"),
                (2, 1, 2): ("pod", "data", "model")}
SHARD_SPECS = {
    ("data", "model"): [["data", None], [None, "model"], ["model", "data"],
                        [["data", "model"], None], [["model", "data"], None],
                        [None, None]],
    ("pod", "data", "model"): [[["data", "pod"], "model"],
                               [["pod", "data"], None],
                               [None, ["model", "pod"]], ["pod", None]],
}

_REFERENCE_SHARDS = r"""
import json, sys
import jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
cases = json.loads(sys.argv[1])
x = np.arange(8 * 12, dtype=np.float32).reshape(8, 12)
out = {}
for key, (shape, axes, specs) in cases.items():
    n = int(np.prod(shape))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(shape), axes)
    rows = []
    for spec in specs:
        spec = P(*(tuple(e) if isinstance(e, list) else e for e in spec))
        arr = jax.device_put(x, NamedSharding(mesh, spec))
        by_dev = {s.device.id: np.asarray(s.data).tolist()
                  for s in arr.addressable_shards}
        rows.append([by_dev[d.id] for d in mesh.devices.reshape(-1)])
    out[key] = rows
print("SHARDS " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def shard_blocks():
    import json
    cases = {str(k): [list(k), list(v), SHARD_SPECS[v]]
             for k, v in SHARD_MESHES.items()}
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO_ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") +
                          " --xla_force_host_platform_device_count=4"))
    proc = subprocess.Popen([sys.executable, "-c", _REFERENCE_SHARDS,
                             json.dumps(cases)], env=env, cwd=REPO_ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    x = np.arange(8 * 12, dtype=np.float32).reshape(8, 12)
    try:
        port = {str(k): run_world(k, "shard", {"x": x, "specs": SHARD_SPECS[v]},
                                  axes=v, timeout=120)
                for k, v in SHARD_MESHES.items()}
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr[-2000:]
    line = [ln for ln in stdout.splitlines() if ln.startswith("SHARDS ")][-1]
    return json.loads(line[len("SHARDS "):]), port


@pytest.mark.parametrize("mesh", [str(k) for k in SHARD_MESHES])
def test_shard_leaf_blocks_equal_reference_shards(shard_blocks, mesh):
    """Each rank's ``shard_leaf`` block equals the reference's shard on
    the device at the same mesh position, for every spec."""
    ref, port = shard_blocks
    for i, _ in enumerate(ref[mesh]):
        for rank, res in enumerate(port[mesh]):
            assert np.array_equal(res["blocks"][i],
                                  np.asarray(ref[mesh][i][rank])), (i, rank)


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_checkpoint_restores_across_worlds(tmp_path, shape):
    """A checkpoint of the deepseek-v2 smoke model written at world 1
    restores onto (2, 1) and (1, 2) worlds, every rank's blocks the slices
    of the saved leaves (by ``param_specs`` and by ``local_specs``); and a
    world of two writes one (the blocks gathered whole, rank 0 writing)
    that world 1 restores to the weights it draws itself."""
    from repro_torch.convert import model_tree_to_numpy
    arch = "deepseek-v2-236b"
    cfg = get_smoke(arch)
    model = tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    d1, d2 = str(tmp_path / "w1"), str(tmp_path / "w2")
    ckpt.save(d1, 5, model_tree_to_numpy(cfg, model))
    ranks = run_world(shape, "many", {"jobs": [
        ("restore", {"arch": arch, "dir": d1, "specs": "param"}),
        ("restore", {"arch": arch, "dir": d1, "specs": "local"}),
        ("save", {"arch": arch, "dir": d2, "step": 7, "seed": 0})]},
        timeout=180)
    for res in ranks:
        for got in res[:2]:
            assert got["all_equal"] and got["step"] == 5
    w_gate = [r[1]["shapes"]["scanned/0/ffn/w_gate"] for r in ranks]
    e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.expert_d_ff
    n_per = tr.plan_segments(cfg).n_periods
    assert w_gate == [[n_per, e // shape[1], d // shape[0], f]] * 2
    template = {k: v for k, v in tr.model_defs(cfg).items()}
    back, step = ckpt.restore(d2, _zeros(template), device="cpu")
    assert step == 7
    want = model_tree_to_numpy(cfg, model)
    for (p, a), (_, b) in zip(tree_leaves(back), tree_leaves(want)):
        assert np.array_equal(a.numpy(), b), p


def _zeros(defs):
    return {k: _zeros(v) if isinstance(v, dict) else 0
            for k, v in defs.items()}
