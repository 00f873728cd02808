"""The expert-parallel MoE (``models/moe.py``'s ``moe_ffn_ep``,
``moe_ffn_ep_replicated``, ``moe_ffn_ep_replicated_dsharded`` and
``moe_block_sharded``): the port in a gloo world of 2 or 4 processes
against the reference's ``shard_map`` on 4 XLA host devices.

Inputs: the reference's MoE weights (its ``init_tree`` over ``moe_defs``,
key 0) of the deepseek-v2 (top-2, two shared experts) and llama4-maverick
(top-1, one shared) smoke configs in float32, activations and a cotangent
from a numpy seed; meshes (1, 2), (2, 1) and (2, 2) over ``("data",
"model")``; the config's capacity factor (1.25, so choices drop).  The
reference runs in a subprocess (``--xla_force_host_platform_device_count
=4``); the port runs every case of a mesh in one world
(``launch/ep_world.py``).  Each function runs as its ``shard_map`` runs
it: ``ep`` with the tokens over batch and ``model``, ``replicated`` over
batch, ``dsharded`` with the tokens whole (its weights over ``fsdp``),
each body's ``aux`` averaged over the axes its tokens vary over; the block
as it is, at a prefill (8, 16) and a decode (8, 1).  At a decode on a
mesh whose ``data`` and ``model`` both exceed 1 the reference's block is
wrong (below), and the port's, which keeps the tokens whole over ``data``
there, is held against the reference's ``dsharded`` ``shard_map`` with
the tokens whole, the same body on the same layout.

Where the reference raises (JAX 0.9's ``shard_map`` checks which values
vary over which axes), the test runs it with two changes that alter no
arithmetic: its ``pmean`` averages over each named axis once, and
``check_vma=False``.  The raising cases are exactly three of the
reference's faults (ROADMAP queue 3): at every decode with ``model`` > 1
the block's ``pmean`` over ``batch + fsdp`` names ``data`` twice
("repeated axis"); at ``model`` 1 the block's ``shard_map`` cannot prove
its outputs replicated; and ``moe_ffn_ep_replicated_dsharded`` ends in an
``all_gather`` over ``fsdp`` whose result JAX types as varying there, so
no ``shard_map`` can return it replicated.  A fourth shows once the first
is patched: at a decode with ``data`` and ``model`` > 1 the block splits
the tokens over ``data`` and its decode body's ``psum`` over ``fsdp``
(also ``data``) adds partial products of different tokens
(``test_ep_equals_dense_without_drops`` pins it).

Tolerances, and why:

* router ids: equal (the same f32 router on the same tokens; a flipped
  choice would move every later slot);
* output: 1e-5 of max |out|, ``aux`` 1e-5 relative: the expert products
  are f32 GEMMs of two libraries, as ``tests/test_torch_moe.py`` holds
  ``moe_ffn_dense``; where the arithmetic is one sequence of ops the two
  agree to the bit (``test_ep_equals_dense_without_drops``; where the
  port's decode splits the d_model contraction over ``fsdp`` and sums the
  parts, it is held to the dense path at 1e-5 too);
* gradients of ``sum(out * wgt) + aux`` (router, experts, shared experts,
  the input): 1e-4 of each leaf's max |g|, as ``moe_ffn_dense``'s, against
  ``jax.grad`` through the reference's ``shard_map``; the block's against
  the reference's whole gradients sliced to each rank's block.  A top-1
  router (llama4-maverick) as ``tests/test_torch_moe.py`` holds it: its
  weight renormalises to w / w = 1, so the output's part of its gradient
  is each package's rounding residue; aux's part alone within 1e-4, the
  port's residue within 4x the reference's.
"""

import dataclasses
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as ref_get_smoke
from repro.models import moe as ref_moe
from repro.models.layers import init_tree as ref_init_tree
from repro_torch.configs import get_smoke
from repro_torch.distributed.mesh import AxisEnv
from repro_torch.launch.ep_world import ep_specs, run_world
from repro_torch.models import moe

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ARCHS = ("deepseek-v2-236b", "llama4-maverick-400b-a17b")
MESHES = ((1, 2), (2, 1), (2, 2))
# function -> (batch, sequence) of the tokens
FNS = {"ep": (8, 16), "replicated": (8, 4), "dsharded": (8, 1),
       "block": (8, 16), "block_decode": (8, 1)}
CASES = [(a, m, f) for a in ARCHS for m in MESHES for f in FNS]
# EP against the dense path with a capacity at which nothing drops
NODROP = [(a, m, f) for a in ARCHS for m in MESHES
          for f in ("block", "block_decode")]


def _cfg(arch, capacity_factor=None):
    cfg = dataclasses.replace(ref_get_smoke(arch), dtype="float32")
    if capacity_factor:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    return cfg


def _no_drop(arch):
    mo = ref_get_smoke(arch).moe
    return mo.num_experts / mo.top_k


def _inputs(arch, fn, seed):
    cfg = _cfg(arch)
    params = jax.tree.map(np.asarray, ref_init_tree(
        ref_moe.moe_defs(cfg), jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)
    b, s = FNS[fn]
    x = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    wgt = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    return params, x, wgt


_REFERENCE = r"""
import functools, os, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.configs import get_smoke
from repro.distributed.mesh import AxisEnv
from repro.models import moe
import dataclasses

cases = pickle.load(open(sys.argv[1], "rb"))
_pmean, _shard_map = jax.lax.pmean, jax.shard_map


def pmean_once(x, axes):
    return _pmean(x, tuple(dict.fromkeys(axes)) if isinstance(axes, tuple)
                  else axes)


def run(c, patched):
    jax.lax.pmean = pmean_once if patched else _pmean
    jax.shard_map = (functools.partial(_shard_map, check_vma=False)
                     if patched else _shard_map)
    cfg = dataclasses.replace(get_smoke(c["arch"]), dtype="float32")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=c["capacity_factor"]))
    shape = tuple(c["mesh"])
    devs = np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape)
    mesh = jax.sharding.Mesh(devs, ("data", "model"))
    env = AxisEnv.from_mesh(mesh)
    params = jax.tree.map(jnp.asarray, c["params"])
    x, wgt = jnp.asarray(c["x"]), jnp.asarray(c["wgt"])
    fn = c["fn"]
    if fn.startswith("block"):
        def f(p, xx):
            return moe.moe_block_sharded(p, xx, cfg, mesh, env, jnp.float32)
    else:
        pspec = jax.tree.map(lambda s: P(*s), c["pspec"],
                             is_leaf=lambda s: isinstance(s, list))
        x_spec, vary = P(*c["x_spec"]), tuple(c["vary"])

        def body(p, xx):
            if fn == "ep":
                o, a = moe.moe_ffn_ep(p, xx, cfg, "model", jnp.float32)
            elif fn == "replicated":
                o, a = moe.moe_ffn_ep_replicated(p, xx, cfg, "model",
                                                 jnp.float32)
            else:
                o, a = moe.moe_ffn_ep_replicated_dsharded(
                    p, xx, cfg, "model", env.fsdp, jnp.float32)
            if vary:
                a = jax.lax.pmean(a, vary)
            return o, a

        def f(p, xx):
            return jax.shard_map(body, mesh=mesh, in_specs=(pspec, x_spec),
                                 out_specs=(x_spec, P()))(p, xx)
    if c.get("block_too"):
        # the block itself, whose decode splits the tokens over data
        res_block = np.asarray(jax.jit(lambda p, xx: moe.moe_block_sharded(
            p, xx, cfg, mesh, env, jnp.float32)[0])(params, x))

    def loss(p, xx):
        o, a = f(p, xx)
        return jnp.sum(o * wgt) + a, (o, a)
    _, ids, _ = moe._router(params, x.reshape(-1, x.shape[-1]), cfg.moe)
    res = {"ids": np.asarray(ids), "patched": patched}
    if c.get("block_too"):
        res["block_out"] = res_block
    if not c["grad"]:
        out, aux = jax.jit(f)(params, x)
        dense = moe.moe_ffn_dense(params, x, cfg, jnp.float32)[0]
        return dict(res, out=np.asarray(out), aux=float(aux),
                    dense=np.asarray(dense))
    (_, (out, aux)), (g, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, x)
    res.update(out=np.asarray(out), aux=float(aux),
               grads=jax.tree.map(np.asarray, g), x_grad=np.asarray(gx))
    if cfg.moe.top_k == 1:
        res["router_grad_aux"] = np.asarray(jax.jit(jax.grad(
            lambda p: f(p, x)[1]))(params)["router"])
    return res


out = []
for c in cases:
    try:
        out.append(run(c, False))
    except Exception as e:
        msg = str(e)
        r = run(c, True)
        r["error"] = msg.split("\n")[0][:200]
        out.append(r)
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def _case_payload(arch, mesh, fn, capacity_factor, seed, grad):
    params, x, wgt = _inputs(arch, fn, seed)
    return {"arch": arch, "dtype": "float32",
            "capacity_factor": capacity_factor,
            "fn": "block" if fn.startswith("block") else fn,
            "params": params, "x": x, "wgt": wgt, "grad": grad,
            "aux_weight": 1.0, "mesh": list(mesh)}


def _reference_case(c, fn):
    """The payload plus what the reference's shard_map needs (specs as
    lists).  A decode of the block where ``data`` and ``model`` both
    exceed 1 runs as the port's block lays it out, the ``dsharded`` body
    with the tokens whole, and as the reference's block (``block_out``)."""
    out = dict(c, fn=fn)
    if fn == "block_decode" and min(c["mesh"]) > 1:
        out.update(fn="dsharded", block_too=True)
        fn = "dsharded"
    if not fn.startswith("block"):
        env = AxisEnv(batch=("data",), fsdp=("data",), tp=("model",),
                      sp=("model",), expert=("model",))

        class _M:
            shape = {"data": c["mesh"][0], "model": c["mesh"][1]}
        pspec, x_spec, vary = ep_specs(fn, env, _M, c["x"].shape[0],
                                       "shared" in c["params"])
        out["pspec"] = {k: ({n: list(s) for n, s in v.items()}
                            if isinstance(v, dict) else list(v))
                        for k, v in pspec.items()}
        out["x_spec"], out["vary"] = list(x_spec), list(vary)
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory, step_reference):
    """Every case through the reference (one subprocess) and the port (one
    world a mesh): {(arch, mesh, fn, capacity): (reference, port ranks)}."""
    keys = [(a, m, f, "config") for a, m, f in CASES] + \
        [(a, m, f, "no_drop") for a, m, f in NODROP]
    payloads = {}
    for i, (a, m, f, cap) in enumerate(keys):
        cf = ref_get_smoke(a).moe.capacity_factor if cap == "config" \
            else _no_drop(a)
        payloads[(a, m, f, cap)] = _case_payload(a, m, f, cf, seed=i,
                                                 grad=cap == "config")
    tmp = tmp_path_factory.mktemp("moe_ep")
    spec = tmp / "cases.pkl"
    res = tmp / "ref.pkl"
    with open(spec, "wb") as fh:
        pickle.dump([_reference_case(payloads[k], k[2]) for k in keys], fh)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO_ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") +
                          " --xla_force_host_platform_device_count=4"))
    # the reference's subprocess runs while the port's worlds do
    proc = subprocess.Popen([sys.executable, "-c", _REFERENCE, str(spec),
                             str(res)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=REPO_ROOT)
    try:
        port = {}
        for mesh in MESHES:
            ks = [k for k in keys if k[1] == mesh]
            ranks = run_world(mesh, "many", {"jobs": [
                ("ep_fn", payloads[k]) for k in ks]}, timeout=300)
            for i, k in enumerate(ks):
                port[k] = [r[i] for r in ranks]
        _, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    with open(res, "rb") as fh:
        ref = dict(zip(keys, pickle.load(fh)))
    return {k: (ref[k], port[k], payloads[k]) for k in keys}


def _rel(got, want):
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _token_rows(rank, mesh, fn, b, s):
    """Flat token indices (b * S + s) of the rank's block of x."""
    data, model = rank // mesh[1], rank % mesh[1]
    bw = mesh[0] if b % mesh[0] == 0 and b >= mesh[0] else 1
    bi = data if bw > 1 else 0
    whole = fn == "dsharded" or (fn == "block_decode" and mesh[1] > 1)
    rows_b = np.arange(b) if whole else np.arange(b).reshape(bw, -1)[bi]
    seq_split = fn == "ep" or (fn == "block" and s % mesh[1] == 0 and s > 1
                               and s >= mesh[1])
    rows_s = np.arange(s).reshape(mesh[1], -1)[model] if seq_split \
        else np.arange(s)
    return (rows_b[:, None] * s + rows_s[None, :]).reshape(-1)


def _blocks(mesh, rank, whole: dict, shared: bool):
    """The reference's whole MoE weights sliced to the rank's blocks
    (``moe_param_specs``)."""
    from repro_torch.distributed.mesh import Spec
    env = AxisEnv(batch=("data",), fsdp=("data",), tp=("model",),
                  sp=("model",), expert=("model",))
    specs = moe.moe_param_specs(env, shared)
    coords = {"data": rank // mesh[1], "model": rank % mesh[1]}
    size = {"data": mesh[0], "model": mesh[1]}

    def cut(a, spec):
        spec = Spec(*spec)
        for dim in range(a.ndim):
            axes = spec.axes(dim)
            if axes:
                n = size[axes[0]]
                step = a.shape[dim] // n
                a = np.take(a, range(coords[axes[0]] * step,
                                     (coords[axes[0]] + 1) * step), axis=dim)
        return a
    return {k: ({n: cut(t, specs[k][n]) for n, t in v.items()}
                if isinstance(v, dict) else cut(v, specs[k]))
            for k, v in whole.items()}


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("arch,mesh,fn", CASES)
def test_ep_matches_reference_shard_map(results, arch, mesh, fn):
    """Outputs, ``aux`` and router ids of each rank equal the reference's
    (1e-5; ids exactly), at the config's capacity (choices drop)."""
    ref, ranks, pay = results[(arch, mesh, fn, "config")]
    b, s = FNS[fn]
    for rank, got in enumerate(ranks):
        rows = _token_rows(rank, mesh, fn, b, s)
        assert np.array_equal(got["ids"], ref["ids"][rows]), rank
        assert _rel(got["out"], ref["out"]) <= 1e-5, rank
        assert abs(got["aux"] - ref["aux"]) <= 1e-5 * abs(ref["aux"]), rank
    # the changed reference runs are exactly its three faults
    assert ref["patched"] == (fn == "dsharded" or fn == "block_decode"
                              or (fn == "block" and mesh[1] == 1))


@pytest.mark.parametrize("arch,mesh,fn", CASES)
def test_ep_gradients_match_jax_grad(results, arch, mesh, fn):
    """Gradients of ``sum(out * wgt) + aux`` with respect to the router,
    the experts, the shared experts and the input equal ``jax.grad``
    through the reference's ``shard_map`` (1e-4 of each leaf's max |g|);
    the block's weight gradients are each rank's block of the
    reference's."""
    ref, ranks, pay = results[(arch, mesh, fn, "config")]
    shared = "shared" in pay["params"]
    for rank, got in enumerate(ranks):
        assert _rel(got["x_grad"], ref["x_grad"]) <= 1e-4
        want = (_blocks(mesh, rank, ref["grads"], shared)
                if fn.startswith("block") else ref["grads"])
        whole = dict(_leaves(ref["grads"]))
        for path, g in _leaves(got["grads"]):
            w = dict(_leaves(want))[path]
            if path == ("router",) and "router_grad_aux" in ref:
                aux_ref = ref["router_grad_aux"]
                scale = np.abs(aux_ref).max()
                assert np.abs(got["router_grad_aux"] - aux_ref).max() \
                    <= 1e-4 * scale, rank
                resid_ref = np.abs(w - aux_ref).max()
                resid = np.abs(g - got["router_grad_aux"]).max()
                assert resid <= 4 * resid_ref + 1e-4 * scale, rank
                continue
            scale = np.abs(whole[path]).max() + 1e-30
            assert np.abs(g - w).max() <= 1e-4 * scale, (rank, path)


@pytest.mark.parametrize("arch,mesh,fn", NODROP)
def test_ep_equals_dense_without_drops(results, arch, mesh, fn):
    """With a capacity at which nothing drops (E / k), the block equals the
    dense path in both packages, bit for bit in the port (the same ops in
    the same order) -- except the decode at (2, 2), where the weights'
    d_model dim is sharded over ``data`` (``fsdp``) and the gate and up
    products are two partial sums added by the ``psum``: there the port
    is held to the dense path at 1e-5 of max |out|, as the reference's
    ``dsharded`` body on the port's layout (the tokens whole).  The
    reference's own block there hands that body tokens sharded over
    ``data`` too, so its ``psum`` adds partial products of different
    tokens: a reference fault (ROADMAP queue 3), pinned."""
    import torch as _t
    ref, ranks, pay = results[(arch, mesh, fn, "no_drop")]
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=_no_drop(arch)))
    params = {k: ({n: _t.as_tensor(t) for n, t in v.items()}
                  if isinstance(v, dict) else _t.as_tensor(v))
              for k, v in pay["params"].items()}
    dense = moe.moe_ffn_dense(params, _t.as_tensor(pay["x"]), cfg,
                              _t.float32)[0].numpy()
    assert all(r["dropped"] == 0 for r in ranks)
    split = fn == "block_decode" and mesh == (2, 2)
    for got in ranks:
        assert _rel(got["out"], ref["out"]) <= 1e-5
        if split:
            assert _rel(got["out"], dense) <= 1e-5
        else:
            assert np.array_equal(got["out"], dense)
    assert _rel(ref["out"], ref["dense"]) <= 1e-6
    if split:
        assert _rel(ref["block_out"], ref["dense"]) > 0.1


def test_collectives_booked_by_axis_and_route(results):
    """The ledger books the (2, 2) block's prefill and its backward:
    all-to-alls over ``model`` (tokens, expert ids, weights, outputs, and
    the transposes of all but the integer ids), the six weights' ``fsdp``
    gathers and their reduce-scatters, the output gathered over ``batch``
    and ``model`` (and the input's cotangent), on the CPU all through
    gloo."""
    _, ranks, _ = results[("deepseek-v2-236b", (2, 2), "block", "config")]
    led = ranks[0]["ledger"]
    rows = {(r["axis"], r["op"]): r for r in led["rows"]}
    assert rows[("model", "all_to_all")]["calls"] == 7
    assert rows[("fsdp", "all_gather")]["calls"] == 6
    assert rows[("fsdp", "reduce_scatter")]["calls"] == 6
    assert rows[("batch", "all_gather")]["calls"] == 2
    assert set(led["by_route"]) == {"gloo", "host"}
    assert led["by_route"]["host"]["calls"] == 0
    assert led["by_axis"]["model"]["bytes"] > 0


# --------------------------------------------------------------------------
# one train step with use_ep at (1, 2) against the reference's step
# --------------------------------------------------------------------------

_REFERENCE_STEP = r"""
import dataclasses, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.common.config import TrainConfig
from repro.configs import get_smoke
from repro.distributed.mesh import AxisEnv, axis_size
from repro.models import steps, transformer
from repro.optim import adamw

tokens = pickle.load(open(sys.argv[1], "rb"))
out = {}
for arch in tokens:
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]).reshape(1, 2),
                             ("data", "model"))
    env = AxisEnv.from_mesh(mesh)
    params = transformer.init_params(cfg, jax.random.PRNGKey(0))
    pspecs = transformer.param_specs(cfg, env)

    def ns(tree):
        return jax.tree.map(lambda s: NamedSharding(mesh, s), tree,
                            is_leaf=lambda x: isinstance(x, P))

    # launch/cells.py's train cell: the EP step under param_specs
    def sp_constraint(x):
        if x.ndim == 3 and x.shape[1] % max(axis_size(mesh, env.sp), 1) == 0 \
                and x.shape[1] > 1:
            return jax.lax.with_sharding_constraint(
                x, NamedSharding(mesh, P("data", "model", None)))
        return x
    step = steps.make_train_step(cfg, TrainConfig(), use_ep=True, mesh=mesh,
                                 sp_constraint=sp_constraint)
    fn = jax.jit(step, in_shardings=(
        ns(pspecs), ns({"m": pspecs, "v": pspecs, "step": P()}), None))
    t = jnp.asarray(tokens[arch], jnp.int32)
    batch = {"tokens": t[:, :-1], "labels": t[:, 1:]}
    _, opt, met = fn(params, adamw.init_opt_state(params), batch)
    out[arch] = {"params": jax.tree.map(np.asarray, params),
                 "metrics": {k: float(v) for k, v in met.items()},
                 "m": jax.tree.map(np.asarray, opt["m"])}
pickle.dump(out, open(sys.argv[2], "wb"))
"""


@pytest.fixture(scope="module")
def step_reference(tmp_path_factory):
    """The reference's step for each MoE smoke config (4 XLA host devices,
    the first 2 as the (1, 2) mesh), started in a subprocess that runs
    while ``results``' worlds do: (process, tokens, output path)."""
    tmp = tmp_path_factory.mktemp("moe_ep_step")
    rng = np.random.default_rng(21)
    tokens = {a: rng.integers(0, ref_get_smoke(a).vocab_size, (8, 17))
              for a in ARCHS}
    with open(tmp / "tokens.pkl", "wb") as fh:
        pickle.dump(tokens, fh)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO_ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") +
                          " --xla_force_host_platform_device_count=4"))
    proc = subprocess.Popen([sys.executable, "-c", _REFERENCE_STEP,
                             str(tmp / "tokens.pkl"), str(tmp / "ref.pkl")],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=REPO_ROOT)
    yield proc, tokens, tmp / "ref.pkl"
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def train_results(step_reference):
    """The reference's step and the port's on the reference's weights in
    a (1, 2) gloo world."""
    proc, tokens, path = step_reference
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    with open(path, "rb") as fh:
        ref = pickle.load(fh)
    jobs = [("model", {"arch": a, "dtype": "float32", "tree": ref[a]["params"],
                       "prompt": tokens[a][:, :16], "capacity": 16,
                       "train": {"tokens": tokens[a][:, :-1],
                                 "labels": tokens[a][:, 1:]}})
            for a in ARCHS]
    ranks = run_world((1, 2), "many", {"jobs": jobs}, timeout=300)
    return {a: (ref[a], [r[i] for r in ranks]) for i, a in enumerate(ARCHS)}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_use_ep_matches_reference_step(train_results, arch):
    """One ``make_train_step(use_ep=True)`` step at (1, 2) on the
    reference's weights against the reference's, built as its dry-run's
    train cell builds it (pjit with ``param_specs`` shardings on the host
    devices): PERF.md §2's f32 train-step tolerances -- loss 1e-5
    relative, ``lr`` equal, ``grad_norm`` and every leaf of ``m`` 1e-3
    of its max."""
    ref, ranks = train_results[arch]
    want = ref["metrics"]
    for got in ranks:
        met = got["metrics"]
        assert abs(met["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
        assert met["lr"] == want["lr"]
        assert abs(met["grad_norm"] - want["grad_norm"]) \
            <= 1e-3 * want["grad_norm"]
        ref_m = dict(_leaves(ref["m"]))
        for path, m in _leaves(got["m"]):
            w = ref_m[path]
            assert np.abs(m - w).max() <= 1e-3 * (np.abs(w).max() + 1e-30), \
                path
