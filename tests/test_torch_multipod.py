"""The port's join mesh: the ring engine L-sharded over a
``torch.distributed`` world of (pod, data, model) ranks, on the CPU.

Ports of the JAX package's tests/test_multipod.py, one to one: the mesh
rules, the engine on a 1-rank (1, 1, 1) mesh against numpy, the mesh
resolved per evaluation, ``FDJConfig.pods``, two units of the collective
ledger (in place of the reference's two HLO-parsing units), and the
dry-run (``launch/multipod_dryrun``, a world of gloo processes it spawns
itself) at (2, 2, 2), (1, 4, 1), (2, 2, 1) on the kernel's eval units and
(2, 4, 2) as the slow case (the reference's 512-device (2, 16, 16) mesh is
not reproduced with processes).

Then parity with the reference at the same mesh: the reference
``ShardedEngine`` on ``make_join_mesh(2, 2, 1)`` (four XLA host devices,
in a subprocess, as its own dry-run runs) and the port's (2, 2, 1) world
must give the same chunks, candidates, ``conjunct_evals``,
``bytes_to_host``, retries and ``last_sweep_caps``, on the police_records
fixture and on the capacity-1 fixture.  And units of what the slice adds:
``hierarchical_offsets``, the mesh layout of ``stage_planes``,
``build_join_cell``, the fleet's refusal of a world > 1, ``launch.join``
under a two-rank ``torchrun``-style environment, and the new modules'
imports.
"""

import ast
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.costs import CostLedger
from repro_torch.data import synth
from repro_torch.data.cnf_fixtures import representative_cnf
from repro_torch.data.simulated_llm import SimulatedExtractor
from repro_torch.distributed import collectives
from repro_torch.distributed.mesh import (JoinMesh, l_shard_axes,
                                          make_host_mesh, make_join_mesh)
from repro_torch.engine import extract, get_engine
from repro_torch.launch.dryrun_client import REPO_ROOT, run_dryrun

_OPTS = dict(tl=32, tr=32, r_chunk=64, device="cpu")


def _police(n_incidents=20, seed=3):
    ds = synth.police_records(n_incidents=n_incidents, reports_per_incident=2,
                              seed=seed)
    specs, clauses, thetas = representative_cnf(ds)
    return ds, specs, clauses, thetas


# --- in-process units -------------------------------------------------------

def test_make_join_mesh_always_carries_pod_axis():
    mesh = make_join_mesh(1, 1, 1)              # a world of one rank
    assert mesh.axis_names == ("pod", "data", "model")
    assert dict(mesh.shape) == {"pod": 1, "data": 1, "model": 1}
    assert l_shard_axes(mesh) == ("pod", "data")
    assert mesh.coords == {"pod": 0, "data": 0, "model": 0}
    assert mesh.is_coordinator and mesh.size == 1
    assert (mesh.inner, mesh.cross, mesh.pull) == (None, None, None)


def test_make_join_mesh_rejects_oversubscription():
    with pytest.raises(ValueError, match="devices"):
        make_join_mesh(64, 64, 64)


def test_l_shard_axes_without_pod():
    assert l_shard_axes(make_host_mesh()) == ("data",)


def test_sharded_engine_accepts_join_mesh_on_one_device():
    """The 3-axis pod code path agrees with numpy (and the reference's
    engine on its own 1-device join mesh) on a 1-rank world."""
    from repro.core.costs import CostLedger as JLedger
    from repro.data import synth as j_synth
    from repro.data.cnf_fixtures import representative_cnf as j_cnf
    from repro.data.simulated_llm import SimulatedExtractor as JExtractor
    from repro.distributed.mesh import make_join_mesh as j_mesh
    from repro.engine import get_engine as j_engine

    ds, specs, clauses, thetas = _police()
    feats = SimulatedExtractor(ds).materialize(specs, CostLedger())
    want = get_engine("numpy", block=64).evaluate(feats, clauses, thetas)
    got = get_engine("sharded", mesh=make_join_mesh(1, 1, 1),
                     **_OPTS).evaluate(feats, clauses, thetas)
    assert got.candidates == want.candidates
    j_ds = j_synth.police_records(n_incidents=20, reports_per_incident=2,
                                  seed=3)
    j_feats = JExtractor(j_ds).materialize(j_cnf(j_ds)[0], JLedger())
    ref = j_engine("sharded", mesh=j_mesh(1, 1, 1), tl=32, tr=32,
                   r_chunk=64).evaluate(j_feats, clauses, thetas)
    assert got.candidates == ref.candidates
    for key in ("bytes_to_host", "bytes_h2d", "bytes_reshard",
                "conjunct_evals"):
        assert getattr(got.stats, key) == getattr(ref.stats, key), key


@pytest.mark.parametrize("kind,ranks", [("inner", 4), ("cross", 2),
                                        ("pull", 8)])
def test_collective_ledger_classifies_by_group(kind, ranks):
    """Counterpart of the reference's replica-group parsing: each call is
    booked under the kind of group it ran over, a gather at its whole
    result's bytes, and only calls over a cross group of > 1 rank count
    as crossing a pod."""
    led = collectives.CollectiveLedger()
    led.record(kind, "all_gather", "counts", 4 * ranks, ranks)
    led.record("cross", "all_gather", "counts", 4, 1)   # a 1-pod mesh
    s = led.summary()
    assert s["by_group"][kind]["calls"] == 1 + (kind == "cross")
    assert s["by_group"][kind]["bytes"] == 4 * ranks + 4 * (kind == "cross")
    assert s["cross_pod_calls"] == (1 if kind == "cross" else 0)
    assert s["by_payload"] == {"counts": 4 * ranks + 4, "pairs": 0}
    assert collectives.check_counts_only(s) == []
    with pytest.raises(ValueError, match="payload"):
        led.record(kind, "all_gather", "planes", 4, ranks)


def test_collective_ledger_gates_cross_pod_bytes_and_pairs():
    """Counterpart of the reference's pod-crossing classifier: a cross-pod
    call over one int32 a rank, or pairs outside the pull group, is a
    finding; planes never enter a collective at all."""
    led = collectives.CollectiveLedger()
    led.record("inner", "all_gather", "counts", 32, 8)
    led.record("cross", "all_gather", "counts", 8, 2)    # s32[2]: counts
    led.record("pull", "recv", "pairs", 800, 16)
    s = led.summary()
    assert s["cross_pod_calls"] == 1 and s["by_group"]["cross"]["bytes"] == 8
    assert s["max_cross_call_bytes"] == s["cross_call_budget_bytes"] == 8
    assert collectives.check_counts_only(s) == []
    led.record("cross", "all_gather", "counts", 4096, 2)  # a plane's worth
    led.record("inner", "send", "pairs", 80, 8)
    findings = collectives.check_counts_only(led.summary())
    assert len(findings) == 2
    mesh = make_join_mesh(1, 1, 1)
    with pytest.raises(TypeError, match="int32"):
        collectives.all_gather(np.zeros(3, np.float32), mesh, "pull")


def test_hierarchical_offsets_on_one_rank():
    """A 1-rank world runs the same code: the local equivalents of the two
    gathers, booked in the mesh's ledger (the pod gather only where there
    is a pod axis)."""
    mesh = make_join_mesh(1, 1, 1)
    base, pod_counts = extract.hierarchical_offsets(7, mesh)
    assert base == 0 and pod_counts.tolist() == [7]
    s = mesh.ledger.summary()
    assert s["by_group"]["inner"]["calls"] == 1
    assert s["by_group"]["cross"]["calls"] == 1
    assert s["cross_pod_calls"] == 0           # a 1-rank cross group
    host = make_host_mesh()
    assert extract.hierarchical_offsets(3, host)[0] == 0
    assert host.ledger.summary()["by_group"]["cross"]["calls"] == 0


def test_sharded_engine_mesh_resolved_per_evaluation(monkeypatch):
    """An engine constructed without a mesh resolves it fresh on every
    evaluation (the plane set's, else the host mesh) and never pins the
    first plane set's; a mesh passed at construction always wins.  The spy
    sits on the port's dispatch input: the mesh handed to
    ``stage_planes``."""
    from repro_torch.engine.sharded import ShardedEngine
    from repro_torch.kernels.fused_cnf_join import ops as cnf_ops
    from repro_torch.serving.planes import FeaturePlaneStore, corpus_fingerprint

    ds, specs, clauses, thetas = _police(n_incidents=12)
    ext = SimulatedExtractor(ds)
    join_mesh = make_join_mesh(1, 1, 1)
    store = FeaturePlaneStore(device="cpu", mesh=join_mesh)
    planes = store.provide(
        specs, ext, CostLedger(),
        fp_l=corpus_fingerprint(ds.name, "l", ds.texts_l, ds.fields_l),
        fp_r=corpus_fingerprint(ds.name, "r", ds.texts_r, ds.fields_r))
    assert planes.mesh is join_mesh
    feats = ext.materialize(specs, CostLedger())

    seen = []
    real = cnf_ops.stage_planes

    def spy(*a, mesh=None, **k):
        seen.append(mesh)
        return real(*a, mesh=mesh, **k)

    monkeypatch.setattr(cnf_ops, "stage_planes", spy)
    eng = get_engine("sharded", **_OPTS)
    r1 = eng.evaluate(planes, clauses, thetas)    # the store's join mesh
    assert seen == [join_mesh]
    assert eng.mesh is None                       # nothing pinned
    seen.clear()
    r2 = eng.evaluate(feats, clauses, thetas)     # plain feats: host mesh
    assert len(seen) == 1 and seen[0] is not join_mesh, \
        "engine kept the first plane set's mesh for a mesh-less corpus"
    assert "pod" not in seen[0].axis_names
    assert r2.candidates == r1.candidates
    pinned_mesh = make_join_mesh(1, 1, 1)
    seen.clear()
    pinned = get_engine("sharded", mesh=pinned_mesh, **_OPTS)
    r3 = pinned.evaluate(planes, clauses, thetas)
    assert seen == [pinned_mesh]
    assert r3.candidates == r1.candidates
    assert ShardedEngine(tl=32, tr=32, device="cpu").mesh is None


def test_fdjconfig_pods_threads_into_engine(monkeypatch):
    from repro_torch.core.join import FDJConfig, _get_engine
    import repro_torch.distributed.mesh as mesh_mod

    captured = {}
    real = mesh_mod.make_join_mesh

    def spy(n_pods=1, n_data=None, n_model=1):
        captured["n_pods"] = n_pods
        return real(n_pods, n_data, n_model)

    monkeypatch.setattr(mesh_mod, "make_join_mesh", spy)
    # pods=1: no mesh built, the engine falls through to its default
    eng = _get_engine(FDJConfig(engine="sharded", device="cpu"))
    assert eng.mesh is None and "n_pods" not in captured
    with pytest.raises(ValueError, match="devices"):
        # pods=2 on a 1-rank world: the mesh build is attempted (the field
        # threads through) and rejects the oversubscription
        _get_engine(FDJConfig(engine="sharded", device="cpu", pods=2))
    assert captured["n_pods"] == 2


def test_stage_planes_mesh_layout_memoized_and_free_on_one_rank():
    """On a 1-rank world every array is already laid out (0 reshard
    bytes); the layout is memoized under the reference's key."""
    from repro_torch.kernels.fused_cnf_join import ops as cnf_ops
    from repro_torch.serving.planes import FeaturePlaneStore

    ds, specs, clauses, _ = _police(n_incidents=12)
    mesh = make_join_mesh(1, 1, 1)
    store = FeaturePlaneStore(device="cpu", mesh=mesh)
    planes = store.provide(specs, SimulatedExtractor(ds), CostLedger(),
                           fp_l="l", fp_r="r")
    st = cnf_ops.stage_planes(planes, clauses, tl=32, tr=64, device="cpu",
                              mesh=mesh, l_axes=("pod", "data"))
    assert st.bytes_h2d == 0 and st.bytes_reshard == 0
    keys = [k for k in planes.pack_cache if k[0] == "mesh"]
    assert len(keys) == 1 and keys[0][4] is mesh
    again = cnf_ops.stage_planes(planes, clauses, tl=32, tr=64, device="cpu",
                                 mesh=mesh, l_axes=("pod", "data"))
    assert again.emb_l is st.emb_l and again.bytes_reshard == 0
    assert cnf_ops.shard_rows(mesh, ("pod", "data"), 96) == (0, 96)


def test_build_join_cell_shards_and_step():
    """The production cell: 3 one-member embed clauses at theta 0.4; on a
    1-rank mesh the rank's inputs are the whole plane, as meta tensors,
    and the step is the kernel wrapper (its plain version on the CPU)."""
    from repro_torch.kernels.fused_cnf_join import ref as cref
    from repro_torch.kernels.fused_cnf_join.kernel import VEC
    from repro_torch.launch.join import build_join_cell

    step, (a_l, a_r) = build_join_cell(make_join_mesh(1, 1, 1))
    assert a_l.device.type == "meta" and a_r.device.type == "meta"
    assert tuple(a_l.shape) == (4, 262144, 128) == tuple(a_r.shape)
    assert step.clauses == (((VEC, 0),), ((VEC, 1),), ((VEC, 2),))
    assert step.thetas == (0.4, 0.4, 0.4)
    step, (a_l, a_r) = build_join_cell(make_join_mesh(1, 1, 1), n_l=512,
                                       n_r=1024, d=32)
    g = torch.Generator().manual_seed(0)
    el = torch.randn(a_l.shape, generator=g)
    er = torch.randn(a_r.shape, generator=g)
    el /= el.norm(dim=-1, keepdim=True)
    er /= er.norm(dim=-1, keepdim=True)
    got = step(el, er)
    ok = cref.cnf_join_ref(el, er, torch.zeros(1, 512), torch.zeros(1, 1024),
                           step.clauses, step.thetas)
    assert torch.equal(got, cref.pack_mask(ok))


def test_fleet_refuses_a_world_of_more_than_one_rank(monkeypatch):
    """A fleet would interleave band steps — and so collectives — in a
    different order on each rank: refused on a world > 1; a world of one
    serves as before."""
    import repro_torch.distributed.mesh as mesh_mod
    from repro_torch.serving.fleet import JoinFleet

    fleet = JoinFleet(device="cpu", mesh=make_join_mesh(1, 1, 1))
    assert fleet.store.mesh is not None
    fleet.close()
    monkeypatch.setattr(mesh_mod, "world_size", lambda: 2)
    with pytest.raises(ValueError, match="2 ranks"):
        JoinFleet(device="cpu")


def test_new_modules_import_neither_jax_nor_repro():
    """The slice's modules import nothing of JAX or of the JAX package,
    statically and at run time."""
    src = os.path.join(REPO_ROOT, "src", "repro_torch")
    mods = ["distributed/__init__.py", "distributed/mesh.py",
            "distributed/collectives.py", "launch/mesh.py",
            "launch/multipod_dryrun.py", "launch/dryrun_client.py",
            "engine/sharded.py", "engine/extract.py", "launch/join.py"]
    for rel in mods:
        with open(os.path.join(src, rel)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (rel, n)
    code = ("import sys; import repro_torch.launch.multipod_dryrun, "
            "repro_torch.launch.mesh, repro_torch.engine.sharded; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]; assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO_ROOT, "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def test_launch_join_under_a_two_rank_torchrun_env():
    """``launch.join`` joins the world a torchrun-style environment
    describes: two ranks, L sharded over them, and rank 0's report equal
    to the one-rank run's."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    argv = [sys.executable, "-m", "repro_torch.launch.join", "--dataset",
            "products", "--size", "0.3", "--engine", "sharded", "--device",
            "cpu", "--r-chunk", "128"]
    base = dict(os.environ, PYTHONPATH=os.path.join(REPO_ROOT, "src"),
                OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        argv, env=dict(base, WORLD_SIZE="2", RANK=str(r),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=REPO_ROOT) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180))
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    assert outs[1][0].strip() == "", "rank 1 printed a report"
    two = json.loads(outs[0][0])
    one = json.loads(subprocess.run(argv, env=base, capture_output=True,
                                    text=True, check=True, timeout=180,
                                    cwd=REPO_ROOT).stdout)
    for key in ("candidates", "recall", "precision", "theta", "clauses",
                "cost_ratio", "breakdown"):
        assert two[key] == one[key], key
    e1, e2 = one["engine"], two["engine"]
    steps = -(-e1["n_r"] // 128)
    assert e1["bytes_to_host"] == 12 * steps + 8 * e1["n_candidates"]
    assert e2["bytes_to_host"] == 12 * 2 * steps + 8 * e2["n_candidates"]


# --- the dry-run: gloo worlds ----------------------------------------------

def test_pod_mesh_2x2x2_end_to_end():
    """(2, 2, 2): parity vs numpy, stream disjointness, capacity-1 retry,
    serving warm/delta invariants, and counts-only cross-pod traffic."""
    rep = run_dryrun("2,2,2", timeout=240)
    assert rep["devices"] == 8
    assert rep["parity"]["candidates"] > 0
    assert rep["parity"]["bytes_to_host"] < rep["parity"]["plane_bytes"]
    assert rep["stream"]["chunks"] > 1
    assert rep["overflow"]["final_capacity"] >= 4
    s = rep["serving"]
    assert s["warm_extraction_cost"] == 0.0
    assert s["warm_h2d_bytes"] == 0
    assert s["warm_reshard_bytes"] == 0 and s["cold_reshard_bytes"] > 0
    c = rep["collectives"]
    assert c["cross_pod_calls"] >= 1
    assert c["max_cross_call_bytes"] <= c["cross_call_budget_bytes"] == 8
    assert c["plane_mask_bytes"] == 0 and c["findings"] == []
    assert c["bytes_by_payload"]["pairs"] > 0
    assert [r["coords"] for r in rep["ranks"]][-1] == \
        {"pod": 1, "data": 1, "model": 1}


def test_degenerate_pod_mesh_1xNx1():
    """(1, 4, 1): a pod axis of width 1 — numpy's output, and no
    pod-crossing collective at all."""
    rep = run_dryrun("1,4,1", "--skip-serving", timeout=240)
    assert rep["parity"]["candidates"] > 0
    assert rep["overflow"]["candidates"] == 33 * 33
    assert rep["collectives"]["cross_pod_calls"] == 0


def test_pod_mesh_kernel_path():
    """The kernel's tile eval units (use_kernel=True: on the CPU, the
    kernel's plain version) across the pod-axis world."""
    rep = run_dryrun("2,2,1", "--kernel", "--skip-serving", timeout=240)
    assert rep["use_kernel"] is True
    assert rep["parity"]["candidates"] > 0
    assert rep["collectives"]["cross_pod_calls"] >= 1


@pytest.mark.slow
def test_dryrun_2x4x2_full():
    """The largest world this host holds, (2, 4, 2) = 16 ranks (the
    reference's (2, 16, 16) = 512 devices is not reproduced with
    processes): host traffic O(candidates), cross-pod collectives
    count-sized, warm serving queries at 0 reshard bytes."""
    rep = run_dryrun("2,4,2", timeout=400)
    assert rep["devices"] == 16
    p = rep["parity"]
    assert p["bytes_to_host"] < p["plane_bytes"]
    c = rep["collectives"]
    assert c["cross_pod_calls"] >= 1
    assert c["max_cross_call_bytes"] <= c["cross_call_budget_bytes"]
    assert c["bytes_by_group"]["cross"] < p["bytes_h2d"] / 100
    s = rep["serving"]
    assert s["warm_reshard_bytes"] == 0 and s["cold_reshard_bytes"] > 0
    assert s["warm_extraction_cost"] == 0.0 and s["warm_h2d_bytes"] == 0


def test_dryrun_cell_on_a_small_plane():
    """The production cell's check at 2048 x 2048 on a (2, 1, 1) world:
    each rank's L shard shaped as ``build_join_cell`` says, kernel A and
    the compaction once a band step on every rank, and ``bytes_to_host``
    12 B a rank a step + 8 B a pair."""
    rep = run_dryrun("2,1,1", "--skip-serving", "--cell", "2048",
                     "--cell-r-chunk", "512", timeout=240)
    cell = rep["cell"]
    assert cell["steps"] == 4 and cell["shard_rows"] == 1024
    assert cell["candidates"] > 0
    assert cell["bytes_to_host"] == 12 * 2 * 4 + 8 * cell["candidates"]
    assert cell["bytes_reshard"] > 0


# --- parity with the reference at the same mesh ------------------------------

_REFERENCE = r"""
import json
from repro.core.costs import CostLedger
from repro.core.featurize import FeaturizationSpec, vectorize
from repro.data import synth
from repro.data.cnf_fixtures import representative_cnf
from repro.data.simulated_llm import SimulatedExtractor
from repro.distributed.mesh import make_join_mesh
from repro.engine import get_engine
from repro.obs import Tracer, use_tracer

mesh = make_join_mesh(2, 2, 1)
opts = dict(mesh=mesh, tl=8, tr=32, r_chunk=32, use_kernel=True)

def run(eng, feats, clauses, thetas):
    tracer = Tracer()
    with use_tracer(tracer):
        chunks = list(eng.evaluate_stream(feats, clauses, thetas))
    retries = sum(e.name == "overflow" for sp in tracer.spans()
                  for e in sp.events)
    rows = [[c.index, [list(p) for p in c.candidates], c.stats.n_candidates,
             c.stats.bytes_to_host, c.stats.bytes_h2d, c.stats.bytes_reshard,
             c.stats.conjunct_evals] for c in chunks]
    return {"chunks": rows, "retries": retries,
            "last_sweep_caps": eng.last_sweep_caps.tolist()}

ds = synth.police_records(n_incidents=37, reports_per_incident=2, seed=5)
specs, clauses, thetas = representative_cnf(ds)
feats = SimulatedExtractor(ds).materialize(specs, CostLedger())
police = run(get_engine("sharded", prefetch_depth=4, **opts), feats, clauses,
             thetas)
spec = FeaturizationSpec("name", "", "word_overlap", "llm", "name")
dense = [vectorize(spec, ["same text"] * 33, ["same text"] * 33)]
overflow = run(get_engine("sharded", capacity=1, **opts), dense, [[0]],
               [0.5])
print("REFERENCE " + json.dumps({"parity": police, "overflow": overflow}))
"""


def _reference_221() -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO_ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") +
                          " --xla_force_host_platform_device_count=4"))
    proc = subprocess.run([sys.executable, "-c", _REFERENCE], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=REPO_ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("REFERENCE ")][-1]
    return json.loads(line[len("REFERENCE "):])


def test_world_2x2x1_matches_reference_sharded_engine():
    """The port's (2, 2, 1) gloo world against the reference
    ``ShardedEngine(mesh=make_join_mesh(2, 2, 1))`` on four XLA host
    devices, exactly: every chunk (index, pairs, bytes, evals), the
    retries and the per-shard capacities the sweep ended at."""
    ref = _reference_221()
    rep = run_dryrun("2,2,1", "--kernel", "--skip-serving", "--detail",
                     timeout=240)
    for fixture in ("parity", "overflow"):
        got, want = rep[fixture], ref[fixture]
        assert got["chunks"] == want["chunks"], fixture
        assert got["retries"] == want["retries"], fixture
        assert got["last_sweep_caps"] == want["last_sweep_caps"], fixture
    assert ref["overflow"]["retries"] >= 1
    p = rep["parity"]
    assert p["bytes_to_host"] == sum(c[3] for c in ref["parity"]["chunks"])
    assert p["conjunct_evals"] == sum(c[6] for c in ref["parity"]["chunks"])
    assert p["candidates"] == sum(c[2] for c in ref["parity"]["chunks"])


def test_join_mesh_requires_world_coverage():
    """A mesh must cover the world exactly (a rank outside it would take
    no part in the collectives): a 1-rank world refuses a 2-rank mesh by
    its device count, and ``JoinMesh`` takes only positive axis sizes."""
    with pytest.raises(ValueError, match="devices"):
        JoinMesh(("pod", "data", "model"), (1, 2, 1))
    with pytest.raises(ValueError):
        JoinMesh(("data", "model"), (0, 1))


def test_adj_target_curve_cache_is_written_whole(tmp_path, monkeypatch):
    """The ranks of a world plan at once and compute the same Monte-Carlo
    curve: its cache file appears only complete (written aside, then
    renamed), so no rank loads another's half-written file.  A rank that
    did would fail its plan and leave the others in a collective."""
    from repro_torch.core import adj_target as at

    monkeypatch.setenv("REPRO_TORCH_ADJ_CACHE", str(tmp_path))
    real_save = np.save
    during = []

    def save(f, arr):
        during.append(sorted(os.listdir(tmp_path)))
        real_save(f, arr)

    monkeypatch.setattr(np, "save", save)
    tail = at.failure_curve(5, 2, 40, 0.9, 200)
    assert during and all(n.endswith(".tmp") for n in during[0])
    after = os.listdir(tmp_path)
    assert len(after) == 1 and after[0].endswith(".npy")
    np.testing.assert_array_equal(at.failure_curve(5, 2, 40, 0.9, 200), tail)
    np.testing.assert_array_equal(
        at.failure_curve(5, 2, 40, 0.9, 200, cache=False), tail)
