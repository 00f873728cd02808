"""repro_torch one-shot join vs the JAX reference join.

``repro_torch.core.join.fdj_join(engine="cuda", device="cpu")`` must give
the reference ``fdj_join(engine="pallas")``'s pairs, theta, conjunct
order, candidate count and ledger total on products (a 2-clause scaffold,
so Eq-4 selection runs the threshold sweep), police_records and
citations, in barrier and streaming-refinement modes.  The reference's
stream and barrier modes are identical by its own tests, so each dataset's
reference runs once.  Also: a reference plan and its planes carried over
through ``repro_torch.convert`` execute to the reference's pairs; the
port's main path imports neither jax nor repro; asking for CUDA without a
GPU raises; ``precision_target < 1`` runs the Appx-C path.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core.costs import CostLedger as JLedger
from repro.core.join import (FDJConfig as JCfg, execute_join as j_execute,
                             make_label_fn as j_label, plan_join as j_plan)
from repro.data.simulated_llm import (SimulatedExtractor as JExtractor,
                                      SimulatedProposer as JProposer)
from repro.launch._args import make_dataset as j_dataset
from repro_torch import convert
from repro_torch.core.join import (FDJConfig, QueryOptions, execute_join,
                                   fdj_join)
from repro_torch.data.simulated_llm import SimulatedExtractor, SimulatedProposer
from repro_torch.launch._args import make_dataset

# small sizes (the one-shot launcher's corpora scaled down); products at
# 0.3 is 210 x 210 and still builds the 2-clause scaffold [[4], [2]]
SIZES = {"products": 0.3, "police_records": 0.2, "citations": 0.1}
_TILES = {"tl": 64, "tr": 128}
_REF: dict = {}


def _reference(name):
    """Reference plan_join + execute_join (what its fdj_join composes)."""
    if name not in _REF:
        ds = j_dataset(name, size=SIZES[name])
        oracle = ds.make_oracle()
        cfg = JCfg(engine="pallas", engine_opts=dict(_TILES))
        ext = JExtractor(ds)
        label = j_label(oracle, {})
        plan = j_plan(ds, oracle, JProposer(ds), ext, cfg,
                      ledger=oracle.ledger, label=label)
        res = j_execute(ds, oracle, ext, cfg, plan, ledger=oracle.ledger,
                        label=label)
        _REF[name] = (plan, res, ext)
    return _REF[name]


def _port(name, stream):
    ds = make_dataset(name, size=SIZES[name])
    cfg = FDJConfig(engine="cuda", device="cpu", stream_refinement=stream,
                    engine_opts=dict(_TILES))
    return fdj_join(ds, ds.make_oracle(), SimulatedProposer(ds),
                    SimulatedExtractor(ds), cfg)


def _assert_same_result(got, want):
    assert got.pairs == want.pairs
    np.testing.assert_array_equal(got.theta, want.theta)
    assert got.candidate_count == want.candidate_count
    assert got.cost.total == want.cost.total
    assert got.scaffold.clauses == want.scaffold.clauses
    assert (got.recall, got.precision, got.t_prime) == \
        (want.recall, want.precision, want.t_prime)
    assert got.candidate_count > len(got.pairs) > 0


@pytest.mark.parametrize("stream", [False, True], ids=["barrier", "stream"])
@pytest.mark.parametrize("name", list(SIZES))
def test_fdj_join_matches_reference(name, stream):
    _, want, _ = _reference(name)
    got = _port(name, stream)
    _assert_same_result(got, want)
    if name == "products":
        assert len(got.scaffold.clauses) == 2      # the sweep ran


@pytest.mark.parametrize("name", ["products", "police_records"])
def test_plan_conjunct_order_matches_reference(name):
    from repro_torch.core.join import plan_join
    plan, _, _ = _reference(name)
    ds = make_dataset(name, size=SIZES[name])
    oracle = ds.make_oracle()
    got = plan_join(ds, oracle, SimulatedProposer(ds), SimulatedExtractor(ds),
                    FDJConfig(engine="cuda", device="cpu"))
    assert got.conjunct_order == plan.conjunct_order
    np.testing.assert_array_equal(got.theta, plan.theta)
    assert (got.t_prime, got.feasible) == (plan.t_prime, plan.feasible)
    assert got.sc_local.clauses == plan.sc_local.clauses


def _plan_state(plan) -> dict:
    return {"specs": [dataclasses.asdict(s) for s in plan.specs],
            "clauses": plan.scaffold.clauses, "theta": np.asarray(plan.theta),
            "t_prime": plan.t_prime, "feasible": plan.feasible,
            "conjunct_order": plan.conjunct_order,
            "calib_pairs": plan.calib_pairs, "calib_labels": plan.calib_labels}


def _plane_state(fd) -> dict:
    return {"spec": dataclasses.asdict(fd.spec), "kind": fd.kind,
            "data_l": np.asarray(fd.data_l), "data_r": np.asarray(fd.data_r),
            "scale": fd.scale}


@pytest.mark.parametrize("stream", [False, True], ids=["barrier", "stream"])
def test_convert_reference_plan_and_planes(stream):
    """The reference's plan and planes, handed over as plain values, run
    through the port's execute_join to the reference's pairs."""
    plan, want, ext = _reference("products")
    planes = [_plane_state(fd)
              for fd in ext.materialize(plan.used_specs, JLedger())]
    t_plan = convert.plan_from_state(_plan_state(plan))
    assert [dataclasses.asdict(s) for s in t_plan.used_specs] == \
        [dataclasses.asdict(s) for s in plan.used_specs]
    assert t_plan.sc_local.clauses == plan.sc_local.clauses
    ds = make_dataset("products", size=SIZES["products"])
    cfg = FDJConfig(engine="cuda", device="cpu", stream_refinement=stream,
                    engine_opts=dict(_TILES))
    got = execute_join(ds, ds.make_oracle(), None, cfg, t_plan,
                       plane_provider=lambda specs, led:
                       convert.features_from_state(planes))
    assert got.pairs == want.pairs
    assert got.candidate_count == want.candidate_count


def test_precision_extension_not_ported_raises():
    """The Appx-C path is ported now: the call that raised
    NotImplementedError runs and returns the reference's result
    (tests/test_torch_precision.py covers it in full)."""
    from repro.core.join import fdj_join as j_fdj_join
    ds = make_dataset("citations", size=SIZES["citations"])
    cfg = FDJConfig(engine="numpy", device="cpu", precision_target=0.9)
    got = fdj_join(ds, ds.make_oracle(), SimulatedProposer(ds),
                   SimulatedExtractor(ds), cfg)
    jds = j_dataset("citations", size=SIZES["citations"])
    want = j_fdj_join(jds, jds.make_oracle(), JProposer(jds), JExtractor(jds),
                      JCfg(engine="numpy", precision_target=0.9))
    assert got.pairs == want.pairs
    assert got.candidate_count == want.candidate_count
    assert got.cost.total == want.cost.total


def test_query_options_resolve():
    base = FDJConfig(device="cpu")
    cfg = QueryOptions(engine="numpy", stream=True,
                       overrides={"seed": 4}).resolve(base)
    assert (cfg.engine, cfg.stream_refinement, cfg.seed, cfg.device) == \
        ("numpy", True, 4, "cpu")
    # FDJConfig.pods is a field of the port since the join mesh: it
    # resolves; a name that is no field still raises
    assert QueryOptions(overrides={"pods": 2}).resolve(base).pods == 2
    with pytest.raises(TypeError, match="unknown FDJConfig"):
        QueryOptions(overrides={"n_pods": 2}).resolve(base)


def test_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the cuda path would run")
    ds = make_dataset("products", size=SIZES["products"])
    with pytest.raises(RuntimeError, match="CUDA"):
        fdj_join(ds, ds.make_oracle(), SimulatedProposer(ds),
                 SimulatedExtractor(ds), FDJConfig())


_MAIN_PATH = """
import json, sys
from repro_torch.launch.join import run_join
out = run_join("products", size=0.3, engine="cuda", device="cpu")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"bad": bad, "clauses": out["clauses"],
                  "candidates": out["candidates"]}))
"""


def test_main_path_imports_neither_jax_nor_repro():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    proc = subprocess.run([sys.executable, "-c", _MAIN_PATH], cwd=root,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    assert out["clauses"] == [[4], [2]] and out["candidates"] > 0
