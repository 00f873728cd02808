"""The join mesh on the card: worlds of one and two ranks on one GPU.

These tests need a CUDA device and skip without one.  The file imports
neither jax nor the JAX package, so it runs on a GPU machine that has only
the port's dependencies:

    python -m pytest -q tests/test_torch_multipod_cuda.py

The CPU file ``tests/test_torch_multipod.py`` holds the mesh against the
JAX package; here the ring over a (1, 1, 1) join mesh on the card must
give the CPU ring's chunks, and a two-rank world sharing the card (gloo
collectives on the host) must pass the dry-run's checks with both kernels
launched on every rank.
"""

import pytest
import torch

from repro_torch.core.costs import CostLedger
from repro_torch.data import synth
from repro_torch.data.cnf_fixtures import representative_cnf
from repro_torch.data.simulated_llm import SimulatedExtractor
from repro_torch.distributed.mesh import make_join_mesh
from repro_torch.engine import get_engine
from repro_torch.launch.dryrun_client import run_dryrun


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def test_world_of_one_mesh_on_the_card_matches_cpu(cuda_device):
    ds = synth.police_records(n_incidents=37, reports_per_incident=2, seed=5)
    specs, clauses, thetas = representative_cnf(ds)
    feats = SimulatedExtractor(ds).materialize(specs, CostLedger())
    opts = dict(mesh=make_join_mesh(1, 1, 1), tl=32, tr=32, r_chunk=64,
                capacity=64)
    got = list(get_engine("sharded", device="cuda", **opts).evaluate_stream(
        feats, clauses, thetas))
    want = list(get_engine("sharded", device="cpu", **opts).evaluate_stream(
        feats, clauses, thetas))
    assert [(c.index, c.candidates, c.stats.bytes_to_host,
             c.stats.conjunct_evals) for c in got] == \
        [(c.index, c.candidates, c.stats.bytes_to_host,
          c.stats.conjunct_evals) for c in want]


@pytest.mark.parametrize("shape", ["2,1,1", "1,2,1"])
def test_two_ranks_share_the_card(cuda_device, shape):
    rep = run_dryrun(shape, "--cell", "16384", "--cell-r-chunk", "4096",
                     device="cuda", timeout=400)
    assert rep["use_kernel"] is True
    cell = rep["cell"]
    assert cell["steps"] == 4 and cell["shard_rows"] == 8192
    assert cell["bytes_to_host"] == 12 * 2 * 4 + 8 * cell["candidates"]
    for r in rep["ranks"]:
        assert r["launches"]["cnf_join"] > 0 and r["launches"]["compact"] > 0
    c = rep["collectives"]
    assert c["findings"] == [] and c["plane_mask_bytes"] == 0
    assert (c["cross_pod_calls"] >= 1) == shape.startswith("2")
