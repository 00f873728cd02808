"""The expert-parallel MoE on the card against the CPU, in a (1, 2) world
of two processes sharing card 0 over gloo.

These tests need a CUDA device and skip without one.  The file imports
neither jax nor the JAX package, so it runs on a GPU machine that has only
the port's dependencies:

    python -m pytest -q tests/test_torch_moe_ep_cuda.py

* ``moe_block_sharded`` at a prefill (8, 16) and a decode (8, 1) and
  ``moe_ffn_ep_replicated`` on the deepseek-v2 smoke config's MoE weights
  in float32, TF32 off, at the config's capacity: router ids equal, the
  output within 1e-5 of max |out| and the gradients of ``sum(out * wgt) +
  aux`` within 1e-4 of each leaf's max |g| (f32 GEMMs of two libraries).
* On the card the ``all_to_all`` and ``all_gather`` calls are staged
  through the host (gloo has neither for CUDA tensors) and booked so;
  ``all_reduce`` goes to gloo on the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.launch.ep_world import run_world
from repro_torch.models import moe
from repro_torch.models.layers import init_tree, tree_map

ARCH = "deepseek-v2-236b"


@pytest.fixture(scope="module")
def worlds():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = dataclasses.replace(get_smoke(ARCH), dtype="float32")
    params = tree_map(lambda t: t.numpy(), init_tree(
        moe.moe_defs(cfg), torch.Generator().manual_seed(0), "cpu"))
    rng = np.random.default_rng(0)
    jobs = []
    for fn, (b, s) in (("block", (8, 16)), ("block", (8, 1)),
                       ("replicated", (8, 4))):
        x = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
        wgt = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
        for dev in ("cuda", "cpu"):
            jobs.append(("ep_fn", {"arch": ARCH, "dtype": "float32", "fn": fn,
                                   "params": params, "x": x, "wgt": wgt,
                                   "grad": True, "device": dev}))
    ranks = run_world((1, 2), "many", {"jobs": jobs}, device="cuda",
                      timeout=300)
    return [[(r[2 * i], r[2 * i + 1]) for i in range(3)] for r in ranks]


def _leaves(tree):
    for k in sorted(tree):
        v = tree[k]
        yield from (_leaves(v) if isinstance(v, dict) else [v])


@pytest.mark.parametrize("case", range(3))
def test_ep_on_the_card_equals_cpu(worlds, case):
    for rank in worlds:
        card, cpu = rank[case]
        assert np.array_equal(card["ids"], cpu["ids"])
        scale = np.abs(cpu["out"]).max()
        assert np.abs(card["out"] - cpu["out"]).max() <= 1e-5 * scale
        assert abs(card["aux"] - cpu["aux"]) <= 1e-5 * abs(cpu["aux"])
        for g, w in zip(_leaves(card["grads"]), _leaves(cpu["grads"])):
            assert np.abs(g - w).max() <= 1e-4 * (np.abs(w).max() + 1e-30)


def test_card_collectives_are_booked_by_route(worlds):
    """The prefill block on the card: its all-to-alls and gathers through
    the host, its all-reduces to gloo on the card; the same calls on the
    CPU all through gloo."""
    card, cpu = worlds[0][0]
    rows = {(r["axis"], r["op"]): r["route"] for r in card["ledger"]["rows"]}
    assert rows[("model", "all_to_all")] == "host"
    assert rows[("model", "all_gather")] == "host"
    assert rows[("batch+model", "all_reduce")] == "gloo"
    assert cpu["ledger"]["by_route"]["host"]["calls"] == 0
    assert card["ledger"]["by_route"]["host"]["calls"] \
        == cpu["ledger"]["by_route"]["gloo"]["calls"] \
        - card["ledger"]["by_route"]["gloo"]["calls"]
