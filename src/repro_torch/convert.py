"""Carry a join's state into the port from plain numpy arrays and dicts.

FDJ's "weights" are a plan (the featurized decomposition and its
thresholds) and the feature planes it is evaluated on.  Another
implementation, such as the JAX package, can hand both over as plain
values: this module turns them into the port's ``JoinPlan`` and
``FeatureData`` without ever seeing a foreign type.

Plan state::

    {"specs": [spec, ...],            # every proposed featurization
     "clauses": [[f, ...], ...],      # CNF over indices into "specs"
     "theta": [...], "t_prime": float, "feasible": bool,
     "conjunct_order": [...] or None,
     "calib_pairs": [(i, j), ...], "calib_labels": [...]}   # optional

Each spec is a dict of ``FeaturizationSpec`` fields (name, description,
distance_kind, extractor_kind, field, version).  Each plane is
``{"spec": spec, "kind": "embed" | "scalar", "data_l": array,
"data_r": array, "scale": float}``.

A serving plane store's entries (one side of one plane each) are
``{"spec": spec, "side": "l" | "r", "fingerprint": str, "values": [...],
"host": array, "kind": "embed" | "scalar", "scale": float}``: the raw
extracted values, the vectorized plane and the corpus fingerprint it was
keyed under.

A model of the zoo is its parameter tree, in the JAX package's layout (a
nested dict of arrays: ``embed/embedding``, ``ln_f``, ``prefix/<i>/...``,
``scanned/<j>/...`` with a leading ``n_periods`` axis, ``unembed`` when
untied); ``model_params_from_numpy`` loads it into the port's
``Transformer`` and ``model_tree_to_numpy`` gives it back.  The AdamW state
is ``{"m": tree, "v": tree, "step": int32}``, ``m`` and ``v`` in the same
layout (``opt_state_from_numpy`` / ``opt_state_to_numpy``), so trained
weights and optimizer state cross between the packages both ways.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.common.config import ModelConfig
from repro_torch.core.featurize import FeatureData, FeaturizationSpec
from repro_torch.core.join import JoinPlan
from repro_torch.core.scaffold import Scaffold
from repro_torch.models.layers import tree_map
from repro_torch.models.transformer import (
    Transformer, tree_from_weights, weights_from_tree,
)
from repro_torch.serving.planes import FeaturePlaneStore


def spec_from_state(spec: dict) -> FeaturizationSpec:
    return FeaturizationSpec(**spec)


def plan_from_state(state: dict) -> JoinPlan:
    """A ``JoinPlan`` whose used specs and local scaffold are derived from
    ``clauses`` exactly as ``plan_join`` derives them."""
    specs = [spec_from_state(s) for s in state["specs"]]
    sc = Scaffold(clauses=[[int(f) for f in c] for c in state["clauses"]])
    used = sc.used_featurizations()
    remap = {f: i for i, f in enumerate(used)}
    order = state.get("conjunct_order")
    labels = state.get("calib_labels")
    return JoinPlan(
        specs=specs, scaffold=sc, used_specs=[specs[i] for i in used],
        sc_local=Scaffold(clauses=[[remap[f] for f in c] for c in sc.clauses]),
        theta=np.asarray(state["theta"], np.float64).reshape(-1),
        t_prime=float(state["t_prime"]), feasible=bool(state["feasible"]),
        calib_pairs=[tuple(map(int, p)) for p in state.get("calib_pairs") or []],
        calib_labels=None if labels is None else np.asarray(labels, bool),
        conjunct_order=None if order is None else [int(i) for i in order])


def features_from_state(planes: Sequence[dict]) -> list:
    """``FeatureData`` planes (in the order given) from plain arrays."""
    out = []
    for p in planes:
        if p["kind"] not in ("embed", "scalar"):
            raise ValueError(f"unknown plane kind {p['kind']!r}")
        out.append(FeatureData(spec_from_state(p["spec"]), p["kind"],
                               np.asarray(p["data_l"], np.float32),
                               np.asarray(p["data_r"], np.float32),
                               scale=float(p.get("scale", 1.0))))
    return out


def store_from_state(entries: Sequence[dict], *,
                     device="cuda") -> FeaturePlaneStore:
    """A ``FeaturePlaneStore`` on ``device`` with every entry pinned, in
    the order given (the last is the most recently used).  Pinning
    uploads, so ``bytes_to_device`` counts each plane once."""
    store = FeaturePlaneStore(device=device)
    for e in entries:
        if e["kind"] not in ("embed", "scalar") or e["side"] not in ("l", "r"):
            raise ValueError(f"bad store entry kind/side "
                             f"{(e['kind'], e['side'])!r}")
        store.put(spec_from_state(e["spec"]), e["side"], str(e["fingerprint"]),
                  list(e["values"]), np.asarray(e["host"], np.float32),
                  e["kind"], float(e["scale"]))
    return store


def model_params_from_numpy(cfg: ModelConfig, tree: dict,
                            device="cuda") -> Transformer:
    """A ``Transformer`` on ``device`` holding the weights of ``tree``, a
    nested dict of arrays in the reference's layout (scanned leaves are
    unstacked, one a layer).  A missing or surplus leaf, or a shape that is
    not the config's, raises ``ValueError``."""
    return Transformer(cfg, weights_from_tree(cfg, tree_map(
        lambda a: torch.tensor(np.asarray(a), device=device), tree)))


def model_tree_to_numpy(cfg: ModelConfig, model: Transformer) -> dict:
    """``model``'s weights as a nested dict of numpy arrays in the
    reference's layout (scanned leaves restacked)."""
    return tree_map(lambda t: t.numpy(), tree_from_weights(cfg, {
        n: p.detach().cpu() for n, p in model.named_parameters()}))


def opt_state_from_numpy(cfg: ModelConfig, tree: dict, device="cuda") -> dict:
    """The port's AdamW state (``optim.adamw``: ``m``, ``v`` keyed by
    parameter name, ``step`` an int32 0-dim tensor) on ``device`` from the
    reference's ``{"m", "v", "step"}`` tree of arrays."""
    def moments(t):
        return weights_from_tree(cfg, tree_map(
            lambda a: torch.tensor(np.asarray(a), dtype=torch.float32,
                                   device=device), t))
    return {"m": moments(tree["m"]), "v": moments(tree["v"]),
            "step": torch.tensor(int(np.asarray(tree["step"])),
                                 dtype=torch.int32, device=device)}


def opt_state_to_numpy(cfg: ModelConfig, opt_state: dict) -> dict:
    """The reference's ``{"m", "v", "step"}`` tree of numpy arrays from the
    port's AdamW state."""
    def moments(t):
        return tree_map(lambda a: a.numpy(), tree_from_weights(
            cfg, {n: v.detach().cpu() for n, v in t.items()}))
    return {"m": moments(opt_state["m"]), "v": moments(opt_state["v"]),
            "step": np.asarray(int(opt_state["step"]), np.int32)}
