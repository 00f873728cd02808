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
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.featurize import FeatureData, FeaturizationSpec
from repro_torch.core.join import JoinPlan
from repro_torch.core.scaffold import Scaffold
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
