"""Simulated Alg-2 LLM backends: proposer + extractor.

``SimulatedProposer`` models get-featurization-from-examples (Alg 2): it
proposes featurizations drawn from the dataset schema in relevance order with
realistic pathologies — missed features (found only in later iterations when
feedback examples surface them), redundant duplicates, occasional wrong
distance-function choices — and *fixes* extraction errors (version bump) when
the Alg-1 feedback loop returns failing examples.

``SimulatedExtractor`` models the extraction functions X_L / X_R: it returns
the true field value with deterministic per-(spec, side, record) corruption
whose rate decays with the spec version (the LLM's fixes), charging the
ledger with token-accurate extraction + embedding costs on first touch of
each record (generation phase touches only sampled records; the join-time
``materialize`` pass touches the full corpus).  Charging is vectorized per
spec — one batched ledger charge over the newly touched records — and
``extract_values`` exposes per-side raw extraction for the serving plane
store (serving/planes.py).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.costs import CostLedger, n_tokens
from repro_torch.core.featurize import (FeatureData, FeaturizationSpec, distance_stack,
                                  vectorize)
from repro_torch.core.llm import HashedNgramEmbedder, _stable_hash
from repro_torch.data.synth import Field, JoinDataset


def _unit(seed_key: str) -> float:
    return (_stable_hash(seed_key, seed=13) % (2**32)) / 2.0**32


def _garble(value: str, key: str) -> str:
    if not value:
        return value
    h = _stable_hash(value + key, seed=29)
    s = list(str(value))
    k = max(1, len(s) // 3)
    start = h % max(len(s) - k, 1)
    repl = "".join(chr(97 + ((h >> (i % 48)) % 26)) for i in range(k))
    return "".join(s[:start]) + repl + "".join(s[start + k:])


@dataclasses.dataclass
class SimulatedProposer:
    dataset: JoinDataset
    miss_prob: float = 0.2          # chance a relevant field is missed this call
    redundant_prob: float = 0.25    # chance of proposing a redundant variant
    wrong_distance_prob: float = 0.1
    fix_prob: float = 0.6           # chance to fix a noisy extractor on feedback
    max_new_per_call: int = 2
    calls: int = 0

    def propose(self, example_pairs, example_labels, existing, join_prompt,
                ledger: CostLedger) -> list:
        self.calls += 1
        out: list = []
        by_field = {}
        for s in existing:
            by_field.setdefault(s.field, []).append(s)
        # --- fix pass: bump versions of noisy extractors; the fix also
        # corrects a wrong distance-function choice (the LLM sees the
        # extraction outputs alongside the failing examples)
        schema = {f.name: f for f in self.dataset.schema}
        for s in existing:
            fld = schema.get(s.field)
            if fld is None:
                continue
            wrong_kind = s.distance_kind != fld.distance_kind
            if (fld.base_noise <= 0 or s.version >= 2) and not wrong_kind:
                continue
            if _unit(f"fix|{self.dataset.name}|{s.key}|{self.calls}") < self.fix_prob:
                out.append(dataclasses.replace(
                    s, version=s.version + 1,
                    distance_kind=fld.distance_kind if wrong_kind else s.distance_kind))
        # --- new featurizations ----------------------------------------------
        fields = sorted(self.dataset.schema, key=lambda f: -f.relevance)
        n_new = 0
        for fld in fields:
            if fld.name in by_field or n_new >= self.max_new_per_call:
                continue
            if _unit(f"miss|{self.dataset.name}|{fld.name}|{self.calls}") < self.miss_prob:
                continue
            kind = fld.distance_kind
            if _unit(f"dk|{self.dataset.name}|{fld.name}|{self.calls}") < self.wrong_distance_prob:
                kind = "semantic" if fld.distance_kind != "semantic" else "word_overlap"
            out.append(FeaturizationSpec(
                name=fld.name, description=f"extract {fld.name}",
                distance_kind=kind,
                extractor_kind="llm" if fld.llm_needed else "code",
                field=fld.name))
            n_new += 1
        # --- redundant variant -------------------------------------------------
        if existing and _unit(f"red|{self.dataset.name}|{self.calls}") < self.redundant_prob:
            base = existing[self.calls % len(existing)]
            alt = "semantic" if base.distance_kind != "semantic" else "word_overlap"
            out.append(dataclasses.replace(
                base, name=base.name + "_alt", distance_kind=alt, version=0))
        # --- cost: Alg-2 is a multi-call pipeline ------------------------------
        texts = []
        for (i, j) in example_pairs:
            texts.append(self.dataset.texts_l[i])
            texts.append(self.dataset.texts_r[j])
        prompt_tok = sum(n_tokens(t) for t in texts) + 400
        ledger.charge_generation(prompt_tok * 4, 150 * max(len(out), 1) * 3)
        return out


@dataclasses.dataclass
class SimulatedExtractor:
    dataset: JoinDataset
    seed: int = 0

    def __post_init__(self):
        self._values: dict = {}        # (key, side) -> list of values
        self._features: dict = {}      # key -> FeatureData
        self._charged: dict = {}       # (key, side) -> bool ndarray
        self._embedder = HashedNgramEmbedder(dim=128)
        self._text_tok: dict = {}      # side -> per-record token counts
        self._val_tok: dict = {}       # (key, side) -> per-record token counts

    # -- extraction simulation ------------------------------------------------
    def _noise_rate(self, fld: Field, version: int) -> float:
        return fld.base_noise * (0.25 ** version)

    def _extract_side(self, spec: FeaturizationSpec, side: str) -> list:
        key = (spec.key, side)
        if key in self._values:
            return self._values[key]
        fields = self.dataset.fields_l if side == "l" else self.dataset.fields_r
        schema = {f.name: f for f in self.dataset.schema}
        fld = schema[spec.field]
        true_vals = fields[spec.field]
        vals = []
        for i, v in enumerate(true_vals):
            u_m = _unit(f"miss|{spec.field}|{side}|{i}|{self.dataset.name}")
            u_c = _unit(f"corr|{spec.field}|{side}|{i}|{self.dataset.name}")
            if v is None or u_m < fld.missing:
                vals.append(None)
            elif u_c < self._noise_rate(fld, spec.version):
                if spec.distance_kind in ("arithmetic", "date"):
                    jitter = 5.0 + 45.0 * _unit(f"j|{spec.field}|{side}|{i}")
                    vals.append(float(v) + jitter)
                else:
                    vals.append(_garble(str(v), f"{side}|{i}"))
            else:
                vals.append(v)
        self._values[key] = vals
        return vals

    def _feature(self, spec: FeaturizationSpec) -> FeatureData:
        if spec.key not in self._features:
            vl = self._extract_side(spec, "l")
            vr = self._extract_side(spec, "r")
            self._features[spec.key] = vectorize(spec, vl, vr, self._embedder)
        return self._features[spec.key]

    # -- cost charging ----------------------------------------------------------
    # Charging is a vectorized per-spec pass: token counts are precomputed
    # once per (spec, side) as arrays, and a materialize/extract call issues
    # ONE batched ledger charge over the newly touched records instead of a
    # per-record host loop.  Totals match the per-record loop exactly (the
    # per-record prices are linear in token counts; see
    # tests/test_simulated_llm.py for the parity check).

    def _text_tok_counts(self, side: str) -> np.ndarray:
        if side not in self._text_tok:
            texts = self.dataset.texts_l if side == "l" else self.dataset.texts_r
            self._text_tok[side] = np.asarray(
                [n_tokens(t) for t in texts], np.int64)
        return self._text_tok[side]

    def _val_tok_counts(self, spec: FeaturizationSpec, side: str) -> np.ndarray:
        key = (spec.key, side)
        if key not in self._val_tok:
            vals = self._extract_side(spec, side)
            self._val_tok[key] = np.asarray(
                [n_tokens(str(v or "")) for v in vals], np.int64)
        return self._val_tok[key]

    def _charge(self, spec: FeaturizationSpec, side: str, idx: np.ndarray,
                ledger: CostLedger):
        key = (spec.key, side)
        texts = self.dataset.texts_l if side == "l" else self.dataset.texts_r
        if key not in self._charged:
            self._charged[key] = np.zeros(len(texts), bool)
        mask = self._charged[key]
        new = np.unique(idx[~mask[idx]]) if len(idx) else np.zeros(0, int)
        if new.size == 0:
            return
        val_tok = self._val_tok_counts(spec, side)
        if spec.extractor_kind == "llm":
            ledger.charge_extraction(
                int(self._text_tok_counts(side)[new].sum() + 30 * new.size),
                int(val_tok[new].sum() + 2 * new.size))
        if spec.distance_kind == "semantic":
            ledger.charge_embedding(int(val_tok[new].sum() + new.size))
        mask[new] = True

    # -- FeatureExtractor protocol ------------------------------------------------
    def pair_distances(self, specs: Sequence[FeaturizationSpec], pairs,
                       ledger: CostLedger) -> np.ndarray:
        il = np.asarray([p[0] for p in pairs], int)
        ir = np.asarray([p[1] for p in pairs], int)
        feats = []
        for s in specs:
            f = self._feature(s)
            self._charge(s, "l", il, ledger)
            self._charge(s, "r", ir, ledger)
            feats.append(f)
        return distance_stack(feats, pairs)

    def materialize(self, specs: Sequence[FeaturizationSpec],
                    ledger: CostLedger) -> list:
        feats = []
        for s in specs:
            f = self._feature(s)
            self._charge(s, "l", np.arange(self.dataset.n_l), ledger)
            self._charge(s, "r", np.arange(self.dataset.n_r), ledger)
            feats.append(f)
        return feats

    def extract_values(self, spec: FeaturizationSpec, side: str,
                       ledger: CostLedger, idx=None) -> list:
        """Raw extracted values for ``side`` at ``idx`` (full corpus when
        None), charging the ledger for first-touch records only — the
        extraction seam the serving plane store builds on (a resident
        plane never reaches this call)."""
        n = self.dataset.n_l if side == "l" else self.dataset.n_r
        idx = np.arange(n) if idx is None else np.asarray(idx, int)
        vals = self._extract_side(spec, side)
        self._charge(spec, side, idx, ledger)
        return [vals[i] for i in idx]
