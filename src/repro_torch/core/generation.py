"""Candidate featurization generation (§5, Alg 1–3).

``get_candidate_featurizations`` drives the iterative loop:
propose → extract on the sample → evaluate cost-to-cover → feed worst-covered
positives (and the negatives that explain them) back to the proposer.

The proposer is the Alg-2 "LLM": an abstract interface.  Offline runs use the
schema-aware ``SimulatedProposer`` (data/synth.py) that exhibits the
paper's observed behaviors — proposing redundant/erroneous featurizations
first and *fixing extraction errors* when shown failing examples.  The real
backend would render the Appx-I prompts.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Protocol, Sequence

import numpy as np

from repro_torch.core.costs import CostLedger
from repro_torch.core.featurize import FeaturizationSpec


class FeaturizationProposer(Protocol):
    """The Alg-2 LLM pipeline behind get-featurization-from-examples."""

    def propose(self, example_pairs: Sequence[tuple], example_labels: np.ndarray,
                existing: Sequence[FeaturizationSpec], join_prompt: str,
                ledger: CostLedger) -> list:
        ...


class FeatureExtractor(Protocol):
    """Extraction + vectorization backend (dataset-owned; charges ledger)."""

    def pair_distances(self, specs: Sequence[FeaturizationSpec],
                       pairs: Sequence[tuple], ledger: CostLedger) -> np.ndarray:
        ...


def cost_to_cover(dists: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """c_Φ(l,r) for every positive pair (Alg 3 lines 2-3).

    dists: (k, F) distances on the sample; labels: (k,) bool.
    Returns (k+,) minimum-over-featurizations count of negatives with
    distance <= the positive's distance.
    """
    k, f = dists.shape
    if f == 0:
        return np.full(int(labels.sum()), int((~labels).sum()), np.int64)
    pos = dists[labels]                                  # (k+, F)
    neg = dists[~labels]                                 # (k-, F)
    costs = np.empty((pos.shape[0], f), np.int64)
    for j in range(f):
        sn = np.sort(neg[:, j])
        costs[:, j] = np.searchsorted(sn, pos[:, j], side="right")
    return costs.min(axis=1)


@dataclasses.dataclass
class PickedExamples:
    pairs: list
    labels: np.ndarray


def evaluate_and_pick_examples(dists: np.ndarray, labels: np.ndarray,
                               sample_pairs: Sequence[tuple], alpha: int,
                               beta: int, rng: np.random.Generator
                               ) -> Optional[PickedExamples]:
    """Alg 3. Returns None when featurizations cover every positive well."""
    labels = labels.astype(bool)
    pos_idx = np.flatnonzero(labels)
    neg_idx = np.flatnonzero(~labels)
    c = cost_to_cover(dists, labels)
    if c.size == 0 or c.max() < alpha:
        return None
    half = max(beta // 2, 1)
    worst = pos_idx[np.argsort(c)[::-1][:half]]          # largest cost-to-cover
    # negatives "explaining" the cost: distance <= some selected positive's
    if dists.shape[1] > 0:
        pos_d = dists[worst]                             # (h, F)
        neg_d = dists[neg_idx]                           # (k-, F)
        expl = (neg_d[None, :, :] <= pos_d[:, None, :]).any(axis=(0, 2))
        cand_neg = neg_idx[expl]
    else:
        cand_neg = neg_idx
    if cand_neg.size > half:
        cand_neg = rng.choice(cand_neg, size=half, replace=False)
    chosen = np.concatenate([worst, cand_neg])
    return PickedExamples(pairs=[sample_pairs[i] for i in chosen],
                          labels=labels[chosen])


def get_candidate_featurizations(
    sample_pairs: Sequence[tuple],
    sample_labels: np.ndarray,
    proposer: FeaturizationProposer,
    extractor: FeatureExtractor,
    join_prompt: str,
    ledger: CostLedger,
    *,
    alpha: int = 3,
    beta: int = 20,
    max_iter: int = 8,
    seed: int = 0,
) -> list:
    """Alg 1. Returns the final list of FeaturizationSpec."""
    rng = np.random.default_rng(seed)
    labels = np.asarray(sample_labels, bool)
    k = len(sample_pairs)
    init = rng.choice(k, size=min(beta, k), replace=False)
    examples = PickedExamples([sample_pairs[i] for i in init], labels[init])
    specs: list = []
    for it in range(max_iter):
        new = proposer.propose(examples.pairs, examples.labels, specs,
                               join_prompt, ledger)
        # dedupe by key; a re-proposed name with bumped version replaces
        by_name = {s.name: s for s in specs}
        for s in new:
            if s.name not in by_name or s.version > by_name[s.name].version:
                by_name[s.name] = s
        specs = list(by_name.values())
        dists = extractor.pair_distances(specs, sample_pairs, ledger)
        examples = evaluate_and_pick_examples(dists, labels, sample_pairs,
                                              alpha, beta, rng)
        if examples is None:
            break
    return specs
