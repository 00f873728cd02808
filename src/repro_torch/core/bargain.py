"""BARGAIN-style cascade baselines [65] and SUPG-style [28] (for LOTUS [46]).

BARGAIN applied to joins (paper §8.1): the join is a filter over L×R with
proxy score = embedding similarity.  With β=0 every kept pair is verified by
the LLM (precision 1); the threshold must keep >= T recall w.h.p.  That is a
1-D instance of FDJ's threshold problem, so we reuse ``adj_target`` with r=1
— giving BARGAIN the *same* statistical guarantee the paper grants it.

``supg_threshold`` is the CLT/limit-style selection (observed recall >= T on
the sample, no finite-sample adjustment) — the variant shown in Table 2 to
miss targets; included to reproduce that failure mode.

``bargain_precision_subset`` is the precision-target primitive used by the
Appx-C extension: largest score-prefix whose precision >= T_P w.h.p., via a
Hoeffding ladder over candidate thresholds.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np

from repro_torch.core.adj_target import adj_target


@dataclasses.dataclass
class CascadeResult:
    tau: float                 # keep pairs with distance <= tau (score-based)
    t_prime: float
    observed_recall: float


def recall_guarded_threshold(sample_dists: np.ndarray, sample_labels: np.ndarray,
                             target: float, delta: float, *, n_pairs: int,
                             n_trials: int = 20000) -> CascadeResult:
    """Smallest-keep-set distance threshold with observed recall >= T'.

    sample_dists: proxy distances (smaller = more likely match) for a uniform
    sample; labels from the oracle.
    """
    labels = sample_labels.astype(bool)
    k_plus = int(labels.sum())
    k = len(labels)
    res = adj_target(max(k_plus, 1), 1, target, delta, n_pairs=n_pairs,
                     k_sample=k, n_trials=n_trials)
    t_prime = res.t_prime
    pos = np.sort(sample_dists[labels])
    if k_plus == 0:
        return CascadeResult(float("inf"), t_prime, 1.0)
    need = int(math.ceil(t_prime * k_plus - 1e-9))
    tau = pos[min(need, k_plus) - 1]
    obs = float((sample_dists[labels] <= tau).sum()) / k_plus
    return CascadeResult(float(tau), t_prime, obs)


def supg_threshold(sample_dists: np.ndarray, sample_labels: np.ndarray,
                   target: float) -> float:
    """SUPG/LOTUS-style: observed recall >= T on the sample, no adjustment."""
    labels = sample_labels.astype(bool)
    k_plus = int(labels.sum())
    if k_plus == 0:
        return float("inf")
    pos = np.sort(sample_dists[labels])
    need = int(math.ceil(target * k_plus - 1e-9))
    return float(pos[min(need, k_plus) - 1])


def optimal_cascade_threshold(all_dists: np.ndarray, all_labels: np.ndarray,
                              target: float) -> float:
    """Oracle threshold: smallest keep-set with TRUE recall >= T (uses all
    ground truth; infeasible in practice — lower bound for cascades)."""
    labels = all_labels.astype(bool)
    pos = np.sort(all_dists[labels])
    if pos.size == 0:
        return float("inf")
    need = int(math.ceil(target * pos.size - 1e-9))
    return float(pos[need - 1])


def bargain_precision_subset(
    dists: np.ndarray,
    label_fn: Callable[[np.ndarray], np.ndarray],
    t_p: float,
    delta: float,
    *,
    sample_per_level: int = 40,
    n_levels: int = 12,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Largest prefix (by ascending distance) with precision >= T_P w.h.p.

    label_fn(indices) -> bool labels (charges the oracle's ledger).
    Returns a boolean accept-mask over ``dists``.  Hoeffding ladder: level j
    tests the prefix up to quantile q_j with failure budget delta/n_levels.
    """
    rng = rng or np.random.default_rng(0)
    n = len(dists)
    if n == 0:
        return np.zeros(0, bool)
    order = np.argsort(dists, kind="stable")
    accept = np.zeros(n, bool)
    d_level = delta / n_levels
    eps = math.sqrt(math.log(1.0 / d_level) / (2.0 * sample_per_level))
    best = 0
    for j in range(1, n_levels + 1):
        m = int(n * j / n_levels)
        if m <= best:
            continue
        idx = order[:m]
        take = rng.choice(idx, size=min(sample_per_level, m), replace=False)
        labs = label_fn(take)
        p_hat = float(np.mean(labs))
        if p_hat - eps >= t_p:
            best = m
        else:
            break
    accept[order[:best]] = True
    return accept
