"""Target adjustment (§6.3–6.4, Appx B): T' = adj-target(k+, r, T, δ).

Theory recap.  For a conjunction of r predicates, Lemma 6.2 shows the
worst-case positive-pair distance dataset is axis-aligned with an even split:
``D*_r = {x e_i : x in [n+/r], i in [r]}`` (plus n+ mod r zero points for
non-divisible n+), valid for r ≤ n+/(n+(1−T)−1) ≈ 1/(1−T) — the same bound
Alg 4 enforces on clause count.  For r=1 this degenerates to the all-distinct
1-D dataset of the classical cascade-threshold analyses [28, 65], which our
implementation reproduces (see tests).  A threshold vector Θ with per-dim
admitted counts ``c_i`` has true recall (z + Σ c_i)/n+, so the *bad*
thresholds are exactly ``Σ c_i ≤ B_max = ceil(T n+) − 1 − z``.

For a uniform sample S of k+ points, the largest observed recall any bad
threshold can reach is ``(z_s + M*)/k+`` where ``M* = max Σ t_i`` subject to
``Σ s_i(t_i) ≤ B_max`` and ``s_i(t)`` = rank (value) of the t-th smallest
sampled point in dim i — optimal thresholds capture per-dim *prefixes* of
sampled points.  M* is a grouped prefix-knapsack solved exactly by DP, once
per Monte-Carlo trial; one DP yields the failure probability for *every*
candidate T' simultaneously.

Appx B corrections: Hoeffding MC-error inflation (δ1), Hoeffding bounds on
the unknown n+ (δ2, evaluated at both endpoints + midpoint and maxed), and
the threshold-selection budget δ3 = 8δ/10.  Results are cached on disk —
the computation is data-independent (paper: "computed offline").
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import tempfile
from typing import Optional

import numpy as np


def cache_dir() -> str:
    """Resolve the on-disk curve cache directory at call time.

    ``REPRO_TORCH_ADJ_CACHE`` wins; the default derives the repo root from
    this file's location (src/repro_torch/core/ -> three parents up) so any
    checkout caches inside its own gitignored ``.cache/`` instead of
    scribbling on a hardcoded absolute path.
    """
    env = os.environ.get("REPRO_TORCH_ADJ_CACHE")
    if env:
        return env
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    return os.path.join(root, ".cache", "adj_target_torch")


def _worst_case_maxcap(k_plus: int, r: int, n_plus: int, target: float,
                       n_trials: int, seed: int = 0) -> np.ndarray:
    """Distribution of max achievable sampled-capture (z_s + M*) over trials.

    Returns an int array (n_trials,) of the best observed-recall *count* any
    bad threshold attains on a random k+-subset of D*_{r, n+}.
    """
    if r == 0:
        return np.zeros(n_trials, np.int64)
    u = n_plus // r                                   # points per dim (Lemma 6.2)
    z = n_plus - u * r                                # zero points (divisibility)
    b_max = int(math.ceil(target * n_plus)) - 1 - z
    if b_max < 0:
        return np.zeros(n_trials, np.int64)           # no bad thresholds exist
    if k_plus >= n_plus:
        # sample = entire dataset: best bad threshold captures exactly B_max
        return np.full(n_trials, z + min(b_max, u * r), np.int64)
    rng = np.random.default_rng(seed)
    out = np.empty(n_trials, np.int64)
    chunk = max(1, min(512, n_trials, int(2e7 / max(n_plus, 1)) + 1))
    m_cap = k_plus                                     # dp budget dimension
    done = 0
    while done < n_trials:
        b = min(chunk, n_trials - done)
        # sample k+ ids w/o replacement from [0, n+) per trial
        ids = np.argpartition(rng.random((b, n_plus), dtype=np.float32),
                              k_plus, axis=1)[:, :k_plus]
        z_s = (ids < z).sum(axis=1)                    # sampled zero points
        # per-dim sampled ranks
        nz = ids - z
        dim = nz // u                                  # dim index (invalid for zero pts)
        rank = nz % u + 1                              # 1..u
        dp = np.full((b, m_cap + 1), np.inf, np.float64)
        dp[:, 0] = 0.0
        for i in range(r):
            mask = (nz >= 0) & (dim == i)
            # sorted ranks per trial for dim i, padded with inf
            rr = np.where(mask, rank, np.iinfo(np.int64).max).astype(np.float64)
            rr.sort(axis=1)
            t_max = int(mask.sum(axis=1).max()) if mask.any() else 0
            if t_max == 0:
                continue
            costs = rr[:, :t_max]                      # s_i(t), inf-padded
            costs[costs > 1e17] = np.inf
            new_dp = dp.copy()
            for t in range(1, t_max + 1):
                cand = dp[:, : m_cap + 1 - t] + costs[:, t - 1 : t]
                np.minimum(new_dp[:, t:], cand, out=new_dp[:, t:])
            dp = new_dp
        # M* = max m with dp[m] <= B_max
        feasible = dp <= b_max
        mstar = np.where(feasible.any(axis=1),
                         feasible.shape[1] - 1 - np.argmax(feasible[:, ::-1], axis=1),
                         0)
        out[done : done + b] = z_s + mstar
        done += b
    return out


def _cache_key(**kw) -> str:
    s = json.dumps(kw, sort_keys=True)
    return hashlib.sha1(s.encode()).hexdigest()[:16]


def failure_curve(k_plus: int, r: int, n_plus: int, target: float,
                  n_trials: int, seed: int = 0, cache: bool = True) -> np.ndarray:
    """P_{T'} for T' = (T + i/k+) — returns P(max count >= m) for m=0..k+."""
    key = _cache_key(k=k_plus, r=r, n=n_plus, t=round(target, 6), N=n_trials, s=seed)
    path = os.path.join(cache_dir(), key + ".npy")
    if cache and os.path.exists(path):
        return np.load(path)
    caps = _worst_case_maxcap(k_plus, r, n_plus, target, n_trials, seed)
    # tail[m] = P(caps >= m)
    counts = np.bincount(caps, minlength=k_plus + 2)[: k_plus + 2]
    tail = counts[::-1].cumsum()[::-1] / n_trials
    if cache:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        # written whole, then renamed: the ranks of a world, and a fleet's
        # workers within one process, compute the same curve at once; one
        # must never load another's half, nor rename another's file
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                                   prefix=f"{key}.", suffix=".tmp")
        with os.fdopen(fd, "wb") as f:
            np.save(f, tail)
        os.replace(tmp, path)
    return tail


@dataclasses.dataclass
class AdjTargetResult:
    t_prime: float
    delta1: float
    delta2: float
    delta3: float
    mc_error: float
    n_bounds: tuple


def adj_target(k_plus: int, r: int, target: float, delta: float, *,
               n_pairs: int, k_sample: int, n_plus_hat: Optional[int] = None,
               n_trials: int = 20000, seed: int = 0) -> AdjTargetResult:
    """Alg 7 (adj-target-est): smallest T' with bounded failure probability.

    k_plus: observed positives in the threshold sample (size k_sample) from
    n_pairs total pairs; n_plus_hat overrides the point estimate (testing).
    """
    if r == 0:
        return AdjTargetResult(target, 0, 0, delta, 0.0, (0, 0))
    # --- n+ bounds (Hoeffding, Appx B) ------------------------------------
    delta2 = delta / 10.0
    p_hat = k_plus / max(k_sample, 1)
    eps = math.sqrt(math.log(1.0 / delta2) / (2.0 * max(k_sample, 1)))
    n_lo = max(int(math.floor((p_hat - eps) * n_pairs)), k_plus)
    n_hi = min(int(math.ceil((p_hat + eps) * n_pairs)), n_pairs)
    if n_plus_hat is not None:
        n_lo = n_hi = n_plus_hat
    # --- delta split (Appx B) ----------------------------------------------
    width = max(2.0 * k_plus * n_pairs * eps, 1.0)
    delta1 = delta / (10.0 * width)
    delta3 = 8.0 * delta / 10.0
    mc_err = math.sqrt(math.log(1.0 / max(delta1, 1e-300)) / (2.0 * n_trials))

    evals = sorted({n_lo, (n_lo + n_hi) // 2, n_hi})
    tails = [failure_curve(k_plus, r, n, target, n_trials, seed) for n in evals]
    tail = np.max(np.stack(tails), axis=0) + mc_err

    # smallest T' = T + i/k+ with P <= delta3; failure: count >= ceil(k+ T')
    for i in range(1, k_plus + 1):
        t_prime = target + i / k_plus
        if t_prime > 1.0 + 1e-12:
            break
        m_req = int(math.ceil(k_plus * t_prime - 1e-9))
        if m_req > k_plus:
            break
        if tail[m_req] <= delta3:
            return AdjTargetResult(min(t_prime, 1.0), delta1, delta2, delta3,
                                   mc_err, (n_lo, n_hi))
    # infeasible: require perfect observed recall
    return AdjTargetResult(1.0, delta1, delta2, delta3, mc_err, (n_lo, n_hi))
