"""Logical scaffolds (§6.1–6.2) and threshold search (Eq 1 / Eq 4, Appx G).

A scaffold is a CNF over featurization indices: ``clauses = [[f, ...], ...]``
(outer conjunction, inner disjunction).  Per Appx D / Lemma D.1 thresholds
are tied within a clause, so a clause's effective distance is the *min* over
its featurizations' distances — the CNF then reduces to a pure conjunction
over per-clause distances with one threshold each.

``min_fpr_thresholds`` solves  min FPR  s.t. observed recall >= target:
exhaustive for 1 clause (Appx G pruning makes this O(k log k)); for more
clauses, ``method`` selects the route:

  * ``"greedy"`` — the Alg-8 greedy coordinate descent from +inf, with
    swap-repair local search (the cheap route Alg-4 scaffold *cost
    estimation* stays on: it only needs relative ordering across candidate
    scaffolds, not the tightest theta);
  * ``"device"`` — the ``kernels/threshold_sweep`` path: a capped
    cartesian grid of per-clause positive-distance quantiles
    (``candidate_grid``) is swept in one kernel launch on ``device`` (all
    (pos, sel) counts at once), the argmin-FPR grid point subject to
    recall >= target seeds a greedy coordinate refinement, and the result
    is A/B'd against the plain greedy descent — the device route never
    returns a worse feasible FPR than the greedy baseline, by
    construction;
  * ``"auto"`` — the exact 1-D sweep for one clause, ``"device"`` for
    more (Eq-4 selection in plan_join passes this).  Unlike the JAX
    package's ``"auto"``, it never falls back to greedy when the sweep
    cannot run: on a GPU the sweep launches its kernel or raises.

Candidate thresholds are exactly the positive pairs' distances — pushing a
threshold below the largest retained positive only drops negatives, so
optima sit on positive distances.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from repro_torch.kernels.threshold_sweep.ops import candidate_grid, sweep_counts


@dataclasses.dataclass
class Scaffold:
    clauses: list                      # list[list[int]] featurization indices

    @property
    def n_clauses(self) -> int:
        return len(self.clauses)

    def used_featurizations(self) -> list:
        return sorted({f for c in self.clauses for f in c})

    def clause_distances(self, dstack: np.ndarray) -> np.ndarray:
        """dstack: (k, F) per-featurization distances -> (k, C) clause-min."""
        if not self.clauses:
            return np.zeros((dstack.shape[0], 0), dstack.dtype)
        return np.stack([dstack[:, c].min(axis=1) for c in self.clauses], axis=1)


@dataclasses.dataclass
class ThresholdResult:
    theta: np.ndarray                  # (C,)
    fpr: float
    recall: float
    feasible: bool


def _eval(cd: np.ndarray, labels: np.ndarray, theta: np.ndarray):
    """FPR = admitted negatives / all negatives — proportional to refinement
    cost (the paper's cost proxy); recall over positives."""
    sel = np.all(cd <= theta[None, :], axis=1)
    n_pos = max(int(labels.sum()), 1)
    n_neg = max(int((~labels).sum()), 1)
    recall = float((sel & labels).sum()) / n_pos
    fpr = float((sel & ~labels).sum()) / n_neg
    return recall, fpr, sel


def min_fpr_thresholds(cd: np.ndarray, labels: np.ndarray, target: float,
                       method: str = "greedy",
                       device="cuda") -> ThresholdResult:
    """cd: (k, C) clause distances; labels: (k,) bool. Solves Eq 1 / Eq 4.

    ``method``: "greedy" | "device" | "auto" (see module docstring); ``device`` is
    where the sweep runs.  The device sweep is strictly-no-worse: its
    result is the best feasible of (refined sweep winner, greedy baseline).
    """
    if method not in ("greedy", "device", "auto"):
        raise ValueError(f"unknown threshold method {method!r}")
    k, c = cd.shape
    labels = labels.astype(bool)
    n_pos = int(labels.sum())
    if c == 0:
        recall, fpr, _ = _eval(cd, labels, np.zeros(0))
        return ThresholdResult(np.zeros(0), fpr, 1.0, True)
    if n_pos == 0:
        return ThresholdResult(np.full(c, np.inf), 0.0, 1.0, False)

    pos = cd[labels]                                # (k+, C)
    need = int(math.ceil(target * n_pos - 1e-9))    # min retained positives

    if c == 1 and method != "device":
        return _sweep_1d(cd[:, 0], labels, need, n_pos)

    # --- greedy coordinate descent from +inf (Alg 8 style) -----------------
    if c == 1:
        best = _sweep_1d(cd[:, 0], labels, need, n_pos)
    else:
        theta = pos.max(axis=0).astype(np.float64)  # recall = 1
        best = _greedy(cd, labels, theta, need, n_pos)
        # swap-repair passes: raise one dim to its max, re-descend
        for j in range(c):
            t2 = best.theta.copy()
            t2[j] = pos[:, j].max()
            cand = _greedy(cd, labels, t2, need, n_pos)
            if cand.feasible and cand.fpr < best.fpr - 1e-12:
                best = cand
    if method == "greedy":
        return best
    dev = _device_sweep(cd, labels, pos, need, n_pos, device=device)
    if dev.feasible and (not best.feasible or dev.fpr < best.fpr - 1e-12):
        return dev
    return best


def _device_sweep(cd: np.ndarray, labels: np.ndarray, pos: np.ndarray,
                  need: int, n_pos: int, *, device):
    """Grid sweep on ``device`` (kernels/threshold_sweep) + coordinate
    refinement around the argmin-FPR feasible grid point."""
    grid = candidate_grid(pos)
    pos_counts, sel_counts = sweep_counts(cd, labels, grid, device=device)
    k = cd.shape[0]
    n_neg = max(k - n_pos, 1)
    feas = pos_counts >= need - 0.5                 # counts are exact f32 ints
    if not feas.any():
        # grid always contains the per-dim positive max (recall-1 corner),
        # so this only happens when even recall 1 cannot reach ``need``
        v = pos.max(axis=0).astype(np.float64)
        recall, fpr, _ = _eval(cd, labels, v)
        return ThresholdResult(v, fpr, recall, False)
    fprs = np.where(feas, (sel_counts - pos_counts) / n_neg, np.inf)
    theta0 = grid[int(np.argmin(fprs))].astype(np.float64)
    # coordinate refinement: the winner seeds the same descent the greedy
    # route uses, landing on exact positive-distance optima the quantile
    # grid straddles
    if cd.shape[1] == 1:
        refined = _sweep_1d(cd[:, 0], labels, need, n_pos)
    else:
        refined = _greedy(cd, labels, theta0, need, n_pos)
    return refined


def _sweep_1d(d: np.ndarray, labels: np.ndarray, need: int, n_pos: int) -> ThresholdResult:
    pos_vals = np.sort(np.unique(d[labels]))
    n_neg = max(len(d) - n_pos, 1)
    order = np.argsort(d, kind="stable")
    ds = d[order]
    ls = labels[order]
    cum_pos = np.cumsum(ls)
    cum_all = np.arange(1, len(d) + 1)
    # for each candidate v: retained = count(d <= v)
    idx = np.searchsorted(ds, pos_vals, side="right") - 1
    npos_at = cum_pos[idx]
    nsel_at = cum_all[idx]
    feas = npos_at >= need
    if not feas.any():
        v = pos_vals[-1]
        recall, fpr, _ = _eval(d[:, None], labels, np.array([v]))
        return ThresholdResult(np.array([v]), fpr, recall, False)
    fprs = np.where(feas, (nsel_at - npos_at) / n_neg, np.inf)
    i = int(np.argmin(fprs))
    v = pos_vals[i]
    recall = npos_at[i] / n_pos
    return ThresholdResult(np.array([v]), float(fprs[i]), float(recall), True)


def _greedy(cd: np.ndarray, labels: np.ndarray, theta0: np.ndarray,
            need: int, n_pos: int) -> ThresholdResult:
    k, c = cd.shape
    theta = theta0.astype(np.float64).copy()
    pos = cd[labels]
    cands = [np.sort(np.unique(pos[:, j]))[::-1] for j in range(c)]  # desc
    recall, fpr, sel = _eval(cd, labels, theta)
    if int((sel & labels).sum()) < need:
        return ThresholdResult(theta, fpr, recall, False)
    improved = True
    while improved:
        improved = False
        best_move = None
        best_fpr = fpr
        # under the current other-dims selection, try lowering each dim
        for j in range(c):
            others = np.all(np.delete(cd, j, axis=1) <=
                            np.delete(theta, j)[None, :], axis=1) if c > 1 else \
                np.ones(k, bool)
            dj = cd[:, j]
            vals = cands[j]
            vals = vals[vals < theta[j]]
            if vals.size == 0:
                continue
            # vectorized: counts for each candidate
            alive = others
            d_alive = dj[alive]
            l_alive = labels[alive]
            o = np.argsort(d_alive, kind="stable")
            ds, ls = d_alive[o], l_alive[o]
            cpos = np.cumsum(ls)
            idx = np.searchsorted(ds, vals, side="right") - 1
            valid = idx >= 0
            npos_at = np.where(valid, cpos[np.maximum(idx, 0)], 0)
            nsel_at = np.where(valid, idx + 1, 0)
            feas = npos_at >= need
            n_neg = max(k - int(labels.sum()), 1)
            f = np.where(feas, (nsel_at - npos_at) / n_neg, np.inf)
            if f.size and f.min() < best_fpr - 1e-12:
                i = int(np.argmin(f))
                best_fpr = float(f[i])
                best_move = (j, float(vals[i]))
        if best_move is not None:
            j, v = best_move
            theta[j] = v
            recall, fpr, sel = _eval(cd, labels, theta)
            improved = True
    return ThresholdResult(theta, fpr, recall, True)


def ordered_conjuncts(cd: np.ndarray, theta: np.ndarray,
                      clauses: list) -> list:
    """Cheapest-and-most-selective-first conjunct order for short-circuit
    CNF evaluation (the classic selectivity ordering for AND chains).

    cd: (k, C) clause distances on the threshold sample (step ⑤'s S′ —
    already computed for threshold selection, so measurement is free);
    theta: (C,) selected thresholds; clauses: the scaffold's clause list
    (cost proxy = clause width, the number of distance planes it min-
    reduces).

    Rank = cost / (1 - pass_rate): the expected planes evaluated per
    rejection if this conjunct goes first.  Pass-everything conjuncts
    (pass_rate ~ 1) reject nothing and sort last.  Ties break by
    (pass_rate, cost, original index) so the order is deterministic.
    Returns a permutation of range(C) — a pure *evaluation* order: the
    conjunction commutes, so the candidate set is invariant under it
    (tests/test_torch_conjunct_order.py proves it on every engine of the
    port on the CPU, tests/test_torch_conjunct_order_cuda.py on the card).
    """
    c = cd.shape[1]
    if c != len(clauses) or theta.shape[0] != c:
        raise ValueError(
            f"clause-distance width {c} disagrees with {len(clauses)} "
            f"clauses / {theta.shape[0]} thresholds")
    if cd.shape[0] == 0:
        return list(range(c))
    rates = (cd <= theta[None, :]).mean(axis=0)
    def rank(ci):
        cost = max(len(clauses[ci]), 1)
        reject = 1.0 - float(rates[ci])
        key = cost / reject if reject > 1e-12 else math.inf
        return (key, float(rates[ci]), cost, ci)
    return sorted(range(c), key=rank)


# ---------------------------------------------------------------------------
# Alg 4 — greedy scaffold construction
# ---------------------------------------------------------------------------

def scaffold_cost(dstack: np.ndarray, labels: np.ndarray, sc: Scaffold,
                  target: float) -> float:
    """Ĉ_S(Π̊): optimistic min-FPR over thresholds (Eq 1)."""
    cd = sc.clause_distances(dstack)
    res = min_fpr_thresholds(cd, labels, target)
    return res.fpr if res.feasible else np.inf


def get_logical_scaffold(dstack: np.ndarray, labels: np.ndarray, target: float,
                         gamma: float = 0.05,
                         max_clauses: Optional[int] = None) -> Scaffold:
    """Alg 4: greedy conjunction growth, then disjunction growth.

    dstack: (k, F) distances for the labeled sample; labels: (k,) bool.
    max_clauses enforces Thm 6.1's r <= 1/(1-T).
    """
    k, f = dstack.shape
    if max_clauses is None:
        max_clauses = max(int(math.floor(1.0 / max(1.0 - target, 1e-9))), 1)
    sc = Scaffold(clauses=[])
    # cost of the empty scaffold: every negative admitted (FPR = 1)
    cur_cost = 1.0
    remaining = list(range(f))

    # conjunctions (Lines 3-12)
    while remaining and sc.n_clauses < max_clauses:
        costs = []
        for phi in remaining:
            cand = Scaffold(clauses=sc.clauses + [[phi]])
            costs.append(scaffold_cost(dstack, labels, cand, target))
        i = int(np.argmin(costs))
        if costs[i] < cur_cost - gamma:
            sc = Scaffold(clauses=sc.clauses + [[remaining[i]]])
            cur_cost = costs[i]
            remaining.pop(i)
        else:
            break

    # disjunctions (Lines 13-18): each (featurization, clause) pair once
    for phi in list(remaining):
        for ci in range(sc.n_clauses):
            cand_clauses = [list(c) for c in sc.clauses]
            cand_clauses[ci] = cand_clauses[ci] + [phi]
            cand = Scaffold(clauses=cand_clauses)
            cost = scaffold_cost(dstack, labels, cand, target)
            if cost < cur_cost - gamma:
                sc = cand
                cur_cost = cost
                break
    return sc
