"""Every ``torch.distributed`` call of the join engine, with a byte ledger.

The JAX package checks what crosses a pod by parsing the compiled
program's collectives (``distributed/hlo_analysis.py``
``pod_crossing_stats``).  Here the engine's collectives are calls made on
the host, so they are counted as they are made: each goes through this
module, which records its bytes by the kind of group it ran over —

  * ``inner``: within a pod (the gather of candidate counts);
  * ``cross``: across pods (the gather of pod totals);
  * ``pull``:  the world, to the coordinating rank (count and eval
    gathers, and the candidate pairs sent to the coordinator).

The invariant the dry-run gates on (``check_counts_only``):

  * planes and masks never enter a collective: every payload is int32,
    tagged ``counts`` or ``pairs``;
  * across pods, a call carries int32 counts only: one int32 a rank of
    the group;
  * candidate pairs travel once, to the coordinating rank, over the pull
    group, 8 B a pair.

Counts travel as int32 host tensors over ``gloo``: they are on the host
anyway once a band step's 8-byte counter pull lands, and gloo lets several
ranks share one card (NCCL refuses that).  On a group of one rank — every
group of a 1-rank world — a call is its exact local equivalent and is
recorded all the same, so a 1-rank world runs the same code.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

GROUP_KINDS = ("inner", "cross", "pull")
PAYLOADS = ("counts", "pairs")


class CollectiveLedger:
    """Calls and bytes of a mesh's collectives, by (group kind, op,
    payload, ranks in the group).  Aggregated, not logged: a serving
    process makes calls for as long as it runs."""

    def __init__(self):
        self._lock = threading.Lock()   # fleet workers share the host mesh
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._rows: dict = {}

    def record(self, kind: str, op: str, payload: str, nbytes: int,
               ranks: int) -> None:
        """One call: ``nbytes`` moved (a gather's whole result; the bytes
        a point-to-point call sends), ``ranks`` in its group."""
        if kind not in GROUP_KINDS or payload not in PAYLOADS:
            raise ValueError(f"collective over {kind!r} with payload "
                             f"{payload!r}")
        with self._lock:
            row = self._rows.setdefault(
                (kind, op, payload, int(ranks)),
                {"calls": 0, "bytes": 0, "max_call_bytes": 0})
            row["calls"] += 1
            row["bytes"] += int(nbytes)
            row["max_call_bytes"] = max(row["max_call_bytes"], int(nbytes))

    def summary(self) -> dict:
        """By group kind: calls, bytes, largest call, widest group; by
        payload: bytes; ``cross_pod_calls``: calls over a cross group of
        more than one rank (those that cross a pod boundary)."""
        with self._lock:
            rows = {k: dict(v) for k, v in self._rows.items()}
        by_group = {k: {"calls": 0, "bytes": 0, "max_call_bytes": 0,
                        "ranks": 0} for k in GROUP_KINDS}
        by_payload = {p: 0 for p in PAYLOADS}
        cross_calls = 0
        for (kind, _op, payload, ranks), r in rows.items():
            g = by_group[kind]
            g["calls"] += r["calls"]
            g["bytes"] += r["bytes"]
            g["max_call_bytes"] = max(g["max_call_bytes"],
                                      r["max_call_bytes"])
            g["ranks"] = max(g["ranks"], ranks)
            by_payload[payload] += r["bytes"]
            if kind == "cross" and ranks > 1:
                cross_calls += r["calls"]
        return {"by_group": by_group, "by_payload": by_payload,
                "cross_pod_calls": cross_calls,
                "max_cross_call_bytes": by_group["cross"]["max_call_bytes"],
                # one int32 count a rank of the group
                "cross_call_budget_bytes": 4 * by_group["cross"]["ranks"],
                "pairs_outside_pull": sum(
                    r["bytes"] for (kind, _o, p, _n), r in rows.items()
                    if p == "pairs" and kind != "pull"),
                "ops": sorted({f"{k}:{o}:{p}" for k, o, p, _n in rows})}


def check_counts_only(summary: dict) -> list:
    """Findings (strings; empty = the invariant holds) for a ledger
    summary: cross-pod calls count-sized and pairs only over the pull
    group.  (Planes cannot enter: payloads are int32 by ``_int32``; a pair
    is 2 int32 by ``send_pairs`` / ``recv_pairs``.)"""
    out = []
    if summary["max_cross_call_bytes"] > summary["cross_call_budget_bytes"]:
        out.append(f"a cross-pod call moved {summary['max_cross_call_bytes']}"
                   f" B, over the {summary['cross_call_budget_bytes']} B of "
                   f"one int32 a rank")
    if summary["pairs_outside_pull"]:
        out.append(f"{summary['pairs_outside_pull']} B of pairs outside the "
                   f"pull group")
    return out


def _int32(values) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(values))
    if t.dtype != torch.int32:
        # planes (f32) and anything else stay out of collectives
        raise TypeError(f"collective payloads are int32, got {t.dtype}")
    return t.reshape(-1).contiguous()


def all_gather(values, mesh, kind: str) -> np.ndarray:
    """All-gather int32 ``values`` (one per field) over this rank's
    ``kind`` group; returns int32 (group ranks, fields), in group rank
    order."""
    t = _int32(values)
    ranks = mesh.group_ranks(kind)
    group = mesh.group(kind)
    if group is None:                  # a 1-rank group: the local copy
        out = t.numpy().reshape(1, -1).copy()
    else:
        import torch.distributed as dist
        parts = [torch.empty_like(t) for _ in ranks]
        dist.all_gather(parts, t, group=group)
        out = torch.stack(parts).numpy()
    mesh.ledger.record(kind, "all_gather", "counts", out.nbytes, len(ranks))
    return out


def send_pairs(pairs: np.ndarray, mesh) -> None:
    """Send this rank's (n, 2) int32 candidate pairs to the coordinator
    over the pull group (n is known there from the gathered counts).  The
    sender records what it sent, the coordinator what it received."""
    import torch.distributed as dist
    t = _int32(pairs)
    dist.send(t, dst=mesh.coordinator, group=mesh.pull)
    mesh.ledger.record("pull", "send", "pairs", t.numel() * 4,
                       len(mesh.pull_ranks))


def recv_pairs(n: int, src: int, mesh) -> np.ndarray:
    """Receive rank ``src``'s ``n`` candidate pairs on the coordinator."""
    import torch.distributed as dist
    t = torch.empty(2 * n, dtype=torch.int32)
    dist.recv(t, src=src, group=mesh.pull)
    mesh.ledger.record("pull", "recv", "pairs", t.numel() * 4,
                       len(mesh.pull_ranks))
    return t.numpy().reshape(n, 2)
