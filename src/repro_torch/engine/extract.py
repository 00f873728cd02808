"""On-device candidate extraction from the packed CNF bitmask, on PyTorch.

The fused kernel emits an int32 mask packed 32 R-neighbours per word.
Pulling that mask to the host costs n_l·n_r/8 bytes regardless of how few
pairs survive — at corpus scale the transfer, not the kernel, dominates.
``compact_append`` turns the mask into a dense buffer of (i, j) index
pairs *on the device* (popcount, exclusive prefix sum over words in
row-major order, a scatter of each set bit to its slot): the hand-written
kernel ``csrc/extract.cu`` on CUDA tensors, its plain-torch version on CPU
tensors (``kernels/extract``).

The buffer has a fixed capacity; overflow is *detected, never silent* —
the returned count keeps growing past capacity, so the caller compares
count vs capacity and retries bigger.  Host traffic becomes
O(candidates): one scalar count plus 8 bytes per surviving pair.

``hierarchical_offsets`` gives a rank of the join mesh the global base of
its candidates, from int32 counts on the host: within the pod first, then
across pods.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.extract.kernel import compact_append

__all__ = ["compact_append", "extract_pairs", "grow_caps",
           "hierarchical_offsets"]

_CAP_QUANTUM = 1024                    # capacities round up to this


def grow_caps(caps, counts):
    """Per-shard capacity growth after an overflowed step (DESIGN.md §3).

    caps:   int array, one sweep-carried capacity per shard; counts: that
            step's exact per-shard candidate counts (``compact_append``
            never clamps, so they are true totals).

    Only shards whose count exceeded their capacity grow — each to
    ``max(4 * its own capacity, count rounded up to 1 KiB of rows)``.  The
    ≥4× rule bounds retries per shard.  Returns a new array; input caps
    are never shrunk.
    """
    caps = np.asarray(caps, np.int64)
    counts = np.asarray(counts, np.int64)
    need = -(-counts // _CAP_QUANTUM) * _CAP_QUANTUM
    return np.where(counts > caps, np.maximum(4 * caps, need), caps)


def hierarchical_offsets(count: int, mesh):
    """Global exclusive offset of this rank's candidates, prefix-summed
    hierarchically: within the pod first, then across pods.

    count: this rank's candidate count (host int); mesh: the
    ``distributed.mesh.JoinMesh`` the rank belongs to.

    Two collectives, both over *counts only* (``distributed.collectives``):

      1. an all-gather of ``count`` over the pod's ranks (``inner``), one
         int32 a rank; the exclusive cumsum at the rank's inner index is
         its base inside the pod;
      2. an all-gather of the pod total over the ``cross`` group, one
         int32 a pod — the **only cross-pod collective of the engine**:
         links between pods carry candidate counts, never planes or masks.
         Skipped on a mesh without a pod axis.

    Returns (global base int, pod_counts int32 (ranks of the pod,)).
    """
    from repro_torch.distributed import collectives
    pod_counts = collectives.all_gather(
        np.array([count], np.int32), mesh, "inner").reshape(-1)
    excl = np.cumsum(pod_counts) - pod_counts
    base = int(excl[mesh.inner_index])
    if "pod" not in mesh.axis_names:
        return base, pod_counts
    totals = collectives.all_gather(
        np.array([pod_counts.sum()], np.int32), mesh, "cross").reshape(-1)
    pod_base = int((np.cumsum(totals) - totals)[mesh.pod])
    return pod_base + base, pod_counts


def extract_pairs(packed, *, capacity, row_offset=0, col_offset=0):
    """One-shot compaction of a packed mask into a fresh buffer on the
    mask's device.

    Returns (buf int32 (capacity, 2), count int32 0-d).  Entries past
    ``count`` are -1 filler; count > capacity signals overflow (see
    compact_append).
    """
    buf = torch.full((capacity, 2), -1, dtype=torch.int32,
                     device=packed.device)
    return compact_append(packed, buf, 0, row_offset=row_offset,
                          col_offset=col_offset)
