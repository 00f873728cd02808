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

The multi-device prefix sum of the reference (``hierarchical_offsets``)
is not here: on one device a step's global base is the 1-rank exclusive
prefix sum, 0, which ``engine.sharded`` computes and pulls all the same.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.extract.kernel import compact_append

__all__ = ["compact_append", "extract_pairs", "grow_caps"]

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
