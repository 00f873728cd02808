"""Plain-torch version of the candidate-compaction kernel.

``compact_append_ref`` computes what ``csrc/extract.cu`` computes, and
what the JAX package's ``engine.extract.compact_append`` computes: the set
bits of a packed (nl, nw) mask, in row-major order and the lowest bit of a
word first, written as (row + row_offset, 32 * w + b + col_offset) int32
pairs into ``buf`` from slot ``count`` on; a pair whose slot is not below
the capacity is dropped, and the returned count (int32) is ``count`` plus
every set bit, never clamped.  ``torch.nonzero`` on the unpacked mask
gives exactly that order, so the buffer is bit-identical to the
reference's.  The kernel's wrapper uses it for tensors on the CPU.
"""

from __future__ import annotations

import torch


def _wrap_int32(x: int) -> int:
    """``x`` as an int32 sum wraps (two's complement)."""
    return (x + 2 ** 31) % 2 ** 32 - 2 ** 31


def compact_append_ref(packed: torch.Tensor, buf: torch.Tensor, count, *,
                       row_offset: int = 0, col_offset: int = 0):
    """packed: int32 (nl, nw) words (bit 31 the sign bit); buf: int32
    (capacity, 2), written in place; count: int or int32 scalar tensor.
    Returns (buf, new_count) with new_count an int32 0-d tensor."""
    nl, nw = packed.shape
    count = int(count)
    dev = packed.device
    shifts = torch.arange(32, dtype=torch.int32, device=dev)
    cursor = count
    # row blocks of at most 2**24 bits bound the expanded temporaries
    step = max(1, (1 << 24) // max(32 * nw, 1))
    for r0 in range(0, nl, step):
        bits = (packed[r0:r0 + step, :, None].to(torch.int32) >> shifts) & 1
        rows, cols = torch.nonzero(bits.reshape(bits.shape[0], nw * 32),
                                   as_tuple=True)
        slots = cursor + torch.arange(rows.numel(), dtype=torch.int64,
                                      device=dev)
        keep = (slots >= 0) & (slots < buf.shape[0])
        pairs = torch.stack([rows + (r0 + row_offset), cols + col_offset],
                            dim=1)
        buf[slots[keep]] = pairs[keep].to(torch.int32)
        cursor += rows.numel()
    return buf, torch.tensor(_wrap_int32(cursor), dtype=torch.int32,
                             device=buf.device)
