"""Plain-torch version of the threshold-sweep kernel.

For G candidate threshold rows over k labeled sample rows of C clause
distances: ``pos[g] = sum_i valid_i * label_i * AND_c(cd[i,c] <= th[g,c])``
and ``sel[g] = sum_i valid_i * AND_c(...)``.  Labels and ``valid`` are 0/1;
any nonzero value counts as 1.  Pad rows must be excluded by ``valid``,
never by sentinel distances: ``inf <= inf`` is true.

Counts are exact integers (int32 output, int64 accumulation).  k is
walked in chunks so the (G, chunk, C) compare never holds more than about
2**26 elements at once.
"""

from __future__ import annotations

import torch

_CHUNK_ELEMS = 1 << 26


def threshold_sweep_ref(cd: torch.Tensor, labels: torch.Tensor,
                        thetas: torch.Tensor, valid=None) -> torch.Tensor:
    """cd: (k, C); labels: (k,); thetas: (G, C); valid: (k,) or None.
    Returns int32 (G, 2): [:, 0] positives, [:, 1] selected."""
    k, c = cd.shape
    g = thetas.shape[0]
    w_sel = (valid != 0) if valid is not None else \
        torch.ones(k, dtype=torch.bool, device=cd.device)
    w_pos = w_sel & (labels != 0)
    pos = torch.zeros(g, dtype=torch.int64, device=cd.device)
    sel = torch.zeros(g, dtype=torch.int64, device=cd.device)
    step = max(1, _CHUNK_ELEMS // max(g * max(c, 1), 1))
    for s in range(0, k, step):
        ok = (cd[None, s:s + step, :] <= thetas[:, None, :]).all(dim=-1)
        sel += (ok & w_sel[None, s:s + step]).sum(dim=1)
        pos += (ok & w_pos[None, s:s + step]).sum(dim=1)
    return torch.stack([pos, sel], dim=1).to(torch.int32)
