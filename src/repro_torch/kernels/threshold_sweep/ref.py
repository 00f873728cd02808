"""Plain-torch versions of the threshold-sweep kernels.

For G candidate threshold rows over k labeled sample rows of C clause
distances: ``pos[g] = sum_i valid_i * label_i * AND_c(cd[i,c] <= th[g,c])``
and ``sel[g] = sum_i valid_i * AND_c(...)``.  Labels and ``valid`` are 0/1;
any nonzero value counts as 1.  Pad rows must be excluded by ``valid``,
never by sentinel distances: ``inf <= inf`` is true.

``threshold_sweep_ref`` compares every sample row with every threshold
row (the direct route); it is the oracle of both routes.
``threshold_sweep_ranked_ref`` is the ranked route: a sample row's
pass/fail against every threshold row depends only on its rank among each
clause's distinct threshold values, so the counts are a histogram over
rank vectors followed by an inclusive prefix along every clause.

Counts are exact integers (int32 output, int64 accumulation).  The
direct route walks k in chunks so the (G, chunk, C) compare never holds
more than about 2**26 elements at once.
"""

from __future__ import annotations

import math

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


def threshold_sweep_ranked_ref(cd: torch.Tensor, labels: torch.Tensor,
                               thetas: torch.Tensor, valid, axes) -> torch.Tensor:
    """The ranked route.  ``axes = (values, offsets)``: clause c's axis is
    ``values[offsets[c]:offsets[c + 1]]``, the sorted distinct non-NaN
    values of ``thetas[:, c]`` with -0.0 merged into +0.0
    (``ops.rank_axes``).

    A sample row with r_c = #(axis_c < cd[i, c]) passes threshold row g iff
    r_c <= j_c for every c, where axis_c[j_c] = thetas[g, c].  Rows with a
    NaN distance, or a distance above every axis value, pass nothing and
    are dropped; a threshold row with a NaN passes nothing.  A threshold
    missing from its axis gives (-1, -1), never a wrong count.
    Returns int32 (G, 2) like ``threshold_sweep_ref``."""
    values, offsets = axes
    k, c = cd.shape
    g = thetas.shape[0]
    off = [int(o) for o in offsets]
    u = [off[j + 1] - off[j] for j in range(c)]
    bins = math.prod(u)
    out = torch.zeros((g, 2), dtype=torch.int32, device=cd.device)
    if bins == 0:                # an all-NaN column: every row passes nothing
        return out
    keep = (valid != 0) if valid is not None else \
        torch.ones(k, dtype=torch.bool, device=cd.device)
    row_bin = torch.zeros(k, dtype=torch.int64, device=cd.device)
    th_bin = torch.zeros(g, dtype=torch.int64, device=cd.device)
    th_nan = torch.zeros(g, dtype=torch.bool, device=cd.device)
    th_found = torch.ones(g, dtype=torch.bool, device=cd.device)
    for j in range(c):
        axis = values[off[j]:off[j + 1]]
        x = cd[:, j].contiguous()
        r = torch.searchsorted(axis, x, side="left")
        keep &= ~torch.isnan(x) & (r < u[j])
        row_bin = row_bin * u[j] + r
        t = thetas[:, j].contiguous()
        jj = torch.searchsorted(axis, t, side="left").clamp(max=u[j] - 1)
        th_nan |= torch.isnan(t)
        th_found &= axis[jj] == t
        th_bin = th_bin * u[j] + jj
    keep_pos = keep & (labels != 0)
    table = torch.stack([torch.bincount(row_bin[keep_pos], minlength=bins),
                         torch.bincount(row_bin[keep], minlength=bins)], dim=1)
    table = table.view(*u, 2)
    for j in range(c):
        table = table.cumsum(dim=j)
    counts = table.reshape(bins, 2)[th_bin].to(torch.int32)
    out = torch.where(th_found[:, None], counts, torch.full_like(counts, -1))
    return torch.where(th_nan[:, None], torch.zeros_like(out), out)
