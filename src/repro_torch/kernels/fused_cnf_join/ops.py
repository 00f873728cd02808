"""Host packing + corpus loop for the fused CNF-join kernel.

``pack_features`` converts a list of core ``FeatureData`` (+ scaffold clause
structure) into the kernel's array layout, padding record counts to tile
multiples and embedding dims to a lane multiple (128).
``pack_features_device`` writes the same layout on the device from the
resident per-feature planes of a ``serving.planes.DevicePlaneSet``.
``stage_planes`` puts the kernel's inputs on the evaluation device: a
host pack and upload, or the device-side assembly with no upload; with a
join mesh, each rank keeps its L shard and all of R.
``evaluate_corpus_stream`` is the engine behind ``engine="cuda"``: it runs
the kernel one L-row strip at a time and yields each strip's candidate
pairs (the plain-torch version when the device is the CPU).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.fused_cnf_join import ref
from repro_torch.kernels.fused_cnf_join.kernel import SCAL, VEC, cnf_join_block


def _pad_to(x: np.ndarray, n: int, axis: int, value: float) -> np.ndarray:
    pad = n - x.shape[axis]
    if pad <= 0:
        return x
    width = [(0, 0)] * x.ndim
    width[axis] = (0, pad)
    return np.pad(x, width, constant_values=value)


def pack_features(feats: Sequence, clauses: Sequence, *, tl: int, tr: int,
                  lane: int = 128):
    """Returns (emb_l, emb_r, scal_l, scal_r, kclauses, n_l, n_r).

    Padded L rows are marked missing (distance 1 to everything) so they can
    never produce spurious matches; padded R likewise.
    """
    kclauses, vec_ids, scal_ids = _clause_layout(feats, clauses)
    used = sorted({f for c in clauses for f in c})
    vmap = {f: i for i, f in enumerate(vec_ids)}

    n_l = feats[used[0]].data_l.shape[0]
    n_r = feats[used[0]].data_r.shape[0]
    pl_n = -(-n_l // tl) * tl
    pr_n = -(-n_r // tr) * tr
    d_max = max([feats[f].data_l.shape[1] for f in vec_ids], default=lane)
    d_pad = -(-d_max // lane) * lane

    if vec_ids:
        emb_l = np.zeros((len(vec_ids), pl_n, d_pad), np.float32)
        emb_r = np.zeros((len(vec_ids), pr_n, d_pad), np.float32)
        for f in vec_ids:
            dl, dr = feats[f].data_l, feats[f].data_r
            emb_l[vmap[f], : n_l, : dl.shape[1]] = dl
            emb_r[vmap[f], : n_r, : dr.shape[1]] = dr
            # padded rows: missing markers [.., m=-2, 1] / [.., 1, m=-2]
            emb_l[vmap[f], n_l:, dl.shape[1] - 2] = -2.0
            emb_l[vmap[f], n_l:, dl.shape[1] - 1] = 1.0
            emb_r[vmap[f], n_r:, dr.shape[1] - 2] = 1.0
            emb_r[vmap[f], n_r:, dr.shape[1] - 1] = -2.0
    else:
        emb_l = np.zeros((1, pl_n, d_pad), np.float32)
        emb_r = np.zeros((1, pr_n, d_pad), np.float32)

    if scal_ids:
        scal_l = np.stack([_pad_to(feats[f].data_l.astype(np.float32), pl_n, 0, 1e9)
                           for f in scal_ids])
        scal_r = np.stack([_pad_to(feats[f].data_r.astype(np.float32), pr_n, 0, -1e9)
                           for f in scal_ids])
    else:
        scal_l = np.full((1, pl_n), 1e9, np.float32)
        scal_r = np.full((1, pr_n), -1e9, np.float32)
    return emb_l, emb_r, scal_l, scal_r, kclauses, n_l, n_r


def _clause_layout(feats: Sequence, clauses: Sequence):
    """Kernel-facing clause structure: (kclauses, vec_ids, scal_ids) with
    featurization indices remapped into the packed embed/scalar stacks."""
    used = sorted({f for c in clauses for f in c})
    vec_ids = [f for f in used if feats[f].kind == "embed"]
    scal_ids = [f for f in used if feats[f].kind == "scalar"]
    vmap = {f: i for i, f in enumerate(vec_ids)}
    smap = {f: i for i, f in enumerate(scal_ids)}
    kclauses = tuple(
        tuple((VEC, vmap[f]) if feats[f].kind == "embed" else (SCAL, smap[f])
              for f in c)
        for c in clauses)
    return kclauses, vec_ids, scal_ids


def _pad_embed_device(dst: torch.Tensor, x: torch.Tensor, side: str) -> None:
    """Write plane ``x`` (n, d) into ``dst`` (pl_n, d_pad, zeros): the
    device-side equivalent of pack_features' embed padding.  Pad rows
    carry the missing markers [m=-2, 1] (L) / [1, m=-2] (R) in the last
    two *pre-padding* columns, so they can never match below theta=1."""
    n, d = x.shape
    dst[:n, :d] = x
    if dst.shape[0] > n:
        lo, hi = (-2.0, 1.0) if side == "l" else (1.0, -2.0)
        dst[n:, d - 2] = lo
        dst[n:, d - 1] = hi


def pack_features_device(planes, clauses: Sequence, *, tl: int, tr: int,
                         lane: int = 128):
    """``pack_features`` assembled on the planes' device from resident
    per-feature tensors (serving.planes.DevicePlaneSet) — zero host->device
    plane bytes.

    Writes the identical values as the host path (padding is constant
    writes, copies do no arithmetic), so kernel outputs are bit-identical
    whichever path staged the planes.  The result is always new
    contiguous tensors, whatever views the plane set holds
    (``slice_r``).  Assemblies are memoized on the plane set (keyed by
    used features + padded geometry) so repeated warm queries skip the
    reshuffle entirely.
    """
    kclauses, vec_ids, scal_ids = _clause_layout(planes, clauses)
    used = sorted({f for c in clauses for f in c})
    n_l = planes[used[0]].data_l.shape[0]
    n_r = planes[used[0]].data_r.shape[0]
    pl_n = -(-n_l // tl) * tl
    pr_n = -(-n_r // tr) * tr
    d_max = max([planes[f].data_l.shape[1] for f in vec_ids], default=lane)
    d_pad = -(-d_max // lane) * lane

    cache = getattr(planes, "pack_cache", None)
    key = (tuple(used), pl_n, pr_n, d_pad)
    if cache is not None and key in cache:
        emb_l, emb_r, scal_l, scal_r = cache[key]
        return emb_l, emb_r, scal_l, scal_r, kclauses, n_l, n_r

    dev = planes.device
    f32 = torch.float32
    emb_l = torch.zeros((max(len(vec_ids), 1), pl_n, d_pad), dtype=f32,
                        device=dev)
    emb_r = torch.zeros((max(len(vec_ids), 1), pr_n, d_pad), dtype=f32,
                        device=dev)
    for i, f in enumerate(vec_ids):
        _pad_embed_device(emb_l[i], planes.device_l(f), "l")
        _pad_embed_device(emb_r[i], planes.device_r(f), "r")
    # scalar pad rows hold 1e9 (L) / -1e9 (R), as pack_features pads them
    scal_l = torch.full((max(len(scal_ids), 1), pl_n), 1e9, dtype=f32,
                        device=dev)
    scal_r = torch.full((max(len(scal_ids), 1), pr_n), -1e9, dtype=f32,
                        device=dev)
    for i, f in enumerate(scal_ids):
        scal_l[i, :n_l] = planes.device_l(f)
        scal_r[i, :n_r] = planes.device_r(f)
    if cache is not None:
        cache[key] = (emb_l, emb_r, scal_l, scal_r)
    return emb_l, emb_r, scal_l, scal_r, kclauses, n_l, n_r


@dataclasses.dataclass(eq=False)
class StagedPlanes:
    """Kernel inputs on the evaluation device plus the transfer accounting
    for how they got there (``bytes_h2d``: host to device;
    ``bytes_reshard``: laying resident planes out on a mesh — 0 on warm
    queries).  With a mesh, ``emb_l`` / ``scal_l`` hold this rank's L
    shard; ``n_l`` / ``n_r`` are the corpus's."""
    emb_l: torch.Tensor
    emb_r: torch.Tensor
    scal_l: torch.Tensor
    scal_r: torch.Tensor
    kclauses: tuple
    n_l: int
    n_r: int
    bytes_h2d: int = 0
    bytes_reshard: int = 0

    @property
    def arrays(self) -> tuple:
        return (self.emb_l, self.emb_r, self.scal_l, self.scal_r)


def shard_rows(mesh, l_axes: tuple, rows: int) -> tuple:
    """(first row, rows) of this rank's L shard when ``rows`` (a multiple
    of the shard count) are split over the mesh axes ``l_axes``."""
    shard, n = 0, 1
    for a in l_axes:
        shard = shard * mesh.shape[a] + mesh.coords[a]
        n *= mesh.shape[a]
    per = rows // n
    return shard * per, per


def _place_on_mesh(arrays, mesh, l_axes: tuple):
    """Lay the assembled planes out on the mesh: this rank keeps its L
    shard (a copy of its rows) and all of R.  Counts the reference's
    reshard bytes: an array laid out anew counts its global ``nbytes``
    once; on a 1-rank world every array is already laid out (0)."""
    if mesh.size == 1:
        return tuple(arrays), 0
    emb_l, emb_r, scal_l, scal_r = arrays
    row0, rows = shard_rows(mesh, l_axes, emb_l.shape[1])
    moved = sum(a.numel() * a.element_size() for a in arrays)
    return (emb_l[:, row0:row0 + rows].clone(), emb_r,
            scal_l[:, row0:row0 + rows].clone(), scal_r), moved


def stage_planes(feats: Sequence, clauses: Sequence, *, tl: int, tr: int,
                 lane: int = 128, device="cuda", mesh=None,
                 l_axes: tuple = ("data",)) -> StagedPlanes:
    """Stage feature planes for the kernel on ``device``, preferring
    device residency.

    A plain ``FeatureData`` list is packed on the host and uploaded
    (``bytes_h2d`` = packed bytes, as the reference counts it on any
    backend); a plane set exposing ``device_l``/``device_r``
    (serving.planes.DevicePlaneSet) is assembled on its own device from
    the resident tensors (``bytes_h2d`` = 0).  Resident planes on another
    device than ``device`` raise: they are never moved silently.

    With ``mesh`` (a ``distributed.mesh.JoinMesh``; ``tl`` a multiple of
    the L shard count) the rank keeps only its L shard over ``l_axes``,
    and all of R.  The host path uploads the shard alone (``bytes_h2d``
    stays the packed bytes, the reference's count); the resident path pays
    a one-time reshard (``bytes_reshard``, see ``_place_on_mesh``) whose
    result is memoized on the plane set's ``pack_cache`` under
    ``("mesh", used, shapes, mesh, l_axes)``, so warm queries report 0.
    """
    dev = resolve_device(device)
    l_axes = tuple(l_axes)
    if hasattr(feats, "device_l") and hasattr(feats, "device_r"):
        have = feats.device
        if have.type != dev.type or dev.index not in (None, have.index):
            raise ValueError(
                f"stage_planes: planes are resident on {have}, but the "
                f"evaluation device is {dev}")
        emb_l, emb_r, scal_l, scal_r, kclauses, n_l, n_r = \
            pack_features_device(feats, clauses, tl=tl, tr=tr, lane=lane)
        staged = StagedPlanes(emb_l, emb_r, scal_l, scal_r, kclauses, n_l,
                              n_r)
        if mesh is None:
            return staged
        cache = getattr(feats, "pack_cache", None)
        used = tuple(sorted({f for c in clauses for f in c}))
        mkey = ("mesh", used, tuple(emb_l.shape), tuple(emb_r.shape), mesh,
                l_axes)
        if cache is not None and mkey in cache:
            return dataclasses.replace(staged, **dict(zip(
                ("emb_l", "emb_r", "scal_l", "scal_r"), cache[mkey])))
        arrays, moved = _place_on_mesh(staged.arrays, mesh, l_axes)
        if cache is not None:
            cache[mkey] = arrays
        return StagedPlanes(*arrays, kclauses, n_l, n_r, bytes_reshard=moved)
    emb_l, emb_r, scal_l, scal_r, kclauses, n_l, n_r = pack_features(
        feats, clauses, tl=tl, tr=tr, lane=lane)
    h2d = emb_l.nbytes + emb_r.nbytes + scal_l.nbytes + scal_r.nbytes
    if mesh is not None:
        row0, rows = shard_rows(mesh, l_axes, emb_l.shape[1])
        emb_l = emb_l[:, row0:row0 + rows]
        scal_l = scal_l[:, row0:row0 + rows]
    arrays = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                   for a in (emb_l, emb_r, scal_l, scal_r))
    return StagedPlanes(*arrays, kclauses, n_l, n_r, bytes_h2d=h2d)


def evaluate_corpus(feats: Sequence, clauses: Sequence, thetas,
                    *, tl: int = 256, tr: int = 512, device="cuda",
                    return_mask_bytes: bool = False):
    """Full-corpus CNF evaluation through the kernel; returns [(i, j), ...]
    (and the device->host mask bytes with ``return_mask_bytes``)."""
    pairs: list = []
    mask_bytes = 0
    for delta in evaluate_corpus_stream(
            feats, clauses, thetas, tl=tl, tr=tr, l_block=None,
            device=device):
        pairs.extend(delta.pairs)
        mask_bytes += delta.bytes_to_host
    if return_mask_bytes:
        return pairs, mask_bytes
    return pairs


def evaluate_corpus_stream(feats: Sequence, clauses: Sequence, thetas,
                           *, tl: int = 256, tr: int = 512,
                           l_block=None, early_reject: bool = True,
                           device="cuda"):
    """Streaming corpus evaluation: yields an ``engine.base.ChunkDelta`` per
    L-row block.

    Features are staged once (host pack + upload, or assembled from
    device-resident planes with zero H2D — see ``stage_planes``); the
    kernel then grids one ``l_block``-row
    strip at a time (``l_block`` a multiple of ``tl``, default one whole
    pass).  Each strip's packed mask is pulled and unpacked immediately,
    so candidates for early rows reach the consumer while later strips
    are still to run.  The one-time plane upload is attributed to the
    first emitted block.  The per-tile eval counts are pulled with the
    mask and charged to the chunk (``conjunct_evals``, in pair-clause
    units over padded tiles).
    """
    from repro_torch.engine.base import ChunkDelta
    from repro_torch.obs.trace import current_tracer
    tracer = current_tracer()
    staged = stage_planes(feats, clauses, tl=tl, tr=tr, device=device)
    demb_l, demb_r, dscal_l, dscal_r = staged.arrays
    kclauses, n_l, n_r, h2d = (staged.kclauses, staged.n_l, staged.n_r,
                               staged.bytes_h2d)
    pl_n, pr_n = demb_l.shape[1], demb_r.shape[1]
    if l_block is None:
        l_block = pl_n
    if l_block % tl != 0:
        raise ValueError(f"l_block={l_block} must be a multiple of tl={tl}")
    thetas = tuple(float(t) for t in thetas)
    for i0 in range(0, pl_n, l_block):
        rows = min(l_block, pl_n - i0)
        t0 = time.perf_counter()
        packed, evals_grid = cnf_join_block(
            demb_l[:, i0:i0 + rows], demb_r, dscal_l[:, i0:i0 + rows], dscal_r,
            kclauses, thetas, tl=tl, tr=tr, early_reject=early_reject,
            with_evals=True)
        t1 = time.perf_counter()
        host_mask = packed.cpu().numpy().view(np.uint32)  # O(rows*n_r/8) pull
        evals_host = evals_grid.cpu().numpy()              # one int32 per tile
        t2 = time.perf_counter()
        ok = ref.unpack_mask(host_mask, pr_n)[: max(n_l - i0, 0), :n_r]
        ii, jj = np.nonzero(ok)
        # trace sub-slices only: the kernel call vs the blocking mask pull.
        # Deliberately NOT named dispatch/pull — this backend's EngineStats
        # carries no dispatch/pull walls.
        trace = None
        if tracer:
            trace = [
                {"name": "kernel", "t0": t0, "t1": t1,
                 "attrs": {"rows": rows}},
                {"name": "mask_pull", "t0": t1, "t1": t2,
                 "attrs": {"bytes": host_mask.nbytes + evals_host.nbytes}},
            ]
        yield ChunkDelta(
            list(zip((ii + i0).tolist(), jj.tolist())),
            bytes_to_host=host_mask.nbytes + evals_host.nbytes,
            bytes_h2d=h2d if i0 == 0 else 0,
            conjunct_evals=int(evals_host.sum()) * tl * tr,
            trace=trace)
