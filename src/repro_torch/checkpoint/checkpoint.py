"""Checkpointing with atomic writes and rotation, in the reference's format.

Layout:  <dir>/step_<N:08d>/ {manifest.json, arrays.npz}; a checkpoint
becomes visible only when its directory is atomically renamed from a
``.tmp`` staging name, so a crash mid-write can never yield a
readable-but-corrupt checkpoint.  The leaves are stored as ``a0 ... aN`` in
``jax.tree.flatten``'s order (dict keys sorted at every level, tuples and
lists in order, ``None`` an empty subtree), so a checkpoint written by
either package restores in the other.  Tensors are written as numpy arrays
and restored as tensors.  ``restore(mesh=, specs=)`` reshards onto a model
mesh (``distributed/mesh.py``), as the reference's elastic restore does:
each rank reads the whole ``npz`` and keeps its block of each leaf by the
leaf's spec, so a checkpoint written on one world restores onto another.
``gather_tree`` gives the whole leaves back from the blocks, so a world of
more than one rank can write a checkpoint any world restores.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Optional

import numpy as np
import torch


def _flatten(tree: Any, leaf_type: type = None) -> list:
    """The leaves of ``tree`` in ``jax.tree.flatten``'s order (an instance
    of ``leaf_type`` is a leaf, as a ``PartitionSpec`` is one there)."""
    if leaf_type is not None and isinstance(tree, leaf_type):
        return [tree]
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in _flatten(tree[k], leaf_type)]
    if isinstance(tree, (tuple, list)):
        return [l for t in tree for l in _flatten(t, leaf_type)]
    return [tree]


def _unflatten(template: Any, leaves) -> Any:
    """``template``'s structure over ``leaves`` (an iterator), consumed in
    ``_flatten``'s order."""
    if template is None:
        return None
    if isinstance(template, dict):
        out = {k: _unflatten(template[k], leaves) for k in sorted(template)}
        return {k: out[k] for k in template}
    if isinstance(template, (tuple, list)):
        return type(template)(_unflatten(t, leaves) for t in template)
    return next(leaves)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(directory: str, step: int, tree: Any, *, keep: int = 3,
         extra: Optional[dict] = None) -> str:
    """Atomic checkpoint write; returns the final path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves = _flatten(tree)
    arrays = {f"a{i}": _to_numpy(l) for i, l in enumerate(leaves)}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "n_leaves": len(leaves),
        "written_at": time.time(),
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                       # atomic visibility
    _rotate(directory, keep)
    return final


def _rotate(directory: str, keep: int):
    ckpts = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in ckpts[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore(directory: str, template: Any, *, step: Optional[int] = None,
            device=None, mesh=None, specs: Any = None) -> tuple:
    """Restore into the structure of ``template``: every leaf a tensor of
    the stored dtype, on ``device``, or where the template's leaf lies (the
    CPU for a leaf that is no tensor).  Returns (tree, step).  A template
    whose leaf count differs from the checkpoint's raises ``ValueError``.
    With ``mesh`` and ``specs`` (a tree of ``Spec`` in the template's
    structure) every leaf is this rank's block under its spec (the whole
    leaf where the spec shards nothing)."""
    if (mesh is None) != (specs is None):
        raise ValueError("restore onto a mesh takes both mesh= and specs=")
    if step is None:
        step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    targets = _flatten(template)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        if len(targets) != len(data.files):
            raise ValueError(
                f"checkpoint has {len(data.files)} leaves, template {len(targets)}"
                " — incompatible architecture")
        spec_leaves = (_flatten_specs(specs) if mesh is not None
                       else [None] * len(targets))
        if len(spec_leaves) != len(targets):
            raise ValueError(f"specs have {len(spec_leaves)} leaves, "
                             f"template {len(targets)}")
        loaded = []
        for i, (t, spec) in enumerate(zip(targets, spec_leaves)):
            x = torch.from_numpy(data[f"a{i}"])
            if spec is not None:
                from repro_torch.distributed.mesh import shard_leaf
                x = shard_leaf(mesh, x, spec)
            loaded.append(x.to(
                device if device is not None
                else t.device if isinstance(t, torch.Tensor) else "cpu"))
    return _unflatten(template, iter(loaded)), step


def _flatten_specs(specs: Any) -> list:
    """A tree of ``Spec`` leaves in ``_flatten``'s order."""
    from repro_torch.distributed.mesh import Spec
    return _flatten(specs, Spec)


def gather_tree(tree: Any, mesh, specs: Any) -> Any:
    """The whole leaves of a tree of this rank's blocks (every rank calls
    it: an all-gather a sharded dim), in the tree's structure."""
    from repro_torch.distributed.mesh import unshard_leaf
    leaves = [unshard_leaf(mesh, l, s) if isinstance(l, torch.Tensor) else l
              for l, s in zip(_flatten(tree), _flatten_specs(specs))]
    return _unflatten(tree, iter(leaves))
