"""Dry-run cells: (architecture x input shape x mesh) -> the port's step
function and its arguments for one rank of the mesh.

The reference builds each cell as a jitted step and ``ShapeDtypeStruct``
stand-ins with a ``NamedSharding`` each, for its compiler to lower over
the whole mesh.  The port has no compiler; a rank runs its own step on
its own blocks (``models/transformer.py``), so a cell here is one rank's:

  * ``fn``: ``make_train_step`` / ``make_prefill_step`` /
    ``make_decode_step`` over the mesh (always passed: the blocks need it;
    ``use_ep`` as the reference's);
  * ``abstract_args``: a ``Transformer`` holding this rank's blocks of the
    parameters (``mesh_specs``, in the reference's dtypes: f32 masters),
    then for a train cell the AdamW state on the parameters' blocks, the
    batch (whole: every rank of the port's step takes the whole batch and
    slices its rows), and for a decode cell this rank's block of the state
    (``init_state(mesh=)``).  Over an ``AbstractMesh``
    (``make_production_mesh(abstract=True)``) every tensor is on the
    ``meta`` device: no storage, so the production mesh's cells of the
    largest configs build in a process; over a real mesh they are on
    ``device`` (``weights``, when given, loaded into the blocks);
  * ``specs``: every argument leaf of the reference's cell, named by its
    path in the reference's trees (``params/<leaf path>``,
    ``opt/m/<leaf path>``, ``opt/v/...``, ``opt/step``, ``batch/<input>``,
    ``state/<leaf path>``), as a ``Leaf``: its global shape, dtype and
    ``Spec``, and the block this rank holds, its ``NamedSharding``'s
    ``shard_shape``; ``argument_bytes`` sums the blocks, which is the
    reference's per-device argument size.

Departures, all forced by running the rank's own step: no
``sp_constraint`` (the port's activations are whole between blocks, so
there is no layout to constrain); ``mla_absorb`` is taken and, as in the
reference, passed nowhere; ``param_cast`` is set on the config, and the
port's path is the same either way (each block reads its weights in the
compute dtype before it gathers them, ``layers.use_block``); an MoE config
over a mesh of more than one rank runs expert-parallel only
(``use_ep=False`` raises).  A shape is a name of ``SHAPES`` or, for a cell
at a size of one's own, a ``ShapeConfig``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.common.config import (BlockKind, FFNKind, ModelConfig,
                                       SHAPES, ShapeConfig, TrainConfig)
from repro_torch.configs import LONG_CONTEXT_ARCHS, get_config
from repro_torch.distributed.mesh import (AxisEnv, Spec, axis_size,
                                          batch_spec, block_shape, shard_leaf)
from repro_torch.models import steps, transformer
from repro_torch.models.layers import tree_leaves
from repro_torch.optim import adamw


@dataclasses.dataclass(frozen=True)
class Leaf:
    """An argument leaf of a cell: its global ``shape``, ``dtype`` (a
    torch dtype's name), ``spec`` and the ``block`` one rank holds."""
    shape: tuple
    dtype: str
    spec: Spec
    block: tuple

    @property
    def block_bytes(self) -> int:
        return int(np.prod(self.block, dtype=np.int64)) * torch.empty(
            (), dtype=getattr(torch, self.dtype)).element_size()


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    fn: object                   # fn(*abstract_args) runs this rank's step
    abstract_args: tuple
    cfg: ModelConfig
    note: str = ""
    specs: dict = dataclasses.field(default_factory=dict)   # name -> Leaf
    mesh: object = None
    kind: str = ""               # train | prefill | decode
    use_ep: bool = False


def cell_supported(arch: str, shape: str) -> tuple:
    """(supported, reason)."""
    if shape == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
        return False, "long_500k requires sub-quadratic mixing (skip: full attention)"
    return True, ""


def tp_pad_config(cfg: ModelConfig, tp: int) -> ModelConfig:
    """Function-preserving head padding for tensor parallelism.

    Q heads are zero-padded to a multiple of tp (padded heads have null
    output projections ⇒ identical function); KV heads are value-duplicated
    to a multiple of tp (standard KV replication when tp > n_kv) with the
    GQA group mapping preserved.  Archs without attention blocks are
    untouched (their TP lands on head_dim/inner dims instead).  The
    weights that keep the function are ``tp_pad_weights``'."""
    if tp <= 1:
        return cfg
    kinds = set(cfg.pattern)
    if not ({"attn", "cross_attn", "mla"} & kinds):
        return cfg
    nh, nkv = cfg.num_heads, cfg.num_kv_heads
    nh2 = -(-nh // tp) * tp
    if "mla" in kinds:
        nkv2 = nkv if nh2 == nh else nh2       # MLA: latent cache, per-q heads
    else:
        nkv2 = nkv if nkv % tp == 0 else -(-nkv // tp) * tp
        if nh2 % nkv2:
            nkv2 = nh2                          # degenerate to MHA padding
    if nh2 == nh and nkv2 == nkv:
        return cfg
    return dataclasses.replace(cfg, num_heads=nh2, num_kv_heads=nkv2)


def head_layout(h: int, kv: int, h2: int, kv2: int) -> tuple:
    """(q_src, kv_src): for each of the ``h2`` padded query heads the
    original query head it holds, and for each of the ``kv2`` padded KV
    slots the original KV head it holds (-1: a zero head).

    Attention maps query head ``p`` to KV slot ``p // (h2 / kv2)``, so a
    group size that changes cannot keep the heads in place (phi4-mini at
    tp 16: (24, 8) -> (32, 16), groups of 3 -> 2).  Each original KV head
    ``j`` takes ``r`` adjacent slots (``kv2 / kv`` where that divides, else
    as few as hold its group), a copy of it in each, and its ``h / kv``
    query heads fill the first query positions of those slots in order;
    the positions left, and the slots left, are zero heads."""
    g, g2 = h // kv, h2 // kv2
    r = kv2 // kv if kv2 % kv == 0 else -(-g // g2)
    if r * g2 < g or r * kv > kv2:
        raise ValueError(f"heads ({h}, {kv}) do not fit ({h2}, {kv2}) with "
                         f"the group map kept")
    q_src, kv_src = [-1] * h2, [-1] * kv2
    for j in range(kv):
        for t in range(r):
            kv_src[j * r + t] = j
        for i in range(g):
            q_src[j * r * g2 + i] = j * g + i
    return q_src, kv_src


def _take(w: torch.Tensor, dim: int, src: list) -> torch.Tensor:
    """w's slices on ``dim`` in the order of ``src``, a zero slice for
    -1."""
    idx = torch.tensor([max(s, 0) for s in src], device=w.device)
    keep = torch.tensor([s >= 0 for s in src], device=w.device)
    shape = [1] * w.ndim
    shape[dim] = len(src)
    return torch.where(keep.view(shape), w.index_select(dim, idx),
                       torch.zeros((), dtype=w.dtype, device=w.device))


def tp_pad_weights(cfg: ModelConfig, weights: dict, tp: int) -> tuple:
    """(``tp_pad_config(cfg, tp)``, the weights that give it ``cfg``'s
    function): ``weights`` are a whole model's (world 1, keyed as
    ``weights_from_tree`` keys them).  GQA and cross-attention layers lay
    their heads out by ``head_layout``: ``wq`` (d, H, hd) and ``wo`` (H,
    hd, d) take the query layout (a zero head: zero ``wq`` columns and
    zero ``wo`` rows, so it adds nothing), ``wk`` / ``wv`` the KV slots
    (each KV head duplicated into its slots).  An MLA layer's heads are
    zero-padded at the end (``wq`` or ``w_uq``, ``w_uk``, ``w_uv``, and
    ``wo``'s rows); its latent is whole over heads.  Every other leaf is
    the same tensor."""
    cfg2 = tp_pad_config(cfg, tp)
    if cfg2 is cfg:
        return cfg, dict(weights)
    if cfg2.resolved_head_dim != cfg.resolved_head_dim:
        raise ValueError(f"{cfg.name}: padding the heads changes the head "
                         f"dim ({cfg.resolved_head_dim} -> "
                         f"{cfg2.resolved_head_dim}); give head_dim")
    h, kv, h2, kv2 = (cfg.num_heads, cfg.num_kv_heads, cfg2.num_heads,
                      cfg2.num_kv_heads)
    out = dict(weights)
    for i, (kind, _) in enumerate(transformer.plan_segments(cfg).layers):
        pre = f"layers.{i}.attn."
        if kind in (BlockKind.ATTN.value, BlockKind.CROSS_ATTN.value):
            q_src, kv_src = head_layout(h, kv, h2, kv2)
            for name, dim, src in (("wq", 1, q_src), ("wk", 1, kv_src),
                                   ("wv", 1, kv_src), ("wo", 0, q_src)):
                out[pre + name] = _take(weights[pre + name], dim, src)
        elif kind == BlockKind.MLA.value:
            q_src = list(range(h)) + [-1] * (h2 - h)
            for name, dim in (("wq", 1), ("w_uq", 1), ("w_uk", 1),
                              ("w_uv", 1), ("wo", 0)):
                if pre + name in weights:
                    out[pre + name] = _take(weights[pre + name], dim, q_src)
    return cfg2, out


def _shape(shape) -> ShapeConfig:
    return SHAPES[shape] if isinstance(shape, str) else shape


def _bspec(env: AxisEnv, mesh, b: int):
    name = batch_spec(env, mesh, b)
    return env.resolve((name,))[0] if name else None


def _leaf(mesh, shape, dtype: str, spec) -> Leaf:
    spec = Spec(*spec)
    return Leaf(tuple(shape), dtype, spec, block_shape(mesh, shape, spec))


def input_specs(arch: str, shape, mesh, cfg: Optional[ModelConfig] = None
                ) -> dict:
    """The cell's model inputs as the reference's ``input_specs`` gives
    them, each a ``Leaf`` (global shape, dtype, spec, this rank's block):
    tokens (and labels) with the batch over the batch axes where it
    divides them and the sequence over ``sp`` where it divides; a decode's
    token and position; the VLM's memory (B, M, F) f32.  ``cfg`` (default:
    the arch's) gives the memory's size."""
    cfg = cfg or get_config(arch)
    sc = _shape(shape)
    env = AxisEnv.from_mesh(mesh)
    b = sc.global_batch
    bs = _bspec(env, mesh, b)
    sp = "model" if sc.seq_len % max(axis_size(mesh, env.sp), 1) == 0 else None
    out = {}
    if sc.kind in ("train", "prefill"):
        out["tokens"] = _leaf(mesh, (b, sc.seq_len), "int32", (bs, sp))
        if sc.kind == "train":
            out["labels"] = _leaf(mesh, (b, sc.seq_len), "int32", (bs, sp))
    else:
        out["tokens"] = _leaf(mesh, (b, 1), "int32", (bs, None))
        out["positions"] = _leaf(mesh, (b, 1), "int32", (bs, None))
    if cfg.cross_attn_every:
        out["memory"] = _leaf(
            mesh, (b, cfg.cross_attn_memory_len, cfg.frontend_embed_dim),
            "float32", (bs, None, None))
    return out


def _model(cfg: ModelConfig, mesh, device, weights: Optional[dict]):
    """A ``Transformer`` holding this rank's blocks: of ``weights`` (a
    whole model's, on any device), else empty (``meta``: no storage)."""
    specs = transformer.mesh_specs(cfg, mesh)
    if weights is None:
        tree = transformer._zip_map(
            lambda d, sp: torch.empty(block_shape(mesh, d.shape, sp),
                                      dtype=getattr(torch, d.dtype),
                                      device=device),
            transformer.model_defs(cfg), specs)
    else:
        tree = transformer._zip_map(
            lambda a, sp: shard_leaf(mesh, a, sp).to(device).clone(),
            transformer.tree_from_weights(cfg, weights), specs)
    return transformer.Transformer(cfg, transformer.weights_from_tree(
        cfg, tree, mesh))


def _stacked_block(tensors: list) -> tuple:
    """The block of a leaf held as ``tensors`` (one a layer of a scanned
    leaf, else one): its shape, with the leading periods axis."""
    shapes = {tuple(t.shape) for t in tensors}
    if len(shapes) != 1:
        raise ValueError(f"a scanned leaf's layers hold blocks {shapes}")
    return (len(tensors),) + shapes.pop() if len(tensors) > 1 else shapes.pop()


def _param_specs(cfg, env, mesh, model, opt) -> dict:
    """``params/...`` and, with ``opt``, ``opt/m/...``, ``opt/v/...`` and
    ``opt/step``: each leaf's reference shape, dtype and ``param_specs``
    spec, and the block this rank holds (read off its tensors)."""
    specs = dict(tree_leaves(transformer.param_specs(cfg, env)))
    held = dict(model.named_parameters())
    out = {}
    for path, d, names in transformer.reference_leaves(cfg):
        key = "/".join(path)
        sp = specs[path]
        out[f"params/{key}"] = Leaf(tuple(d.shape), d.dtype, sp,
                                    _stacked_block([held[n] for n in names]))
        if opt is not None:
            for m in ("m", "v"):
                out[f"opt/{m}/{key}"] = Leaf(
                    tuple(d.shape), "float32", sp,
                    _stacked_block([opt[m][n] for n in names]))
    if opt is not None:
        out["opt/step"] = Leaf((), "int32", Spec(), ())
    return out


def _state_specs(cfg, env, mesh, b, capacity, state) -> dict:
    """``state/...``: each leaf of the reference's state tree (its global
    shape, dtype and ``state_specs`` spec) and the block this rank holds
    in ``state`` (one dict a layer; ``index`` a Python int, an int32)."""
    defs = transformer.state_defs(cfg, b, capacity)
    specs = transformer.state_specs(cfg, env, b, capacity,
                                    batch_logical=batch_spec(env, mesh, b))
    segs = transformer.plan_segments(cfg)
    n_pre, per = len(segs.prefix), len(segs.period)
    out = {}
    for seg in ("prefix", "scanned"):
        if defs[seg] is None:
            continue
        for j, leaves in defs[seg].items():
            for name, sd in leaves.items():
                layers = ([n_pre + p * per + int(j)
                           for p in range(segs.n_periods)]
                          if seg == "scanned" else [int(j)])
                held = [state[i][name] for i in layers]
                blk = _stacked_block([t if torch.is_tensor(t)
                                      else torch.empty((), device="meta")
                                      for t in held])
                out[f"state/{seg}/{j}/{name}"] = Leaf(
                    tuple(sd[0]), sd[2], Spec(*specs[seg][j][name]), blk)
    return out


def build_cell(arch: str, shape, mesh, *,
               remat_policy: Optional[str] = None,
               use_ep: Optional[bool] = None,
               mla_absorb: bool = True,
               layers_override: Optional[int] = None,
               scan_override: Optional[bool] = None,
               param_cast: Optional[str] = None,
               cfg_override: Optional[ModelConfig] = None,
               weights: Optional[dict] = None,
               device=None,
               cache_dtype: Optional[str] = None) -> Cell:
    """The cell of ``arch`` at ``shape`` for this rank of ``mesh``, the
    overrides applied in the reference's order, then the heads padded for
    the mesh's ``tp`` (``tp_pad_config``).  Over an ``AbstractMesh`` every
    argument is on ``meta``; over a real mesh on ``device`` (default
    ``cuda``), the parameters empty or, with ``weights`` (a whole model's
    at the config before padding, ``weights_from_tree``'s keys), this
    rank's blocks of them padded by ``tp_pad_weights``; the KV and latent
    caches of a decode cell (and of its prefill) in ``cache_dtype`` where
    given (``init_state``'s)."""
    sc = _shape(shape)
    ok, why = cell_supported(arch, sc.name)
    if not ok:
        raise ValueError(why)
    cfg = cfg_override if cfg_override is not None else get_config(arch)
    if remat_policy is not None:
        cfg = dataclasses.replace(cfg, remat_policy=remat_policy)
    if layers_override is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers_override)
    if scan_override is not None:
        cfg = dataclasses.replace(cfg, scan_layers=scan_override)
    if param_cast is not None:
        cfg = dataclasses.replace(cfg, param_cast=param_cast)
    env = AxisEnv.from_mesh(mesh)
    tp = axis_size(mesh, env.tp)
    if weights is not None:
        cfg, weights = tp_pad_weights(cfg, weights, tp)
    else:
        cfg = tp_pad_config(cfg, tp)
    is_moe = cfg.ffn_kind == FFNKind.MOE.value
    if use_ep is None:
        use_ep = is_moe
    if is_moe and not use_ep and mesh.size > 1:
        raise ValueError(f"{cfg.name}: the port runs an MoE FFN over a mesh "
                         f"of {mesh.size} ranks expert-parallel only")
    abstract = getattr(mesh, "abstract", False)
    if abstract:
        if weights is not None:
            raise ValueError("an abstract mesh's cell holds no weights")
        device = torch.device("meta")
    else:
        device = torch.device(device or "cuda")
    model = _model(cfg, mesh, device, weights)
    ins = input_specs(arch, sc, mesh, cfg if cfg_override is not None
                      else None)

    def inp(name):
        leaf = ins[name]
        return torch.zeros(leaf.shape, dtype=getattr(torch, leaf.dtype),
                           device=device)

    batch_specs = {f"batch/{n}": leaf for n, leaf in ins.items()}
    b, capacity = sc.global_batch, sc.seq_len
    note = ("one rank's step; flops are FlopCounterMode's matmul-class "
            "count; collective bytes are the AxisLedger's")
    if sc.kind == "train":
        tcfg = TrainConfig()
        fn = steps.make_train_step(cfg, tcfg, use_ep=use_ep, mesh=mesh)
        opt = adamw.init_opt_state(dict(model.named_parameters()))
        batch = {"tokens": inp("tokens"), "labels": inp("labels")}
        if "memory" in ins:
            batch["memory"] = inp("memory")
        specs = _param_specs(cfg, env, mesh, model, opt)
        specs.update(batch_specs)
        return Cell(arch, sc.name, fn, (model, opt, batch), cfg, note, specs,
                    mesh, "train", use_ep)

    specs = _param_specs(cfg, env, mesh, model, None)
    if sc.kind == "prefill":
        prefill = steps.make_prefill_step(cfg, capacity, use_ep=use_ep,
                                          mesh=mesh, cache_dtype=cache_dtype)
        specs.update(batch_specs)
        if "memory" in ins:
            def fn(m, t, mem):
                return prefill(m, t, memory=mem)
            args = (model, inp("tokens"), inp("memory"))
        else:
            def fn(m, t):
                return prefill(m, t)
            args = (model, inp("tokens"))
        return Cell(arch, sc.name, fn, args, cfg, note, specs, mesh,
                    "prefill", use_ep)

    # decode
    state = transformer.init_state(cfg, b, capacity, device, mesh=mesh,
                                   cache_dtype=cache_dtype)
    specs.update(_state_specs(cfg, env, mesh, b, capacity, state))
    specs.update({k: v for k, v in batch_specs.items()
                  if k != "batch/memory"})
    fn = steps.make_decode_step(cfg, use_ep=use_ep, mesh=mesh)
    return Cell(arch, sc.name, fn, (model, state, inp("tokens"),
                                    inp("positions")), cfg, note, specs,
                mesh, "decode", use_ep)


def argument_bytes(cell: Cell) -> dict:
    """The bytes of this rank's blocks of the cell's arguments, as the
    reference's per-device ``argument_size_in_bytes`` counts them: by
    group (``params``, ``opt``, ``batch``, ``state``) and ``total``."""
    out = {k: 0 for k in ("params", "opt", "batch", "state")}
    for name, leaf in cell.specs.items():
        out[name.split("/")[0]] += leaf.block_bytes
    out["total"] = sum(out.values())
    return out

