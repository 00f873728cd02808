"""Training launcher with checkpoint/restart fault tolerance.

  PYTHONPATH=src python -m repro_torch.launch.train --arch phi4-mini-3.8b \
      --smoke --steps 12 --device cpu --checkpoint-dir /tmp/ck
  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-350m \
      --full --steps 6                                      # on the card

Restarts resume from the latest checkpoint automatically; ``--fail-at N``
injects a crash at step N to exercise the restart path.  Checkpoints hold
``(params, opt_state)`` in the reference's layout and format, so either
package resumes the other's.  Weights are drawn from ``--seed`` by a
``torch.Generator`` on the target device (``--device``, the card unless
``cpu`` is asked for).  ``--mesh host`` (the default) trains in this one
process; ``--mesh single|multi`` joins the world a ``torchrun``-style
environment describes (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``,
``MASTER_PORT``; gloo) and builds the production mesh over it, (16, 16) or
(2, 16, 16), which must have exactly 256 or 512 ranks (else the
``ValueError`` names the size it needs).  That is all the mesh does here,
as in the reference: its launcher jits ``make_train_step`` with no
shardings over parameters drawn on the default device
(``src/repro/launch/train.py:63``), so each rank trains a whole copy of
the model on the same batches, with no collective, and rank 0 writes the
checkpoints.  The sharded step, each rank holding its ``param_specs``
blocks of the dense leaves (``transformer.local_specs``), is the train
cell's: ``make_train_step(mesh=)`` over a model drawn with
``init_params(mesh=)``.  Prints one JSON report with the reference's
keys.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.common.config import TrainConfig
from repro_torch.configs import get_config, get_smoke
from repro_torch.convert import model_tree_to_numpy, opt_state_to_numpy
from repro_torch.data.pipeline import PackedLMConfig, PackedLMDataset, PrefetchLoader
from repro_torch.device import resolve_device
from repro_torch.distributed.mesh import (init_from_env, make_production_mesh,
                                          world_rank)
from repro_torch.models import steps, transformer
from repro_torch.models.layers import tree_map
from repro_torch.optim import adamw


class SimulatedFailure(RuntimeError):
    pass


def corpus_texts():
    from repro_torch.data import synth
    ds = synth.police_records(n_incidents=150, reports_per_incident=2)
    return ds.texts_l


def make_loader(cfg, *, batch: int, seq: int, seed: int) -> PrefetchLoader:
    """The launcher's data: ``corpus_texts`` packed into (batch, seq)
    examples, prefetched on a background thread."""
    data = PackedLMDataset(
        corpus_texts(), PackedLMConfig(seq_len=seq, batch_size=batch, seed=seed),
        vocab_size=cfg.vocab_size)
    return PrefetchLoader(data)


def _state_tree(cfg, model, opt) -> tuple:
    """``(params, opt_state)`` as the reference's trees of numpy arrays."""
    return model_tree_to_numpy(cfg, model), opt_state_to_numpy(cfg, opt)


def _restore_into(cfg, model, opt, directory: str) -> int:
    """Load the latest checkpoint in ``directory`` into ``model`` and
    ``opt`` in place; returns its step."""
    shape = tree_map(lambda d: 0, transformer.model_defs(cfg))
    (params, o), step = ckpt.restore(
        directory, (shape, {"m": shape, "v": shape, "step": 0}))
    with torch.no_grad():
        for src, dst in ((params, dict(model.named_parameters())),
                         (o["m"], opt["m"]), (o["v"], opt["v"])):
            for n, t in transformer.weights_from_tree(cfg, src).items():
                dst[n].copy_(t)
        opt["step"].fill_(int(o["step"]))
    return step


def train(arch: str, *, smoke: bool = True, steps_n: int = 50, batch: int = 8,
          seq: int = 128, ckpt_dir: str = None, ckpt_every: int = 20,
          fail_at: int = -1, mesh_kind: str = "host", seed: int = 0,
          grad_compression: str = "none", log_every: int = 10,
          device="cuda") -> dict:
    if mesh_kind not in ("host", "single", "multi"):
        raise ValueError(f"--mesh {mesh_kind}: use host, single or multi")
    if mesh_kind != "host":
        init_from_env()
        # checks the world's size; the ranks then train whole copies, as
        # the reference's launcher does
        make_production_mesh(multi_pod=mesh_kind == "multi")
    writer = world_rank() == 0
    dev = resolve_device(device)
    ckpt_dir = ckpt_dir or os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    cfg = get_smoke(arch) if smoke else get_config(arch)
    tcfg = TrainConfig(total_steps=steps_n, warmup_steps=max(steps_n // 10, 1),
                       checkpoint_dir=ckpt_dir, checkpoint_every=ckpt_every,
                       grad_compression=grad_compression)
    model = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    opt = adamw.init_opt_state(dict(model.named_parameters()))
    start = 0
    if ckpt.latest_step(ckpt_dir) is not None:
        start = _restore_into(cfg, model, opt, ckpt_dir)
        print(f"[train] resumed from checkpoint step {start}")

    train_step = steps.make_train_step(cfg, tcfg)
    metrics = {}
    t0 = time.time()
    loader = make_loader(cfg, batch=batch, seq=seq, seed=seed)
    try:
        for step in range(start, steps_n):
            if step == fail_at:
                raise SimulatedFailure(f"injected failure at step {step}")
            b = loader.next()
            batch_dev = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
            opt, metrics = train_step(model, opt, batch_dev)
            if writer and ((step + 1) % ckpt_every == 0
                           or step + 1 == steps_n):
                ckpt.save(ckpt_dir, step + 1, _state_tree(cfg, model, opt))
            if (step + 1) % log_every == 0:
                print(f"[train] step {step+1}/{steps_n} "
                      f"loss={float(metrics['loss']):.4f} "
                      f"lr={float(metrics['lr']):.2e} "
                      f"({(time.time()-t0)/max(step+1-start,1):.2f}s/step, "
                      f"backup_batches={loader.backup_batches})")
    finally:
        loader.close()
    return {"loss": float(metrics.get("loss", float("nan"))), "steps": steps_n,
            "params": transformer.count_params(cfg)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi4-mini-3.8b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="default: repro_torch_ckpt in the temp directory")
    ap.add_argument("--checkpoint-every", type=int, default=20)
    ap.add_argument("--fail-at", type=int, default=-1)
    ap.add_argument("--mesh", default="host",
                    choices=("host", "single", "multi"))
    ap.add_argument("--grad-compression", default="none",
                    choices=("none", "fp16", "int8"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    out = train(args.arch, smoke=args.smoke, steps_n=args.steps,
                batch=args.batch, seq=args.seq, ckpt_dir=args.checkpoint_dir,
                ckpt_every=args.checkpoint_every, fail_at=args.fail_at,
                mesh_kind=args.mesh, seed=args.seed,
                grad_compression=args.grad_compression, device=args.device)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
