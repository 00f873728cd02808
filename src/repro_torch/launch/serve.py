"""Serving launcher: batched generation with an --arch backbone of the zoo
(the dense GQA configs, llama4-maverick's MoE, deepseek-v2's MLA + MoE).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b \
      --smoke --requests 16 --max-new 12 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch deepseek-v2-236b --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b \
      --full --requests 16 --max-new 12 --batch-slots 8     # on the card

Weights are drawn from ``--seed`` by a ``torch.Generator`` on the target
device.  Prints one JSON report with the reference launcher's keys.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.data.pipeline import ByteTokenizer
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.serving.engine import Request, ServeEngine


def serve(arch: str, *, smoke: bool = True, n_requests: int = 16,
          max_new: int = 12, batch_slots: int = 8, capacity: int = 256,
          seed: int = 0, device="cuda") -> dict:
    dev = resolve_device(device)
    cfg = get_smoke(arch) if smoke else get_config(arch)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = transformer.init_params(cfg, gen, dev)
    tok = ByteTokenizer(cfg.vocab_size)
    engine = ServeEngine(cfg, model, batch_slots=batch_slots, capacity=capacity)
    rng = np.random.default_rng(seed)
    prompts = [
        f"Do records {int(rng.integers(1e4))} and {int(rng.integers(1e4))} "
        f"refer to the same incident?" for _ in range(n_requests)]
    reqs = [Request(np.clip(tok.encode(p), 0, cfg.vocab_size - 1),
                    max_new_tokens=max_new) for p in prompts]
    t0 = time.time()
    engine.run(reqs)
    dt = time.time() - t0
    toks = sum(len(r.out_tokens) for r in reqs)
    return {"requests": n_requests, "tokens_generated": toks,
            "wall_s": round(dt, 2), "tok_per_s": round(toks / max(dt, 1e-9), 1)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi4-mini-3.8b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--batch-slots", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    print(json.dumps(serve(args.arch, smoke=args.smoke,
                           n_requests=args.requests, max_new=args.max_new,
                           batch_slots=args.batch_slots, seed=args.seed,
                           device=args.device)))


if __name__ == "__main__":
    main()
