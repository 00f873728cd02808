"""Phase 1 of ``chip_smoke.py`` (the card and the kernels' build), then
the threshold sweep's phases or sub-phases of phase 11 alone, on the card:

    python3 chip_phases.py s              # phase 3, then phase 5's direct-
                                          # route timings
    python3 chip_phases.py a d            # (a) EP MoE smoke, (d) dense TP
    python3 chip_phases.py d --layers 2,4 # (d) at each depth in turn
    python3 chip_phases.py e              # (e) MLA, cross, SSM leaves
    python3 chip_phases.py f              # (f) the decode state's blocks
    python3 chip_phases.py b              # (b) deepseek-v2 EP decode
    python3 chip_phases.py g              # (g) the padded dry-run cell

(s) is ``Smoke.phase3_threshold_sweep`` and ``Smoke.time_direct_sweeps``;
(a) is ``Smoke._ep_smoke``, (b) ``Smoke._ep_full_width``; (d), (e) and
(f) are ``Smoke._tp_world`` with that letter alone, (d) at ``DENSE_TP_LAYERS`` or at each depth of ``--layers``
(where a failed gate is printed and the next depth run); (g) is
``Smoke._padded_cell`` with the host's dry-run.  Each
sub-phase prints its line as ``chip_smoke.py`` does, then its wall; the
last line is the card's name and power limit."""

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sub", nargs="+", choices=("s", "a", "b", "d", "e", "f", "g"))
    ap.add_argument("--layers", default=None,
                    help="comma-separated depths for (d)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        chip_smoke.fail("torch sees no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = chip_smoke.Smoke(torch)
    ctx.phase1_card_and_build()
    ctx.ep_launches = []
    for sub in args.sub:
        depths = ([int(x) for x in args.layers.split(",")]
                  if sub == "d" and args.layers else [None])
        for layers in depths:
            if layers is not None:
                chip_smoke.DENSE_TP_LAYERS = layers
            t = time.perf_counter()
            try:
                if sub == "s":
                    ctx.phase3_threshold_sweep()
                    ctx.time_direct_sweeps()
                elif sub == "a":
                    ctx._ep_smoke()
                elif sub == "b":
                    ctx._ep_full_width()
                elif sub == "g":
                    ctx._padded_cell()
                else:
                    ctx._tp_world(sub)
            except SystemExit as e:
                if layers is None:
                    raise
                print(f"(d) at {layers} layers: {e}", flush=True)
            print(f"sub-phase {sub}"
                  + (f" at {layers} layers" if layers else "")
                  + f": {time.perf_counter() - t:.1f} s", flush=True)
    print("join-kernel launches of the ranks:", ctx.ep_launches, flush=True)
    print(ctx.smi, flush=True)


if __name__ == "__main__":
    main()
