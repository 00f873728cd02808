"""Times the candidate compaction (``compact_append``) on the card at the
ring's two band shapes, through its wrapper, with the count given as the
int 0 as the ring gives it:

  * the main path's first band: a (2816, 16) word mask with 25 659 bits
    set, into 45 056 slots;
  * a production band: a (262 144, 128) word mask (134 MB) with 1 632
    bits set, into 1 048 576 slots.

The masks are random, with those shapes and bit counts, drawn from
``--seed``.  For each: CUDA events around back-to-back calls (median of
7 runs), one call (events around it, median of 21), the host's enqueue
time a call (200 calls, no synchronisation), the profiler's device time
and device activities a call (10 calls), and the bytes bound (the mask
read once, 8 B a written pair, 8 B of counts, over 3.35 TB/s).  Prints
one JSON line.

    PYTHONPATH=src python src/repro_torch/launch/bench_compaction.py

It imports ``repro_torch`` from the path, so run as a file with another
checkout's ``src`` first on PYTHONPATH it times that checkout's kernel:
two versions compared within one machine.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
SHAPES = {"main_band": (2816, 16, 25659, 45056),
          "production_band": (262144, 128, 1632, 1 << 20)}


def _mask(rng, nl, nw, n_set, dev):
    pos = rng.choice(nl * nw * 32, size=n_set, replace=False)
    words = np.bincount(pos >> 5, weights=np.ldexp(1.0, pos & 31),
                        minlength=nl * nw).astype(np.uint64)
    words = words.astype(np.uint32).view(np.int32).reshape(nl, nw)
    return torch.from_numpy(words).to(dev)


def _events_ms(fn, reps, runs):
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def _profile(fn, n=10):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.key != "Activity Buffer Request"]
    return (sum(e.self_device_time_total for e in events) / n / 1e3,
            sum(e.count for e in events) / n,
            {e.key[:40]: e.count for e in events})


def measure(name, dev, rng):
    from repro_torch.kernels.extract.kernel import compact_append
    nl, nw, n_set, cap = SHAPES[name]
    packed = _mask(rng, nl, nw, n_set, dev)
    buf = torch.full((cap, 2), -1, dtype=torch.int32, device=dev)

    def call():
        return compact_append(packed, buf, 0)
    count = int(call()[1])
    assert count == n_set, (count, n_set)
    ms = _events_ms(call, reps=200 if name == "main_band" else 20, runs=7)
    one = _events_ms(call, reps=1, runs=21)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        call()
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    device_ms, per_call, activities = _profile(call)
    nbytes = 4 * nl * nw + 8 * min(n_set, cap) + 8
    bound_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    return {"mask": [nl, nw], "pairs": n_set, "cap": cap, "ms": ms,
            "one_call_ms": one, "host_enqueue_us": host_us,
            "device_ms": device_ms if device_ms >= bound_ms else None,
            "device_reading_ms": device_ms, "activities_per_call": per_call,
            "activities": activities, "bound_ms": bound_ms, "bytes": nbytes,
            "ms_over_bound": ms / bound_ms}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_compaction: torch sees no CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(args.seed)
    out = {"label": args.label, "card": card}
    for name in SHAPES:
        out[name] = measure(name, dev, rng)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
