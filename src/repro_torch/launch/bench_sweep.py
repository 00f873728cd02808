"""Times the threshold sweep's direct route (``threshold_sweep_launch``) on
the card, through its wrapper, at:

  * the wide case: k 700 000 sample rows padded to 700 416, G 4096 random
    thresholds, C 2 and C 5 (chip_smoke.py phase 3's inputs: 1 % of the
    distances +inf, 5 % positives, thresholds uniform in [0, 1) with a
    +inf row, a -inf row and a +inf column);
  * a 15-clause ``candidate_grid``: k 700 416 likewise, G 2**15, each
    clause at the smallest and the largest positive distance (what
    ``candidate_grid`` keeps at 15 clauses; 10 % positives, which sit
    closer).

The inputs are built here from fixed seeds with numpy alone, so two
checkouts time the same inputs.  For each case: the counts against the
plain version on the card (exact), CUDA events around back-to-back calls
(median of 7 runs), one call between events (median of 7), the profiler's
device time a call (kernels and memsets, 5 calls), and three bounds:
G * k * (C + 2) lane operations over the FP32 lane rate (half of 67
TFLOP/s), the same over the FP32 FLOP rate (the bound the port's records
gave before), and G * k * C compares over 64 a clock an SM (the
compare throughput of compute capability 9.0 in the CUDA programming
guide) at 132 SMs and 1.98 GHz.  Prints one JSON line, with the card's
name and power limit.

    PYTHONPATH=src python src/repro_torch/launch/bench_sweep.py

It imports ``repro_torch`` from the path, so run as a file with another
checkout's ``src`` first on PYTHONPATH it times that checkout's kernel:
two versions compared within one machine.
"""

from __future__ import annotations

import json
import statistics
import subprocess

import numpy as np
import torch

FP32_FLOPS = 67e12              # H100 SXM data sheet
LANE_OPS = FP32_FLOPS / 2       # an FMA lane-clock counts as two FLOPs
COMPARE_OPS = 132 * 64 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
K, K_PADDED = 700000, 700416


def wide_case(c: int) -> tuple:
    rng = np.random.default_rng(100 + c)
    cd = rng.uniform(0, 1, size=(K, c)).astype(np.float32)
    cd[rng.random(size=(K, c)) < 0.01] = np.inf
    labels = (rng.random(K) < 0.05).astype(np.float32)
    th = rng.uniform(0, 1, size=(4096, c)).astype(np.float32)
    th[0], th[1], th[2, 0] = np.inf, -np.inf, np.inf
    return _padded(cd, labels, th)


def grid_case(c: int = 15) -> tuple:
    rng = np.random.default_rng(215)
    labels = rng.random(K) < 0.1
    cd = rng.uniform(0, 1, size=(K, c)).astype(np.float32)
    cd[labels] *= np.float32(0.4)
    pos = cd[labels]
    axes = [np.array([pos[:, j].min(), pos[:, j].max()], np.float32)
            for j in range(c)]
    mesh = np.meshgrid(*axes, indexing="ij")
    th = np.stack([m.ravel() for m in mesh], axis=1).astype(np.float32)
    return _padded(cd, labels.astype(np.float32), th)


def _padded(cd, labels, th):
    pad = K_PADDED - K
    valid = np.pad(np.ones(K, np.float32), (0, pad))
    return (np.pad(cd, ((0, pad), (0, 0))), np.pad(labels, (0, pad)), valid,
            th)


def _events_ms(fn, reps, runs=7):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def _device_ms(fn, n=5):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.key != "Activity Buffer Request"]
    return sum(e.self_device_time_total for e in events) / n / 1e3


def measure(arrays) -> dict:
    from repro_torch.kernels.threshold_sweep.kernel import threshold_sweep
    from repro_torch.kernels.threshold_sweep.ref import threshold_sweep_ref
    dev = torch.device("cuda")
    cd, labels, valid, th = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                             for a in arrays)
    k, c = cd.shape
    g = th.shape[0]

    def kernel():
        return threshold_sweep(cd, labels, valid, th)
    got = kernel()
    want = threshold_sweep_ref(cd, labels, th, valid)
    torch.cuda.synchronize()
    one = _events_ms(kernel, reps=1)
    ms = _events_ms(kernel, reps=max(1, min(50, int(20.0 / max(one, 1e-3)))))
    device = _device_ms(kernel)
    ops = g * k * (c + 2)
    nbytes = 4 * (k * (c + 2) + g * c + 2 * g)
    bound = 1e3 * max(ops / LANE_OPS, nbytes / HBM_BYTES_PER_S)
    return {"k": k, "c": c, "g": g, "exact": bool(torch.equal(got, want)),
            "max_sel": int(got[:, 1].max()), "ms": ms, "ms_one_call": one,
            "device_ms": device, "bound_ms": bound,
            "bound_fraction": bound / device,
            "bound_flop_rate_ms": 1e3 * ops / FP32_FLOPS,
            "compare_pipe_bound_ms": 1e3 * g * k * c / COMPARE_OPS,
            "lane_ops_per_pair": LANE_OPS * device / 1e3 / (g * k)}


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    out = {"card": smi}
    for c in (2, 5):
        out[f"wide_c{c}"] = measure(wide_case(c))
    out["grid_c15"] = measure(grid_case())
    print(json.dumps(out))


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("bench_sweep: needs a CUDA device")
    main()
