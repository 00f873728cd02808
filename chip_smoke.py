#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds every CUDA kernel from ``src/repro_torch/csrc`` (one nvcc per source,
in parallel), holds each kernel against its plain-torch version on the card,
drives the port's main path (the one-shot FDJ join on ``products`` at
``--size 4``, barrier and streaming refinement) through its user entry
point, checks that both kernels were launched by it, checks the result
against the plain path on a small input, and times each kernel with CUDA
events against its bound, its plain version and a library yardstick.

Phases, in order; any failure exits non-zero before the last line:
  1. the card (nvidia-smi name and power limit), the kernel builds and
     ptxas's report of each kernel's registers, shared memory and spills;
  2. cnf_join_block vs its plain version: the kernel-test fixtures, early
     reject on and off, with the evals grid; the boundary fixture (64
     pairs on each clause's threshold, exact duplicates at theta = 0); the
     production cell (262144 x 262144, F_v = 4, D = 128, 3 clauses at
     theta = 0.4) on a 2048-row strip against all of R;
  3. threshold_sweep, both routes, counts exactly equal to the plain
     versions: the direct route at k = 700000, C in {2, 5}, G = 4096 random
     thresholds with pad rows and +-inf columns; the ranked route against
     its plain version and the brute-force one on the edge fixture (+-inf,
     NaN, +-0.0, duplicate rows, invalid rows; G = 48 and G = 1) and on
     ``candidate_grid`` grids at k = 700000 for C = 2..6, with and without
     -inf pad rows; ``ops.sweep`` on thresholds of 2**14 bins must take the
     ranked route and on 2**14 + 1 bins the direct one;
  4. the end-to-end join, barrier then streaming (launch counts reset just
     before each and read just after; both kernels must have run, the
     sweep by its ranked route), the
     cuda engine against the numpy engine on the same plan, the
     police_records representative CNF at size 4, and the CUDA join
     against the plain-torch join on a small input;
  5. timing at the main path's shapes and at the production cell: each
     sample is a run of back-to-back warm calls between two CUDA events,
     over the count; the median of >= 5 samples.  The main-path launches
     also give their one-call time (one call between the events, host
     dispatch included) and their device time per call from the profiler
     (kernels and memsets only), kernel A each beside the same for the
     library yardstick.  The sweep: the ranked route at the main-path
     launch, on the C = 5 grid (k 700000, unpadded and padded) and on
     2**14 bins with rows spread over all of them, the
     direct route at the wide case, and the host wall of one
     ``ops.sweep_counts`` call at the main-path shape (route choice and
     host-to-device copies included).

A mask bit may differ from the plain version only for a pair whose float64
distance lies within D * 2**-24 of a threshold (f32 dot products summed in
another order); every other difference fails.  Sweep counts must be equal.

Prints the card line, a ``{"kernels": [...]}`` line, and as its last line
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
without a CUDA device or outside a checkout of the repository.
"""

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# NVIDIA data-sheet peaks (dense, no sparsity), per H100 variant: FP32
# outside the tensor cores, HBM bandwidth, TF32 on the tensor cores
PEAKS = {"sxm": (67e12, 3.35e12, 495e12), "pcie": (51e12, 2.0e12, 378e12)}
EPS_NOTE = "pairs within D*2^-24 of a threshold"


def fail(msg):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def check(cond, msg):
    if not cond:
        fail(msg)


def log(*args):
    print(*args, flush=True)


def main():
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}: run from a checkout")
    sys.path.insert(0, SRC)
    import torch
    if not torch.cuda.is_available():
        fail("torch sees no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    ctx = Smoke(torch)
    ctx.phase1_card_and_build()
    ctx.phase2_cnf_join()
    ctx.phase3_threshold_sweep()
    ctx.phase4_join()
    ctx.phase5_timing()
    log(json.dumps({"kernels": ctx.kernels}))
    log(f"total wall {time.perf_counter() - t_start:.1f} s")
    log(ctx.smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


class Smoke:
    def __init__(self, torch):
        import numpy as np
        from repro_torch.kernels import _build
        from repro_torch.kernels.fused_cnf_join import kernel as ck, ref as cref
        from repro_torch.kernels.threshold_sweep import kernel as sk, ref as sref
        self.torch, self.np = torch, np
        self.build, self.ck, self.cref, self.sk, self.sref = \
            _build, ck, cref, sk, sref
        self.dev = torch.device("cuda")
        name = torch.cuda.get_device_name(0)
        self.flops, self.bw, self.tf32 = \
            PEAKS["pcie" if "PCIe" in name else "sxm"]
        self.captured = {}
        self.kernels = []
        self.main_launches = {}
        self.sweep_timed = []     # (what, args, kw) of ranked cases to time

    # -- helpers -----------------------------------------------------------
    def time_ms(self, fn, runs=7, reps=None):
        """Median ms per call of ``fn``: each of ``runs`` samples is ``reps``
        warm calls back to back between two CUDA events, over the count.
        By default ``reps`` spans about 2 ms of one-call time (at most 50);
        ``reps=1`` gives the one-call time, host dispatch included."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        if reps is None:
            one = self.time_ms(fn, runs=1, reps=1)
            reps = max(1, min(50, int(2.0 / max(one, 1e-3))))
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

    def device_ms(self, fn, n=10, by_name=False):
        """Device ms per call of ``fn`` from the profiler's device
        activities (kernels and memsets); with ``by_name`` also each
        activity's ms per call, keyed by its name's first 40 characters."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        fn()
        self.torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            self.torch.cuda.synchronize()
        # the profiler's own buffer requests show as device activities too
        parts = {e.key[:40]: e.self_device_time_total / n / 1e3
                 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA
                 and e.key != "Activity Buffer Request"}
        total = sum(parts.values())
        return (total, parts) if by_name else total

    @staticmethod
    def host_ms(fn, n=50):
        """Host ms per call of ``fn`` when its launches are queued back to
        back (no synchronisation inside the loop)."""
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return 1e3 * (time.perf_counter() - t0) / n

    def reset_launches(self):
        self.ck.launches["cnf_join"] = 0
        for name in self.sk.launches:
            self.sk.launches[name] = 0

    def read_launches(self):
        return {"cnf_join": self.ck.launches["cnf_join"],
                **self.sk.launches}

    def cnf_compare(self, args, clauses, thetas, *, tl, tr, early_reject,
                    what):
        """Kernel vs plain on the same CUDA inputs.  The evals grids must be
        equal; a mask bit may differ only for a pair within the f32 dot
        band of a threshold.  Returns (mismatched bits, largest float64
        gap to a threshold among them)."""
        torch = self.torch
        got_m, got_e = self.ck.cnf_join_block(
            *args, clauses, thetas, tl=tl, tr=tr, early_reject=early_reject,
            with_evals=True)
        want_m, want_e = self.cref.cnf_join_tiles_ref(
            *args, clauses, thetas, tl=tl, tr=tr, early_reject=early_reject)
        torch.cuda.synchronize()
        check(torch.equal(got_e, want_e), f"{what}: evals grid differs")
        diff = got_m ^ want_m
        rows, words = torch.nonzero(diff, as_tuple=True)
        shifts = torch.arange(32, device=self.dev, dtype=torch.int32)
        k, bit = torch.nonzero((diff[rows, words][:, None] >> shifts) & 1,
                               as_tuple=True)
        if k.numel() == 0:
            return 0, 0.0
        ii, jj = rows[k].cpu().numpy(), (32 * words[k] + bit).cpu().numpy()
        gap = self.cref.threshold_gap(*args, clauses, thetas, ii, jj)
        band = self.cref.dot_error_band(args[0].shape[2])
        check((gap <= band).all(), f"{what}: {int((gap > band).sum())} of "
              f"{len(ii)} mismatched pairs lie outside the f32 band")
        return len(ii), float(gap.max())

    def cnf_bound_ms(self, args, clauses, tl, tr, evals):
        """Least time for this call, two ways, each the larger of its ops
        time and the bytes over the HBM rate.  Ops count what this data
        needs: per tile, only the clauses it evaluated (evals grid).

        ``fp32``: every op on the FP32 pipe: 2*D per embed member-pair, 2
        per scalar member-pair, 1 compare per clause-pair (``ops``).
        ``route``: the kernel's 3xTF32 route: 3 * 2*D per embed member-pair
        on the tensor cores at the TF32 peak, plus the epilogue on the FP32
        pipe (2 per member-pair, 1 compare per clause-pair).

        Returns (route ms, route bound_by, fp32 ms, ops, bytes)."""
        emb_l, emb_r, scal_l, scal_r = args
        d = emb_l.shape[2]
        vec = self.ck.VEC

        def per_tile(cost):
            cum = [0]
            for m in clauses:
                cum.append(cum[-1] + cost(m))
            return sum(cum[e] for e in evals.flatten().cpu().tolist()) * tl * tr
        ops = per_tile(lambda m: sum(2 * d if k == vec else 2 for k, _ in m)
                       + 1)
        dots = per_tile(lambda m: sum(2 * d for k, _ in m if k == vec))
        epilogue = per_tile(lambda m: 2 * len(m) + 1)
        n_l, n_r = emb_l.shape[1], emb_r.shape[1]
        used_v = {fi for m in clauses for k, fi in m if k == vec}
        used_s = {fi for m in clauses for k, fi in m if k == self.ck.SCAL}
        nbytes = 4 * (len(used_v) * (n_l + n_r) * d + len(used_s) * (n_l + n_r)
                      + n_l * n_r // 32 + evals.numel())
        route_ops_s = 3 * dots / self.tf32 + epilogue / self.flops
        route = 1e3 * max(route_ops_s, nbytes / self.bw)
        fp32 = 1e3 * max(ops / self.flops, nbytes / self.bw)
        by = "operations" if route_ops_s >= nbytes / self.bw else "bytes"
        return route, by, fp32, ops, nbytes

    def sweep_bound_ms(self, k, c, g, axes=None):
        """(ms, bound_by, ops, bytes): each input read once, the output
        written once.  Direct route: G * k * (C + 2) compare/AND/add
        operations.  Ranked route: per sample and per threshold row, a
        binary search of ceil(log2(u_c + 1)) compares and a multiply-add a
        clause, plus log2(u_c) adds a bin a clause for the prefix."""
        nbytes = 4 * (k * (c + 2) + g * c + 2 * g)
        if axes is None:
            ops = g * k * (c + 2)
        else:
            u = self.np.diff(axes[1].numpy()).tolist()
            bins = int(self.np.prod(u))
            ops = (k + g) * sum(int(n).bit_length() + 2 for n in u) + \
                bins * sum(max(int(n) - 1, 0).bit_length() for n in u)
        ops_s, bytes_s = ops / self.flops, nbytes / self.bw
        return (1e3 * max(ops_s, bytes_s),
                "operations" if ops_s >= bytes_s else "bytes", ops, nbytes)

    # -- phases --------------------------------------------------------------
    def phase1_card_and_build(self):
        self.smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        log(f"card: {self.smi}")
        t0 = time.perf_counter()
        secs = self.build.build_all(["cnf_join", "threshold_sweep"])
        log(f"build: {json.dumps({k: round(v, 2) for k, v in secs.items()})} "
            f"(parallel nvcc, wall {time.perf_counter() - t0:.2f} s)")
        for name in secs:
            for line in self.build.ptxas_report(name):
                log(f"ptxas {name}: {line}")

    def _fixture(self, rng, fv, nl, nr, d):
        np = self.np
        el = rng.normal(size=(fv, nl, d)).astype(np.float32)
        er = rng.normal(size=(fv, nr, d)).astype(np.float32)
        el /= np.linalg.norm(el, axis=-1, keepdims=True)
        er /= np.linalg.norm(er, axis=-1, keepdims=True)
        sl = rng.uniform(0, 1.5, size=(1, nl)).astype(np.float32)
        sr = rng.uniform(0, 1.5, size=(1, nr)).astype(np.float32)
        return [self.torch.from_numpy(a).to(self.dev) for a in (el, er, sl, sr)]

    def phase2_cnf_join(self):
        np, torch = self.np, self.torch
        VEC, SCAL = self.ck.VEC, self.ck.SCAL
        total = 0
        shapes = [(128, 128, 128, 64, 128), (256, 512, 128, 128, 256),
                  (256, 256, 256, 256, 256), (512, 256, 128, 128, 128)]
        structures = [(((VEC, 0),),), (((SCAL, 0),),),
                      (((VEC, 0), (VEC, 1)), ((SCAL, 0),)),
                      (((VEC, 0),), ((VEC, 1),), ((SCAL, 0), (VEC, 0)))]
        for nl, nr, d, tl, tr in shapes:
            args = self._fixture(np.random.default_rng(nl + nr), 2, nl, nr, d)
            for er in (False, True):
                n, _ = self.cnf_compare(
                    args, (((VEC, 0), (SCAL, 0)), ((VEC, 1),)), (0.45, 0.52),
                    tl=tl, tr=tr, early_reject=er, what=f"shape {nl}x{nr}")
                total += n
        args = self._fixture(np.random.default_rng(7), 2, 128, 128, 128)
        args[2][0, :64] += 3.0                # dead tiles under early reject
        for st in structures:
            th = tuple(0.3 + 0.1 * i for i in range(len(st)))
            for er in (False, True):
                n, _ = self.cnf_compare(args, st, th, tl=64, tr=64,
                                        early_reject=er, what=f"clauses {st}")
                total += n
        log(f"phase 2: cnf_join fixtures ok ({len(shapes) * 2 + len(structures) * 2}"
            f" cases, evals grids equal, {total} mismatched bits, all {EPS_NOTE})")
        self._boundary_fixture()

        # production cell: planes on the card, compared on a 2048-row strip
        g = torch.Generator(device=self.dev).manual_seed(0)
        n, fv, d = 262144, 4, 128
        emb_l = torch.randn((fv, n, d), generator=g, device=self.dev)
        emb_r = torch.randn((fv, n, d), generator=g, device=self.dev)
        emb_l /= emb_l.norm(dim=-1, keepdim=True)
        emb_r /= emb_r.norm(dim=-1, keepdim=True)
        scal_l = torch.zeros((1, n), device=self.dev)
        scal_r = torch.zeros((1, n), device=self.dev)
        self.prod = dict(args=(emb_l, emb_r, scal_l, scal_r),
                         clauses=tuple(((VEC, i),) for i in range(3)),
                         thetas=(0.4, 0.4, 0.4))
        p = self.prod
        strip = (emb_l[:, :2048], emb_r, scal_l[:, :2048], scal_r)
        n_mis, err = self.cnf_compare(strip, p["clauses"], p["thetas"],
                                      tl=256, tr=512, early_reject=True,
                                      what="production strip")
        log(f"phase 2: production cell 262144^2, F_v=4, D=128, 3 clauses: "
            f"strip 2048 x 262144 ok, {n_mis} mismatched bits "
            f"(max |d64 - theta| {err:.3g}, all {EPS_NOTE})")
        self.prod_strip = strip

    def _boundary_fixture(self):
        """Each clause's theta on the float64 distance of 64 chosen pairs,
        and 64 exact-duplicate pairs compared at theta = 0: the kernel's
        3xTF32 products may part from the plain version only there."""
        from repro_torch.data.cnf_fixtures import boundary_fixture
        arrays, clauses, thetas, pairs = boundary_fixture(0)
        args = [self.torch.from_numpy(a).to(self.dev) for a in arrays]
        band = self.cref.dot_error_band(arrays[0].shape[2])
        for case, th in thetas.items():
            for tl, tr in ((256, 512), (32, 64)):
                for er in (False, True):
                    n, gap = self.cnf_compare(
                        args, clauses, th, tl=tl, tr=tr, early_reject=er,
                        what=f"boundary fixture, {case}")
                    log(f"phase 2: boundary fixture, {case}, tiles {tl}x{tr},"
                        f" early_reject {er}: {n} bits differ from the plain "
                        f"version, largest gap {gap:.3g} (band {band:.3g})")
        self._distance_error(args, arrays, thetas, pairs)

    def _distance_error(self, args, arrays, thetas, pairs):
        """The f32 distance each implementation computes for the boundary
        fixture's chosen pairs, read back exactly from the mask: theta
        steps over consecutive f32 values, and a pair's distance is the
        first theta at which it passes.  Prints its error against the
        float64 distance in units of 2^-24 (bias shows as a mean away
        from 0; truncation in the tensor cores would show as a bias)."""
        np, torch = self.np, self.torch
        ii, jj = pairs
        el, er = (a.astype(np.float64) for a in arrays[:2])
        dup = np.arange(64)
        impls = {"kernel": lambda *a, **k: self.ck.cnf_join_block(*a, **k),
                 "plain": lambda *a, **k: self.cref.cnf_join_tiles_ref(
                     *a, early_reject=False, **k)[0]}
        for f in range(2):
            center = np.float32(thetas["on_threshold"][f + 1])
            up = [center]
            down = []
            for _ in range(24):
                up.append(np.nextafter(up[-1], np.float32(1)))
                down.append(np.nextafter((down or [center])[-1], np.float32(0)))
            groups = {
                "on-threshold": (ii, jj, 0.5 - 0.5 * (el[f, ii] * er[f, jj]).sum(-1),
                                 np.array(down[::-1] + up, np.float32)),
                "duplicates": (dup, dup, np.clip(
                    0.5 - 0.5 * (el[f, dup] ** 2).sum(-1), 0, 1),
                    np.arange(49, dtype=np.float32) * np.float32(2.0 ** -25))}
            for group, (ri, ci, d64, grid) in groups.items():
                rows = torch.as_tensor(ri, device=self.dev)
                cols = torch.as_tensor(ci, device=self.dev)
                for name, fn in impls.items():
                    passes = []
                    for th in grid:
                        m = fn(*args, (((self.ck.VEC, f),),), (float(th),),
                               tl=256, tr=512)
                        passes.append(((m[rows, cols // 32] >> (cols % 32)) & 1)
                                      .bool().cpu().numpy())
                    passes = np.array(passes)
                    # passing at the first theta locates the pair only if
                    # that theta is 0, the least distance there is
                    ok = passes.any(0) & (~passes[0] | (grid[0] == 0))
                    err = (grid[passes.argmax(0)].astype(np.float64) - d64)[ok]
                    err /= 2.0 ** -24
                    log(f"phase 2: distance error, feature {f}, {group}, "
                        f"{name}: {int(ok.sum())} of {len(ri)} pairs located,"
                        f" error / 2^-24 max |.| "
                        f"{np.abs(err).max() if ok.any() else float('nan'):.3g}"
                        f", mean {err.mean() if ok.any() else float('nan'):.3g}")

    def phase3_threshold_sweep(self):
        np, torch = self.np, self.torch
        for c in (2, 5):
            rng = np.random.default_rng(100 + c)
            k, g = 700000, 4096
            cd = rng.uniform(0, 1, size=(k, c)).astype(np.float32)
            cd[rng.random(size=(k, c)) < 0.01] = np.inf
            labels = (rng.random(k) < 0.05).astype(np.float32)
            kp = -(-k // 512) * 512
            cd = np.pad(cd, ((0, kp - k), (0, 0)))
            labels = np.pad(labels, (0, kp - k))
            valid = np.pad(np.ones(k, np.float32), (0, kp - k))
            th = rng.uniform(0, 1, size=(g, c)).astype(np.float32)
            th[0], th[1], th[2, 0] = np.inf, -np.inf, np.inf
            args = [torch.from_numpy(a).to(self.dev)
                    for a in (cd, labels, valid, th)]
            got = self.sk.threshold_sweep(*args)
            want = self.sref.threshold_sweep_ref(args[0], args[1], args[3],
                                                 args[2])
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"threshold_sweep C={c}: counts "
                  f"differ in {int((got != want).sum())} entries")
            check(int(got[0, 1]) == k and int(got[1, 1]) == 0,
                  "threshold_sweep: pad rows or -inf rows miscounted")
            if c == 5:
                self.sweep_wide = args
        log("phase 3: threshold_sweep direct route, k=700000 (padded 700416),"
            " G=4096 random thresholds, C in {2, 5}: counts exactly equal")
        self._sweep_ranked_cases()
        self._sweep_route_choice()

    def sweep_inputs(self, cd, labels, valid, thetas):
        """Card tensors and the ranked route's axes of numpy inputs."""
        from repro_torch.kernels.threshold_sweep.ops import rank_axes
        values, offsets, _ = rank_axes(thetas)
        args = [self.torch.from_numpy(self.np.ascontiguousarray(a)).to(self.dev)
                for a in (cd, labels, valid, thetas)]
        axes = (self.torch.from_numpy(values).to(self.dev),
                self.torch.from_numpy(offsets))
        return args, {"axes": axes}

    def sweep_compare(self, args, kw, what):
        """The ranked kernels vs both plain versions, counts exactly equal.
        Returns (the kernels' counts, their largest |difference|)."""
        torch = self.torch
        got = self.sk.threshold_sweep(*args, **kw)
        ranked = self.sref.threshold_sweep_ranked_ref(
            args[0], args[1], args[3], args[2], kw["axes"])
        direct = self.sref.threshold_sweep_ref(args[0], args[1], args[3],
                                               args[2])
        torch.cuda.synchronize()
        for name, want in (("ranked", ranked), ("brute-force", direct)):
            check(torch.equal(got, want), f"{what}: ranked kernel differs "
                  f"from the {name} plain version in "
                  f"{int((got != want).sum())} entries")
        return got, max(float((got - want).abs().max()) if want.numel() else 0.0
                        for want in (ranked, direct))

    def _sweep_ranked_cases(self):
        from repro_torch.data.sweep_fixtures import edge_fixture, grid_fixture
        cd, labels, valid, th = edge_fixture(0)
        cases = {"edge fixture G=48": (cd, labels, valid, th),
                 "edge fixture G=1": (cd, labels, valid, th[:1])}
        for c in range(2, 7):
            for pad in (False, True):
                cases[f"candidate_grid C={c}{' padded' if pad else ''}"] = \
                    grid_fixture(200 + c, 700000, c, pad)
        for what, arrays in cases.items():
            args, kw = self.sweep_inputs(*arrays)
            offsets = kw["axes"][1]
            self.reset_launches()
            got, _ = self.sweep_compare(args, kw, what)
            check(self.sk.launches["threshold_sweep_ranked"] == 1,
                  f"{what}: the ranked kernels were not launched")
            log(f"phase 3: threshold_sweep ranked route, {what}: k "
                f"{args[0].shape[0]}, G {args[3].shape[0]}, axes "
                f"{self.np.diff(offsets.numpy()).tolist()}, counts equal to "
                f"both plain versions (max sel {int(got[:, 1].max())})")
            if what.startswith("candidate_grid C=5"):
                self.sweep_timed.append((what, args, kw))

    def _sweep_route_choice(self):
        """ops.sweep picks the route from the thresholds' bin count."""
        from repro_torch.data.sweep_fixtures import bins_thetas
        from repro_torch.kernels.threshold_sweep import ops as sops
        np, torch = self.np, self.torch
        rng = np.random.default_rng(300)
        for u, route in (((128, 128), "ranked"), ((5, 29, 113), "direct")):
            th = bins_thetas(u)
            cd = rng.uniform(0, 1, size=(700000, len(u))).astype(np.float32)
            labels = rng.random(700000) < 0.1
            self.reset_launches()
            pos, sel = sops.sweep(cd, labels, th)
            check(self.sk.launches[f"threshold_sweep_{route}"] == 1 and
                  self.sk.launches["threshold_sweep"] == 1,
                  f"{np.prod(u)} bins: ops.sweep did not take the {route} "
                  f"route: {self.sk.launches}")
            want = self.sref.threshold_sweep_ref(
                *(torch.from_numpy(a).to(self.dev) for a in (
                    cd, labels.astype(np.float32), th))).cpu().numpy()
            check((pos == want[:, 0]).all() and (sel == want[:, 1]).all(),
                  f"{np.prod(u)} bins: ops.sweep counts differ")
            log(f"phase 3: ops.sweep, {int(np.prod(u))} bins: {route} route, "
                f"counts equal to the brute-force plain version")
            if route == "ranked":        # the most bins, rows spread over all
                self.sweep_timed.append(
                    (f"{np.prod(u)} bins, uniform rows",
                     *self.sweep_inputs(cd, labels.astype(np.float32),
                                        np.ones(len(cd), np.float32), th)))

    def _install_recorders(self):
        """Record the main path's first call to each kernel wrapper (and the
        engine's feats/clauses/thetas) so phase 5 times the kernels on
        exactly those inputs.  The recorders call through; the wrappers
        count their own launches."""
        from repro_torch.kernels.fused_cnf_join import ops as cops
        from repro_torch.kernels.threshold_sweep import ops as sops
        captured = self.captured

        def recorder(module, name, key):
            orig = getattr(module, name)

            def call(*args, **kw):
                captured.setdefault(key, (args, kw))
                return orig(*args, **kw)
            setattr(module, name, call)
        recorder(cops, "cnf_join_block", "cnf_join")
        recorder(sops, "threshold_sweep", "threshold_sweep")
        recorder(cops, "evaluate_corpus_stream", "corpus")

    def phase4_join(self):
        from repro_torch.launch.join import run_join
        self._install_recorders()
        runs = {}
        for mode, stream in (("barrier", False), ("stream", True)):
            self.reset_launches()
            t0 = time.perf_counter()
            out = run_join("products", size=4, engine="cuda", stream=stream)
            wall = time.perf_counter() - t0
            launches = self.read_launches()
            check(launches["cnf_join"] > 0 and launches["threshold_sweep"] > 0,
                  f"products {mode}: a kernel was not launched: {launches}")
            check(launches["threshold_sweep_ranked"] ==
                  launches["threshold_sweep"],
                  f"products {mode}: the sweep left the ranked route: "
                  f"{launches}")
            if mode == "barrier":
                self.main_launches = launches
            runs[mode] = out
            log(f"phase 4: products size 4 {mode}: " + json.dumps({
                "n_l": out["n_l"], "n_r": out["n_r"], "recall": out["recall"],
                "met_target": out["met_target"], "clauses": out["clauses"],
                "theta": out["theta"], "candidates": out["candidates"],
                "wall_s": round(wall, 3), "walls": out["walls"],
                "launches": launches}))
        a, b = runs["barrier"], runs["stream"]
        for key in ("candidates", "recall", "precision", "theta", "clauses"):
            check(a[key] == b[key], f"barrier vs stream differ in {key}")
        check(a["candidates"] > 0 and a["recall"] > 0, "empty join")
        check(len(a["clauses"]) >= 2, "products built < 2 clauses: the "
              "threshold sweep is not on this path")
        self._engines_on_same_plan()
        self._police_representative()
        self._small_input_vs_plain()

    def _engine_pair(self, feats, clauses, thetas, what):
        """cuda engine vs numpy engine on one plan; differences must lie in
        the f32 band."""
        from repro_torch.engine import get_engine
        from repro_torch.kernels.fused_cnf_join.ops import pack_features
        t0 = time.perf_counter()
        got = get_engine("cuda").evaluate(feats, clauses, thetas)
        t1 = time.perf_counter()
        want = get_engine("numpy").evaluate(feats, clauses, thetas)
        t2 = time.perf_counter()
        diff = sorted(set(got.candidates) ^ set(want.candidates))
        if diff:
            arrays = pack_features(feats, clauses, tl=256, tr=512)
            args = [self.torch.from_numpy(x).to(self.dev) for x in arrays[:4]]
            gap = self.cref.threshold_gap(*args, arrays[4], thetas,
                                          [p[0] for p in diff],
                                          [p[1] for p in diff])
            check((gap <= self.cref.dot_error_band(args[0].shape[2])).all(),
                  f"{what}: cuda vs numpy engine differ outside the f32 band")
        log(f"phase 4: {what}: cuda engine {len(got.candidates)} candidates "
            f"({t1 - t0:.3f} s), numpy engine {len(want.candidates)} "
            f"({t2 - t1:.3f} s), {len(diff)} differing pairs "
            f"({'equal' if not diff else 'all ' + EPS_NOTE})")

    def _engines_on_same_plan(self):
        feats, clauses, thetas = self.captured["corpus"][0][:3]
        self._engine_pair(feats, clauses, thetas, "products plan")

    def _police_representative(self):
        from repro_torch.core.costs import CostLedger
        from repro_torch.data.cnf_fixtures import representative_cnf
        from repro_torch.data.simulated_llm import SimulatedExtractor
        from repro_torch.launch._args import make_dataset
        t0 = time.perf_counter()
        ds = make_dataset("police_records", size=4)
        specs, clauses, thetas = representative_cnf(ds)
        feats = SimulatedExtractor(ds).materialize(specs, CostLedger())
        log(f"phase 4: police_records size 4 ({ds.n_l} x {ds.n_r}) "
            f"extraction {time.perf_counter() - t0:.1f} s (host)")
        self._engine_pair(feats, clauses, thetas,
                          "police_records representative CNF")

    def _small_input_vs_plain(self):
        from repro_torch.launch.join import run_join
        gpu = run_join("products", size=0.3, engine="cuda")
        cpu = run_join("products", size=0.3, engine="cuda", device="cpu")
        for key in ("candidates", "recall", "precision", "theta", "clauses",
                    "cost_ratio"):
            check(gpu[key] == cpu[key], f"products size 0.3: CUDA vs plain "
                  f"path differ in {key}: {gpu[key]} vs {cpu[key]}")
        log(f"phase 4: products size 0.3: CUDA join == plain-torch join "
            f"(candidates {gpu['candidates']}, theta {gpu['theta']})")

    def phase5_timing(self):
        torch = self.torch
        # kernel A at the main path's first launch
        args, kw = self.captured["cnf_join"]
        tensors, clauses, thetas = args[:4], args[4], args[5]
        tl, tr, er = kw["tl"], kw["tr"], kw["early_reject"]
        n_mis, err = self.cnf_compare(tensors, clauses, thetas, tl=tl, tr=tr,
                                      early_reject=er, what="main-path launch")
        row_a = self._time_cnf(tensors, clauses, thetas, tl, tr, er,
                               one_call=True)
        row_a.update(max_abs_err=err, mismatches=n_mis)
        log(f"phase 5: cnf_join main path: L strip {tuple(tensors[0].shape)}, "
            f"R {tuple(tensors[1].shape)}, clauses {clauses}, tiles {tl}x{tr}: "
            + json.dumps(row_a))
        self.kernels.append(dict(
            name="cnf_join_block", route="cuda",
            source="src/repro_torch/csrc/cnf_join.cu",
            replaces="src/repro/kernels/fused_cnf_join/kernel.py:130",
            launches=self.main_launches["cnf_join"], **row_a))

        # kernel B at the main path's launch: its ranked route
        sargs, skw = self.captured["threshold_sweep"]
        check(skw.get("axes") is not None, "main-path sweep: not the ranked "
              "route")
        got, err = self.sweep_compare(sargs, skw, "main-path sweep")
        row_b = self._time_sweep(sargs, skw, one_call=True)
        row_b.update(max_abs_err=err, mismatches=0)
        log(f"phase 5: threshold_sweep ranked route, main path: cd "
            f"{tuple(sargs[0].shape)}, G {sargs[3].shape[0]}, axes "
            f"{self.np.diff(skw['axes'][1].numpy()).tolist()}, max sel "
            f"{int(got[:, 1].max())}: " + json.dumps(row_b))
        routes = {}
        for what, args, kw in self.sweep_timed:
            row = self._time_sweep(args, kw, one_call=True)
            routes[f"ranked, {what}"] = row
            log(f"phase 5: threshold_sweep ranked route, {what}: k "
                f"{args[0].shape[0]}, G {args[3].shape[0]}: " + json.dumps(row))
        wide = self._time_sweep(self.sweep_wide, {}, one_call=True)
        routes["direct, k 700416, C 5, G 4096 random"] = wide
        log("phase 5: threshold_sweep direct route, k=700416, C=5, G=4096: "
            + json.dumps(wide))
        self._sweep_counts_wall(sargs)
        self.kernels.append(dict(
            name="threshold_sweep", route="cuda",
            source="src/repro_torch/csrc/threshold_sweep.cu",
            replaces="src/repro/kernels/threshold_sweep/kernel.py:60",
            launches=self.main_launches["threshold_sweep"],
            sweep_route="ranked",
            launches_ranked=self.main_launches["threshold_sweep_ranked"],
            launches_direct=self.main_launches["threshold_sweep_direct"],
            **row_b, other_shapes=routes))

        # production cell: the whole plane for the kernel, the strip for all
        p = self.prod
        strip = self._time_cnf(self.prod_strip, p["clauses"], p["thetas"],
                               256, 512, True)
        full_ms = self.time_ms(lambda: self.ck.cnf_join_block(
            *p["args"], p["clauses"], p["thetas"], tl=256, tr=512,
            early_reject=True), runs=5)
        _, evals = self.ck.cnf_join_block(*p["args"], p["clauses"],
                                          p["thetas"], tl=256, tr=512,
                                          early_reject=True, with_evals=True)
        bound, _, bound_fp32, ops, nbytes = self.cnf_bound_ms(
            p["args"], p["clauses"], 256, 512, evals)
        log("phase 5: cnf_join production cell: " + json.dumps({
            "full_ms": full_ms, "full_bound_ms": bound,
            "full_bound_fp32_ms": bound_fp32, "full_ops": ops,
            "full_bytes": nbytes, "full_tflops": ops / full_ms / 1e9,
            "strip_2048": strip}))

    def _time_cnf(self, tensors, clauses, thetas, tl, tr, er, one_call=False):
        torch = self.torch

        def kernel():
            self.ck.cnf_join_block(*tensors, clauses, thetas, tl=tl, tr=tr,
                                   early_reject=er)
        ms = self.time_ms(kernel)
        plain_ms = self.time_ms(lambda: self.cref.cnf_join_tiles_ref(
            *tensors, clauses, thetas, tl=tl, tr=tr, early_reject=er), runs=5)
        emb_l, emb_r = tensors[0], tensors[1]
        members = [fi for m in clauses for k, fi in m if k == self.ck.VEC]

        def library():
            for fi in members:
                torch.matmul(emb_l[fi], emb_r[fi].T)
        lib_ms = self.time_ms(library, runs=5) if members else None
        single = {}
        if one_call:
            single = {
                "ms_one_call": self.time_ms(kernel, reps=1),
                "library_ms_one_call": self.time_ms(library, reps=1)
                if members else None,
                "device_ms": self.device_ms(kernel),
                "library_device_ms": self.device_ms(library)
                if members else None}
        _, evals = self.ck.cnf_join_block(*tensors, clauses, thetas, tl=tl,
                                          tr=tr, early_reject=er,
                                          with_evals=True)
        bound, by, bound_fp32, ops, nbytes = self.cnf_bound_ms(
            tensors, clauses, tl, tr, evals)
        return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": by, "bound_fp32_ms": bound_fp32,
                "library_ms": lib_ms, "ops": ops, "bytes": nbytes,
                "tflops": ops / ms / 1e9, **single}

    def _time_sweep(self, args, kw, one_call=False):
        """Events, one-call and device time of the sweep's route (``axes``
        in ``kw``: ranked), its bound and its plain versions' times."""
        k, c = args[0].shape
        g = args[3].shape[0]
        axes = kw.get("axes")

        def kernel():
            self.sk.threshold_sweep(*args, **kw)
        ms = self.time_ms(kernel)
        plain_direct_ms = self.time_ms(lambda: self.sref.threshold_sweep_ref(
            args[0], args[1], args[3], args[2]), runs=5)
        row = {"route_name": "direct" if axes is None else "ranked", "ms": ms}
        if axes is None:
            row["plain_ms"] = plain_direct_ms
        else:
            row["plain_ms"] = self.time_ms(
                lambda: self.sref.threshold_sweep_ranked_ref(
                    args[0], args[1], args[3], args[2], axes), runs=5)
            row["plain_direct_ms"] = plain_direct_ms
        bound, by, ops, nbytes = self.sweep_bound_ms(k, c, g, axes)
        row.update(bound_ms=bound, bound_by=by, library_ms=None, ops=ops,
                   bytes=nbytes)
        if one_call:
            device, parts = self.device_ms(kernel, by_name=True)
            self.torch.cuda.synchronize()
            row.update(ms_one_call=self.time_ms(kernel, reps=1),
                       device_ms=device, device_parts_ms=parts,
                       host_ms=self.host_ms(kernel))
            self.torch.cuda.synchronize()
        return row

    def _sweep_counts_wall(self, sargs):
        """Host wall of one ops.sweep_counts call at the main-path shape:
        route choice, axes, host-to-device copies, launches and the pull."""
        from repro_torch.kernels.threshold_sweep import ops as sops
        cd, labels, thetas = (a.cpu().numpy() for a in
                              (sargs[0], sargs[1], sargs[3]))
        labels = labels != 0
        walls = []
        for _ in range(6):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            sops.sweep_counts(cd, labels, thetas)
            walls.append(1e3 * (time.perf_counter() - t0))
        log(f"phase 5: ops.sweep_counts wall at the main-path shape (cd "
            f"{cd.shape}, G {thetas.shape[0]}): median "
            f"{statistics.median(walls[1:]):.4f} ms of 5 warm calls, first "
            f"{walls[0]:.4f} ms")


if __name__ == "__main__":
    main()
