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
  1. the card (nvidia-smi name and power limit) and the kernel builds;
  2. cnf_join_block vs its plain version: the kernel-test fixtures, early
     reject on and off, with the evals grid; the production cell
     (262144 x 262144, F_v = 4, D = 128, 3 clauses at theta = 0.4) on a
     2048-row strip against all of R;
  3. threshold_sweep vs its plain version at k = 700000, C in {2, 5},
     G = 4096, with pad rows and +-inf columns (counts exact);
  4. the end-to-end join, barrier then streaming (launch counts reset just
     before each and read just after; both kernels must have run), the
     cuda engine against the numpy engine on the same plan, the
     police_records representative CNF at size 4, and the CUDA join
     against the plain-torch join on a small input;
  5. timing (warm, median of >= 5) at the main path's shapes and at the
     production cell.

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

# NVIDIA data-sheet peaks (dense, no sparsity): FP32 outside the tensor
# cores, and HBM bandwidth, per H100 variant
PEAKS = {"sxm": (67e12, 3.35e12), "pcie": (51e12, 2.0e12)}
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
        self.flops, self.bw = PEAKS["pcie" if "PCIe" in name else "sxm"]
        self.captured = {}
        self.kernels = []
        self.main_launches = {}

    # -- helpers -----------------------------------------------------------
    def time_ms(self, fn, runs=7):
        """Median device ms of ``fn`` over ``runs`` warm calls (CUDA events)."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(runs):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    def reset_launches(self):
        self.ck.launches["cnf_join"] = 0
        self.sk.launches["threshold_sweep"] = 0

    def read_launches(self):
        return {"cnf_join": self.ck.launches["cnf_join"],
                "threshold_sweep": self.sk.launches["threshold_sweep"]}

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
        """Least time for this call: ops over the FP32 peak vs bytes over the
        HBM rate.  Ops count what this data needs: per tile, only the
        clauses it evaluated (evals grid), 2*D per embed member-pair, 2 per
        scalar member-pair, 1 compare per clause-pair."""
        emb_l, emb_r, scal_l, scal_r = args
        d = emb_l.shape[2]
        per_clause = [sum(2 * d if k == self.ck.VEC else 2 for k, _ in m) + 1
                      for m in clauses]
        cum = [0]
        for c in per_clause:
            cum.append(cum[-1] + c)
        counts = evals.flatten().cpu().tolist()
        ops = sum(cum[e] for e in counts) * tl * tr
        n_l, n_r = emb_l.shape[1], emb_r.shape[1]
        used_v = {fi for m in clauses for k, fi in m if k == self.ck.VEC}
        used_s = {fi for m in clauses for k, fi in m if k == self.ck.SCAL}
        nbytes = 4 * (len(used_v) * (n_l + n_r) * d + len(used_s) * (n_l + n_r)
                      + n_l * n_r // 32 + evals.numel())
        return 1e3 * max(ops / self.flops, nbytes / self.bw), ops, nbytes

    def sweep_bound_ms(self, k, c, g):
        ops = g * k * (c + 2)
        nbytes = 4 * (k * (c + 2) + g * c + 2 * g)
        return 1e3 * max(ops / self.flops, nbytes / self.bw), ops, nbytes

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
        log("phase 3: threshold_sweep k=700000 (padded 700416), G=4096, "
            "C in {2, 5}: counts exactly equal")

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
        row_a = self._time_cnf(tensors, clauses, thetas, tl, tr, er)
        row_a.update(max_abs_err=err, mismatches=n_mis)
        grid = (tensors[0].shape[1] // tl) * (tensors[1].shape[1] // tr)
        log(f"phase 5: cnf_join main path: L strip {tuple(tensors[0].shape)}, "
            f"R {tuple(tensors[1].shape)}, clauses {clauses}, tiles {tl}x{tr}, "
            f"{grid} blocks per launch: " + json.dumps(row_a))
        self.kernels.append(dict(
            name="cnf_join_block", route="cuda",
            source="src/repro_torch/csrc/cnf_join.cu",
            replaces="src/repro/kernels/fused_cnf_join/kernel.py:130",
            launches=self.main_launches["cnf_join"], **row_a))

        # kernel B at the main path's launch
        sargs, skw = self.captured["threshold_sweep"]
        got = self.sk.threshold_sweep(*sargs, **skw)
        want = self.sref.threshold_sweep_ref(sargs[0], sargs[1], sargs[3],
                                             sargs[2])
        check(torch.equal(got, want), "main-path sweep: counts differ")
        row_b = self._time_sweep(sargs, skw)
        row_b.update(max_abs_err=float((got - want).abs().max()), mismatches=0)
        log(f"phase 5: threshold_sweep main path: cd {tuple(sargs[0].shape)}, "
            f"G {sargs[3].shape[0]}: " + json.dumps(row_b))
        self.kernels.append(dict(
            name="threshold_sweep", route="cuda",
            source="src/repro_torch/csrc/threshold_sweep.cu",
            replaces="src/repro/kernels/threshold_sweep/kernel.py:60",
            launches=self.main_launches["threshold_sweep"], **row_b))

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
        bound, ops, nbytes = self.cnf_bound_ms(p["args"], p["clauses"], 256,
                                               512, evals)
        log("phase 5: cnf_join production cell: " + json.dumps({
            "full_ms": full_ms, "full_bound_ms": bound, "full_ops": ops,
            "full_bytes": nbytes, "full_tflops": ops / full_ms / 1e9,
            "strip_2048": strip}))
        wide = self._time_sweep(self.sweep_wide, {})
        log("phase 5: threshold_sweep k=700416, C=5, G=4096: " +
            json.dumps(wide))

    def _time_cnf(self, tensors, clauses, thetas, tl, tr, er):
        torch = self.torch
        ms = self.time_ms(lambda: self.ck.cnf_join_block(
            *tensors, clauses, thetas, tl=tl, tr=tr, early_reject=er))
        plain_ms = self.time_ms(lambda: self.cref.cnf_join_tiles_ref(
            *tensors, clauses, thetas, tl=tl, tr=tr, early_reject=er), runs=5)
        emb_l, emb_r = tensors[0], tensors[1]
        members = [fi for m in clauses for k, fi in m if k == self.ck.VEC]

        def library():
            for fi in members:
                torch.matmul(emb_l[fi], emb_r[fi].T)
        lib_ms = self.time_ms(library, runs=5) if members else None
        _, evals = self.ck.cnf_join_block(*tensors, clauses, thetas, tl=tl,
                                          tr=tr, early_reject=er,
                                          with_evals=True)
        bound, ops, nbytes = self.cnf_bound_ms(tensors, clauses, tl, tr, evals)
        return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": "operations" if ops / self.flops >= nbytes / self.bw
                else "bytes", "library_ms": lib_ms, "ops": ops,
                "bytes": nbytes, "tflops": ops / ms / 1e9}

    def _time_sweep(self, args, kw):
        k, c = args[0].shape
        g = args[3].shape[0]
        ms = self.time_ms(lambda: self.sk.threshold_sweep(*args, **kw))
        plain_ms = self.time_ms(lambda: self.sref.threshold_sweep_ref(
            args[0], args[1], args[3], args[2]), runs=5)
        bound, ops, nbytes = self.sweep_bound_ms(k, c, g)
        return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": "operations" if ops / self.flops >= nbytes / self.bw
                else "bytes", "library_ms": None, "ops": ops, "bytes": nbytes}


if __name__ == "__main__":
    main()
