#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds every CUDA kernel from ``src/repro_torch/csrc`` (one nvcc per source,
in parallel), holds each kernel against its plain-torch version on the card,
drives the port's main path (the one-shot FDJ join on ``products`` at
``--size 4``, barrier and streaming refinement) through its user entry
point, checks that both kernels were launched by it, checks the result
against the plain path on a small input, times each kernel with CUDA
events against its bound, its plain version and a library yardstick, and
then drives the serving path (``JoinService`` over a plane store on the
card, the fleet, the precision path, trace export) on the same corpus,
and then the ring engine (``engine="sharded"``: R streamed in bands through
a prefetch ring, candidates compacted on the card by ``csrc/extract.cu``)
on the main path's corpus, the production cell and the serving path, then
the join mesh (the ring L-sharded over ranks) at world sizes 1 and 2, and
then the model zoo's serving path (dense GQA transformers through
``ServeEngine``, phi4-mini-3.8b at full width through ``launch.serve``),
and then its training path (AdamW train steps with checkpoints and
restart, phi4-mini-3.8b at full width), and last the reference's
invariant checks over the port (static analysis, the recall guarantee,
conjunct-order invariance, the lock witness) on the card.

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
     thresholds with pad rows and +-inf columns, on every f32 edge at C in
     {1, 8, 9, 15, 32} (``direct_fixture``) and on a 15-clause
     ``candidate_grid`` at k = 700000 (G = 2**15); the ranked route against
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
     direct route at the wide case (C 2 and 5) and on the 15-clause grid
     (with ptxas's registers and spills of the kernel that ran), and the
     host wall of one
     ``ops.sweep_counts`` call at the main-path shape (route choice and
     host-to-device copies included);
  6. serving on products 2800 x 2800 (``serve_join --size 8``), launch
     counts reset just before and read just after each query: a cold
     query, two warm barrier and two warm stream queries ($0 extraction,
     0 plane bytes to the device, the cold pairs, kernel A fed from the
     ``pack_cache``); ``append_right`` of a quarter of R held out, then a
     delta query over L x dR equal to a cold execution of the plan over
     the grown corpus; a perturbed append whose recalibration swaps theta
     with the sweep on the card, recall >= target after it; a
     ``precision_target`` 0.9 query on the card against the same query on
     ``device="cpu"``; a two-tenant fleet, concurrent against serial, the
     second tenant's cold query riding the first's planes; the production
     cell's planes pinned in a store on the card, staged by
     ``pack_features_device`` with 0 bytes to the device, kernel A on a
     2048-row strip bit-identical to the host-staged strip; one warm
     query's trace and the ``serve_join --trace-out`` trace checked by
     ``trace_report --check`` (both written under ``build/traces/``).
     Each query prints its walls (plan, step ②, refine), kernel A's ms
     by events around its calls and its launches; a warm query's device
     busy time comes from the profiler;
  7. the ring engine: (a) the compaction kernel bit-identical to its plain
     version on random masks (densities 0 to 1, overflow, offsets, up to
     2**14 x 2**12 bits; a production band's 262144 x 128 words at
     densities 0, 2e-6 and 1e-3; a count 100 below 2**31, which wraps and
     writes nothing), its count given as an int and as a device tensor;
     (b) the one-shot join on ``products --size 4``
     through ``launch.join --engine sharded --r-chunk 512`` (launch counts
     reset just before and read just after: kernel A and the compaction
     launch once a band step and once a retry or re-dispatch), then the
     same plan executed through the ring at depths 1, 2 and 4, barrier and
     stream, each against the cuda engine's candidates, with an overflow
     retry and ``overlap_s`` 0.0 at depth 1, > 0 deeper; (c) the
     production cell at ``r_chunk`` 4096: a 2048-row strip's ring pairs
     equal to the cuda engine's, then the full 262144^2 plane through the
     ring from phase 6's store (wall, device time by kernel, steps,
     ``bytes_to_host`` = 12 a step + 8 a pair); (d) warm and delta queries
     of the serving path with the engine overridden to ``sharded`` (no new
     plan, 0 bytes to the device), equal to the cuda engine's, and phase
     6's two-tenant fleet on ``sharded`` (band steps through the fleet's
     scheduler, concurrent == serial == phase 6's pairs); (e) the
     ring's traces checked by ``trace_report --check``; the compaction
     kernel timed at the main path's band and at a production band
     (events, one call, the profiler's device time and kernels a call,
     which must be 1, and the host's enqueue time a call), each reading
     held to its bytes bound;
  8. the join mesh (the ring L-sharded over ranks): (a) a world of one
     through the mesh code path — ``products --size 4`` through
     ``launch.join --engine sharded --pods 1`` equal to phase 7's launcher
     run, phase 7's plan through a (1, 1, 1) join mesh with 0 pairs
     differing from phase 7's ring, and the production plane (its shape
     from ``build_join_cell``) through the (1, 1, 1) mesh, phase 7's pairs
     with ``bytes_to_host`` = 12 a step + 8 a pair; (b) two ranks sharing
     the card, as (2, 1, 1) and (1, 2, 1), spawned by ``multipod_dryrun
     --device cuda``: the production plane at ``r_chunk`` 4096 with phase
     7's candidate count and ``bytes_to_host`` = 12 a rank a step + 8 a
     pair, cross-pod collectives of int32 counts only, and the dry-run's
     parity, stream, overflow and serving checks, with both kernels
     launched on every rank (counts printed).  Walls beside the card's
     name and power limit;
  9. the model zoo's serving path, which runs none of the three kernels
     (their counts, set to 0 before it, must stay 0): (a) the five dense
     smoke configs in float32, weights drawn on the CPU and moved to the
     card, a wave of three ragged prompts through ``ServeEngine`` on both
     devices: equal greedy tokens, prefill logits within 1e-4 of max
     |logit| (3e-2 where a bf16 KV-cache element rounded the other way);
     (b) ``launch.serve --arch phi4-mini-3.8b --full --requests 16
     --max-new 12 --batch-slots 8 --device cuda``: 192 tokens, wall and
     tok/s; (c) the same model in process: prefill ms per wave and decode
     ms per step by CUDA events, the decode step's device time and bytes
     bound, peak memory; (d) prefill 32 tokens and decode the 33rd against
     a full forward, within 0.15 of max |logit|; (e) a padded wave of
     three against solo runs at full width, in bf16 and in f32: the share
     of equal greedy tokens, the prefill logits' difference and the solo
     top-2 gap (printed, not required); then the MoE configs, in a window
     of their own whose counts must stay 0 as well (``launches_moe``):
     (a) llama4-maverick's and deepseek-v2's smoke configs as in (a), in
     float32 with a capacity that drops nothing (E / k), the cache flips
     read from MLA's ``ckv``/``kr``, router ids that differ counted; (b)
     ``launch.serve --arch deepseek-v2-236b --smoke --device cuda``: 192
     tokens; (c) deepseek-v2-236b at full width cut to 2 of its 60 layers
     (5 358 679 040 parameters) and llama4-maverick-400b-a17b cut to 2 of
     48 (18 553 267 200), bf16, each leaf drawn on the card in f32 and
     rounded as it is drawn: init s and peak memory, the launcher's 16
     requests x 12 new tokens on 8 slots (wall, tok/s, dropped choices a
     wave, the first prefill's expert-load histogram), prefill ms a wave,
     decode ms a step (events) with its device ms and busy share against
     two bytes bounds (every weight, which ``moe_ffn_dense`` reads; the
     experts the step chose), max |logit|; (d) decode against a full
     forward with no drops (< 0.15 of max |logit| where no routing choice
     of the decoded token flipped; flips counted), and in float32 compute
     decode against a prefill through the same bf16 cache (1e-4, or 3e-2
     with cache flips; no routing flip); (e) padded against solo
     (recorded); then the SSM blocks and gated cross-attention, in a
     window of their own whose counts must stay 0 (``launches_ssm``): (a)
     zamba2's, xlstm's and llama-3.2-vision's smoke configs in float32
     (cross gates 0.5, a memory from the seed), card against CPU: forward,
     prefill of 69 tokens and the 70th decoded within 1e-4 of max |logit|,
     a ``ServeEngine`` wave's greedy tokens equal; (b) ``launch.serve
     --full`` for zamba2-1.2b and xlstm-350m: 192 tokens each; (c)
     zamba2-1.2b (38 layers, 1 352 519 680 parameters) whole, xlstm-350m
     cut to 12 of 24 layers (254 184 496), llama-3.2-vision-90b cut to 10 of
     100 layers (10 678 870 018; a memory (8, 1600, 1280), prefill with it
     must differ from prefill without), bf16: init s and peak, the
     launcher's 16 requests in process, prefill ms a wave and of 8 x 256
     tokens, decode ms a step (events), device ms and busy share against
     the bytes bound; (d) zamba2 prefill 1 x 512 tokens (2 chunks)
     and xlstm 1 x 256, and decode one, in float32 compute and bf16: the
     first layer's state within 1e-4 of a prefill of all n + 1 (f32); the
     decode against that prefill and against a full forward recorded
     (the random models keep the forward, which starts mLSTM and sLSTM
     from the reference's other initial state, and zamba2's bf16 KV
     cache, more than 0.15 away at this length);
 10. the model zoo's training path, which runs none of the three kernels
     either (counts set to 0 before it stay 0): (a) the five dense smoke
     configs, the two MoE ones (no drops; aux > 0 and finite) and the
     three SSM / cross ones (a memory in llama-vision's batch) in
     float32, weights drawn on the CPU and copied to the card, two train
     steps (``steps.make_train_step``, AdamW) on both devices from one
     batch: equal ``lr``, loss within 1e-5, ``grad_norm`` within 1e-3,
     ``m`` within 1e-3 of each parameter's max -- or within twice the
     config's float32 noise floor where that is larger (the CPU run's
     distance from a float64-compute run: deepseek-v2's smoke model at
     step 2) -- parameters within ``2.5 * lr`` a step (the share of
     elements further apart than ``1e-2 * lr`` a step is printed);
     (b) ``launch.train --device cuda`` at smoke size: a run that fails at
     an injected step, then one that resumes from its checkpoint and ends
     with a finite loss; (c) phi4-mini-3.8b at full width (f32 masters,
     bf16 compute, remat) with the launcher's loader (batch 8, seq 128):
     six steps, every loss finite and ``grad_norm`` > 0; step ms (CUDA
     events, median of steps 2-6), tok/s, model FLOPs and MFU against the
     bf16 peak, the optimizer alone against its bytes bound (p, g, m, v
     read, p, m, v written: 28 B a parameter), the card's busy share of a
     step (profiler, one step) beside the host's time to enqueue one, and
     peak memory against the 61.38 GB of state; then zamba2-1.2b whole
     and xlstm-350m at 12 of its 24 layers the same way (state 21.64 and
     4.07 GB);
 11. the model mesh and the expert-parallel MoE, over worlds of ranks
     sharing the card through gloo (``launch/ep_world.py``), none of
     which may launch a join kernel: (a) the two MoE smoke configs in
     float32 at (1, 2) and (2, 2), card against CPU in one world: a
     prefill of 8 x 64 (``moe_ffn_ep``), 8 decode steps
     (``moe_ffn_ep_replicated_dsharded``), one train step with
     ``use_ep`` (held to max(tolerance, the CPU's own floor: its step on
     weights nudged one ulp)), ``moe_ffn_ep_replicated`` called
     directly, and on the card the block's decode against
     ``moe_ffn_dense``; (b)
     deepseek-v2-236b at full width (``EP_FULL_LAYERS`` of 60 layers,
     bf16) over (1, 2) against world 1's ``moe_ffn_dense``, each MoE call against world
     1's layer on the rank's own input (a decode's expert sums in the EP
     decode's order) and every step's logits against world 1 run with
     the rank's MoE outputs (``_ep_full_width``; its ranks run
     ``_ep_full_width_rank``, so the ranks import this file); (c) a
     world-1 checkpoint restored onto (1, 2), and ``launch.train --mesh
     single`` refused at world 1; (d) the dense GQA leaves as their
     ``param_specs`` blocks (tensor-parallel attention and FFN, the batch
     split over ``batch``): phi4-mini's train step over (1, 2) and (2, 1)
     in one world of two ranks (``_dense_tp_rank``), its smoke config
     card against CPU in float32, and at full width (``DENSE_TP_LAYERS``
     layers, bf16 compute, f32 masters) two steps against world 1 (the
     logits and the taught layers against world 1 run on the mesh's
     groups of rows, where it splits them): step ms a rank, peak memory,
     collectives by axis and route; (e) the other
     leaf kinds as their ``param_specs`` blocks (MLA, cross-attention,
     Mamba2, mLSTM, sLSTM, the frontend and memory projections): the
     smoke configs of ``LEAVES_SMOKE`` card against CPU as (d)'s, and
     the models of ``LEAVES_FULL`` cut in depth against world 1 as
     (d)'s full width (``_leaves_tp_rank``), one layer of each new kind
     taught; (f) the decode state as its ``state_specs`` blocks (each
     rank holds and runs against its rows, KV heads, latent columns and
     mixer-state columns): the smoke configs of ``CACHE_SMOKE`` prefilled
     and decoded card against CPU with f32 caches, and the models of
     ``CACHE_FULL`` at full width cut in depth, a prefill of 8 x 512
     into 1024 slots and 16 decode steps against world 1
     (``_cache_tp_rank``): state bytes and decode ms a step a rank
     against world 1's, the ledger a step by axis; (g) a dry-run cell
     run for real with its heads padded: ``launch.cells.build_cell``'s
     starcoder2-3b ``decode_32k`` cell (2 layers, f32, KV heads 2 -> 4)
     over (1, 4), four ranks sharing the card, on world-1 weights padded
     by ``tp_pad_weights``: a prefill into the cell's state and 4 decode
     steps through its step against the unpadded world 1 on the card
     (``_padded_cell_rank``); and ``python -m repro_torch.launch.dryrun``
     on the host for one cell of each kind on both production meshes
     (``DRYRUN_CELLS``, meta tensors, no card), each record printed;
 12. the reference's invariants over the port, each sub-phase's wall and
     launches printed (counts set to 0 just before it, read just after):
     (a) ``python -m repro_torch.analysis --check`` exits 0 on the port's
     tree (lock graph and lint rules), every waived hold printed with its
     reason; (b) the recall guarantee through ``fdj_join`` on engine
     ``cuda``, barrier mode, 25 seeds x biodex and police: failure rate
     <= delta + 2 sigma and mean recall >= target, and on the 5 smoke
     seeds theta equal to the CPU port's and candidates equal to its but
     for pairs within the f32 band; (c) ``representative_cnf`` on
     police_records 74 x 74 and 1400 x 1400 through ``cuda`` and
     ``sharded``: every conjunct order, early reject on and off, one
     candidate set (the numpy engine's but for the f32 band); (d) the
     3-tenant ``sharded`` fleet under ``lock_witness(guard_blocking=
     True)``, whose guard wraps the CUDA syncs and the ring's pulls,
     planning on an empty curve cache: no order cycle observed or merged
     into the static graph, no blocking pull under a lock, equal pairs
     for the tenants sharing a corpus;
 13. the join fleet over a world of ranks (``phase13_fleet_world``):
     ``launch.serve_fleet``'s ``run_fleet``, engine ``sharded``, on
     world 1 in this process and on world 2 (two ranks sharing the card
     over gloo, ``launch.ep_world.run_world`` with
     ``_fleet_world_rank``), rank 0 ordering admissions and every
     collective: (a) 3 tenants on one corpus, products 2800 x 2800
     (phase 6's), 3 workers; (b) 2 tenants on corpora of their own,
     products 1400 x 1400 at seeds 0 and 1, 2 workers; one (cold) query
     a tenant.  Rank 0's per-query pairs, theta and candidates equal
     world 1's (and in (a) phase 6's ``cuda`` engine's) but for
     phase 6's corpus's pairs in the f32 band, the fleet's dollars
     (``math.fsum`` of every query's) equal world 1's; shared: one plan
     built on every rank and a cold query at $0 extraction and
     labelling; ``bytes_to_host`` 12 B a rank a band step + 8 B a pair;
     every rank agrees on rank 0's admission and grant sequences, band
     steps, interleaves and collective calls by group (``ranks_agree``);
     each query's wall on each rank against world 1, each rank's
     launches of the three kernels and the control records printed.

A mask bit may differ from the plain version only for a pair whose float64
distance lies within D * 2**-24 of a threshold (f32 dot products summed in
another order); every other difference fails.  Sweep counts must be equal.

Prints the card line, a ``{"kernels": [...]}`` line (each kernel's
``launches`` from the main path -- the compaction's from the ring's main
path, where kernels A and B give theirs as ``launches_ring`` -- and
``launches_serving`` per serving path, ``launches_zoo``,
``launches_moe``, ``launches_ssm``, ``launches_train`` and
``launches_model_mesh`` 0, ``launches_invariants`` per sub-phase of
phase 12, and ``launches_fleet_world`` per sub-phase and world of phase
13), and as its last line
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
without a CUDA device or outside a checkout of the repository.
"""

import json
import math
import os
import shutil
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
# phase 6's corpus: serve_join --size 8 at SERVE_SCALE 0.5, i.e. products
# 2800 x 2800, the one-shot main path's corpus; a quarter of R is held out
# for the appends
SERVE_SIZE = 8
# phase 9: the dense ("attn",) configs of the model zoo, and the one served
# at full width (the launcher's default --arch)
ZOO_DENSE = ("phi4-mini-3.8b", "mistral-nemo-12b", "minitron-8b",
             "starcoder2-3b", "musicgen-medium")
ZOO_ARCH = "phi4-mini-3.8b"
# phase 9's MoE configs, smoke size card against CPU, and at full width cut
# in depth to fit one card: (arch, layers, parameters); deepseek-v2 first,
# its dense layer 0 and one MoE layer (4 layers until phase 11 (g) came,
# cut for time)
ZOO_MOE = ("llama4-maverick-400b-a17b", "deepseek-v2-236b")
ZOO_MOE_FULL = (("deepseek-v2-236b", 2, 5_358_679_040),
                ("llama4-maverick-400b-a17b", 2, 18_553_267_200))
# phase 9's SSM and cross-attention configs, smoke size card against CPU,
# and at full width (phases 9 and 10 (c)): (arch, layers, parameters);
# llama-vision cut to 10 of its 100 layers (2 periods, so 2 cross layers;
# 20 until phase 11 (f) came, cut for time); xlstm to 12 of its 24 for time (6 mLSTM + 6 sLSTM: its
# sLSTM is a Python loop over time, and 24 layers took 84 s of phase 10
# (c) and 35 s of phase 9).  Not fewer: a scanned leaf's fan_in is its
# period count, so fewer periods draw larger weights, and the card's draw
# at 6 and at 8 layers gives NaN gradients (the reference gives NaN on
# the port's CPU draw at 6 too; ROADMAP queue 3)
ZOO_SSM = ("zamba2-1.2b", "xlstm-350m", "llama-3.2-vision-90b")
ZOO_SSM_FULL = (("zamba2-1.2b", 38, 1_352_519_680),
                ("xlstm-350m", 12, 254_184_496),
                ("llama-3.2-vision-90b", 10, 10_678_870_018))
# phase 10: bf16 dense peak of the data sheet (SXM / PCIe), for the MFU
BF16_PEAK = {"sxm": 989e12, "pcie": 756e12}
# phase 9 (SSM) (d): the long prefill's length per config, cut from 4096
# to keep the script under 1000 s (xlstm's sLSTM is a Python loop over
# time, on the card ≈ 15 s a 4096-token pass); zamba2's from 2048 to 1024
# when phase 11 (e) came; when phase 11 (g) came, zamba2's to 512 and
# xlstm's from 512 to 256
LONG_PREFILL = {"zamba2-1.2b": 512, "xlstm-350m": 256}
# phase 11 (b): deepseek-v2's depth over (1, 2), its dense layer 0 and one
# MoE layer (4 until phase 11 (g) came, cut for time)
EP_FULL_LAYERS = 2
# phase 11 (d): phi4-mini's depth over two ranks sharing the card (a layer
# 100.7 M parameters, the embedding 614.6 M; 16 B a parameter in training);
# cut from 4 to make room for (e) (the taught gates read alike at 2, 4 and
# 8 layers)
DENSE_TP_LAYERS = 2
# phase 11 (e): the smoke configs of the leaf kinds beyond the dense GQA
# ones, (name, arch, config overrides, meshes): MLA alone (a dense FFN),
# MLA beside the expert-parallel MoE, cross-attention and memory_proj,
# Mamba2 beside GQA, mLSTM and sLSTM
LEAVES_SMOKE = (
    ("mla", "deepseek-v2-236b", {"ffn_kind": "dense", "moe": None},
     ("1x2", "2x1")),
    ("mla_ep", "deepseek-v2-236b", {}, ("1x2",)),
    ("vision", "llama-3.2-vision-90b", {}, ("1x2", "2x1")),
    ("zamba", "zamba2-1.2b", {}, ("1x2", "2x1")),
    ("xlstm", "xlstm-350m", {}, ("1x2", "2x1")))
# and at full width, cut in depth: (arch, layers, train, meshes, taught
# layers).  deepseek-v2's layer 0 (MLA and its dense FFN, d_ff 12 288;
# 1.39 B parameters), one zamba2 period (5 Mamba2 + 1 attention; 0.33 B),
# xlstm's mLSTM and sLSTM (0.13 B), llama-vision's first 5 layers, the
# least that hold a cross layer (6.40 B: ~100 GB of f32 training state,
# which does not fit beside two ranks, so bf16 parameters and the forward
# alone).  MLA and the cross layer only over (1, 2): over (2, 1) their
# fsdp gathers would move ~2.8 and ~12.8 GB of bf16 weights through the
# host at ~0.5 GB/s
LEAVES_FULL = (
    ("deepseek-v2-236b", 1, True, ("1x2",), (0,)),
    ("zamba2-1.2b", 6, True, ("1x2", "2x1"), (0,)),
    ("xlstm-350m", 2, True, ("1x2", "2x1"), (0, 1)),
    ("llama-3.2-vision-90b", 5, False, ("1x2",), (4,)))
# its full-width gates against world 1 (bf16 compute): each step's loss
# relative (the random model's loss is ln V to 7e-4, so the limit lies
# below that) and the logits of max |logit|, each raised to twice world
# 1's own floor (its run on weights nudged one ulp) where that is larger;
# layer 0 and the embedding's two uses taught (fixed inputs and
# cotangent), each output and gradient as ||x - world 1's|| / ||world
# 1's||, on the same weights: not raised (a one-ulp nudge of the weights
# moves these more than the rounding of one layer does)
DENSE_TP_TOL = {"loss": 2e-4, "logits": 3e-2, "teacher": 3e-2}
# phase 11 (f): the decode state as its state_specs blocks.  Smoke (name,
# arch, config overrides, batch), tests/test_torch_cache_tp.py's cases: a
# GQA model with a batch the (2, 1) batch axis does not divide, MLA with
# a dense FFN, Mamba2 beside GQA with left padding, mLSTM and sLSTM, GQA
# beside cross layers prefilled with a memory; a prefill of 12 tokens
# into 16 slots, 4 decode steps.  At full width, cut in depth to the
# models of (d) and (e): (arch, layers, meshes); a prefill of 8 x
# CACHE_PREFILL tokens into CACHE_CAPACITY slots, then CACHE_STEPS decode
# steps; the logits held to DENSE_TP_TOL's, raised to twice world 1's
# one-ulp floor where that is larger and below 1
CACHE_SMOKE = (
    ("gqa", "phi4-mini-3.8b", {}, 3),
    ("mla", "deepseek-v2-236b", {"ffn_kind": "dense", "moe": None}, 8),
    ("zamba", "zamba2-1.2b", {}, 8),
    ("xlstm", "xlstm-350m", {}, 8),
    ("vision", "llama-3.2-vision-90b", {}, 8))
CACHE_FULL = (
    ("phi4-mini-3.8b", 2, ("1x2", "2x1")),
    ("deepseek-v2-236b", 1, ("1x2",)),
    ("zamba2-1.2b", 6, ("1x2",)),
    ("xlstm-350m", 2, ("1x2",)))
CACHE_PREFILL, CACHE_CAPACITY, CACHE_STEPS = 512, 1024, 16
# phase 11 (g): the padded decode cell over (1, 4): (arch, shape, layers),
# a prompt of PADDED_PROMPT tokens into the cell's state (its batch of 128
# and 32768 slots, f32 caches) and PADDED_STEPS decode steps; in f32
# compute, so that the mesh's order of sums alone sets its distance from
# world 1
PADDED_CELL = ("starcoder2-3b", "decode_32k", 2)
PADDED_PROMPT, PADDED_STEPS = 8, 4
# and the host's dry-run, one cell of each kind at one period on both
# production meshes: dense train, MoE + MLA decode, SSM long_500k, cross
# prefill, padded decode
DRYRUN_CELLS = (("phi4-mini-3.8b", "train_4k"),
                ("deepseek-v2-236b", "decode_32k"),
                ("zamba2-1.2b", "long_500k"),
                ("llama-3.2-vision-90b", "prefill_32k"),
                ("starcoder2-3b", "decode_32k"))


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
    ctx.phase6_serving()
    ctx.phase7_ring()
    ctx.phase8_mesh()
    ctx.phase9_zoo()
    ctx.phase9_moe()
    ctx.phase9_ssm()
    ctx.phase10_train()
    ctx.phase11_model_mesh()
    ctx.phase12_invariants()
    ctx.phase13_fleet_world()
    ctx.serving_launches()
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
        from repro_torch.kernels.extract import kernel as ek, ref as eref
        from repro_torch.kernels.fused_cnf_join import kernel as ck, ref as cref
        from repro_torch.kernels.threshold_sweep import kernel as sk, ref as sref
        self.torch, self.np = torch, np
        self.build, self.ck, self.cref, self.sk, self.sref = \
            _build, ck, cref, sk, sref
        self.ek, self.eref = ek, eref
        self.dev = torch.device("cuda")
        name = torch.cuda.get_device_name(0)
        self.flops, self.bw, self.tf32 = \
            PEAKS["pcie" if "PCIe" in name else "sxm"]
        self.bf16 = BF16_PEAK["pcie" if "PCIe" in name else "sxm"]
        self.captured = {}
        self.kernels = []
        self.main_launches = {}
        self.sweep_timed = []     # (what, args, kw) of ranked cases to time
        self.sweep_direct = {}    # what -> args of direct-route cases to time
        # one FP32 lane operation a lane a clock: the FP32 FLOP rate counts
        # each FMA lane-clock as two
        self.lane_ops = self.flops / 2

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
        activity's ms per call, keyed by its name's first 40 characters.
        How many times the profiler recorded each activity is left in
        ``self.device_calls``: a count that is not a multiple of ``n``
        means records were lost, and the time is then None (not
        measured)."""
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
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.key != "Activity Buffer Request"]
        parts = {e.key[:40]: e.self_device_time_total / n / 1e3
                 for e in events}
        self.device_calls = {e.key[:40]: e.count for e in events}
        total = sum(parts.values())
        if any(c % n for c in self.device_calls.values()):
            log(f"profiler: activity counts {self.device_calls} are not "
                f"multiples of {n} calls: device time not measured")
            total = None
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
        self.ek.launches["compact"] = 0
        for name in self.sk.launches:
            self.sk.launches[name] = 0

    def read_launches(self):
        return {"cnf_join": self.ck.launches["cnf_join"],
                "compact": self.ek.launches["compact"], **self.sk.launches}

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
        operations, each one lane-instruction, over the card's FP32 lane
        rate (``lane_ops``: half the FP32 FLOP rate, which counts an FMA
        twice).  Ranked route: per sample and per threshold row, a binary
        search of ceil(log2(u_c + 1)) compares and a multiply-add a clause,
        plus log2(u_c) adds a bin a clause for the prefix, over the FP32
        FLOP rate."""
        nbytes = 4 * (k * (c + 2) + g * c + 2 * g)
        if axes is None:
            ops = g * k * (c + 2)
            ops_s = ops / self.lane_ops
        else:
            u = self.np.diff(axes[1].numpy()).tolist()
            bins = int(self.np.prod(u))
            ops = (k + g) * sum(int(n).bit_length() + 2 for n in u) + \
                bins * sum(max(int(n) - 1, 0).bit_length() for n in u)
            ops_s = ops / self.flops
        bytes_s = nbytes / self.bw
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
        secs = self.build.build_all(["cnf_join", "threshold_sweep",
                                     "extract"])
        log(f"build: {json.dumps({k: round(v, 2) for k, v in secs.items()})} "
            f"(parallel nvcc, wall {time.perf_counter() - t0:.2f} s)")
        for name in secs:
            for line in self.build.ptxas_report(name):
                log(f"ptxas {name}: {line}")
        entries = [ln for ln in self.build.ptxas_report("extract")
                   if "Compiling entry function" in ln]
        check(len(entries) == 1, f"csrc/extract.cu builds {len(entries)} "
              f"kernels, want one")

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

        # production cell (launch.join.build_join_cell on a 1-rank mesh:
        # the whole plane): planes on the card, compared on a 2048-row strip
        from repro_torch.distributed.mesh import make_join_mesh
        from repro_torch.launch.join import build_join_cell
        cell, (a_l, a_r) = build_join_cell(make_join_mesh(1, 1, 1))
        g = torch.Generator(device=self.dev).manual_seed(0)
        emb_l = torch.randn(a_l.shape, generator=g, device=self.dev)
        emb_r = torch.randn(a_r.shape, generator=g, device=self.dev)
        emb_l /= emb_l.norm(dim=-1, keepdim=True)
        emb_r /= emb_r.norm(dim=-1, keepdim=True)
        fv, n, d = emb_l.shape
        scal_l = torch.zeros((1, n), device=self.dev)
        scal_r = torch.zeros((1, emb_r.shape[1]), device=self.dev)
        self.prod = dict(args=(emb_l, emb_r, scal_l, scal_r),
                         clauses=cell.clauses, thetas=cell.thetas)
        p = self.prod
        strip = (emb_l[:, :2048], emb_r, scal_l[:, :2048], scal_r)
        n_mis, err = self.cnf_compare(strip, p["clauses"], p["thetas"],
                                      tl=256, tr=512, early_reject=True,
                                      what="production strip")
        log(f"phase 2: production cell {n}^2, F_v={fv}, D={d}, "
            f"{len(cell.clauses)} clauses: "
            f"strip 2048 x {n} ok, {n_mis} mismatched bits "
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
        from repro_torch.launch.bench_sweep import K, wide_case
        torch = self.torch
        for c in (2, 5):
            args = [torch.from_numpy(a).to(self.dev) for a in wide_case(c)]
            got = self.sk.threshold_sweep(*args)
            want = self.sref.threshold_sweep_ref(args[0], args[1], args[3],
                                                 args[2])
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"threshold_sweep C={c}: counts "
                  f"differ in {int((got != want).sum())} entries")
            check(int(got[0, 1]) == K and int(got[1, 1]) == 0,
                  "threshold_sweep: pad rows or -inf rows miscounted")
            self.sweep_direct[f"k 700416, C {c}, G 4096 random"] = args
        log("phase 3: threshold_sweep direct route, k=700000 (padded 700416),"
            " G=4096 random thresholds, C in {2, 5}: counts exactly equal")
        self._sweep_direct_cases()
        self._sweep_ranked_cases()
        self._sweep_route_choice()

    def _sweep_direct_cases(self):
        """The direct kernel against its plain version, counts exactly
        equal, one launch each: every f32 edge at C in {1, 8, 9, 15, 32}
        (``direct_fixture``: NaN, +-0.0, +-inf, k 1037 padded, 2048 pad
        rows at -inf), and a 15-clause ``candidate_grid`` at k 700000
        (2**15 rows, as ``ops.sweep`` pads it: 700416 sample rows;
        ``bench_sweep.grid_case``, which ``grid_fixture(215, 700000, 15,
        False)`` equals)."""
        from repro_torch.data.sweep_fixtures import direct_fixture
        from repro_torch.launch.bench_sweep import grid_case
        np, torch = self.np, self.torch
        cases = {f"edge fixture C={c}": direct_fixture(c, seed=c)
                 for c in (1, 8, 9, 15, 32)}
        cases["candidate_grid C=15"] = grid_case()
        for what, arrays in cases.items():
            args = [torch.from_numpy(np.ascontiguousarray(a)).to(self.dev)
                    for a in arrays]
            self.reset_launches()
            got = self.sk.threshold_sweep(*args)
            launched = self.sk.launches["threshold_sweep_direct"]
            want = self.sref.threshold_sweep_ref(args[0], args[1], args[3],
                                                 args[2])
            torch.cuda.synchronize()
            check(launched == 1, f"{what}: the direct kernel was not "
                  f"launched once: {self.sk.launches}")
            check(torch.equal(got, want), f"{what}: the direct kernel "
                  f"differs from the plain version in "
                  f"{int((got != want).sum())} entries")
            log(f"phase 3: threshold_sweep direct route, {what}: k "
                f"{args[0].shape[0]}, G {args[3].shape[0]}, counts equal to "
                f"the plain version (max sel {int(got[:, 1].max())})")
            if what.startswith("candidate_grid"):
                self.sweep_direct["k 700416, C 15, G 32768 candidate_grid"] \
                    = args

    def _direct_ptxas(self, c):
        """ptxas's lines (registers, spills) for the direct kernel that runs
        C clauses: ``sweep_kernel<C>`` up to 16 clauses, else the next
        multiple of 4."""
        slots = c if c <= 16 else -(-c // 4) * 4
        lines, keep = [], False
        for line in self.build.ptxas_report("threshold_sweep"):
            if "Compiling entry function" in line:
                keep = f"sweep_kernelILi{slots}E" in line
            elif keep:
                lines.append(line)
        return lines

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
                self.phase4_out = out
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
        routes.update(self.time_direct_sweeps())
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

    def time_direct_sweeps(self):
        """Phase 3's direct-route cases timed (``_time_sweep``), each with
        ptxas's lines for the kernel that ran and its share of the bound."""
        rows = {}
        for what, args in self.sweep_direct.items():
            row = self._time_sweep(args, {}, one_call=True, plain_runs=3)
            row["ptxas"] = self._direct_ptxas(args[0].shape[1])
            # over the device time, or the events' where the profiler lost
            # a record (a memset's, at the 15-clause grid)
            row["bound_fraction"] = row["bound_ms"] / (row["device_ms"]
                                                       or row["ms"])
            rows[f"direct, {what}"] = row
            log(f"phase 5: threshold_sweep direct route, {what}: "
                + json.dumps(row))
        return rows

    def _time_sweep(self, args, kw, one_call=False, plain_runs=5):
        """Events, one-call and device time of the sweep's route (``axes``
        in ``kw``: ranked), its bound and its plain versions' times (median
        of ``plain_runs``)."""
        k, c = args[0].shape
        g = args[3].shape[0]
        axes = kw.get("axes")

        def kernel():
            self.sk.threshold_sweep(*args, **kw)
        ms = self.time_ms(kernel)
        plain_direct_ms = self.time_ms(lambda: self.sref.threshold_sweep_ref(
            args[0], args[1], args[3], args[2]), runs=plain_runs)
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


    # -- phase 6: serving ----------------------------------------------------
    def _serving_hooks(self):
        """Wrap the engine's kernel-A call once more: CUDA events around
        each call (kernel A's ms per query) and the emb_r pointer it was
        given (to show the warm path launches from the ``pack_cache``)."""
        from repro_torch.kernels.fused_cnf_join import ops as cops
        torch = self.torch
        seen = self.serve_seen = {"events": [], "emb_r": []}
        orig = cops.cnf_join_block

        def call(*args, **kw):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = orig(*args, **kw)
            b.record()
            seen["events"].append((a, b))
            seen["emb_r"].append(args[1].data_ptr())
            return out
        cops.cnf_join_block = call

    def serve_query(self, svc, what, options=None, append=None, phase=6):
        """One query (or append) with the launch counts set to 0 just before
        and read just after.  Returns (result, row): the walls (plan, step
        ②, refine), kernel A's ms by events, launches, bytes and
        dollars."""
        from repro_torch.obs import Tracer, use_tracer
        torch = self.torch
        self.reset_launches()
        self.serve_seen["events"].clear()
        self.serve_seen["emb_r"].clear()
        tracer = Tracer()
        t0 = time.perf_counter()
        with use_tracer(tracer):
            out = svc.append_right(append) if append is not None \
                else svc.query(options)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = self.read_launches()
        spans = {}
        for sp in tracer.spans():
            spans[sp.name] = spans.get(sp.name, 0.0) + sp.duration_s
        kernel_ms = sum(a.elapsed_time(b) for a, b in self.serve_seen["events"])
        row = {"wall_s": round(wall, 4), "plan_s": round(spans.get("plan", 0.0), 4),
               "extract_s": round(spans.get("extract", 0.0), 4),
               "kernel_a_ms": round(kernel_ms, 5), "launches": launches}
        if append is None:
            walls = out.cost.wall_summary()
            row.update(step2_s=round(walls["step2_wall"], 4),
                       refine_s=round(walls["refine_wall"], 4),
                       recalibrate_s=round(spans.get("recalibrate", 0.0), 4),
                       plan_hit=out.plan_hit, delta_rows=out.delta_rows,
                       candidates=out.join.candidate_count,
                       pairs=len(out.pairs), recall=round(out.join.recall, 4),
                       extraction_usd=out.cost.inference,
                       bytes_h2d=out.cost.bytes_h2d,
                       store_hits=out.store["hits"],
                       store_misses=out.store["misses"],
                       dedup_hits=out.store["dedup_hits"])
        else:
            row.update(rows=out["rows"],
                       extraction_usd=out["ledger"].inference,
                       bytes_to_device=out["store"]["bytes_to_device"])
        log(f"phase {phase}: {what}: " + json.dumps(row))
        return out, row

    def _strips(self, n_l, tl=256, l_block=1024):
        return -(-(-(-n_l // tl) * tl) // l_block)

    def _candidates_in_band(self, got, want, feats, plan, what):
        """Candidate sets may differ only in pairs within the f32 band of a
        threshold; returns the differing pairs."""
        from repro_torch.core.join import apply_conjunct_order
        from repro_torch.kernels.fused_cnf_join.ops import pack_features
        diff = sorted(set(got) ^ set(want))
        if diff:
            clauses, th = apply_conjunct_order(plan.sc_local.clauses,
                                               plan.theta, plan.conjunct_order)
            arrays = pack_features(feats, clauses, tl=256, tr=512)
            args = [self.torch.from_numpy(x).to(self.dev) for x in arrays[:4]]
            gap = self.cref.threshold_gap(*args, arrays[4], th,
                                          [p[0] for p in diff],
                                          [p[1] for p in diff])
            check((gap <= self.cref.dot_error_band(args[0].shape[2])).all(),
                  f"{what}: candidates differ outside the f32 band")
        return set(diff)

    def phase6_serving(self):
        """The serving path on the card at the one-shot main path's corpus:
        products 2800 x 2800 (serve_join --size 8 at SERVE_SCALE 0.5)."""
        from repro_torch.launch._args import make_dataset
        from repro_torch.launch.serve_join import SERVE_SCALE
        from repro_torch.serving.join_service import PlanLibrary
        t0 = time.perf_counter()
        self._serving_hooks()
        self.serving = {}
        full = make_dataset("products", size=SERVE_SIZE, scale=SERVE_SCALE)
        n = int(700 * SERVE_SIZE * SERVE_SCALE)
        check(full.n_l == full.n_r == n,
              f"products at serve size {SERVE_SIZE}: {full.n_l} x {full.n_r}")
        svc = self._serve_cold_warm(full)
        self.serve_svc, self.serve_full = svc, full
        # the delta and recalibration services start from the same base
        # corpus under the same plan key: the second plans nothing (nor
        # does phase 7's delta service)
        base_plans = self.base_plans = PlanLibrary()
        self._serve_append_delta(full, base_plans)
        self._serve_recalibration(full, base_plans)
        self._serve_precision(full)
        self._serve_fleet(full)
        self._serve_production_store()
        self._serve_trace(svc)
        log(f"phase 6: serving ok ({time.perf_counter() - t0:.1f} s)")

    def serving_launches(self):
        """Each kernel's launches per serving path (phases 6 and 7)."""
        keys = {"cnf_join_block": "cnf_join",
                "threshold_sweep": "threshold_sweep",
                "compact_append": "compact"}
        for entry in self.kernels:
            entry["launches_serving"] = {
                path: counts[keys[entry["name"]]]
                for path, counts in self.serving.items()}

    def _serve_cold_warm(self, full):
        """Cold query, then two warm barrier and two warm stream queries on
        one service: warm ones charge $0 extraction, move 0 plane bytes,
        repeat the cold pairs and launch kernel A from the pack_cache."""
        from repro_torch.core.join import FDJConfig, QueryOptions
        from repro_torch.serving.join_service import JoinService
        svc = JoinService(full, FDJConfig(engine="cuda"))
        cold, row = self.serve_query(svc, "cold query")
        self.serve_cold = cold          # phase 13 holds its fleets to it
        strips = self._strips(full.n_l)
        check(row["launches"]["cnf_join"] == strips and
              row["launches"]["threshold_sweep"] >= 1,
              f"cold query launches {row['launches']}")
        check(row["bytes_h2d"] > 0 and row["extraction_usd"] > 0,
              "cold query: no extraction or upload paid")
        self.serving["cold"] = row["launches"]
        cold_ptrs = set(self.serve_seen["emb_r"])
        for i, stream in enumerate((False, False, True, True)):
            what = f"warm query {i + 1} ({'stream' if stream else 'barrier'})"
            warm, row = self.serve_query(svc, what, QueryOptions(stream=stream))
            check(warm.plan_hit and warm.cost.inference == 0.0
                  and warm.cost.bytes_h2d == 0
                  and warm.join.engine_stats.bytes_h2d == 0,
                  f"{what}: not free: {row}")
            check(warm.pairs == cold.pairs and
                  warm.join.candidates == cold.join.candidates,
                  f"{what}: pairs differ from the cold query's")
            check(row["launches"]["cnf_join"] == strips and
                  row["launches"]["threshold_sweep"] == 0,
                  f"{what}: launches {row['launches']}")
            # the store hands back the cold query's plane set, whose
            # pack_cache holds the assembly the cold query built
            check(set(self.serve_seen["emb_r"]) == cold_ptrs,
                  f"{what}: kernel A was not fed from the pack_cache")
        self.serving["warm"] = row["launches"]
        # the card's busy time in a warm barrier query (profiler: kernels
        # and memsets), against the query's wall
        walls = []

        def warm():
            t0 = time.perf_counter()
            svc.query()
            walls.append(time.perf_counter() - t0)
        busy, parts = self.device_ms(warm, n=3, by_name=True)
        wall_ms = 1e3 * statistics.median(walls[1:])
        log("phase 6: warm query on the card (profiler, 3 queries): " +
            json.dumps({"device_busy_ms": busy, "wall_ms": wall_ms,
                        "busy_share": None if busy is None
                        else busy / wall_ms, "device_parts_ms": parts}))
        return svc

    def _serve_append_delta(self, full, plans):
        """append_right of held-out rows, then a delta query over L x dR,
        equal to a cold execution of the same plan over the grown corpus
        (up to the f32 band).  Recalibration is off here: it is the next
        check's subject."""
        from repro_torch.core.join import FDJConfig, execute_join
        from repro_torch.data.simulated_llm import SimulatedExtractor
        from repro_torch.serving.join_service import JoinService, hold_out_right
        base, rows = hold_out_right(full, full.n_r // 4)
        cfg = FDJConfig(engine="cuda", recalibrate=False)
        svc = JoinService(base, cfg, plan_library=plans)
        self.serve_query(svc, f"delta service cold query ({base.n_l} x {base.n_r})")
        _, arow = self.serve_query(svc, f"append {len(rows.texts)} rows",
                                   append=rows)
        check(arow["bytes_to_device"] > 0, "append uploaded nothing")
        dq, row = self.serve_query(svc, "delta query")
        check(dq.plan_hit and dq.delta_rows == len(rows.texts) and
              row["launches"]["cnf_join"] == self._strips(full.n_l),
              f"delta query: {row}")
        check(dq.cost.inference == 0.0 and dq.cost.bytes_h2d == 0,
              "delta query: not free")
        self.serving["delta"] = row["launches"]
        self.delta_cuda = dq
        plan = svc._plans[svc._plan_key(cfg)]
        ext = SimulatedExtractor(svc.dataset, seed=0)
        self.reset_launches()
        ref = execute_join(svc.dataset, svc.dataset.make_oracle(), ext, cfg,
                           plan, keep_candidates=True)
        feats = ext.materialize(plan.used_specs, ref.cost)
        diff = self._candidates_in_band(dq.join.candidates, ref.candidates,
                                        feats, plan, "delta query")
        check(set(dq.pairs) ^ set(ref.pairs) <= diff,
              "delta query: pairs differ beyond the candidate band")
        log(f"phase 6: delta query == cold execution over the grown corpus "
            f"({len(ref.candidates)} candidates, {len(ref.pairs)} pairs, "
            f"{len(diff)} differing candidates, all {EPS_NOTE})")

    def _serve_recalibration(self, full, plans):
        """A perturbed append (junk tokens on every held-out row) breaks the
        carried theta: the reservoir check must swap it, the swap must run
        the sweep on the card, and recall is then >= target."""
        from repro_torch.core.join import FDJConfig
        from repro_torch.serving.join_service import (JoinService,
                                                      hold_out_right,
                                                      perturb_rows)
        base, rows = hold_out_right(full, full.n_r // 4)
        # the reservoir keeps the plan's whole threshold sample S' (700 000
        # pairs) and a proportional top-up: the default cap of 4096 pairs
        # holds ~1 positive at this corpus's match rate (1 in 2800)
        cfg = FDJConfig(engine="cuda", reservoir_cap=1_000_000)
        svc = JoinService(base, cfg, plan_library=plans)
        cold, _ = self.serve_query(svc, "recalibration service cold query")
        self.serve_query(svc, f"perturbed append of {len(rows.texts)} rows",
                         append=perturb_rows(rows, seed=1))
        q, row = self.serve_query(svc, "recalibrated query")
        led = q.cost
        check(led.recalibrations == 1 and led.theta_swaps == 1
              and led.theta_drift > 0,
              f"no theta swap: recalibrations {led.recalibrations}, swaps "
              f"{led.theta_swaps}, drift {led.theta_drift}")
        check(row["launches"]["threshold_sweep"] >= 1 and
              row["launches"]["threshold_sweep_ranked"] +
              row["launches"]["threshold_sweep_direct"] ==
              row["launches"]["threshold_sweep"],
              f"the swap did not run the sweep on the card: {row['launches']}")
        check(q.join.recall >= cfg.recall_target - 1e-12 and q.delta_rows == 0,
              f"recalibrated recall {q.join.recall} < {cfg.recall_target}")
        self.serving["recalibration"] = row["launches"]
        log(f"phase 6: recalibration swapped theta {cold.join.theta.tolist()}"
            f" -> {q.join.theta.tolist()} (drift {led.theta_drift:.4g}, "
            f"reservoir ${led.reservoir_cost:.4g}), recall {q.join.recall:.4f}")

    def _serve_precision(self, full):
        """precision_target 0.9 on the cuda engine gives the pairs of the
        same query on device="cpu" (the plain-torch path), up to the band."""
        from repro_torch.core.join import FDJConfig, QueryOptions
        from repro_torch.data.simulated_llm import SimulatedExtractor
        from repro_torch.serving.join_service import JoinService
        opts = QueryOptions(precision_target=0.9)
        got, row = self.serve_query(JoinService(full, FDJConfig(engine="cuda")),
                                    "precision 0.9 query (cuda)", opts)
        t0 = time.perf_counter()
        cpu_svc = JoinService(full, FDJConfig(engine="cuda", device="cpu"))
        want = cpu_svc.query(opts)
        check(got.join.t_prime == want.join.t_prime and
              (got.join.theta == want.join.theta).all(),
              "precision query: plans differ between cuda and cpu")
        plan = cpu_svc._plans[cpu_svc._plan_key(cpu_svc.cfg.with_overrides(
            precision_target=0.9))]
        feats = SimulatedExtractor(full, seed=0).materialize(plan.used_specs,
                                                              want.cost)
        diff = self._candidates_in_band(got.join.candidates,
                                        want.join.candidates, feats, plan,
                                        "precision query")
        check(got.pairs == want.pairs if not diff else
              set(got.pairs) ^ set(want.pairs) <= diff,
              "precision query: cuda and cpu pairs differ")
        log(f"phase 6: precision 0.9: cuda == cpu ({len(got.pairs)} pairs, "
            f"{got.join.candidate_count} candidates, {len(diff)} differing "
            f"candidates; cpu query {time.perf_counter() - t0:.1f} s)")

    def _serve_fleet(self, full):
        """Two tenants over one store on the card: a concurrent run (two
        worker threads launching kernel A) gives the serial run's pairs
        byte for byte; the second tenant's cold query rides the first's
        planes ($0 extraction, dedup hits).  Concurrently the two cold
        queries race for the store, so exactly one of them pays the
        extraction and the other rides.  The concurrent run takes the
        serial run's plan: cold plans racing in a fleet, with kernel B
        launched inside it, run on the card in phase 13 (a) (and in
        phase 12 (d))."""
        from repro_torch.core.join import FDJConfig
        from repro_torch.serving.fleet import JoinFleet
        t0 = time.perf_counter()
        runs = {}
        self.fleet_plans = None
        for name, workers in (("serial", 1), ("concurrent", 2)):
            self.reset_launches()
            with JoinFleet(max_concurrent=workers) as fleet:
                # the concurrent run and phase 7's fleet reuse the serial
                # run's plan (they plan nothing)
                if self.fleet_plans is None:
                    self.fleet_plans = fleet.plan_library
                fleet.plan_library = self.fleet_plans
                for tenant in ("a", "b"):
                    fleet.add_tenant(tenant, full, FDJConfig(engine="cuda"))
                if workers == 1:
                    res = [fleet.query("a"), fleet.query("b"),
                           fleet.query("a"), fleet.query("b")]
                else:
                    futs = [fleet.submit(t) for t in ("a", "b", "a", "b")]
                    res = [f.result(timeout=600) for f in futs]
                summary = fleet.drain()
            runs[name] = [sorted(r.pairs) for r in res]
            launches = self.read_launches()
            check(launches["cnf_join"] > 0 and summary["failed"] == 0,
                  f"fleet {name}: {launches}, {summary['failed']} failed")
            paid = [r.cost.inference > 0 for r in res[:2]]
            check(paid == [True, False] if workers == 1 else sum(paid) == 1,
                  f"fleet {name}: extraction paid by the cold queries "
                  f"${[r.cost.inference for r in res[:2]]}: want tenant a's "
                  f"only (serial), exactly one of the two (concurrent)")
            second = res[paid.index(False)]
            check(second.cost.plane_dedup_hits >= 1,
                  f"fleet {name}: the riding cold query had no dedup hit")
            log(f"phase 6: fleet {name}: launches {launches}, the riding "
                f"cold query's dedup hits {second.cost.plane_dedup_hits}, "
                f"extraction ${second.cost.inference}, walls "
                f"{[round(r.wall_s, 3) for r in res]}")
        check(runs["serial"] == runs["concurrent"],
              "fleet: concurrent pairs differ from serial")
        self.fleet_pairs = runs["serial"]
        self.serving["fleet"] = launches
        log(f"phase 6: fleet concurrent == serial, byte for byte "
            f"({time.perf_counter() - t0:.1f} s)")

    def _serve_production_store(self):
        """Planes of the production cell (262144 rows, F_v 4, D 128, phase
        2's unit vectors) pinned in a store on the card, staged by
        pack_features_device (0 bytes host to device) and run through
        kernel A on a 2048-row strip: the mask must equal, bit for bit, the
        strip staged by the host pack and phase 2's strip."""
        from repro_torch.core.costs import CostLedger
        from repro_torch.core.featurize import FeatureData, FeaturizationSpec
        from repro_torch.kernels.fused_cnf_join import ops as cops
        from repro_torch.serving.planes import FeaturePlaneStore
        torch = self.torch
        emb_l, emb_r = self.prod["args"][:2]
        clauses, thetas = self.prod["clauses"], self.prod["thetas"]
        fv = emb_l.shape[0]
        specs = [FeaturizationSpec(f"f{f}", "", "semantic", "code", f"f{f}")
                 for f in range(fv)]
        store = FeaturePlaneStore()
        host = {}
        for f, spec in enumerate(specs):
            for side, emb in (("l", emb_l), ("r", emb_r)):
                host[side, f] = emb[f].cpu().numpy()
                store.put(spec, side, "prod", [], host[side, f], "embed", 1.0,
                          device=emb[f])
        check(store.bytes_to_device == 0, "pinning device planes uploaded")
        planes = store.provide(specs, None, CostLedger(), fp_l="prod",
                               fp_r="prod")
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        scaffold = [[f] for f in range(len(clauses))]   # clause c: feature c
        a.record()
        staged = cops.stage_planes(planes, scaffold, tl=256, tr=512)
        b.record()
        torch.cuda.synchronize()
        assemble_ms = a.elapsed_time(b)
        check(staged.bytes_h2d == 0 and staged.kclauses == clauses,
              "store-staged planes moved bytes or changed the clauses")
        feats = [FeatureData(s, "embed", host["l", f], host["r", f])
                 for f, s in enumerate(specs)]
        t0 = time.perf_counter()
        hosted = cops.stage_planes(feats, scaffold, tl=256, tr=512)
        torch.cuda.synchronize()
        host_stage_s = time.perf_counter() - t0
        masks = {}
        for name, st in (("store", staged), ("host", hosted)):
            strip = (st.emb_l[:, :2048], st.emb_r, st.scal_l[:, :2048], st.scal_r)
            self.reset_launches()
            masks[name] = self.ck.cnf_join_block(*strip, clauses, thetas,
                                                 tl=256, tr=512,
                                                 early_reject=True)
            check(self.ck.launches["cnf_join"] == 1, f"{name} strip: no launch")
        masks["phase 2"] = self.ck.cnf_join_block(*self.prod_strip, clauses,
                                                  thetas, tl=256, tr=512,
                                                  early_reject=True)
        torch.cuda.synchronize()
        check(torch.equal(masks["store"], masks["host"]) and
              torch.equal(masks["store"], masks["phase 2"]),
              "production strip: store-staged mask differs")
        strip = (staged.emb_l[:, :2048], staged.emb_r, staged.scal_l[:, :2048],
                 staged.scal_r)
        ms = self.time_ms(lambda: self.ck.cnf_join_block(
            *strip, clauses, thetas, tl=256, tr=512, early_reject=True), runs=5)
        # the same strip's plain version and library yardstick (one
        # torch.matmul an embedding member, as phase 5's)
        plain_ms = self.time_ms(lambda: self.cref.cnf_join_tiles_ref(
            *strip, clauses, thetas, tl=256, tr=512, early_reject=True), runs=5)
        members = [fi for m in clauses for k, fi in m if k == self.ck.VEC]

        def library():
            for fi in members:
                torch.matmul(strip[0][fi], strip[1][fi].T)
        lib_ms = self.time_ms(library, runs=5)
        # least time: each used plane read once, the assembly written once
        staged_bytes = sum(x.numel() * x.element_size() for x in staged.arrays)
        log("phase 6: production planes through the store: " + json.dumps({
            "rows": emb_l.shape[1], "f_v": fv, "d": emb_l.shape[2],
            "resident_bytes": store.resident_bytes,
            "bytes_h2d_store_staged": staged.bytes_h2d,
            "bytes_h2d_host_staged": hosted.bytes_h2d,
            "assemble_ms": assemble_ms,
            "assemble_bound_ms": 1e3 * 2 * staged_bytes / self.bw,
            "host_stage_s": round(host_stage_s, 4),
            "strip_ms": ms, "strip_plain_ms": plain_ms,
            "strip_library_ms": lib_ms, "mask_bits_equal": True}))
        # phase 7 runs the ring over these planes (and the pack_cache
        # entry of this assembly)
        self.prod_store = dict(store=store, planes=planes, specs=specs,
                               scaffold=scaffold, host=host)
        del staged, hosted

    def _serve_trace(self, svc):
        """One warm query's trace through write_trace, and the serve_join
        launcher's --trace-out on the card; the port's trace_report --check
        (in its own process, which imports no JAX) must pass both."""
        from repro_torch.obs import Tracer, use_tracer, write_trace
        out_dir = os.path.join(ROOT, "build", "traces")
        os.makedirs(out_dir, exist_ok=True)
        warm_path = os.path.join(out_dir, "trace_warm_query.json")
        tracer = Tracer()
        with use_tracer(tracer):
            r = svc.query()
        write_trace(tracer, warm_path, metadata={
            "dataset": svc.dataset.name, "engine": "cuda",
            "wall_summary": r.cost.wall_summary(),
            "metrics": svc.metrics.as_dict()})
        cli_path = os.path.join(out_dir, "trace_serve_join.json")
        env = dict(os.environ, PYTHONPATH=SRC)
        for cmd in ([sys.executable, "-m", "repro_torch.launch.serve_join",
                     "--dataset", "products", "--size", "1", "--engine",
                     "cuda", "--script", "query,query", "--trace-out",
                     cli_path],
                    [sys.executable, "-m", "repro_torch.launch.trace_report",
                     warm_path, "--check"],
                    [sys.executable, "-m", "repro_torch.launch.trace_report",
                     cli_path, "--check"]):
            proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                                  text=True, timeout=600)
            check(proc.returncode == 0, f"{' '.join(cmd[2:4])} failed:\n"
                  f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
            if "trace_report" in cmd[2]:
                log(f"phase 6: {proc.stdout.strip()}")

    # -- phase 7: the ring engine ------------------------------------------
    def phase7_ring(self):
        """The ring engine (``engine="sharded"``) and its compaction kernel:
        (a) the kernel against its plain version, (b) the main path and
        the same plan at every ring depth, (c) the production cell, (d)
        the serving path, (e) traces; then the kernel's timing rows."""
        t0 = time.perf_counter()
        self.ring = {}
        self._compaction_fixtures()
        self._ring_main_path()
        self._ring_depths()
        self._ring_production()
        self._ring_serving()
        self._ring_fleet()
        self._ring_traces()
        self._compaction_entry()
        log(f"phase 7: ring ok ({time.perf_counter() - t0:.1f} s)")

    def compaction_compare(self, packed, cap, count=0, what="",
                           **offsets):
        """Kernel vs plain version on the same CUDA inputs, the kernel's
        count given as a device tensor and as an int: the buffers and
        counts must be equal, bit for bit.  Returns the count and what
        was measured: buffer rows that differ, the largest absolute
        difference of a buffer entry, and the count's difference (each
        the larger of the two routes)."""
        torch = self.torch
        want_buf = torch.full((cap, 2), -1, dtype=torch.int32,
                              device=self.dev)
        _, want = self.eref.compact_append_ref(packed, want_buf, count,
                                               **offsets)
        rows = err = count_diff = 0
        for start in (torch.full((), count, dtype=torch.int32,
                                 device=self.dev), count):
            got_buf = torch.full((cap, 2), -1, dtype=torch.int32,
                                 device=self.dev)
            _, got = self.ek.compact_append(packed, got_buf, start, **offsets)
            torch.cuda.synchronize()
            gap = (got_buf.long() - want_buf.long()).abs()
            rows = max(rows, int((gap.amax(dim=1) > 0).sum()) if cap else 0)
            err = max(err, int(gap.max()) if cap else 0)
            count_diff = max(count_diff, abs(int(got) - int(want)))
            check(count_diff == 0 and rows == 0,
                  f"compaction {what}: kernel differs from its plain version "
                  f"(count {int(got)} vs {int(want)}, {rows} buffer rows "
                  f"differ, count given as {type(start).__name__})")
        return int(want), rows, err, count_diff

    def _random_words(self, rng, nl, nw, density):
        """int32 (nl, nw) mask on the card, each bit set at ``density``;
        and its number of set bits."""
        np = self.np
        bits = rng.random((nl, nw * 32)) < density
        words = np.packbits(bits, axis=-1, bitorder="little").view(np.int32)
        return (self.torch.from_numpy(np.ascontiguousarray(words)).to(self.dev),
                int(bits.sum()))

    def _sparse_words(self, rng, nl, nw, density):
        """As ``_random_words`` for a mask too large to draw bit by bit:
        about ``density`` of its bits, at distinct random positions."""
        np = self.np
        n_bits = nl * nw * 32
        pos = np.unique(rng.integers(0, n_bits,
                                     size=rng.binomial(n_bits, density)))
        # distinct bits of a word never carry: the sum is their OR
        words = np.bincount(pos >> 5, weights=np.ldexp(1.0, pos & 31),
                            minlength=nl * nw).astype(np.uint64)
        words = words.astype(np.uint32).view(np.int32).reshape(nl, nw)
        return self.torch.from_numpy(words).to(self.dev), len(pos)

    def _compaction_fixtures(self):
        """(a): random masks from 1 word to 2**14 x 2**12 bits at densities
        0 to 1, and a production band's 262144 x 128 words at densities 0,
        2e-6 and 1e-3, with room to spare, with overflow, with offsets and
        a non-zero starting count; then a count 100 below 2**31, which
        wraps and writes nothing."""
        np = self.np
        rng = np.random.default_rng(15)
        cases = 0
        shapes = [(nl, nw, d) for nl, nw in ((1, 1), (7, 3), (33, 5),
                                             (64, 12), (300, 17),
                                             (1 << 14, 128))
                  for d in (0.0, 1e-3, 0.5, 1.0)]
        shapes += [(1 << 18, 128, d) for d in (0.0, 2e-6, 1e-3)]
        for nl, nw, density in shapes:
            if nl * nw > 1 << 21:
                packed, n = self._sparse_words(rng, nl, nw, density)
            else:
                packed, n = self._random_words(rng, nl, nw, density)
            check(self.compaction_compare(packed, 0, what="count only")[0]
                  == n, f"compaction {nl}x{nw}: count != {n}")
            for cap, offs in ((n + 16, {}), (n // 2, {}),
                              (n + 16, dict(row_offset=4096,
                                            col_offset=262112))):
                got, _, _, _ = self.compaction_compare(
                    packed, cap, count=7, what=f"{nl}x{nw} d{density}",
                    **offs)
                check(got == n + 7, f"compaction {nl}x{nw}: count {got}")
                cases += 1
        near = (1 << 31) - 100
        packed, n = self._random_words(rng, 40, 9, 0.3)
        got, _, _, _ = self.compaction_compare(packed, 6000, count=near,
                                               what="count near 2^31")
        check(got == near + n - (1 << 32),
              f"compaction from 2^31 - 100: count {got}, want the int32 wrap")
        cases += 1
        log(f"phase 7: compaction kernel == plain version on {cases} "
            f"fixtures, count as a tensor and as an int (buffers and counts "
            f"bit for bit; up to 2^14 x 2^12 bits and the production band's "
            f"2^18 x 2^12, overflow, offsets, a count wrapping past 2^31)")

    @staticmethod
    def _ring_events(spans):
        """(band steps, overflow events, re-dispatched steps) of a trace."""
        steps = sum(1 for sp in spans if sp.name.startswith("band_step["))
        events = [e.name for sp in spans for e in sp.events]
        return steps, events.count("overflow"), events.count("redispatch")

    def _ring_main_path(self):
        """(b) the main path: the one-shot join through the launcher's
        function with ``--engine sharded --r-chunk 512 --prefetch-depth
        2``, launch counts set to 0 just before it and read just after."""
        from repro_torch.launch.join import run_join
        out_dir = os.path.join(ROOT, "build", "traces")
        os.makedirs(out_dir, exist_ok=True)
        path = self.ring["trace_main"] = os.path.join(out_dir,
                                                      "trace_ring_join.json")
        self.reset_launches()
        t0 = time.perf_counter()
        out = run_join("products", size=4, engine="sharded", r_chunk=512,
                       prefetch_depth=2, trace_out=path)
        wall = time.perf_counter() - t0
        launches = self.read_launches()
        with open(path) as f:
            trace = json.load(f)["traceEvents"]
        steps = sum(1 for e in trace if e["ph"] == "X"
                    and e["name"].startswith("band_step["))
        retries = sum(1 for e in trace if e["ph"] == "i"
                      and e["name"] in ("overflow", "redispatch"))
        check(steps == 6 and retries >= 1, f"ring main path: {steps} band "
              f"steps, {retries} retries (want 6 steps and a retry)")
        check(launches["cnf_join"] == launches["compact"] == steps + retries
              and launches["threshold_sweep"] >= 1,
              f"ring main path launches {launches}, steps {steps}, "
              f"retries {retries}")
        barrier = self.phase4_out
        for key in ("candidates", "theta", "clauses", "recall"):
            check(out[key] == barrier[key], f"ring main path vs the cuda "
                  f"join: {key} {out[key]} vs {barrier[key]}")
        eng = out["engine"]
        check(eng["engine"] == "sharded" and eng["overlap_s"] > 0,
              f"ring main path engine stats {eng}")
        self.ring_launches = launches
        self.ring["main_out"] = out
        log("phase 7: products size 4 through sharded (launcher, r_chunk 512,"
            " depth 2): " + json.dumps({
                "candidates": out["candidates"], "theta": out["theta"],
                "recall": out["recall"], "wall_s": round(wall, 3),
                "walls": out["walls"], "steps": steps, "retries": retries,
                "launches": launches, "bytes_to_host": eng["bytes_to_host"],
                "overlap_s": eng["overlap_s"],
                "dispatch_wall_s": eng["dispatch_wall_s"],
                "pull_wall_s": eng["pull_wall_s"]}))

    def _ring_depths(self):
        """(b) one plan of products --size 4, executed through the cuda
        engine and through the ring at depths 1, 2, 4, barrier and
        stream: candidates equal up to the f32 band, a retry seen,
        overlap_s 0.0 at depth 1 and > 0 deeper."""
        from repro_torch.core.costs import CostLedger
        from repro_torch.core.join import (FDJConfig, execute_join,
                                           make_label_fn, plan_join)
        from repro_torch.data.simulated_llm import (SimulatedExtractor,
                                                    SimulatedProposer)
        from repro_torch.launch._args import make_dataset
        from repro_torch.obs import Tracer, use_tracer
        torch = self.torch
        ds = make_dataset("products", size=4)
        oracle = ds.make_oracle()
        ext = SimulatedExtractor(ds)
        label = make_label_fn(oracle, {})
        cfg = FDJConfig(engine="cuda")
        t0 = time.perf_counter()
        plan = plan_join(ds, oracle, SimulatedProposer(ds), ext, cfg,
                         ledger=oracle.ledger, label=label)
        plan_s = time.perf_counter() - t0

        def run(c):
            """One execution on its own ledger (walls of this run only);
            labels come from the shared cache, as a serving plan's do."""
            self.reset_launches()
            tracer = Tracer()
            t0 = time.perf_counter()
            with use_tracer(tracer):
                res = execute_join(ds, oracle, ext, c, plan,
                                   ledger=CostLedger(), label=label,
                                   keep_candidates=True)
            torch.cuda.synchronize()
            return res, time.perf_counter() - t0, self.read_launches(), tracer
        ref, ref_wall, _, _ = run(cfg)
        feats = ext.materialize(plan.used_specs, ref.cost)
        band = self._ring_first_band(feats, plan, cfg)
        rows = {"cuda": {"wall_s": round(ref_wall, 4),
                         "step2_s": ref.cost.wall_summary()["step2_wall"],
                         "bytes_to_host": ref.engine_stats.bytes_to_host,
                         "candidates": ref.candidate_count}}
        for depth in (1, 2, 4):
            for stream in (False, True):
                what = f"depth {depth} {'stream' if stream else 'barrier'}"
                c = cfg.with_overrides(
                    engine="sharded", prefetch_depth=depth,
                    stream_refinement=stream,
                    engine_opts={"sharded": {"r_chunk": 512}})
                res, wall, launches, tracer = run(c)
                steps, overflows, redis = self._ring_events(tracer.spans())
                diff = self._candidates_in_band(
                    res.candidates, ref.candidates, feats, plan,
                    f"ring {what}")
                check(set(res.pairs) ^ set(ref.pairs) <= diff,
                      f"ring {what}: pairs differ beyond the candidate band")
                st = res.engine_stats
                check(steps == 6 and overflows >= 1 and
                      redis == overflows * (depth - 1),
                      f"ring {what}: steps {steps}, overflows {overflows}, "
                      f"re-dispatches {redis}")
                check(launches["cnf_join"] == launches["compact"] ==
                      steps + overflows + redis,
                      f"ring {what}: launches {launches}")
                check((st.overlap_s == 0.0) if depth == 1
                      else (st.overlap_s > 0), f"ring {what}: overlap_s "
                      f"{st.overlap_s}")
                check(st.bytes_to_host == 12 * steps + 8 * overflows
                      + 8 * res.candidate_count,
                      f"ring {what}: bytes_to_host {st.bytes_to_host}")
                if depth == 2 and not stream:
                    # phase 8 runs this plan through a join mesh
                    self.ring["plan_run"] = dict(
                        ds=ds, oracle=oracle, ext=ext, label=label,
                        plan=plan, cfg=c, candidates=res.candidates,
                        pairs=res.pairs)
                rows[what] = {
                    "wall_s": round(wall, 4),
                    "step2_s": res.cost.wall_summary()["step2_wall"],
                    "dispatch_wall_s": st.dispatch_wall_s,
                    "pull_wall_s": st.pull_wall_s,
                    "overlap_s": st.overlap_s,
                    "bytes_to_host": st.bytes_to_host,
                    "candidates": res.candidate_count,
                    "differing": len(diff), "steps": steps,
                    "retries": overflows + redis,
                    "launches": launches["cnf_join"]}
        got = {p for p in res.candidates if p[1] < 512}
        check(band == got, f"ring band 0: {len(band)} pairs in its mask vs "
              f"{len(got)} the ring emitted")
        again, wall, _, _ = run(cfg)         # the cuda engine once more, warm
        rows["cuda again"] = {
            "wall_s": round(wall, 4),
            "step2_s": again.cost.wall_summary()["step2_wall"],
            "candidates": again.candidate_count}
        self.ring["depths"] = rows
        log(f"phase 7: one plan (plan_join {plan_s:.1f} s), cuda engine vs "
            f"ring, r_chunk 512: " + json.dumps(rows))

    def _ring_first_band(self, feats, plan, cfg):
        """Kernel A at the ring's own shape: the main path's first band
        (all of L x columns [0, 512), staged as the ring stages it, tiles
        128 x 128, early reject, with the evals grid) against its plain
        version; its mask is kept for the compaction's timing row."""
        from repro_torch.core.join import apply_conjunct_order
        from repro_torch.kernels.fused_cnf_join import ops as cops
        order = plan.conjunct_order if cfg.order_conjuncts else None
        clauses, theta = apply_conjunct_order(plan.sc_local.clauses,
                                              plan.theta, order)
        thetas = tuple(float(t) for t in theta)
        staged = cops.stage_planes(feats, clauses, tl=128, tr=512)
        emb_l, emb_r, scal_l, scal_r = staged.arrays
        args = (emb_l, emb_r[:, :512], scal_l, scal_r[:, :512])
        n_mis, gap = self.cnf_compare(args, staged.kclauses, thetas, tl=128,
                                      tr=128, early_reject=True,
                                      what="ring band 0")
        packed = self.ck.cnf_join_block(*args, staged.kclauses, thetas,
                                        tl=128, tr=128, early_reject=True)
        rows = emb_l.shape[1]
        ii, jj = self.np.nonzero(self.cref.unpack_mask(packed, 512))
        keep = (ii < staged.n_l) & (jj < staged.n_r)
        # the ring's initial capacity: the timing row compacts at it
        self.ring["main_band"] = (packed, max(4096, 4 * rows))
        log(f"phase 7: kernel A == plain at the ring's shape ({rows} x 512, "
            f"tiles 128 x 128, evals grid equal): {n_mis} bits differ inside"
            f" the f32 band (largest gap {gap:.3g}), {len(ii)} bits set")
        return set(zip(ii[keep].tolist(), jj[keep].tolist()))

    def _ring_production(self):
        """(c) the production cell through the ring at r_chunk 4096: the
        2048-row strip's pairs equal the cuda engine's; then the whole
        262144^2 plane from phase 6's store."""
        from repro_torch.core.featurize import FeatureData
        from repro_torch.engine import get_engine
        torch = self.torch
        st = self.prod_store
        scaffold, thetas = st["scaffold"], self.prod["thetas"]
        specs, host = st["specs"], st["host"]
        n = self.prod["args"][0].shape[1]
        steps = -(-n // 4096)
        strip = [FeatureData(s, "embed", host["l", f][:2048], host["r", f])
                 for f, s in enumerate(specs)]
        walls, res = {}, {}
        for name, eng in (("cuda", get_engine("cuda")),
                          ("ring", get_engine("sharded", r_chunk=4096))):
            self.reset_launches()
            t0 = time.perf_counter()
            res[name] = eng.evaluate(strip, scaffold, thetas)
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
            if name == "ring":
                launches = self.read_launches()
                check(launches["cnf_join"] == launches["compact"] == steps,
                      f"production strip ring launches {launches}")
        check(res["ring"].candidates == res["cuda"].candidates,
              "production strip: ring pairs differ from the cuda engine's")
        log(f"phase 7: production strip 2048 x {n}: ring == cuda engine "
            "(" + json.dumps({
                "candidates": len(res["ring"].candidates),
                "ring_wall_s": round(walls["ring"], 4),
                "cuda_wall_s": round(walls["cuda"], 4),
                "ring_bytes_to_host": res["ring"].stats.bytes_to_host,
                "cuda_bytes_to_host": res["cuda"].stats.bytes_to_host}) + ")")
        strip_pairs = res["ring"].candidates
        del res, strip

        planes = st["planes"]
        eng = get_engine("sharded", r_chunk=4096)
        self.reset_launches()
        t0 = time.perf_counter()
        full = eng.evaluate(planes, scaffold, thetas)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = self.read_launches()
        s = full.stats
        check(launches["cnf_join"] == launches["compact"] == steps,
              f"production plane launches {launches}")
        check(s.bytes_to_host == 12 * steps + 8 * s.n_candidates
              and s.bytes_h2d == 0,
              f"production plane: bytes_to_host {s.bytes_to_host} for "
              f"{s.n_candidates} candidates, bytes_h2d {s.bytes_h2d}")
        check([p for p in full.candidates if p[0] < 2048] == strip_pairs,
              "production plane: rows < 2048 differ from the strip's pairs")
        device, parts = self.device_ms(
            lambda: eng.evaluate(planes, scaffold, thetas), n=1, by_name=True)
        self.ring["production_pairs"] = full.candidates
        self.ring["production"] = dict(
            wall_s=wall, candidates=s.n_candidates, steps=steps,
            bytes_to_host=s.bytes_to_host, mask_bytes=n * n // 8,
            device_ms=device, device_parts_ms=parts,
            dispatch_wall_s=s.dispatch_wall_s, pull_wall_s=s.pull_wall_s,
            overlap_s=s.overlap_s, conjunct_evals=s.conjunct_evals)
        log(f"phase 7: production plane {n}^2 through the ring (r_chunk "
            f"4096, {steps} steps, from the store): " +
            json.dumps(self.ring["production"]))
        # a production band for the compaction's timing row: band 0's mask
        from repro_torch.kernels.fused_cnf_join import ops as cops
        staged = cops.stage_planes(planes, scaffold, tl=128, tr=4096)
        emb_l, emb_r, scal_l, scal_r = staged.arrays
        self.ring["prod_band"] = self.ck.cnf_join_block(
            emb_l, emb_r[:, :4096], scal_l, scal_r[:, :4096],
            staged.kclauses, thetas, tl=128, tr=128, early_reject=True)

    def _ring_serving(self):
        """(d) the serving path with the engine overridden to sharded (an
        execution-only option: the cached plan is used, nothing plans): a
        warm query of phase 6's service, then a delta query of a service
        over phase 6's base corpus and plan library, each equal to the
        cuda engine's, with 0 bytes to the device."""
        from repro_torch.core.join import FDJConfig, QueryOptions
        from repro_torch.serving.join_service import JoinService, hold_out_right
        ring = QueryOptions(engine="sharded")
        svc, full = self.serve_svc, self.serve_full
        warm, row = self.serve_query(svc, "warm query (sharded)", ring,
                                     phase=7)
        want = svc.query()
        check(warm.plan_hit and warm.cost.inference == 0.0 and
              warm.cost.bytes_h2d == 0 and warm.join.engine_stats.bytes_h2d
              == 0 and warm.join.engine_stats.engine == "sharded",
              f"sharded warm query: not free or not the ring: {row}")
        check(warm.pairs == want.pairs and
              warm.join.candidate_count == want.join.candidate_count,
              "sharded warm query: pairs differ from the cuda engine's")
        check(row["launches"]["cnf_join"] == row["launches"]["compact"] >= 6
              and row["launches"]["threshold_sweep"] == 0,
              f"sharded warm query launches {row['launches']}")
        self.serving["warm (sharded)"] = row["launches"]
        walls = []

        def warm_ring():
            t0 = time.perf_counter()
            svc.query(ring)
            walls.append(time.perf_counter() - t0)
        busy, parts = self.device_ms(warm_ring, n=3, by_name=True)
        wall_ms = 1e3 * statistics.median(walls[1:])
        log("phase 7: warm sharded query on the card (profiler, 3 queries): "
            + json.dumps({"device_busy_ms": busy, "wall_ms": wall_ms,
                          "busy_share": None if busy is None
                          else busy / wall_ms,
                          "device_parts_ms": parts}))
        base, rows = hold_out_right(full, full.n_r // 4)
        cfg = FDJConfig(engine="cuda", recalibrate=False)
        dsvc = JoinService(base, cfg, plan_library=self.base_plans)
        cold, _ = self.serve_query(dsvc, "delta service cold query (plan "
                                         "from the library)", phase=7)
        check(cold.plan_hit or cold.cost.labeling == 0.0,
              "delta service: the plan was built again")
        self.serve_query(dsvc, f"append {len(rows.texts)} rows", append=rows,
                         phase=7)
        dq, row = self.serve_query(dsvc, "delta query (sharded)", ring,
                                   phase=7)
        want = self.delta_cuda
        check(dq.plan_hit and dq.delta_rows == len(rows.texts) and
              dq.cost.inference == 0.0 and dq.cost.bytes_h2d == 0,
              f"sharded delta query: {row}")
        check(dq.pairs == want.pairs and dq.join.candidates ==
              want.join.candidates, "sharded delta query: pairs or "
              "candidates differ from the cuda delta query's")
        check(row["launches"]["cnf_join"] == row["launches"]["compact"] > 0,
              f"sharded delta query launches {row['launches']}")
        self.serving["delta (sharded)"] = row["launches"]
        log(f"phase 7: sharded warm and delta queries == cuda "
            f"({len(warm.pairs)} and {len(dq.pairs)} pairs, bytes_h2d 0)")

    def _ring_fleet(self):
        """Phase 6's two-tenant fleet on the ring engine, with phase 6's
        plan library (nothing plans): every band step takes a ticket of
        the fleet's scheduler, and the concurrent run gives the serial
        run's pairs, which are phase 6's cuda fleet's."""
        from repro_torch.core.join import FDJConfig
        from repro_torch.serving.fleet import JoinFleet
        t0 = time.perf_counter()
        runs = {}
        for name, workers in (("serial", 1), ("concurrent", 2)):
            self.reset_launches()
            with JoinFleet(max_concurrent=workers) as fleet:
                fleet.plan_library = self.fleet_plans
                for tenant in ("a", "b"):
                    fleet.add_tenant(tenant, self.serve_full,
                                     FDJConfig(engine="sharded"))
                if workers == 1:
                    res = [fleet.query(t) for t in ("a", "b", "a", "b")]
                else:
                    futs = [fleet.submit(t) for t in ("a", "b", "a", "b")]
                    res = [f.result(timeout=600) for f in futs]
                summary = fleet.drain()
            launches = self.read_launches()
            runs[name] = [sorted(r.pairs) for r in res]
            check(summary["failed"] == 0 and summary["band_steps"] > 0 and
                  summary["band_steps"] == launches["cnf_join"] ==
                  launches["compact"], f"sharded fleet {name}: band steps "
                  f"{summary['band_steps']}, launches {launches}")
            check(all(r.join.engine_stats.engine == "sharded" for r in res),
                  f"sharded fleet {name}: a query left the ring")
            log(f"phase 7: fleet on sharded, {name}: band steps "
                f"{summary['band_steps']}, interleaves "
                f"{summary['interleaves']}, launches {launches}, walls "
                f"{[round(r.wall_s, 3) for r in res]}")
        check(runs["serial"] == runs["concurrent"] == self.fleet_pairs,
              "sharded fleet: concurrent, serial and phase 6's pairs differ")
        self.serving["fleet (sharded)"] = launches
        log(f"phase 7: fleet on sharded concurrent == serial == phase 6's "
            f"cuda fleet ({time.perf_counter() - t0:.1f} s)")

    def _ring_traces(self):
        """(e) the main path's ring trace (launcher ``--trace-out``) and a
        sharded warm query's trace, each through ``trace_report --check``
        in its own process (which imports no JAX)."""
        from repro_torch.core.join import QueryOptions
        from repro_torch.obs import Tracer, use_tracer, write_trace
        svc = self.serve_svc
        path = os.path.join(ROOT, "build", "traces", "trace_ring_warm.json")
        tracer = Tracer()
        with use_tracer(tracer):
            r = svc.query(QueryOptions(engine="sharded"))
        write_trace(tracer, path, metadata={
            "dataset": svc.dataset.name, "engine": "sharded",
            "wall_summary": r.cost.wall_summary(),
            "metrics": svc.metrics.as_dict()})
        tracks = {sp.track for sp in tracer.spans()
                  if sp.name.startswith("band_step[")}
        check(tracks == {"ring0", "ring1"}, f"ring trace tracks {tracks}")
        env = dict(os.environ, PYTHONPATH=SRC)
        for trace in (self.ring["trace_main"], path):
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.trace_report",
                 trace, "--check"], cwd=ROOT, env=env, capture_output=True,
                text=True, timeout=300)
            check(proc.returncode == 0, f"trace_report --check {trace} "
                  f"failed:\n{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
            log(f"phase 7: {proc.stdout.strip()}")

    def _time_compaction(self, packed, cap, col_offset):
        """Events, one-call and device ms of the compaction kernel on
        ``packed`` (into one buffer of ``cap`` slots, the count given as
        the int 0, as the ring gives it), its plain version's and
        ``torch.nonzero``'s on the unpacked bool band, the host's enqueue
        time a call (no synchronisation), the profiler's kernels a call,
        and its bytes bound (``bytes_bound``: the mask read once, 8 bytes
        a pair written, 8 bytes of counts).  A device reading below the
        bound is not the kernel's time: it is logged and kept as None."""
        torch = self.torch
        nl, nw = packed.shape
        buf = torch.full((cap, 2), -1, dtype=torch.int32, device=self.dev)
        plain_buf = buf.clone()

        def kernel():
            return self.ek.compact_append(packed, buf, 0,
                                          col_offset=col_offset)
        count = int(kernel()[1])
        ms = self.time_ms(kernel)
        torch.cuda.synchronize()
        host_us = 1e3 * self.host_ms(kernel, n=200)
        torch.cuda.synchronize()
        plain_ms = self.time_ms(lambda: self.eref.compact_append_ref(
            packed, plain_buf, 0, col_offset=col_offset), runs=5)
        # the library yardstick's input: the band unpacked to bools, made
        # outside the timing (row blocks bound the int32 temporaries)
        dense = torch.empty((nl, nw * 32), dtype=torch.bool, device=self.dev)
        shifts = torch.arange(32, dtype=torch.int32, device=self.dev)
        step = max(1, (1 << 24) // (32 * nw))
        for r0 in range(0, nl, step):
            dense[r0:r0 + step] = ((packed[r0:r0 + step, :, None] >> shifts)
                                   & 1).bool().reshape(-1, nw * 32)
        check(int(dense.sum()) == count, "unpacked band: wrong popcount")
        library_ms = self.time_ms(lambda: torch.nonzero(dense), runs=5)
        del dense
        nbytes = self.ek.bytes_bound(nl, nw, count, cap)
        # a short window can come back empty (the profiler lost its
        # records): up to three tries
        n_prof = 20
        for _ in range(3):
            device, parts = self.device_ms(kernel, n=n_prof, by_name=True)
            calls = self.device_calls
            if calls and device is not None:
                break
            log(f"compaction {nl}x{nw}: the profiler recorded {calls} in "
                f"{n_prof} calls: records lost")
        per_call = (sum(calls.values()) / n_prof
                    if calls and device is not None else None)
        check(per_call in (None, 1), f"compaction {nl}x{nw}: the profiler "
              f"saw {calls} device activities in {n_prof} calls, want one "
              f"kernel a call")
        if per_call is None:
            log(f"compaction {nl}x{nw}: kernels a call not measured")
        bound_ms = 1e3 * nbytes / self.bw
        # the mask is read whole: less than its bytes over the HBM rate is
        # a profiler reading, not the kernel's time
        for name, part in list(parts.items()):
            if part < bound_ms:
                log(f"compaction {nl}x{nw}: profiler device time of {name} "
                    f"{part:.6f} ms below the bytes bound {bound_ms:.6f} "
                    f"ms: not measured")
                parts[name] = None
        if device is not None and device < bound_ms:
            log(f"compaction {nl}x{nw}: profiler device time {device:.6f} ms "
                f"below the bytes bound {bound_ms:.6f} ms: not measured")
            device = None
        return {"mask": [nl, nw], "candidates": count, "cap": cap,
                "ms": ms, "ms_one_call": self.time_ms(kernel, reps=1),
                "device_ms": device, "device_parts_ms": parts,
                "device_calls": calls, "kernels_per_call": per_call,
                "host_enqueue_us": host_us,
                "plain_ms": plain_ms, "library_ms": library_ms,
                "library": "torch.nonzero on the unpacked bool band",
                "bound_ms": bound_ms, "bound_by": "bytes",
                "bytes": nbytes,
                "half_bound_reached": ms <= 2 * bound_ms}

    def _compaction_entry(self):
        """The compaction kernel's row of the kernels line, timed at the
        ring main path's first band (as recorded) and at a production
        band; both checked bit for bit first."""
        from repro_torch.engine.extract import grow_caps
        packed, cap = self.ring.pop("main_band")
        n, rows, err, dn = self.compaction_compare(packed, cap,
                                                   what="main-path band")
        # timed at the capacity its retry ran at, where every pair is written
        main = self._time_compaction(packed, int(grow_caps([cap], [n])[0]), 0)
        band = self.ring.pop("prod_band")
        n, rows_p, err_p, dn_p = self.compaction_compare(
            band, 1 << 20, what="production band")
        prod = self._time_compaction(band, max(4096, 4 * band.shape[0]), 0)
        log("phase 7: compaction, main path's first band: " + json.dumps(main))
        log(f"phase 7: compaction, production band {band.shape[0]} x "
            f"{32 * band.shape[1]} ({n} pairs): " + json.dumps(prod))
        self.kernels.append(dict(
            name="compact_append", route="cuda",
            source="src/repro_torch/csrc/extract.cu",
            replaces="src/repro/engine/extract.py:53",
            launches=self.ring_launches["compact"],
            max_abs_err=max(err, err_p), mismatches=rows + rows_p,
            count_diff=[dn, dn_p], **{k: main[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "ms_one_call", "device_ms", "host_enqueue_us",
                "kernels_per_call", "mask", "candidates")},
            production_band=prod))
        for entry in self.kernels[:2]:
            key = "cnf_join" if entry["name"] == "cnf_join_block" \
                else "threshold_sweep"
            entry["launches_ring"] = self.ring_launches[key]

    # -- phase 8: the join mesh --------------------------------------------
    def phase8_mesh(self):
        """The ring L-sharded over a join mesh of ranks: (a) a world of one
        through the mesh code path (``--pods 1``, an explicit (1, 1, 1)
        mesh, the production plane), (b) two-rank worlds sharing the card,
        spawned by ``multipod_dryrun --device cuda``."""
        t0 = time.perf_counter()
        self._mesh_world1()
        self._mesh_world2()
        for entry in self.kernels:
            key = {"cnf_join_block": "cnf_join",
                   "compact_append": "compact"}.get(entry["name"])
            if key:
                entry["launches_mesh"] = self.mesh_launches[key]
        log(f"phase 8: join mesh ok ({time.perf_counter() - t0:.1f} s, "
            f"{self.smi})")

    def _mesh_world1(self):
        """World 1: ``products --size 4`` through ``launch.join --engine
        sharded --pods 1`` (the host mesh) against phase 7's launcher run;
        phase 7's plan executed with a (1, 1, 1) join mesh, candidates and
        pairs equal to phase 7's ring at the same depth; the production
        plane through the (1, 1, 1) mesh from phase 6's store."""
        from repro_torch.core.costs import CostLedger
        from repro_torch.core.join import execute_join
        from repro_torch.distributed.mesh import make_join_mesh
        from repro_torch.engine import get_engine
        from repro_torch.launch.join import run_join
        torch = self.torch
        self.reset_launches()
        t0 = time.perf_counter()
        out = run_join("products", size=4, engine="sharded", pods=1,
                       r_chunk=512, prefetch_depth=2)
        wall = time.perf_counter() - t0
        launches = self.read_launches()
        main = self.ring["main_out"]
        for key in ("candidates", "theta", "clauses", "recall", "precision"):
            check(out[key] == main[key], f"--pods 1 join vs phase 7's: {key} "
                  f"{out[key]} vs {main[key]}")
        check(launches["cnf_join"] == launches["compact"] > 0,
              f"--pods 1 join launches {launches}")
        run = self.ring.pop("plan_run")
        mesh = make_join_mesh(1, 1, 1)
        cfg = run["cfg"].with_overrides(engine_opts={"sharded": {
            "r_chunk": 512, "mesh": mesh}})
        res = execute_join(run["ds"], run["oracle"], run["ext"], cfg,
                           run["plan"], ledger=CostLedger(),
                           label=run["label"], keep_candidates=True)
        differing = len(set(res.candidates) ^ set(run["candidates"]))
        check(differing == 0 and res.pairs == run["pairs"],
              f"(1, 1, 1) mesh: {differing} candidates differ from phase "
              f"7's ring")
        st = self.prod_store
        n = self.prod["args"][0].shape[1]
        steps = -(-n // 4096)
        eng = get_engine("sharded", mesh=mesh, r_chunk=4096)
        self.reset_launches()
        t1 = time.perf_counter()
        full = eng.evaluate(st["planes"], st["scaffold"], self.prod["thetas"])
        torch.cuda.synchronize()
        prod_wall = time.perf_counter() - t1
        self.mesh_launches = self.read_launches()
        s = full.stats
        check(full.candidates == self.ring["production_pairs"],
              "(1, 1, 1) mesh: production plane pairs differ from phase 7's")
        check(s.bytes_to_host == 12 * steps + 8 * s.n_candidates,
              f"(1, 1, 1) production plane: bytes_to_host {s.bytes_to_host}")
        check(self.mesh_launches["cnf_join"] == self.mesh_launches["compact"]
              == steps, f"(1, 1, 1) production launches {self.mesh_launches}")
        self.mesh = {"world1": {
            "pods1_join": {"candidates": out["candidates"],
                           "wall_s": round(wall, 3), "walls": out["walls"],
                           "launches": launches,
                           "bytes_to_host": out["engine"]["bytes_to_host"]},
            "plan_111": {"candidates": res.candidate_count,
                         "differing": differing,
                         "step2_s": res.cost.wall_summary()["step2_wall"]},
            "production_111": {
                "n": n, "steps": steps, "candidates": s.n_candidates,
                "wall_s": prod_wall, "bytes_to_host": s.bytes_to_host,
                "dispatch_wall_s": s.dispatch_wall_s,
                "pull_wall_s": s.pull_wall_s, "overlap_s": s.overlap_s,
                "launches": self.mesh_launches,
                "collectives": mesh.ledger.summary()["by_group"]}}}
        log(f"phase 8: world 1 ({self.smi}): " +
            json.dumps(self.mesh["world1"]))

    def _mesh_world2(self):
        """Two ranks on the one card, as (2, 1, 1) and (1, 2, 1):
        ``multipod_dryrun --device cuda`` with the production cell at
        ``r_chunk`` 4096; the same candidates as phase 7's plane, 12 B a
        rank a step + 8 B a pair to the host, counts-only cross-pod calls,
        and the dry-run's parity, stream, overflow and serving checks with
        both kernels launched on every rank."""
        from repro_torch.launch.dryrun_client import run_dryrun
        n = self.prod["args"][0].shape[1]
        steps = -(-n // 4096)
        want = self.ring["production"]["candidates"]
        self.mesh["world2"] = {}
        for shape in ("2,1,1", "1,2,1"):
            t0 = time.perf_counter()
            rep = run_dryrun(shape, "--cell", str(n), "--cell-r-chunk",
                             "4096", device="cuda", timeout=300)
            wall = time.perf_counter() - t0
            cell, coll = rep["cell"], rep["collectives"]
            check(cell["candidates"] == want and cell["steps"] == steps,
                  f"{shape}: cell {cell['candidates']} candidates in "
                  f"{cell['steps']} steps, want {want} in {steps}")
            check(cell["bytes_to_host"] == 12 * 2 * steps + 8 * want,
                  f"{shape}: bytes_to_host {cell['bytes_to_host']}")
            pods = int(shape.split(",")[0])
            check(coll["findings"] == [] and coll["plane_mask_bytes"] == 0
                  and (coll["cross_pod_calls"] >= 1) == (pods > 1)
                  and coll["max_cross_call_bytes"]
                  <= coll["cross_call_budget_bytes"],
                  f"{shape}: collectives {coll}")
            for r in rep["ranks"]:
                check(r["launches"]["cnf_join"] > 0 and
                      r["launches"]["compact"] > 0,
                      f"{shape}: rank {r['rank']} launches {r['launches']}")
            self.mesh["world2"][shape] = {
                "dryrun_wall_s": round(wall, 2), "cell": cell,
                "cell_wall_s_by_rank": [r["cell_wall_s"] for r in rep["ranks"]],
                "launches_by_rank": [r["launches"] for r in rep["ranks"]],
                "collectives": coll, "parity": {
                    k: rep["parity"][k] for k in ("candidates",
                                                  "bytes_to_host", "steps",
                                                  "overlap_s")},
                "overflow": rep["overflow"], "serving": rep["serving"]}
            log(f"phase 8: world 2 {shape} on one card ({self.smi}): " +
                json.dumps(self.mesh["world2"][shape]))

    # -- phase 9: the model zoo's serving path -------------------------------
    def phase9_zoo(self):
        """The dense GQA transformers through ``ServeEngine`` on the card:
        (a) the card against the CPU for the five dense smoke configs; (b)
        phi4-mini-3.8b at full width through ``launch.serve``, the user's
        entry point; (c) the same model timed in process (prefill, decode
        step, peak memory, bytes bound); (d) decode against a full forward
        at full width; (e) a padded wave against solo runs.  The path runs
        none of the three hand-written kernels: counts set to 0 before it
        and read after must stay 0."""
        torch = self.torch
        t0 = time.perf_counter()
        self.reset_launches()
        self.zoo = {"card_vs_cpu": self._card_vs_cpu(ZOO_DENSE, "phase 9 (a)")}
        self.zoo["launcher"] = self._zoo_launcher(ZOO_ARCH, "--full")
        self.zoo["full_width"] = self._full_width(ZOO_ARCH)
        launches = self.read_launches()
        check(not any(launches.values()),
              f"phase 9 launched a join kernel: {launches}")
        for entry in self.kernels:
            entry["launches_zoo"] = 0
        log("phase 9: the model zoo's serving path launches none of the "
            f"three kernels (counts from its run: {json.dumps(launches)}); "
            "its attention, norms and FFNs are plain PyTorch, as the "
            "reference's are plain jnp")
        torch.cuda.empty_cache()
        log(f"phase 9: model zoo ok ({time.perf_counter() - t0:.1f} s, "
            f"{self.smi})")

    @staticmethod
    def _rel(got, want):
        want = want.float().cpu()
        return float((got.float().cpu() - want).abs().max()
                     / (want.abs().max() + 1e-9))

    @staticmethod
    def _no_drop(cfg):
        """``cfg`` with an MoE capacity that drops no choice (E / k), as
        the reference's own decode test sets it; a dense config as it is."""
        import dataclasses
        if cfg.moe is None:
            return cfg
        mo = cfg.moe
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            mo, capacity_factor=mo.num_experts / mo.top_k))

    @staticmethod
    def _moe_layers(model):
        from repro_torch.models import moe
        return [b.ffn for b in model.layers if isinstance(b.ffn, moe.MoEFFN)]

    def _card_vs_cpu(self, archs, label):
        """(a) For each smoke config of ``archs`` in float32 (an MoE one
        with a capacity that drops nothing; a cross layer's gate at 0.5,
        where 0 would hide a wrong cross path): one set of weights drawn
        on the CPU and copied to the card.  A wave of three ragged prompts
        (3, 7 and 11 tokens; 3, 7 and 40 for an SSM or cross config, whose
        chunk is 32; 6 new tokens) through ``ServeEngine`` on each device
        must give equal greedy tokens.  A dense or MoE config: the wave's
        prefill logits within 1e-4 of max |logit|, and its MoE layers'
        router ids counted where they differ.  An SSM or cross config: 70
        random tokens (three chunks of 32), with a memory from the seed
        for a cross one, through the forward, a prefill of 69 (with the
        memory) and the decode of the 70th (no memory, as the reference's
        decode step), within 1e-4 of max |logit|, or, where it is larger,
        twice the config's own float32 noise floor: the CPU forward's
        distance from a float64 one.  Where an element of the bf16 cache
        (k/v, MLA's ckv/kr) rounded the other way on the two devices (two
        f32 GEMMs summing in another order), the bf16 tolerance 3e-2."""
        import copy
        import dataclasses
        np, torch = self.np, self.torch
        from repro_torch.configs import get_smoke
        from repro_torch.models import steps, transformer
        from repro_torch.serving.engine import Request, ServeEngine, pad_wave
        rows = {}
        for arch in archs:
            cfg = self._no_drop(dataclasses.replace(get_smoke(arch),
                                                    dtype="float32"))
            long = cfg.ssm is not None or bool(cfg.cross_attn_every)
            cpu = transformer.init_params(
                cfg, torch.Generator().manual_seed(0), "cpu")
            self._gate(cpu)
            models = {"cpu": cpu, "card": copy.deepcopy(cpu).to(self.dev)}
            rng = np.random.default_rng(1 if long else 0)
            toks = mem = None
            if long:
                toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 70)))
                if cfg.cross_attn_every:
                    mem = torch.as_tensor(rng.normal(size=(
                        2, cfg.cross_attn_memory_len,
                        cfg.frontend_embed_dim)), dtype=torch.float32)
            prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                       for n in ((3, 7, 40) if long else (3, 7, 11))]
            cap = 64 if long else 32
            wave = [torch.as_tensor(a) for a in pad_wave(prompts, 3)]
            out = {}
            for dev, model in models.items():
                on = self.dev if dev == "card" else "cpu"
                eng = ServeEngine(cfg, model, batch_slots=3, capacity=cap)
                got = {"tokens": [r.out_tokens for r in eng.run(
                    [Request(p, max_new_tokens=6) for p in prompts])]}
                if long:
                    t, m = toks.to(on), None if mem is None else mem.to(on)
                    with torch.no_grad():
                        got["forward"] = model(t, memory=m)[0]
                    st, got["prefill"] = steps.make_prefill_step(cfg, 74)(
                        model, t[:, :69], memory=m)
                    got["state"], got["decode"] = steps.make_decode_step(
                        cfg)(model, st, t[:, 69:], torch.full(
                            (2, 1), 69, dtype=torch.int32, device=on))
                else:
                    got["state"], got["prefill"] = steps.make_prefill_step(
                        cfg, cap)(model, *[a.to(on) for a in wave])
                    got["ids"] = [m.stats["ids"].cpu()
                                  for m in self._moe_layers(model)]
                out[dev] = got
            card, host = out["card"], out["cpu"]
            check(card["tokens"] == host["tokens"], f"{arch}: card tokens "
                  f"{card['tokens']} != cpu {host['tokens']}")
            flips = sum(int((a[n].cpu() != b[n]).sum())
                        for a, b in zip(card["state"], host["state"])
                        for n in ("k", "v", "ckv", "kr") if n in a)
            errs = {w: self._rel(card[w], host[w]) for w in
                    (("forward", "prefill", "decode") if long
                     else ("prefill",))}
            tol = 1e-4 if flips == 0 else 3e-2
            row = {"tokens_equal": True, "cache_flips": flips}
            if long:
                c64 = dataclasses.replace(cfg, dtype="float64")
                f64 = transformer.Transformer(c64, {
                    n: p.detach().double() for n, p in cpu.named_parameters()})
                with torch.no_grad():
                    row["f32_floor"] = self._rel(host["forward"], f64(
                        toks, memory=None if mem is None else mem.double())[0])
                tol = max(tol, 2 * row["f32_floor"])
                row["memory"] = mem is not None
            check(max(errs.values()) <= tol, f"{arch}: card vs cpu {errs} > "
                  f"{tol} ({flips} cache flips)")
            row.update(errs, tol=tol)
            if not long:
                row["within_1e-4"] = errs["prefill"] <= 1e-4
            if card.get("ids"):
                row["router_ids_differing"] = sum(
                    int((a != b).sum()) for a, b in zip(card["ids"], host["ids"]))
                row["capacity_factor"] = cfg.moe.capacity_factor
            rows[arch] = row
        log(f"{label}: card == cpu, {len(archs)} smoke configs, f32: " +
            json.dumps(rows))
        return rows

    def _zoo_launcher(self, arch, size):
        """(b) ``python -m repro_torch.launch.serve --arch <arch> <size>``
        on the card: 16 requests, 12 new tokens, 8 slots."""
        cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
               arch, size, "--requests", "16", "--max-new", "12",
               "--batch-slots", "8", "--device", "cuda"]
        env = dict(os.environ, PYTHONPATH=SRC)
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=600)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0,
              f"launch.serve exited {proc.returncode}: {proc.stderr[-2000:]}")
        rep = json.loads(proc.stdout.strip().splitlines()[-1])
        check(rep["requests"] == 16 and rep["tokens_generated"] == 192,
              f"launch.serve report {rep}")
        row = dict(rep, process_wall_s=round(wall, 2))
        log(f"phase 9 (b): {' '.join(cmd[2:])} ({self.smi}): " +
            json.dumps(row))
        return row

    def _full_width(self, arch, layers=None, n_params=None):
        """(c)-(e) for one config at full width, ``layers`` of it (all by
        default): random weights from seed 0 drawn on the card, in f32
        and cast once to bf16 by ``ServeEngine`` (a config cut in depth:
        drawn in bf16 leaf by leaf, each leaf drawn in f32 and rounded as
        it is drawn), a cross layer's gate at 0.5.  Every family: init s
        and peak; the launcher's 16 requests x 12 new tokens on 8 slots in
        process; a wave's prefill ms (events); a decode step's ms (events;
        one call) and its device time and activities (profiler, one step)
        against its bytes bound (the weights; and the weights, the SSM
        state read and written and the KV cache read); peak memory.  Then
        the family's own parts (``_moe_parts``, ``_dense_parts``): a cross
        config's prefill with a memory (8, 1600, 1280) from the seed, which
        must differ from one without; an SSM config's prefill of 8 x 256
        (what the chunk pad computes anyway) and ``_long_prefill``."""
        import dataclasses
        np, torch = self.np, self.torch
        from repro_torch.configs import get_config
        from repro_torch.data.pipeline import ByteTokenizer
        from repro_torch.models import steps, transformer
        from repro_torch.serving.engine import Request, ServeEngine, pad_wave
        cfg = full = get_config(arch)
        layers = layers or full.num_layers
        if layers < full.num_layers:
            cfg = dataclasses.replace(full, num_layers=layers,
                                      param_dtype=full.dtype)
        got = transformer.count_params(cfg)
        check(cfg.dtype == "bfloat16" and got == (n_params or got),
              f"{arch} at {layers} layers: {got} parameters, want {n_params}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = transformer.init_params(
            cfg, torch.Generator(device=self.dev).manual_seed(0), self.dev)
        self._gate(model)
        eng = ServeEngine(cfg, model, batch_slots=8, capacity=256)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        init_peak = torch.cuda.max_memory_allocated()
        weight_bytes = sum(p.numel() * p.element_size()
                           for p in model.parameters())
        moes = self._moe_layers(model)
        calls = []          # (tokens a row, dropped, load) a layer a call
        hooks = [m.register_forward_hook(
            lambda mod, inp, out: calls.append(
                (inp[0].shape[1], mod.stats["dropped"], mod.stats["load"])))
            for m in moes]
        tok = ByteTokenizer(cfg.vocab_size)
        rng = np.random.default_rng(0)
        prompts = [np.clip(tok.encode(
            f"Do records {int(rng.integers(1e4))} and "
            f"{int(rng.integers(1e4))} refer to the same incident?"), 0,
            cfg.vocab_size - 1) for _ in range(16)]
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reqs = [Request(p, max_new_tokens=12) for p in prompts]
        t0 = time.perf_counter()
        eng.run(reqs)
        run_s = time.perf_counter() - t0
        for h in hooks:
            h.remove()
        n_tok = sum(len(r.out_tokens) for r in reqs)
        check(n_tok == 192, f"{arch} full width: {n_tok} tokens")
        peak = torch.cuda.max_memory_allocated()
        row = {"arch": arch, "layers": layers, "params": got,
               "dtype": cfg.dtype, "weight_bytes": weight_bytes,
               "init_s": round(init_s, 3), "init_peak_bytes": init_peak,
               "serve_16x12": {"wall_s": run_s, "tokens": n_tok,
                               "tok_per_s": n_tok / run_s,
                               "decode_steps": eng.steps_executed},
               "serve_peak_bytes": peak,
               "serve_peak_over_weights_bytes": peak - base}
        if moes:
            row["serve_16x12"]["waves"], loads = self._moe_waves(
                calls, len(moes), cfg.moe.top_k)
            row["first_prefill_load_histogram"] = [
                np.bincount(l).tolist() for l in loads]
            row["first_prefill_max_load"] = [int(l.max()) for l in loads]
        # (c) one wave's prefill and one decode step, CUDA events
        prefill = steps.make_prefill_step(cfg, 256)
        decode = steps.make_decode_step(cfg)
        wave = [torch.as_tensor(a, device=self.dev)
                for a in pad_wave(sorted(prompts, key=len)[8:], 8)]
        pmax = wave[0].shape[1]
        row["wave"] = [8, pmax]
        mem = None
        if cfg.cross_attn_every:
            mem = torch.as_tensor(np.random.default_rng(0).normal(size=(
                8, cfg.cross_attn_memory_len, cfg.frontend_embed_dim)),
                dtype=torch.bfloat16, device=self.dev)
            without = prefill(model, *wave)[1]
            with_mem = prefill(model, *wave, memory=mem)[1]
            row["prefill_memory_vs_none"] = self._rel(with_mem, without)
            check(row["prefill_memory_vs_none"] > 1e-3,
                  f"{arch}: prefill with a memory equals prefill without")
            row["prefill_ms_per_wave_no_memory"] = self.time_ms(
                lambda: prefill(model, *wave), runs=5, reps=3)
            del without, with_mem
        row["prefill_ms_per_wave"] = self.time_ms(
            lambda: prefill(model, *wave, memory=mem), runs=5, reps=3)
        if cfg.ssm is not None:
            long = torch.as_tensor(np.random.default_rng(2).integers(
                0, cfg.vocab_size, (8, 256)), device=self.dev)
            row["prefill_ms_8x256"] = self.time_ms(
                lambda: prefill(model, long), runs=3, reps=1)
            del long
        state, logits = prefill(model, *wave, memory=mem)
        check(bool(torch.all(torch.isfinite(logits))),
              f"{arch} full width: non-finite prefill logits")
        row["max_abs_logit"] = float(logits.abs().max())
        token = steps.greedy_sample(logits)[:, None]
        pos = (pmax - wave[1]).to(torch.int32)[:, None]

        def step():
            decode(model, state, token, pos, wave[1])
        row["decode_ms_per_step"] = self.time_ms(step, runs=7, reps=10)
        row["decode_one_call_ms"] = self.time_ms(step, runs=7, reps=1)
        dev_ms, acts = self._device_once(step)
        row["decode_device_ms"], row["decode_device_activities"] = dev_ms, acts
        row["decode_busy_share"] = dev_ms / row["decode_ms_per_step"]
        # the bytes a decode step must move: the weights, the SSM states
        # (f32) it reads and writes, the KV cache (bf16) it reads at this
        # wave
        cache = ("k", "v", "ckv", "kr")
        state_bytes = sum(t.numel() * t.element_size() for layer in state
                          for n, t in layer.items()
                          if n not in cache and torch.is_tensor(t))
        cache_bytes = sum(8 * (pmax + 1) * t[0, 0].numel() * t.element_size()
                          for layer in state for n, t in layer.items()
                          if n in cache)
        row["decode_bound_ms_weights"] = 1e3 * weight_bytes / self.bw
        row["decode_bound_ms"] = 1e3 * (weight_bytes + 2 * state_bytes
                                        + cache_bytes) / self.bw
        row["bound_by"] = "bytes"
        row["state_bytes"], row["cache_bytes_read"] = state_bytes, cache_bytes
        step()              # an MoE layer's stats: this step's choices
        del state, logits
        if moes:
            row.update(self._moe_parts(cfg, model, moes, weight_bytes,
                                       state_bytes, cache_bytes, prompts))
        elif cfg.ssm is not None:
            row["long_prefill"] = self._long_prefill(
                cfg, model, LONG_PREFILL[arch])
        elif not cfg.cross_attn_every:
            row.update(self._dense_parts(cfg, model, prompts))
        del model, eng
        log(f"phase 9 (c)-(e): {arch} full width, {layers} layers "
            f"({self.smi}): " + json.dumps(row))
        return row

    @staticmethod
    def _moe_waves(calls, n_layers, k):
        """The MoE layers' calls of a serving run, (tokens a row, dropped,
        load) a layer a call: the dropped choices a wave (its prefill, then
        its decode steps) and the first prefill's expert loads."""
        waves, loads = [], None
        for i in range(0, len(calls), n_layers):
            fwd = calls[i:i + n_layers]
            dropped = sum(int(d) for _, d, _ in fwd)
            if fwd[0][0] > 1:
                waves.append({"prefill_dropped": dropped, "prefill_choices":
                              sum(int(l.sum()) for _, _, l in fwd),
                              "decode_dropped": 0, "decode_choices": 0,
                              "decode_steps": 0})
                if loads is None:
                    loads = [l.cpu().numpy() for _, _, l in fwd]
            else:
                waves[-1]["decode_dropped"] += dropped
                waves[-1]["decode_choices"] += 8 * k * n_layers
                waves[-1]["decode_steps"] += 1
        return waves, loads

    def _moe_parts(self, cfg, model, moes, weight_bytes, state_bytes,
                   cache_bytes, prompts):
        """(c)-(e) of an MoE config after a decode step: the experts that
        step's tokens chose and its bound over them alone (and 8 embedding
        rows) besides every weight (``moe_ffn_dense`` computes every
        expert); (d) decode against a forward with no drops; (e) a padded
        wave of three against solo runs (the config's capacity: a wave and
        a solo prompt route different token counts)."""
        used = [int(self.torch.unique(m.stats["ids"]).numel()) for m in moes]
        mo, d = cfg.moe, cfg.d_model
        expert_bytes = 3 * d * mo.expert_d_ff * 2
        active = (weight_bytes - cfg.vocab_size * d * 2 + 8 * d * 2
                  - sum(mo.num_experts - u for u in used) * expert_bytes)
        row = {"decode_experts_used": used,
               "decode_bound_ms_active_experts":
                   1e3 * (active + 2 * state_bytes + cache_bytes) / self.bw}
        weights = {n: p.detach() for n, p in model.named_parameters()}
        nd_cfg = self._no_drop(cfg)
        decode_vs = self._decode_vs_forward(nd_cfg, weights)
        check(decode_vs["bf16_vs_forward"]["routing_flips"] > 0
              or decode_vs["bf16_vs_forward"]["err"] < 0.15,
              f"{cfg.name} full width: decode vs forward {decode_vs}")
        dv = decode_vs["f32_vs_prefill"]
        check(dv["routing_flips"] == 0 and dv["err"] <= (
            1e-4 if dv["cache_flips"] == 0 else 3e-2),
            f"{cfg.name} full width, f32: decode vs prefill {dv}")
        del weights
        trio = [prompts[i][:n] for i, n in ((0, 20), (1, 35), (2, 52))]
        row.update(decode_vs_forward=decode_vs,
                   decode_vs_forward_capacity_factor=nd_cfg.moe.capacity_factor,
                   padded_vs_solo=self._padded_vs_solo(cfg, model, trio))
        return row

    def _dense_parts(self, cfg, model, prompts):
        """(d)-(e) of a dense config: prefill 32 tokens, decode the 33rd,
        against a full forward (< 0.15 of max |logit|); a padded wave of
        three against solo runs, in bf16 (the served model) and in f32
        (the same weights drawn again, not cast)."""
        import dataclasses
        np, torch = self.np, self.torch
        from repro_torch.models import steps, transformer
        toks = torch.as_tensor(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (2, 33)), device=self.dev)
        st, _ = steps.make_prefill_step(cfg, 40)(model, toks[:, :32])
        _, dec = steps.make_decode_step(cfg)(
            model, st, toks[:, 32:33],
            torch.full((2, 1), 32, dtype=torch.int32, device=self.dev))
        with torch.inference_mode():
            full = model(toks)[0][:, -1]
        dec_err = self._rel(dec, full)
        check(dec_err < 0.15, f"full width: decode vs forward {dec_err}")
        del st, full
        trio = [prompts[i][:n] for i, n in ((0, 20), (1, 35), (2, 52))]
        padded = {cfg.dtype: self._padded_vs_solo(cfg, model, trio)}
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        model = transformer.init_params(
            cfg32, torch.Generator(device=self.dev).manual_seed(0), self.dev)
        padded["float32"] = self._padded_vs_solo(cfg32, model, trio)
        return {"decode_vs_forward_err": dec_err, "padded_vs_solo": padded}

    def _padded_vs_solo(self, cfg, model, prompts):
        """A padded wave of ``prompts`` against each prompt served alone:
        the share of equal greedy tokens (6 new a request), which
        requests' first tokens are equal, and the prefill's last logits
        (padded against solo, of max |logit|) with the solo top-2 gap."""
        torch = self.torch
        from repro_torch.models import steps
        from repro_torch.serving.engine import Request, ServeEngine, pad_wave
        wave = ServeEngine(cfg, model, batch_slots=len(prompts),
                           capacity=256).run(
            [Request(p, max_new_tokens=6) for p in prompts])
        solo = [ServeEngine(cfg, model, batch_slots=1, capacity=256).run(
            [Request(p, max_new_tokens=6)])[0] for p in prompts]
        same = sum(a == b for w, o in zip(wave, solo)
                   for a, b in zip(w.out_tokens, o.out_tokens))
        prefill = steps.make_prefill_step(cfg, 256)

        def last_logits(batch):
            return prefill(model, *[torch.as_tensor(a, device=self.dev)
                                    for a in pad_wave(batch, len(batch))])[1]
        padded = last_logits(prompts)
        errs, gaps = [], []
        for i, p in enumerate(prompts):
            alone = last_logits([p])
            errs.append(self._rel(padded[i:i + 1], alone))
            top = torch.topk(alone[0], 2).values
            gaps.append(float(top[0] - top[1]))
        return {"equal_share": same / sum(len(o.out_tokens) for o in solo),
                "first_token_equal": [w.out_tokens[0] == o.out_tokens[0]
                                      for w, o in zip(wave, solo)],
                "prefill_err": errs, "solo_top2_gap": gaps,
                "max_logit": float(padded.abs().max())}

    # -- phase 9, MoE: the zoo's MoE FFN and MLA attention ------------------
    def phase9_moe(self):
        """The MoE configs through ``ServeEngine`` on the card: (a) card
        against CPU for llama4-maverick's and deepseek-v2's smoke configs;
        (b) ``launch.serve --arch deepseek-v2-236b --smoke``; (c)
        deepseek-v2-236b at full width (2 of 60 layers) and then
        llama4-maverick-400b-a17b at full width (2 of 48), each timed; (d)
        decode against a full forward at full width with no drops; (e) a
        padded wave against solo runs (recorded).  The path runs none of
        the three hand-written kernels: counts set to 0 before it and read
        after must stay 0."""
        torch = self.torch
        t0 = time.perf_counter()
        self.reset_launches()
        self.moe = {"card_vs_cpu": self._card_vs_cpu(ZOO_MOE, "phase 9 (a)")}
        self.moe["launcher"] = self._zoo_launcher("deepseek-v2-236b", "--smoke")
        for arch, layers, n_params in ZOO_MOE_FULL:
            self.moe[arch] = self._full_width(arch, layers, n_params)
            torch.cuda.empty_cache()
        launches = self.read_launches()
        check(not any(launches.values()),
              f"phase 9 (MoE) launched a join kernel: {launches}")
        for entry in self.kernels:
            entry["launches_moe"] = 0
        log("phase 9 (MoE): the MoE FFN and MLA paths launch none of the "
            f"three kernels (counts from its run: {json.dumps(launches)}); "
            "routing, capacity gather, expert GEMMs and the combine are "
            "plain PyTorch, as the reference's are plain jnp")
        log(f"phase 9 (MoE): ok ({time.perf_counter() - t0:.1f} s, "
            f"{self.smi})")

    def _decode_vs_forward(self, cfg, weights):
        """(d) Two rows of 33 random tokens through ``cfg`` (no drops) on
        ``weights``: prefill 32, decode the 33rd.  (1) In the served dtype,
        against a full forward (the reference's test): the error and the
        routing flips, the MoE choices of the decoded token that differ
        from the forward's in any layer; the error must be < 0.15 where
        none flipped.  A flip is a discrete change that no tolerance
        bounds: a token sent to another expert.  (2) The same weights in
        float32 compute (cast at use), against a prefill of all 33 tokens
        into a fresh cache, so that both sides read the same bf16 cache:
        within 1e-4 of max |logit| (3e-2 where a cache element rounded the
        other way), no routing flip."""
        import dataclasses
        np, torch = self.np, self.torch
        from repro_torch.models import steps, transformer
        toks = torch.as_tensor(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (2, 33)), device=self.dev)
        pos = torch.full((2, 1), 32, dtype=torch.int32, device=self.dev)
        out = {}
        for what, dtype in (("bf16_vs_forward", cfg.dtype),
                            ("f32_vs_prefill", "float32")):
            c = dataclasses.replace(cfg, dtype=dtype)
            model = transformer.Transformer(c, weights)
            moes = self._moe_layers(model)
            st, _ = steps.make_prefill_step(c, 40)(model, toks[:, :32])
            st, dec = steps.make_decode_step(c)(model, st, toks[:, 32:33], pos)
            ids = [m.stats["ids"].sort(-1).values for m in moes]
            row = {"dtype": dtype}
            if what == "bf16_vs_forward":
                with torch.inference_mode():
                    want = model(toks)[0][:, -1]
            else:
                ref_st, want = steps.make_prefill_step(c, 40)(model, toks)
                row["cache_flips"] = sum(
                    int((a[n][:, :33] != b[n][:, :33]).sum())
                    for a, b in zip(st, ref_st) for n in a if n != "index")
            want_ids = [m.stats["ids"].reshape(2, -1, c.moe.top_k)[:, -1]
                        .sort(-1).values for m in moes]
            row["routing_flips"] = sum(int((a != b).sum())
                                       for a, b in zip(ids, want_ids))
            row["dropped"] = sum(int(m.stats["dropped"]) for m in moes)
            row["err"] = self._rel(dec, want)
            row["max_abs_logit"] = float(want.abs().max())
            check(row["dropped"] == 0, f"{cfg.name}: drops at E / k: {row}")
            out[what] = row
            del model, st, want
        return out

    # -- phase 9, SSM: the SSM blocks and gated cross-attention -------------
    def phase9_ssm(self):
        """The SSM and cross-attention configs through ``ServeEngine`` on
        the card: (a) card against CPU for zamba2's, xlstm's and
        llama-3.2-vision's smoke configs; (b) ``launch.serve --full`` for
        zamba2-1.2b and xlstm-350m; (c) zamba2-1.2b whole, xlstm-350m at 12
        of 24 layers and llama-3.2-vision-90b at 10 of 100, at full width, each
        timed, llama-vision with a memory; (d) a long prefill (zamba2
        512 tokens, xlstm 256), then a decode, against a full forward.
        The path runs none
        of the three hand-written kernels: counts set to 0 before it and
        read after must stay 0."""
        torch = self.torch
        t0 = time.perf_counter()
        self.reset_launches()
        self.ssm = {"card_vs_cpu": self._card_vs_cpu(
            ZOO_SSM, "phase 9 (SSM) (a)")}
        for arch in ZOO_SSM[:2]:
            self.ssm[f"launcher_{arch}"] = self._zoo_launcher(arch, "--full")
        for arch, layers, n_params in ZOO_SSM_FULL:
            self.ssm[arch] = self._full_width(arch, layers, n_params)
            torch.cuda.empty_cache()
        launches = self.read_launches()
        check(not any(launches.values()),
              f"phase 9 (SSM) launched a join kernel: {launches}")
        for entry in self.kernels:
            entry["launches_ssm"] = 0
        log("phase 9 (SSM): the SSM blocks and cross-attention launch none "
            f"of the three kernels (counts from its run: {json.dumps(launches)}"
            "); the chunked scans, the sLSTM loop and cross-attention are "
            "plain PyTorch, as the reference's are plain jnp and lax.scan")
        log(f"phase 9 (SSM): ok ({time.perf_counter() - t0:.1f} s, "
            f"{self.smi})")

    def _gate(self, model, value=0.5):
        """Every cross layer's gate set to ``value`` (0 at init, where a
        wrong cross path would still give the right answer)."""
        with self.torch.no_grad():
            for blk in model.layers:
                if blk.kind == "cross_attn":
                    blk.attn.gate.fill_(value)

    def _nudged(self, model, seed):
        """A copy of ``model`` with every weight moved one ulp up or down,
        the side drawn from ``seed``: another draw of the f32 rounding."""
        import copy
        from repro_torch.launch.ep_world import nudge_
        out = copy.deepcopy(model)
        nudge_(out.parameters(), seed)
        return out

    def _long_prefill(self, cfg, model, n):
        """(d) 1 x ``n`` random tokens prefilled (``LONG_PREFILL``: zamba2
        512, 2 chunks of 256, the inter-chunk scan at full width; xlstm
        256, its sLSTM a Python loop over time), then token n + 1
        decoded, on the served weights (cast at use), against the last
        logits of a full forward of the n + 1 (the reference's decode
        test) and of a prefill of the n + 1 into a fresh state; and the
        prefill's wall (events, one call).  Four runs: float64 compute with an f64 KV cache and f64
        attention scores (rope's angles and rotation stay f32); float32
        compute with the served bf16 KV cache; zamba2 also with an f32
        cache; the served bf16.  Gated, each limit set from the readings
        of a first run on an H100 (PERF.md §6):
        - every SSM layer, teacher-forced in the f32 run (fed its input
          from the prefill of n + 1), after a prefill of n and one step
          gives the state and the output change of that prefill to 5e-4 of
          each leaf's max (read: at most 4.5e-5 zamba2, 9.9e-5 xlstm): the
          recurrent step against the chunked scan at full width, each
          layer on its own (the readings at 4096 for both);
        - in float64 the decode gives the forward's and the prefill of
          n + 1's logits to 1e-6 of max |logit| (card: 2.2e-10 zamba2,
          5.6e-8 xlstm, whose forward starts mLSTM at m = -inf and sLSTM
          at n = 1 where a prefill starts from zeros, as the reference's):
          the decode path in near exact arithmetic;
        - zamba2 in f32 with an f32 cache: decode vs forward < 0.15, the
          reference's own test's bound (read: 1.0e-2).
        Recorded: each run against the f64 one, which shows how far
        rounding alone carries these random models at this length: the
        f32 forward of xlstm lies 0.66 of max |logit| from the f64 one, so
        no f32 decode of it can come within 0.15 of a forward; zamba2's
        bf16 cache moves its prefill 0.21 from its forward; and each
        layer's state error in the f32 run untaught (a deeper layer adds
        what the ones above it round otherwise)."""
        import dataclasses
        np, torch = self.np, self.torch
        from repro_torch.models import steps, transformer
        toks = torch.as_tensor(np.random.default_rng(3).integers(
            0, cfg.vocab_size, (1, n + 1)), device=self.dev)
        pos = torch.full((1, 1), n, dtype=torch.int32, device=self.dev)
        kinds = [k for k, _ in transformer.plan_segments(cfg).layers]
        ssm = [i for i, k in enumerate(kinds) if k in ("mamba2", "mlstm",
                                                       "slstm")]
        weights = {n: p.detach() for n, p in model.named_parameters()}
        runs = [("float64", "float64"), ("float32", "bfloat16")]
        if "attn" in kinds:
            runs.append(("float32", "float32"))
        runs.append((cfg.dtype, "bfloat16"))
        out, last = {}, {}

        def prefill(c, m, cache, length):
            """The prefill step with its KV cache in ``cache``."""
            st = [{k: t.to(getattr(torch, cache)) if k in ("k", "v") else t
                   for k, t in layer.items()}
                  for layer in transformer.init_state(c, 1, n + 8, self.dev)]
            with torch.inference_mode():
                logits, st, _ = m(toks[:, :length], state=st)
            return st, logits[:, -1]
        for dtype, cache in runs:
            key = f"{dtype}_{cache}_cache"
            c = dataclasses.replace(cfg, dtype=dtype)
            if dtype == "float64":
                c = dataclasses.replace(c, attn_scores_dtype="float64")
            m = model if dtype == cfg.dtype else transformer.Transformer(
                c, weights)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.reset_peak_memory_stats()
            ev[0].record()
            st, _ = prefill(c, m, cache, n)
            ev[1].record()
            ev[1].synchronize()
            st, dec = steps.make_decode_step(c)(m, st, toks[:, n:], pos)
            with torch.inference_mode():
                fwd = m(toks)[0][:, -1]
            row = {"prefill_ms": ev[0].elapsed_time(ev[1]),
                   "max_abs_logit": float(fwd.abs().max()),
                   "decode_vs_forward_err": self._rel(dec, fwd)}
            if dtype != cfg.dtype:
                xs, ys = {}, {}
                hooks = [blk.register_forward_pre_hook(
                    lambda mod, a, i=i: xs.__setitem__(i, a[0]))
                    for i, blk in enumerate(m.layers) if i in ssm]
                hooks += [blk.register_forward_hook(
                    lambda mod, a, o, i=i: ys.__setitem__(i, o[0][:, -1]))
                    for i, blk in enumerate(m.layers) if i in ssm]
                st2, pre = prefill(c, m, cache, n + 1)
                for h in hooks:
                    h.remove()
                row["decode_vs_prefill_err"] = self._rel(dec, pre)
                row["prefill_vs_forward_err"] = self._rel(pre, fwd)
                row["state_err_by_layer"] = [
                    max(self._rel(st[i][k], st2[i][k]) for k in st[i])
                    for i in ssm]
                if key == "float32_bfloat16_cache":
                    row["taught_err_by_layer"] = self._taught(
                        m, ssm, xs, ys, st2, n)
                del xs, ys, st2
            if dtype == "float64":
                last["f64"] = {"fwd": fwd, "dec": dec, "pre": pre}
            else:
                row["forward_vs_f64_err"] = self._rel(fwd, last["f64"]["fwd"])
                row["decode_vs_f64_err"] = self._rel(dec, last["f64"]["dec"])
            row["peak_bytes"] = torch.cuda.max_memory_allocated()
            out[key] = row
            del st, fwd, dec, m
        taught = out["float32_bfloat16_cache"]["taught_err_by_layer"]
        check(max(taught) <= 5e-4,
              f"{cfg.name}: {n}-token prefill + one step against a prefill "
              f"of {n + 1}, each SSM layer taught its input: {taught}")
        f64 = out["float64_float64_cache"]
        check(max(f64["decode_vs_prefill_err"],
                  f64["decode_vs_forward_err"]) <= 1e-6,
              f"{cfg.name}: {n}-token prefill + decode in float64: {f64}")
        if "attn" in kinds:
            f32 = out["float32_float32_cache"]
            check(f32["decode_vs_forward_err"] < 0.15,
                  f"{cfg.name}: {n}-token prefill + decode in float32 with "
                  f"an f32 cache against a forward: {f32}")
        out["tokens"] = n
        return out

    def _taught(self, m, ssm, xs, ys, want, n):
        """Each SSM layer ``i`` of ``m``, fed ``xs[i]`` (its input in a
        prefill of all n + 1 tokens): a prefill of the first n from the
        zero state and one step on the last, against that prefill's state
        ``want[i]`` and the change ``ys[i] - x`` its block made to the
        stream at the last token; the larger of the two errors, of max."""
        torch = self.torch
        from repro_torch.models import transformer
        zero = transformer.init_state(m.cfg, 1, n + 8, self.dev)
        pos = torch.arange(n + 1, device=self.dev)[None]
        errs = []
        with torch.inference_mode():
            for i in ssm:
                blk, x = m.layers[i], xs[i]
                _, st, _ = blk(x[:, :n], pos[:, :n], zero[i])
                y, st, _ = blk(x[:, n:], pos[:, n:], st)
                errs.append(max(
                    [self._rel(y[:, -1] - x[:, -1], ys[i] - x[:, -1])]
                    + [self._rel(st[k], want[i][k]) for k in st]))
        return errs

    # -- phase 10: the model zoo's training path ------------------------------
    def phase10_train(self):
        """The zoo's train step on the card: (a) card against CPU for the
        five dense smoke configs, the two MoE ones and the three SSM /
        cross ones; (b) ``launch.train`` with an injected failure and a
        resume; (c) phi4-mini-3.8b, zamba2-1.2b and xlstm-350m (12 of 24
        layers) at full width.  The path runs none of the three hand-written kernels:
        counts set to 0 before it and read after must stay 0."""
        torch = self.torch
        t0 = time.perf_counter()
        self.reset_launches()
        self.train = {"card_vs_cpu": self._train_card_vs_cpu(ZOO_DENSE)}
        self.train["card_vs_cpu_moe"] = self._train_card_vs_cpu(ZOO_MOE)
        self.train["card_vs_cpu_ssm"] = self._train_card_vs_cpu(ZOO_SSM)
        self.train["launcher"] = self._train_launcher()
        self.train["full_width"] = self._train_full_width(ZOO_ARCH,
                                                          3_836_021_760)
        for arch, layers, n_params in ZOO_SSM_FULL[:2]:
            self.train[f"full_width_{arch}"] = self._train_full_width(
                arch, n_params, layers)
            torch.cuda.empty_cache()
        launches = self.read_launches()
        check(not any(launches.values()),
              f"phase 10 launched a join kernel: {launches}")
        for entry in self.kernels:
            entry["launches_train"] = 0
        log("phase 10: the model zoo's training path launches none of the "
            f"three kernels (counts from its run: {json.dumps(launches)}); "
            "its forward, backward and AdamW are plain PyTorch, as the "
            "reference's are plain jnp")
        torch.cuda.empty_cache()
        log(f"phase 10: training ok ({time.perf_counter() - t0:.1f} s, "
            f"{self.smi})")

    def _device_once(self, fn):
        """(device ms, device activities) of one call of ``fn``, from the
        profiler's CUDA activities alone: a window of several calls of a
        full-width train step (≈ 16 000 kernels each) loses records."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        self.torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            self.torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.key != "Activity Buffer Request"]
        return (sum(e.self_device_time_total for e in events) / 1e3,
                sum(e.count for e in events))

    def _train_card_vs_cpu(self, archs):
        """(a) For each smoke config of ``archs`` in float32 (an MoE one
        with a capacity that drops nothing; a cross layer's gate at 0.5 and
        a memory from the seed in the batch): weights drawn on the CPU and
        copied to the card, two train steps on each device from one batch,
        held to the CPU parity tests' float32 tolerances (loss 1e-5,
        ``grad_norm`` and ``m`` 1e-3), or, where it is larger, to twice the
        config's own float32 noise floor, measured on the CPU alone: the
        largest distance from a run in float64 compute on the CPU (f64
        throughout but rope's angles) among five f32 CPU
        runs, the drawn weights and four copies of them each nudged one ulp
        up or down at random (seeds 1-4), five draws of the f32 rounding.
        ``m`` is held after each step.  A chaotic smoke model spreads these
        draws wide: AdamW's first update, g / (|g| + eps), has a slope of
        up to 1 / eps = 1e8 near g = 0, so each draw's roundings move its
        tiny-gradient elements by up to ~lr, and the second step's
        gradients carry that (the draws' spread is logged as
        ``f32_floor.draws``).  So that a fault on the card cannot hide in
        a floor, the floor comes from the CPU's runs only, and the card's
        own distance from the float64 run is held besides, after each
        step, to max(1e-3, twice that floor).  An MoE config's aux loss
        must be > 0 and finite."""
        import copy
        import dataclasses
        np, torch = self.np, self.torch
        from repro_torch.common.config import TrainConfig
        from repro_torch.configs import get_smoke
        from repro_torch.models import steps, transformer
        from repro_torch.optim import adamw
        ulp2 = 2.0 ** -22
        rows = {}
        for arch in archs:
            cfg = self._no_drop(dataclasses.replace(get_smoke(arch),
                                                    dtype="float32"))
            cpu = transformer.init_params(
                cfg, torch.Generator().manual_seed(0), "cpu")
            self._gate(cpu)
            tok = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 17))
            mem = None
            if cfg.cross_attn_every:
                mem = np.random.default_rng(2).normal(size=(
                    4, cfg.cross_attn_memory_len, cfg.frontend_embed_dim))
            out = {}
            runs = [("cpu", cpu), ("card", copy.deepcopy(cpu).to(self.dev))]
            for seed in range(1, 5):
                runs.append((f"cpu{seed}", self._nudged(cpu, seed)))
            c64 = dataclasses.replace(cfg, dtype="float64")
            runs.append(("f64", transformer.Transformer(c64, {
                n: p.detach().double() for n, p in cpu.named_parameters()})))
            for dev, model in runs:
                opt = adamw.init_opt_state(dict(model.named_parameters()))
                on = self.dev if dev == "card" else "cpu"
                batch = {"tokens": torch.as_tensor(tok[:, :-1], device=on),
                         "labels": torch.as_tensor(tok[:, 1:], device=on)}
                if mem is not None:
                    batch["memory"] = torch.as_tensor(
                        mem, device=on,
                        dtype=torch.float64 if dev == "f64" else torch.float32)
                step = steps.make_train_step(
                    c64 if dev == "f64" else cfg,
                    TrainConfig(total_steps=4, warmup_steps=1))
                mets, moms = [], []
                for _ in range(2):
                    opt, met = step(model, opt, batch)
                    mets.append({k: v.cpu() for k, v in met.items()})
                    moms.append({n: v.cpu().clone()
                                 for n, v in opt["m"].items()})
                out[dev] = (mets, moms,
                            {n: p.detach().cpu()
                             for n, p in model.named_parameters()})
            (mc, (m1_c, m_c), p_c) = out["cpu"]
            (mg, (m1_g, m_g), p_g) = out["card"]
            m64, (m1_64, mom64) = out["f64"][0], out["f64"][1]

            def dist(a, b):
                return max(float((a[n] - b[n]).abs().max() / b[n].abs().max())
                           for n in b if b[n].any())

            def from_f64(mets, moms):
                return {"loss": max(abs(float(a["loss"]) / float(b["loss"]) - 1)
                                    for a, b in zip(mets, m64)),
                        "grad_norm": max(abs(float(a["grad_norm"])
                                             / float(b["grad_norm"]) - 1)
                                         for a, b in zip(mets, m64)),
                        "m1": dist(moms[0], m1_64), "m": dist(moms[1], mom64)}
            draws = {dev: from_f64(*out[dev][:2]) for dev in out
                     if dev.startswith("cpu")}
            floor = {k: max(d[k] for d in draws.values())
                     for k in ("loss", "grad_norm", "m1", "m")}
            card = from_f64(mg, (m1_g, m_g))
            floor["draws"], floor["card"] = draws, card
            for k in ("m1", "m"):
                check(card[k] <= max(1e-3, 2 * floor[k]),
                      f"{arch}: the card's m after step {k[1:] or 2} lies "
                      f"{card[k]} of max from the float64 run, the CPU's "
                      f"draws {[d[k] for d in draws.values()]}")
            tol = {k: max(t, 2 * floor[k]) for k, t in
                   (("loss", 1e-5), ("grad_norm", 1e-3), ("m1", 1e-3),
                    ("m", 1e-3))}
            m1_err = dist(m1_g, m1_c)
            check(m1_err <= tol["m1"], f"{arch}: card vs cpu m after step "
                  f"1 {m1_err} (tolerances {tol})")
            lrs, loss_err, gn_err = 0.0, 0.0, 0.0
            for a, b in zip(mg, mc):
                check(torch.equal(a["lr"], b["lr"]), f"{arch}: lr differs")
                check(bool(torch.isfinite(a["loss"])), f"{arch}: loss")
                if cfg.moe is not None:
                    check(bool(torch.isfinite(a["aux"])) and float(a["aux"]) > 0,
                          f"{arch}: aux {float(a['aux'])} on the card")
                loss_err = max(loss_err, abs(float(a["loss"])
                                             / float(b["loss"]) - 1))
                gn_err = max(gn_err, abs(float(a["grad_norm"])
                                         / float(b["grad_norm"]) - 1))
                lrs += float(b["lr"])
            check(loss_err <= tol["loss"] and gn_err <= tol["grad_norm"],
                  f"{arch}: card vs cpu loss {loss_err}, grad_norm {gn_err} "
                  f"(tolerances {tol})")
            m_err, p_err, far, total = 0.0, 0.0, 0, 0
            for n in p_c:
                mx = float(m_c[n].abs().max())
                if mx == 0:      # no gradient reaches it (frontend_proj)
                    check(not m_g[n].any(), f"{arch}: {n} has a gradient "
                          "on the card only")
                else:
                    m_err = max(m_err, float((m_g[n] - m_c[n]).abs().max())
                                / mx)
                d = (p_g[n] - p_c[n]).abs() - ulp2 * p_c[n].abs()
                p_err = max(p_err, float(d.max()) / lrs)
                far += int((d > 1e-2 * lrs).sum())
                total += d.numel()
            check(m_err <= tol["m"] and p_err <= 2.5,
                  f"{arch}: card vs cpu m {m_err}, params {p_err} lr "
                  f"(tolerances {tol})")
            rows[arch] = {"loss": [float(m["loss"]) for m in mg],
                          "loss_err": loss_err, "grad_norm_err": gn_err,
                          "m1_err": m1_err, "m_err": m_err,
                          "param_err_over_lr": p_err,
                          "params_over_1e-2_lr": far / total,
                          "f32_floor": floor, "tol": tol}
            if cfg.moe is not None:
                rows[arch]["aux"] = [float(m["aux"]) for m in mg]
        log(f"phase 10 (a): card == cpu, two train steps, {len(archs)} smoke "
            "configs, f32: " + json.dumps(rows))
        return rows

    def _train_launcher(self):
        """(b) ``python -m repro_torch.launch.train --device cuda`` at smoke
        size: ``--fail-at 5`` leaves checkpoints at steps 2 and 4; a plain
        run resumes at 4 and ends with a finite loss."""
        import shutil
        import tempfile
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        ck = tempfile.mkdtemp(prefix="train_ckpt_", dir=os.path.join(ROOT, "build"))
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
               ZOO_ARCH, "--smoke", "--steps", "8", "--checkpoint-every", "2",
               "--checkpoint-dir", ck, "--device", "cuda"]
        env = dict(os.environ, PYTHONPATH=SRC)
        row = {}
        try:
            for what, extra in (("fail", ["--fail-at", "5"]), ("resume", [])):
                t0 = time.perf_counter()
                proc = subprocess.run(cmd + extra, cwd=ROOT, env=env,
                                      capture_output=True, text=True,
                                      timeout=300)
                row[f"{what}_wall_s"] = round(time.perf_counter() - t0, 2)
                if what == "fail":
                    check(proc.returncode != 0
                          and "SimulatedFailure" in proc.stderr,
                          f"launch.train --fail-at 5 exited "
                          f"{proc.returncode}: {proc.stderr[-2000:]}")
                    check(sorted(os.listdir(ck)) ==
                          ["step_00000002", "step_00000004"],
                          f"checkpoints after the failure: {os.listdir(ck)}")
                    continue
                check(proc.returncode == 0, f"launch.train resume exited "
                      f"{proc.returncode}: {proc.stderr[-2000:]}")
                check("resumed from checkpoint step 4" in proc.stdout,
                      f"launch.train did not resume: {proc.stdout[-500:]}")
                rep = json.loads(proc.stdout.strip().splitlines()[-1])
                check(rep["steps"] == 8 and self.np.isfinite(rep["loss"]),
                      f"launch.train report {rep}")
                row.update(rep, checkpoints=sorted(os.listdir(ck)))
        finally:
            shutil.rmtree(ck, ignore_errors=True)
        shown = " ".join("<tmp>" if c == ck else c for c in cmd[2:])
        log(f"phase 10 (b): {shown} --fail-at 5, then resumed ({self.smi}): "
            + json.dumps(row))
        return row

    def _train_full_width(self, arch, want_params, layers=None):
        """(c) ``arch`` at full width (phi4-mini-3.8b, zamba2-1.2b,
        xlstm-350m), ``layers`` of it (all by default; ``want_params`` its
        parameters there): f32 masters drawn on the card, bf16 compute,
        remat as the config says, AdamW in place; six steps of the
        launcher's loader
        (batch 8, seq 128, ``warmup_steps`` 1 as ``train()`` sets it for 6
        steps).  Model FLOPs: 6 N a token, plus 12 L_attn H hd s a token for
        the causal attention layers' scores (zamba2's 6 shared-pattern
        attention layers, none in xlstm); left out: the SSD's and mLSTM's
        intra-chunk quadratic terms, the scans and sLSTM's recurrence, and
        the embedding counted in N though it is a gather."""
        import dataclasses
        np, torch = self.np, self.torch
        from repro_torch.common.config import TrainConfig
        from repro_torch.configs import get_config
        from repro_torch.launch.train import make_loader
        from repro_torch.models import steps, transformer
        from repro_torch.optim import adamw
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        n_params = transformer.count_params(cfg)
        check(cfg.dtype == "bfloat16" and cfg.param_dtype == "float32"
              and cfg.remat and n_params == want_params,
              f"{arch}: dtype {cfg.dtype}, params {cfg.param_dtype}, "
              f"remat {cfg.remat}, {n_params} parameters")
        n_steps, b, s = 6, 8, 128
        tcfg = TrainConfig(total_steps=n_steps,
                           warmup_steps=max(n_steps // 10, 1))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = transformer.init_params(
            cfg, torch.Generator(device=self.dev).manual_seed(0), self.dev)
        params = dict(model.named_parameters())
        opt = adamw.init_opt_state(params)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        state_bytes = 16 * n_params       # p, g (f32), m, v
        train_step = steps.make_train_step(cfg, tcfg)
        loader = make_loader(cfg, batch=b, seq=s, seed=0)
        rows, ms = [], []
        try:
            torch.cuda.reset_peak_memory_stats()
            for i in range(n_steps):
                batch = {k: torch.as_tensor(v, device=self.dev)
                         for k, v in loader.next().items()}
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                opt, met = train_step(model, opt, batch)
                ev[1].record()
                ev[1].synchronize()
                ms.append(ev[0].elapsed_time(ev[1]))
                rows.append({k: float(v) for k, v in met.items()})
            peak = torch.cuda.max_memory_allocated()
            for i, r in enumerate(rows):
                check(np.isfinite(r["loss"]) and r["grad_norm"] > 0,
                      f"full width step {i + 1}: {r}")
            step_ms = statistics.median(ms[1:])
            # the card's busy share of a step: one more step, profiled, and
            # the host's time to enqueue one (the step never syncs)
            batch = {k: torch.as_tensor(v, device=self.dev)
                     for k, v in loader.next().items()}
            dev_ms, n_kernels = self._device_once(
                lambda: train_step(model, opt, batch))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_step(model, opt, batch)
            enqueue_ms = 1e3 * (time.perf_counter() - t0)
            torch.cuda.synchronize()
            # the optimizer alone: fresh f32 gradients each call, made
            # outside the timed region (adamw_update consumes them)
            opt_ms = []
            for i in range(4):
                grads = {n: torch.randn_like(p) * 1e-4
                         for n, p in params.items()}
                if i == 3:
                    opt_dev_ms, _ = self._device_once(
                        lambda: adamw.adamw_update(params, grads, opt, tcfg))
                    continue
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                adamw.adamw_update(params, grads, opt, tcfg)
                ev[1].record()
                ev[1].synchronize()
                opt_ms.append(ev[0].elapsed_time(ev[1]))
            del grads
            opt_peak = torch.cuda.max_memory_allocated()
        finally:
            loader.close()
        tokens = b * s
        hd = cfg.resolved_head_dim
        n_attn = sum(k == "attn" for k, _ in
                     transformer.plan_segments(cfg).layers)
        flops = 6 * n_params * tokens + \
            12 * n_attn * cfg.num_heads * hd * s * tokens
        opt_bytes = 28 * n_params
        row = {
            "arch": arch, "params": n_params, "batch": [b, s],
            "tokens_per_step": tokens, "init_s": round(init_s, 3),
            "loss": [r["loss"] for r in rows],
            "grad_norm": [r["grad_norm"] for r in rows],
            "lr": [r["lr"] for r in rows], "step_ms": ms,
            "step_ms_median_2_6": step_ms,
            "tok_per_s": tokens / (step_ms / 1e3),
            "model_flops_per_step": flops,
            "flop_bound_ms": 1e3 * flops / self.bf16,
            "mfu": flops / (step_ms / 1e3) / self.bf16,
            "step_device_ms": dev_ms, "step_device_kernels": n_kernels,
            "device_busy_share": dev_ms / step_ms,
            "step_host_enqueue_ms": enqueue_ms,
            "optimizer_ms": opt_ms,
            "optimizer_ms_median": statistics.median(opt_ms),
            "optimizer_device_ms": opt_dev_ms,
            "optimizer_bytes": opt_bytes,
            "optimizer_bound_ms": 1e3 * opt_bytes / self.bw,
            "state_bytes": state_bytes, "peak_bytes_steps": peak,
            "peak_bytes_with_optimizer_timing": opt_peak}
        del model, params, opt, batch
        log(f"phase 10 (c): {arch} full width, {cfg.num_layers} layers, "
            f"train steps ({self.smi}): " + json.dumps(row))
        return row

    # -- phase 11: the model mesh and expert-parallel MoE ------------------
    def phase11_model_mesh(self):
        """The model mesh over ranks sharing the card (gloo,
        ``launch/ep_world.py``): (a) the two MoE smoke configs at (1, 2)
        and (2, 2), card against CPU in one world; (b) deepseek-v2-236b at
        full width (``EP_FULL_LAYERS`` of 60 layers) over (1, 2) against
        world 1's ``moe_ffn_dense``; (c) a world-1 checkpoint restored onto (1, 2)
        and ``launch.train --mesh single`` at world 1; (d) the dense GQA
        leaves as their ``param_specs`` blocks: phi4-mini's train step
        over (1, 2) and (2, 1) at smoke size card against CPU and at full
        width against world 1; (e) the same for MLA, cross-attention, the
        SSM mixers and the frontend projections (deepseek-v2, llama-
        vision, zamba2, xlstm); (f) the decode state as its
        ``state_specs`` blocks, a prefill and decode steps against each
        rank's blocks (phi4-mini, deepseek-v2, zamba2, xlstm; smoke card
        against CPU and full width against world 1); (g) a dry-run cell
        with its heads padded, run for real over (1, 4), and the host's
        dry-run records (its processes started first, so that they run
        beside (a)-(f)).  No rank launches a join kernel (each rank's
        counts, read as its job ends, and this process's)."""
        torch = self.torch
        t0 = time.perf_counter()
        self.reset_launches()
        self.ep_launches = []
        self._start_dryrun()
        self.ep = {"smoke": self._ep_smoke()}
        self.ep["full_width"] = self._ep_full_width()
        tp = self._tp_world()
        self.ep["checkpoint"], self.ep["dense_tp"], self.ep["leaves_tp"] = \
            tp["c"], tp["d"], tp["e"]
        self.ep["cache_tp"] = tp["f"]
        self.ep["padded_cell"] = self._padded_cell()
        launches = [self.read_launches()] + self.ep_launches
        check(not any(v for l in launches for v in l.values()),
              f"phase 11 launched a join kernel: {launches}")
        for entry in self.kernels:
            entry["launches_model_mesh"] = 0
        self.ep["wall_s"] = time.perf_counter() - t0
        log("phase 11: the model mesh launches none of the three kernels "
            f"(counts of this process and of {len(launches) - 1} ranks "
            "all 0); routing, all-to-alls, gathers and expert GEMMs are "
            "plain PyTorch and gloo, as the reference's are jnp and XLA "
            "collectives")
        torch.cuda.empty_cache()
        log(f"phase 11: model mesh ok ({self.ep['wall_s']:.1f} s, "
            f"{self.smi})")

    def _world(self, shape, job, payload, timeout=600):
        from repro_torch.launch.ep_world import run_world
        return run_world(shape, job, payload, device="cuda", timeout=timeout,
                         launches=self.ep_launches)

    def _ep_smoke(self):
        """(a) For each MoE smoke config in float32 (capacity 1.25) and
        each world (1, 2), (2, 2): in one world, on the card and then on
        the CPU with the same weights (drawn on the CPU from seed 0), a
        prefill of 8 x 64 tokens (``moe_ffn_ep``), 8 teacher-forced decode
        steps (``moe_ffn_ep_replicated_dsharded``; fsdp ``("data",)``) and
        one ``make_train_step(use_ep=True)`` step on the same tokens
        (the attention, dense FFN and embedding leaves as their
        ``param_specs`` blocks), and the same step on the CPU on weights
        nudged one ulp (the CPU's own f32 floor on this draw); for
        llama4-maverick also that step with no mesh (world 1 in each rank)
        on the card, on the CPU and on the CPU nudged, held alike;
        ``moe_ffn_ep_replicated`` called directly; and on the card
        ``moe_block_sharded`` at a decode of 8 tokens with a capacity at
        which nothing drops (E / k).  Each rank: router ids of every call
        equal; prefill and decode logits within 1e-4 of max |logit| (3e-2
        where a bf16 cache element rounded the other way); loss within
        1e-5 relative, ``lr`` equal, ``grad_norm`` 1e-3, every leaf of
        ``m`` within 1e-3 of its max, each tolerance raised to the CPU's
        floor where that is larger (printed); the direct call's output within
        1e-5 of max and its ids equal; the block's decode within 1e-5 of
        max |out| of ``moe_ffn_dense`` on the card (f32; at (2, 2) the
        d_model contraction is split over ``fsdp`` and its parts summed),
        its ids equal and nothing dropped."""
        np = self.np
        rows = {}
        rng = np.random.default_rng(11)
        block_rng = np.random.default_rng(13)
        for shape in ((1, 2), (2, 2)):
            jobs, keys, blocks = [], [], {}
            for arch in ZOO_MOE:
                from repro_torch.configs import get_smoke
                cfg = get_smoke(arch)
                toks = rng.integers(0, cfg.vocab_size, (8, 72))
                model = {"arch": arch, "dtype": "float32",
                         "prompt": toks[:, :64], "decode": toks[:, 64:],
                         "capacity": 80, "train": {
                             "tokens": toks[:, :64],
                             "labels": toks[:, 1:65]}}
                rep = self._ep_replicated_payload(arch, rng)
                for dev in ("cuda", "cpu"):
                    jobs += [("model", dict(model, device=dev)),
                             ("ep_fn", dict(rep, device=dev))]
                    keys += [(arch, "model", dev), (arch, "rep", dev)]
                # the CPU's floor: the train step on weights nudged one ulp
                jobs.append(("model", dict(model, device="cpu", nudge=1,
                                           prompt=None)))
                keys.append((arch, "floor", "cpu"))
                if arch == ZOO_MOE[0]:
                    # the same step with no mesh (world 1 in the rank),
                    # card, CPU and the CPU's floor
                    one = dict(model, whole=True, prompt=None)
                    jobs += [("model", dict(one, device="cuda")),
                             ("model", dict(one, device="cpu")),
                             ("model", dict(one, device="cpu", nudge=1))]
                    keys += [(arch, "world1", "cuda"), (arch, "world1", "cpu"),
                             (arch, "world1_floor", "cpu")]
                mo = cfg.moe
                blocks[arch] = dict(
                    rep, fn="block", device="cuda",
                    capacity_factor=mo.num_experts / mo.top_k,
                    x=block_rng.normal(size=(8, 1, cfg.d_model)).astype(
                        np.float32))
                jobs.append(("ep_fn", blocks[arch]))
                keys.append((arch, "block", "cuda"))
            t0 = time.perf_counter()
            ranks = self._world(shape, "many", {"jobs": jobs})
            wall = time.perf_counter() - t0
            for arch in ZOO_MOE:
                rows[f"{arch} {shape}"] = self._ep_compare(
                    arch, shape, keys, ranks, wall)
                rows[f"{arch} {shape}"]["block_decode_vs_dense"] = \
                    self._ep_block_vs_dense(
                        arch, shape, blocks[arch],
                        [res[keys.index((arch, "block", "cuda"))]
                         for res in ranks])
        log(f"phase 11 (a): EP card == cpu, 2 smoke configs x 2 worlds, "
            f"f32 ({self.smi}): " + json.dumps(rows))
        return rows

    def _ep_replicated_payload(self, arch, rng):
        """``moe_ffn_ep_replicated`` on the smoke config's MoE weights
        (drawn from seed 0 on the CPU) and 8 x 4 tokens."""
        import dataclasses
        np, torch = self.np, self.torch
        from repro_torch.configs import get_smoke
        from repro_torch.models import moe
        from repro_torch.models.layers import init_tree, tree_map
        cfg = get_smoke(arch)
        params = tree_map(lambda t: t.numpy(), init_tree(
            moe.moe_defs(dataclasses.replace(cfg, dtype="float32")),
            torch.Generator().manual_seed(0), "cpu"))
        return {"arch": arch, "dtype": "float32", "fn": "replicated",
                "params": params, "x": rng.normal(
                    size=(8, 4, cfg.d_model)).astype(np.float32)}

    def _ep_block_vs_dense(self, arch, shape, pay, ranks):
        """Each rank's ``moe_block_sharded`` decode (``pay``) against
        ``moe_ffn_dense`` on the card on the same weights and tokens:
        ids equal, nothing dropped, within 1e-5 of max |out|."""
        import dataclasses
        np, torch = self.np, self.torch
        from repro_torch.configs import get_smoke
        from repro_torch.models import moe
        from repro_torch.models.layers import tree_map
        cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=pay["capacity_factor"]))
        stats = {}
        dense = moe.moe_ffn_dense(
            tree_map(lambda a: torch.as_tensor(a, device=self.dev),
                     pay["params"]),
            torch.as_tensor(pay["x"], device=self.dev), cfg, torch.float32,
            stats)[0].cpu().numpy()
        ids = stats["ids"].cpu().numpy()
        errs = [float(np.abs(r["out"] - dense).max() / np.abs(dense).max())
                for r in ranks]
        check(all(np.array_equal(r["ids"], ids) and r["dropped"] == 0
                  for r in ranks) and max(errs) <= 1e-5,
              f"{arch} {shape}: moe_block_sharded decode on the card vs "
              f"moe_ffn_dense {errs} of max |out|, dropped "
              f"{[r['dropped'] for r in ranks]}")
        return {"err": errs, "bit_equal": [bool(np.array_equal(
            r["out"], dense)) for r in ranks]}

    def _ep_compare(self, arch, shape, keys, ranks, wall):
        np = self.np
        idx = {k: i for i, k in enumerate(keys)}
        row = {"world_wall_s": round(wall, 2), "ranks": []}
        for r, res in enumerate(ranks):
            card, cpu = (res[idx[(arch, "model", d)]] for d in ("cuda", "cpu"))
            rc, rh = (res[idx[(arch, "rep", d)]] for d in ("cuda", "cpu"))
            ids_equal = all(np.array_equal(a, b) for a, b in
                            zip(card["ids"], cpu["ids"]))
            check(ids_equal and len(card["ids"]) == len(cpu["ids"]),
                  f"{arch} {shape} rank {r}: router ids differ card vs cpu")
            flips = sum(int((a[n] != b[n]).sum()) for a, b in
                        zip(card["cache"], cpu["cache"]) for n in a)
            tol = 1e-4 if flips == 0 else 3e-2
            errs = {w: float(np.abs(card[w] - cpu[w]).max()
                             / np.abs(cpu[w]).max())
                    for w in ("prefill", "decode")}
            check(max(errs.values()) <= tol, f"{arch} {shape} rank {r}: "
                  f"logits card vs cpu {errs} > {tol} ({flips} cache flips)")
            mc, mh = card["metrics"], cpu["metrics"]
            loss_err, gn_err, m_err = _step_dist(card, cpu)
            floor = dict(zip(("loss", "grad_norm", "m"), _step_dist(
                res[idx[(arch, "floor", "cpu")]], cpu)))
            tol = {"loss": max(1e-5, floor["loss"]),
                   "grad_norm": max(1e-3, floor["grad_norm"]),
                   "m": max(1e-3, floor["m"])}
            check(loss_err <= tol["loss"] and mc["lr"] == mh["lr"]
                  and gn_err <= tol["grad_norm"] and m_err <= tol["m"],
                  f"{arch} {shape} rank {r}: train step card vs cpu loss "
                  f"{loss_err} grad_norm {gn_err} m {m_err} lr {mc['lr']} "
                  f"{mh['lr']} (tolerances {tol}, the CPU's floor {floor})")
            check(np.isfinite(mc["loss"]) and mc["aux"] > 0,
                  f"{arch} {shape} rank {r}: train metrics {mc}")
            rep_err = float(np.abs(rc["out"] - rh["out"]).max()
                            / np.abs(rh["out"]).max())
            check(np.array_equal(rc["ids"], rh["ids"]) and rep_err <= 1e-5,
                  f"{arch} {shape} rank {r}: moe_ffn_ep_replicated card vs "
                  f"cpu {rep_err}")
            row["ranks"].append({
                "ids_equal": ids_equal, "cache_flips": flips, "tol": tol,
                **{f"{w}_err": e for w, e in errs.items()},
                "dropped_prefill_decode": [sum(card["dropped"][
                    :card["prefill_calls"]]), sum(card["dropped"][
                        card["prefill_calls"]:])],
                "loss_rel_err": loss_err, "grad_norm_rel_err": gn_err,
                "m_err": m_err, "cpu_floor": floor, "tol": tol,
                "loss": mc["loss"], "aux": mc["aux"],
                "replicated_err": rep_err,
                "collectives_card": card["ledger"]["by_axis"],
                "routes_card": card["ledger"]["by_route"]})
            if (arch, "world1", "cuda") in idx:
                # the same step with no mesh, held as the mesh's is
                one = [res[idx[(arch, k, d)]] for k, d in (
                    ("world1", "cuda"), ("world1", "cpu"),
                    ("world1_floor", "cpu"))]
                names = ("loss", "grad_norm", "m")
                got = dict(zip(names, _step_dist(one[0], one[1])))
                fl = dict(zip(names, _step_dist(one[2], one[1])))
                tol1 = {k: max(tol0, fl[k]) for k, tol0 in
                        (("loss", 1e-5), ("grad_norm", 1e-3), ("m", 1e-3))}
                check(all(got[k] <= tol1[k] for k in tol1)
                      and one[0]["metrics"]["lr"] == one[1]["metrics"]["lr"],
                      f"{arch} {shape} rank {r}: world 1 (no mesh) train "
                      f"step card vs cpu {got} (tolerances {tol1}, the "
                      f"CPU's floor {fl})")
                row["ranks"][-1]["world1_no_mesh"] = {
                    "card_vs_cpu": got, "cpu_floor": fl}
        return row

    def _ep_full_width(self):
        """(b) deepseek-v2-236b at full width cut to ``EP_FULL_LAYERS`` of
        60 layers, bf16,
        weights from seed 0 drawn on the card: world 1 (``moe_ffn_dense``,
        in this process) and a (1, 2) world (``_ep_full_width_rank``: each
        rank draws every leaf whole, in turn, keeping its 80 of the 160
        experts of each MoE layer).  The same 8 x 52 prompt on both: a
        prefill at the config's capacity (logits and dropped choices of
        both paths recorded); in the EP world prefills at capacity factors
        2, 4, 8 and 16 (the dropped choices at each recorded: the send
        buffers' empty slots take local expert 0's slots, ROADMAP queue 3,
        so no factor that fits the card drops nothing at 8 x 52); a short
        prefill of 8 x 2 at the first factor of 40, 48, 64 at which no
        rank drops (world 1 at E / k); then 12 decode steps at the
        config's capacity from world 1's no-drop 8 x 52 prefill cache
        (handed to the ranks), teacher-forced with world 1's greedy
        tokens.

        Two witnesses, world 1 drawn again after the world (kept beside
        the ranks it would not fit the card).  The expert-parallel MoE:
        each rank records every MoE call's input and output, and world 1
        runs the same layer on that input at the same capacity, a
        decode's with ``moe._combine`` adding a token's expert rows as
        the EP decode does (rank 0's experts, then rank 1's, each partial
        in ascending order, then the two partials: the psum); every
        call's router ids equal the witness's, a decode call's output
        bit-equal to it, a short prefill call's (its all-to-all path adds
        in arrival order, with expert GEMMs of another shape) within two
        bf16 ulps of max |out|.  The whole path, attention and its MLA
        state blocks too: world 1 runs the rank's short prefill and its
        12 teacher-forced decode steps from the same cache with each MoE
        layer's output replaced by the rank's recorded one, and every
        step's logits, the short prefill's too, lie within 3e-2 of max
        |logit| of that replay's (PERF.md §2's full-width bf16 limit):
        what is left between them is the attention's and the dense
        FFN's order of sums over ``tp``.  Against plain world 1 the flips
        of every MoE layer and the logits' distance are recorded, not
        held: the rank's first MoE layer's input differs from world 1's
        by that order of sums, a flipped choice is a discrete change no
        tolerance bounds, and this random bf16 model flips 18-69 of 144
        choices a step.
        Recorded: init s and peak memory a rank, decode ms a step (CUDA
        events) against world 1's and against the bytes bound of one
        rank's weights (and of both ranks', which share the card),
        collective calls and bytes by axis and route."""
        np, torch = self.np, self.torch
        from repro_torch.models import moe, steps, transformer
        arch, layers = "deepseek-v2-236b", EP_FULL_LAYERS
        cfg = _full_width_cfg(arch, layers)
        mo = cfg.moe
        no_drop = mo.num_experts / mo.top_k
        prompt = torch.as_tensor(np.random.default_rng(12).integers(
            0, cfg.vocab_size, (8, 52)), device=self.dev)
        # world 1
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = transformer.init_params(
            cfg, torch.Generator(device=self.dev).manual_seed(0), self.dev)
        torch.cuda.synchronize()
        w1 = {"init_s": time.perf_counter() - t0,
              "init_peak_bytes": torch.cuda.max_memory_allocated()}
        moes = self._moe_layers(model)
        calls = []
        hooks = [m.register_forward_hook(lambda mod, i, o: calls.append(
            (mod.stats["ids"].cpu().numpy(), int(mod.stats["dropped"]))))
            for m in moes]
        prefill = steps.make_prefill_step(cfg, 68)
        decode = steps.make_decode_step(cfg)
        cfg_prefill = prefill(model, prompt)[1].float().cpu().numpy()
        w1["config_prefill_dropped"] = sum(c[1] for c in calls)
        _set_capacity(moes, no_drop)
        calls.clear()
        short = steps.make_prefill_step(cfg, 2)(model, prompt[:, :2])[1]
        w1_short = (short.float().cpu().numpy(), [c[0] for c in calls])
        state, last = prefill(model, prompt)
        _set_capacity(moes, mo.capacity_factor)
        w1_state = [{n: v if n == "index" else v.float().cpu().numpy()
                     for n, v in layer.items()} for layer in state]
        calls.clear()
        toks, w1_dec = [], []
        tok = steps.greedy_sample(last)[:, None]
        for j in range(12):
            toks.append(tok)
            pos = torch.full((8, 1), 52 + j, dtype=torch.int32,
                             device=self.dev)
            state, lg = decode(model, state, tok, pos)
            w1_dec.append(lg.float().cpu().numpy())
            tok = steps.greedy_sample(lg)[:, None]
        w1_ids = [c[0] for c in calls]
        w1["decode_dropped"] = sum(c[1] for c in calls)
        for h in hooks:
            h.remove()
        tok0, pos0 = toks[0], torch.full((8, 1), 52, dtype=torch.int32,
                                         device=self.dev)
        w1["decode_ms"] = self.time_ms(
            lambda: decode(model, state, tok0, pos0), runs=5, reps=4)
        w1["param_bytes"] = sum(p.numel() * p.element_size()
                                for p in model.parameters())
        del model, state, moes
        torch.cuda.empty_cache()
        # the (1, 2) world
        t0 = time.perf_counter()
        ranks = self._world((1, 2), _ep_full_width_rank, {
            "arch": arch, "layers": layers, "seed": 0,
            "prompt": prompt.cpu().numpy(), "capacity": 68,
            "short_search": [40, 48, 64], "search": [2, 4, 8, 16],
            "state": w1_state, "decode": torch.cat(toks, 1).cpu().numpy()},
            timeout=900)
        wall = time.perf_counter() - t0
        mx = float(np.abs(cfg_prefill).max())
        n_moe = len(w1_short[1])
        # world 1 drawn again for the witnesses (kept beside the ranks it
        # would not fit the card)
        model = transformer.init_params(
            cfg, torch.Generator(device=self.dev).manual_seed(0), self.dev)
        moes = self._moe_layers(model)

        def flips(a_ids, b_ids):
            return [int((a != b).sum()) for a, b in zip(a_ids, b_ids)]

        def by_step(f):
            return [sum(f[j * n_moe:(j + 1) * n_moe]) for j in range(12)]

        def rel(a, b):
            return float(np.abs(a - b).max() / np.abs(b).max())

        def ulps(a, b):
            """|a - b|'s max in bf16 ulps of max |b|."""
            m = float(np.abs(b).max())
            return float(np.abs(a - b).max()) / 2.0 ** (
                math.floor(math.log2(m)) - 7)

        def witness(res, r):
            """Each of the rank's MoE calls against world 1's layer on
            the same input: (short prefill's, ids differing, output
            distance of max |out|, in bf16 ulps of it, bit equal) a
            call, the short prefill's first."""
            out = []
            combine = moe._combine
            try:
                for c, (x, y, ids) in enumerate(res["moe_calls"]):
                    short = c < n_moe
                    _set_capacity(moes, res["short_search"][-1][0] if short
                                  else mo.capacity_factor)
                    if not short:
                        moe._combine = _combine_in_ep_order(
                            combine, mo.num_experts // 2)
                    with torch.no_grad():
                        want = moes[c % n_moe](torch.as_tensor(
                            x, device=self.dev).to(torch.bfloat16))[0]
                    moe._combine = combine
                    w_ids = moes[c % n_moe].stats["ids"].cpu().numpy()
                    if short:  # rank r routes the r-th half of the sequence
                        w_ids = w_ids.reshape(8, 2, -1)[:, r]
                    want = want.float().cpu().numpy()
                    out.append((short,
                                int((ids != w_ids.reshape(ids.shape)).sum()),
                                rel(y, want), ulps(y, want),
                                bool(np.array_equal(y, want))))
            finally:
                moe._combine = combine
                _set_capacity(moes, mo.capacity_factor)
            return out

        def replay(res):
            """World 1 through the rank's short prefill and decode steps
            with each MoE layer's output the rank's recorded one: the
            short prefill's last logits and each step's."""
            ys = iter(res["moe_calls"])

            def put(mod, i, o):
                return (torch.as_tensor(next(ys)[1], device=self.dev).to(
                    o[0].dtype),) + tuple(o[1:])
            hooks = [m.register_forward_hook(put) for m in moes]
            try:
                short = steps.make_prefill_step(cfg, 2)(model,
                                                        prompt[:, :2])[1]
                st, dec = _state_on(w1_state, self.dev), []
                for j, tok in enumerate(toks):
                    pos = torch.full((8, 1), 52 + j, dtype=torch.int32,
                                     device=self.dev)
                    st, lg = decode(model, st, tok, pos)
                    dec.append(lg.float().cpu().numpy())
            finally:
                for h in hooks:
                    h.remove()
            check(next(ys, None) is None, "(1, 2) full width: the replay "
                  "took fewer MoE calls than the rank recorded")
            return short.float().cpu().numpy(), dec

        rows = []
        for r, res in enumerate(ranks):
            check(len(res["short_ids"]) == n_moe
                  and len(res["ids"]) == len(w1_ids) == 12 * n_moe
                  and len(res["moe_calls"]) == 13 * n_moe,
                  f"(1, 2) full width rank {r}: MoE calls")
            wit = witness(res, r)
            check(all(f == 0 and (u <= 2 if short else eq)
                      for short, f, _, u, eq in wit),
                  f"(1, 2) full width rank {r}: MoE calls against world 1's "
                  f"layers on the same inputs (short prefill's, ids "
                  f"differing, output of max |out|, bf16 ulps of it, bit "
                  f"equal): {wit}")
            rep_short, rep_dec = replay(res)
            rep_errs = [rel(res["short_prefill"], rep_short)] + [
                rel(a, b) for a, b in zip(res["decode"], rep_dec)]
            check(max(rep_errs) <= 3e-2,
                  f"(1, 2) full width rank {r}: logits of max |logit| from "
                  f"world 1 run with the rank's MoE outputs (short "
                  f"prefill, then each decode step): {rep_errs}")
            # rank r holds the r-th half of a prefill's sequence (over
            # model), every token at a decode
            flips_short = flips(res["short_ids"],
                                [b.reshape(8, 2, -1)[:, r] for b in
                                 w1_short[1]])
            flips_dec = flips(res["ids"], w1_ids)
            rows.append({
                "init_s": res["init_s"], "init_peak_bytes":
                res["init_peak_bytes"], "peak_bytes": res["peak_bytes"],
                "param_bytes": res["param_bytes"],
                "replay_short_prefill_err": rep_errs[0],
                "replay_decode_err_by_step": rep_errs[1:],
                "short_prefill_err": rel(res["short_prefill"], w1_short[0]),
                "short_prefill_flips_by_layer": flips_short,
                "short_search_dropped": res["short_search"],
                "decode_err_by_step": [rel(a, b) for a, b in
                                       zip(res["decode"], w1_dec)],
                "decode_flips_by_step": by_step(flips_dec),
                "first_moe_layer_flips_short_decode": [
                    flips_short[0], flips_dec[::n_moe]],
                "moe_witness_short_max_ulps": max(w[3] for w in wit
                                                  if w[0]),
                "moe_witness_max_err": max(w[2] for w in wit),
                "moe_witness_bit_equal": sum(w[4] for w in wit),
                "config_prefill_err": rel(res["config_prefill"],
                                          cfg_prefill),
                "config_prefill_dropped": res["config_prefill_dropped"],
                "search_dropped_8x52": res["search_dropped"],
                "decode_dropped": sum(res["dropped"]),
                "decode_ms": res["decode_ms"],
                "decode_ms_median": statistics.median(res["decode_ms"]),
                "decode_bound_ms_rank": 1e3 * res["param_bytes"] / self.bw,
                "collectives": res["ledger"]})
        both = 1e3 * sum(r["param_bytes"] for r in rows) / self.bw
        out = {"world1": dict(w1, decode_bound_ms=1e3 * w1["param_bytes"]
                              / self.bw, max_abs_logit=mx),
               "world_1x2": rows, "moe_calls_witnessed": len(wit),
               "world_wall_s": wall,
               "decode_bound_ms_both_ranks": both,
               "capacity_factor": mo.capacity_factor,
               "world1_no_drop_capacity_factor": no_drop}
        log(f"phase 11 (b): deepseek-v2-236b full width, {layers} layers, "
            f"EP over (1, 2) vs world 1 ({self.smi}): " + json.dumps(out))
        del model, moes
        torch.cuda.empty_cache()
        return out

    def _ep_checkpoint_job(self):
        """(c) The deepseek-v2 smoke model's tree saved at world 1, and the
        ``restore`` job and its report: restored onto a (1, 2) world on the
        card with the reference's ``param_specs``, every rank's blocks
        equal the slices of the saved leaves; then ``launch.train --mesh
        single`` at world 1 exits non-zero with the production mesh's
        size error."""
        torch = self.torch
        from repro_torch.checkpoint import checkpoint as ckpt
        from repro_torch.configs import get_smoke
        from repro_torch.convert import model_tree_to_numpy
        from repro_torch.models import transformer
        arch = "deepseek-v2-236b"
        cfg = get_smoke(arch)
        d = os.path.join(ROOT, "build", "ck_model_mesh")
        shutil.rmtree(d, ignore_errors=True)
        model = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                        "cpu")
        ckpt.save(d, 3, model_tree_to_numpy(cfg, model))

        def report(ranks):
            for r, res in enumerate(ranks):
                check(res["all_equal"] and res["step"] == 3
                      and res["device"].startswith("cuda"),
                      f"checkpoint onto (1, 2): rank {r} {res}")
            cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
                   "phi4-mini-3.8b", "--smoke", "--steps", "1", "--mesh",
                   "single", "--device", "cuda", "--checkpoint-dir",
                   os.path.join(ROOT, "build", "ck_mesh_single")]
            proc = subprocess.run(cmd, cwd=ROOT, env=dict(
                os.environ, PYTHONPATH=SRC), capture_output=True, text=True,
                timeout=300)
            check(proc.returncode != 0 and "needs a world of 256 ranks"
                  in proc.stderr, f"launch.train --mesh single at world 1: "
                  f"exit {proc.returncode}, {proc.stderr[-500:]}")
            out = {"restore_1x2": [{k: res[k] for k in (
                "step", "all_equal", "leaves", "device")} for res in ranks],
                "mesh_single_exit": proc.returncode,
                "mesh_single_error": proc.stderr.strip().splitlines()[-1]}
            log("phase 11 (c): checkpoint world 1 -> (1, 2) and --mesh "
                "single: " + json.dumps(out))
            return out
        return "restore", {"arch": arch, "dir": d, "specs": "param"}, report

    def _dense_tp_job(self):
        """(d) The dense GQA leaves over a model mesh, ``_dense_tp_rank``'s
        payload and its report: one world of two ranks sharing the card,
        as (1, 2) and as (2, 1) over ``("data", "model")``.  Smoke:
        phi4-mini's smoke config in float32 on each mesh, on the card and
        on the CPU in the world (weights from seed 0 drawn on the CPU; a
        forward of 8 x 64 and one train step), and the CPU's step on
        weights nudged one ulp (``_smoke_vs_cpu``).  Full width:
        phi4-mini-3.8b (d 3072, 24 / 8 heads, d_ff 8192, vocab 200 064,
        tied) cut to ``DENSE_TP_LAYERS`` layers, two steps on two batches
        of 8 x 128 against world 1, layer 0 and the embedding's two uses
        (lookup and tied logits) taught (``_vs_world1``, held by
        ``_full_vs_world1``)."""
        np = self.np
        from repro_torch.configs import get_config, get_smoke
        rng = np.random.default_rng(26)
        smoke = get_smoke(ZOO_ARCH)
        toks = rng.integers(0, smoke.vocab_size, (8, 65))
        base = {"arch": ZOO_ARCH, "dtype": "float32", "forward": toks[:, :-1],
                "train": {"tokens": toks[:, :-1], "labels": toks[:, 1:]}}
        triple = [dict(base, device="cuda"), dict(base, device="cpu"),
                  dict(base, device="cpu", nudge=1)]
        full = rng.integers(0, get_config(ZOO_ARCH).vocab_size, (2, 8, 129))
        payload = {"smoke": {"1x2": triple, "2x1": triple},
                   "layers": DENSE_TP_LAYERS, "tokens": full}

        def report(ranks):
            out = {"rank_wall_s": [r["wall_s"] for r in ranks],
                   "layers": DENSE_TP_LAYERS,
                   "smoke": self._smoke_vs_cpu("(d)", ranks, [ZOO_ARCH]),
                   "full": self._full_vs_world1(ranks, ("1x2", "2x1"))}
            log(f"phase 11 (d): phi4-mini dense GQA leaves as param_specs "
                f"blocks over (1, 2) and (2, 1), smoke card vs cpu and full "
                f"width {DENSE_TP_LAYERS} layers vs world 1 ({self.smi}): "
                + json.dumps(out))
            self._check_full("(d)", out["full"])
            return out
        return _dense_tp_rank, payload, report

    def _leaves_tp_job(self):
        """(e) MLA, cross-attention, the SSM mixers and the frontend
        projections as their ``param_specs`` blocks, ``_leaves_tp_rank``'s
        payload and its report: one world of two ranks sharing the card,
        as (1, 2) and as (2, 1).  Smoke: each config of ``LEAVES_SMOKE`` in
        float32 on each of its meshes, card against CPU as (d)'s smoke
        (``_smoke_vs_cpu``; 8 x 32 tokens, llama-vision's memory (8, 16,
        24), every cross gate 0.5), each limit raised to twice the CPU's
        floor where larger, as phase 10 (a) holds these configs.  Full width, each model of
        ``LEAVES_FULL`` cut in depth, against world 1 on its meshes
        (``_vs_world1``, held by ``_full_vs_world1``): two steps on two
        batches of 8 x 128, phase 10's settings (f32 masters, bf16
        compute, remat, AdamW), or for llama-vision (too large to train
        beside two ranks) bf16 parameters and the forward alone, with a
        memory of (2, 1600, 1280); the logits and one layer of each new
        kind taught, held against world 1 run on the mesh's groups of rows
        (``_vs_world1``'s witness: at (2, 1) each rank runs one row of two,
        and xlstm's bf16 model moves its logits by 0.999 of max and
        sLSTM's gradients by 5x their norm under a one-ulp nudge, so a GEMM
        of another batch moves them too).  The whole model's gradients
        are printed, not held (chaos in bf16, (d))."""
        np = self.np
        from repro_torch.configs import get_config, get_smoke
        rng = np.random.default_rng(27)
        smoke = {"1x2": [], "2x1": []}
        names = {"1x2": [], "2x1": []}
        for name, arch, over, meshes in LEAVES_SMOKE:
            cfg = get_smoke(arch)
            toks = rng.integers(0, cfg.vocab_size, (8, 33))
            base = {"arch": arch, "overrides": over, "dtype": "float32",
                    "gate": 0.5, "forward": toks[:, :-1],
                    "train": {"tokens": toks[:, :-1], "labels": toks[:, 1:]}}
            if cfg.cross_attn_every:
                base["memory"] = rng.normal(
                    size=(8, 16, cfg.frontend_embed_dim)).astype(np.float32)
            for m in meshes:
                smoke[m] += [dict(base, device="cuda"),
                             dict(base, device="cpu"),
                             dict(base, device="cpu", nudge=1)]
                names[m].append(name)
        full = []
        for arch, layers, train, meshes, taught in LEAVES_FULL:
            cfg = get_config(arch)
            full.append({"arch": arch, "layers": layers, "train": train,
                         "meshes": meshes, "taught": taught,
                         "memory_len": cfg.cross_attn_memory_len,
                         "tokens": rng.integers(0, cfg.vocab_size,
                                                (2 if train else 1, 8, 129))})
        def report(ranks):
            out = {"rank_wall_s": [r["wall_s"] for r in ranks],
                   "smoke": {}, "full": {}}
            for m in ("1x2", "2x1"):
                sub = [{"smoke": {m: res["smoke"][m]}} for res in ranks]
                out["smoke"][m] = self._smoke_vs_cpu("(e)", sub, names[m],
                                                     twice=True)[m]
            for q in full:
                res = [r["full"][q["arch"]] for r in ranks]
                out["full"][q["arch"]] = self._full_vs_world1(res,
                                                              q["meshes"])
            log(f"phase 11 (e): MLA, cross, SSM mixers and projections as "
                f"param_specs blocks over (1, 2) and (2, 1), smoke card vs "
                f"cpu and full width vs world 1 ({self.smi}): "
                + json.dumps(out))
            for arch, row in out["full"].items():
                self._check_full(f"(e) {arch}", row)
            return out
        return _leaves_tp_rank, {"smoke": smoke, "full": full}, report

    def _cache_tp_job(self):
        """(f) The decode state as its ``state_specs`` blocks,
        ``_cache_tp_rank``'s payload and its report: one world of two
        ranks sharing the card, as (1, 2) and as (2, 1).  Smoke: each
        config of ``CACHE_SMOKE`` in float32 on both meshes, card against
        CPU (a prefill and 4 teacher-forced decode steps, weights from
        seed 0 drawn on the CPU, every cross gate 0.5, the KV and latent
        caches in f32: a bf16 cache element that the card's order of sums
        rounds the other way would move the logits by ~10⁻⁴, and the
        full-width runs below hold the bf16 caches), and the CPU on
        weights nudged one ulp (its floor): the logits within 1e-4 of max
        |logit|, for the chaotic configs (all but phi4-mini's) raised to
        twice the CPU's floor where larger, as (d) and (e) hold theirs
        (``_smoke_vs_cpu``).  Full width, each
        model of ``CACHE_FULL`` against world 1 on its meshes
        (``_decode_vs_world1``): the logits of the prefill and of every
        decode step within max(3e-2, twice world 1's one-ulp floor, where
        below 1) of max |logit|, at (2, 1) against world 1 run on the
        mesh's groups of rows (plain world 1's distance printed); each
        rank's state bytes against world 1's, decode ms a step a rank
        against world 1's, and the ledger's calls and bytes a step by
        axis printed, with the state blocks' distance from world 1's."""
        np = self.np
        from repro_torch.configs import get_config, get_smoke
        rng = np.random.default_rng(28)
        smoke, names = {"1x2": [], "2x1": []}, []
        for name, arch, over, batch in CACHE_SMOKE:
            cfg = get_smoke(arch)
            toks = rng.integers(0, cfg.vocab_size, (batch, 16))
            base = {"arch": arch, "overrides": over, "dtype": "float32",
                    "gate": 0.5, "prompt": toks[:, :12],
                    "decode": toks[:, 12:], "capacity": 16,
                    "cache_dtype": "float32"}
            if name == "zamba":
                base["valid_from"] = rng.integers(0, 6, batch)
            if cfg.cross_attn_every:
                base["memory"] = rng.normal(
                    size=(batch, 16, cfg.frontend_embed_dim)).astype(
                        np.float32)
            for m in smoke:
                smoke[m] += [dict(base, device="cuda"),
                             dict(base, device="cpu"),
                             dict(base, device="cpu", nudge=1)]
            names.append(name)
        full = [{"arch": arch, "layers": layers, "meshes": meshes,
                 "capacity": CACHE_CAPACITY, "prompt": CACHE_PREFILL,
                 "tokens": rng.integers(0, get_config(arch).vocab_size, (
                     8, CACHE_PREFILL + CACHE_STEPS))}
                for arch, layers, meshes in CACHE_FULL]

        def report(ranks):
            out = {"rank_wall_s": [r["wall_s"] for r in ranks],
                   "smoke": self._decode_smoke_vs_cpu(ranks, names),
                   "full": {}}
            for q in full:
                rows = [r["full"][q["arch"]] for r in ranks]
                floor = rows[0]["world1_floor"]
                raised = 2 * floor
                tol = max(DENSE_TP_TOL["logits"], raised if raised < 1
                          else 0.0)
                out["full"][q["arch"]] = {"tol": tol, "world1_floor": floor,
                                          "ranks": rows}
                for r, row in enumerate(rows):
                    for m in q["meshes"]:
                        got = row["meshes"][m]
                        check(got["logits_err"] <= tol,
                              f"(f) {q['arch']} {m} rank {r} vs world 1: "
                              f"logits {got['logits_err']} of max |logit| "
                              f"(tolerance {tol}; plain world 1 "
                              f"{got['logits_vs_plain']})")
            log(f"phase 11 (f): the decode state as its state_specs blocks "
                f"over (1, 2) and (2, 1), smoke card vs cpu and full width "
                f"vs world 1 ({self.smi}): " + json.dumps(out))
            return out
        return _cache_tp_rank, {"smoke": smoke, "full": full}, report

    def _decode_smoke_vs_cpu(self, ranks, names):
        """(f)'s smoke gates, each rank's (card, CPU, CPU nudged) triple
        a config of ``names`` on each mesh, the caches in f32: the
        prefill's and the decode steps' logits card against CPU within
        1e-4 of max |logit|, raised to twice the CPU's floor where larger
        for every config but phi4-mini's (``gqa``); the state blocks'
        distance printed."""
        np = self.np

        def rel(a, b):
            return float(np.abs(a - b).max() / np.abs(b).max())
        out = {}
        for mesh in ranks[0]["smoke"]:
            rows = {}
            for i, name in enumerate(names):
                for r, res in enumerate(ranks):
                    card, cpu, nudged = res["smoke"][mesh][3 * i:3 * i + 3]
                    errs = {w: rel(card[w], cpu[w])
                            for w in ("prefill", "decode")}
                    floor = max(rel(nudged[w], cpu[w])
                                for w in ("prefill", "decode"))
                    tol = 1e-4 if name == "gqa" else max(1e-4, 2 * floor)
                    check(max(errs.values()) <= tol,
                          f"(f) smoke {name} {mesh} rank {r}: card vs cpu "
                          f"logits {errs} (tolerance {tol}, the CPU's "
                          f"floor {floor})")
                    rows.setdefault(name, []).append({
                        **errs, "cpu_floor": floor,
                        "tol": tol, "state_bytes": card["state_bytes"],
                        "state_vs_cpu": max(
                            rel(a[n], b[n]) for a, b in zip(
                                card["cache"], cpu["cache"]) for n in a
                            if np.abs(b[n]).max() > 0),
                        "step_ledger_card": card["step_ledgers"][-1]})
            out[mesh] = rows
        return out

    def _start_dryrun(self):
        """Start ``python -m repro_torch.launch.dryrun`` for each cell of
        ``DRYRUN_CELLS`` on both production meshes at one period, one
        process a cell, on the host (meta tensors: no card), its records
        under ``build/dryrun_smoke``."""
        out = os.path.join(ROOT, "build", "dryrun_smoke")
        env = dict(os.environ, PYTHONPATH=SRC, CUDA_VISIBLE_DEVICES="")
        self.dryrun = {"out": out, "t0": time.perf_counter(), "procs": [
            (arch, shape, subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 arch, "--shape", shape, "--mesh", "both", "--layers",
                 "period", "--out-dir", out], cwd=ROOT, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
            for arch, shape in DRYRUN_CELLS]}

    def _padded_cell(self):
        """(g) ``launch.cells.build_cell`` of ``PADDED_CELL`` (starcoder2-3b
        ``decode_32k`` at 2 layers, f32 compute, f32 caches) run for real
        over (1, 4): four ranks sharing the card, each drawing the whole
        model on the card from seed 0 (world 1's weights), which
        ``build_cell`` pads for tp 4 (``tp_pad_weights``: KV heads 2 -> 4,
        each duplicated into two slots) and keeps its blocks of; a prompt
        of ``PADDED_PROMPT`` tokens prefilled into the cell's state (its
        batch of 128 and 32768 slots), then ``PADDED_STEPS`` decode steps
        through the cell's step (``_padded_cell_rank``).  Rank 0 then
        runs the unpadded model's world-1 decode on the card, and again on
        weights nudged one ulp (its floor): every rank's logits within
        max(1e-4, twice that floor) of max |logit| of world 1's.  Then
        the host's dry-run (``_start_dryrun``): every process exits 0 and
        each cell's record on both meshes is ``ok``, its argument GiB a
        rank, flops and collective bytes printed."""
        np = self.np
        from repro_torch.configs import get_config
        arch, shape, layers = PADDED_CELL
        from repro_torch.common.config import SHAPES
        sc = SHAPES[shape]
        rng = np.random.default_rng(29)
        toks = rng.integers(0, get_config(arch).vocab_size,
                            (sc.global_batch, PADDED_PROMPT + PADDED_STEPS))
        cell = {"arch": arch, "full": True, "layers": layers,
                "overrides": {"dtype": "float32"}, "seed": 0,
                "shape": (sc.name, sc.seq_len, sc.global_batch, sc.kind),
                "cache_dtype": "float32", "prompt": toks[:, :PADDED_PROMPT],
                "decode": toks[:, PADDED_PROMPT:]}
        t0 = time.perf_counter()
        ranks = self._world((1, 4), _padded_cell_rank, {"cell": cell},
                            timeout=600)
        wall = time.perf_counter() - t0
        w1 = ranks[0]["world1"]

        def rel(a, b):
            return float(np.abs(a - b).max() / np.abs(b).max())
        floor = rel(w1["nudged"], w1["plain"])
        tol = max(1e-4, 2 * floor)
        rows = []
        for r, res in enumerate(ranks):
            err = rel(res["logits"], w1["plain"])
            check(np.isfinite(res["logits"]).all() and err <= tol,
                  f"(g) padded {arch} {shape} over (1, 4) rank {r} vs world "
                  f"1: logits {err} of max |logit| (tolerance {tol})")
            rows.append({"logits_err": err, "heads": res["heads"],
                         "state_bytes": res["state_bytes"],
                         "state_vs_world1": res["state_bytes"]
                         / w1["state_bytes"],
                         "decode_ms_a_step": res["decode_ms"],
                         "wall_s": res["wall_s"]})
        out = {"world_wall_s": wall, "tol": tol, "world1_floor": floor,
               "world1_decode_ms_a_step": w1["decode_ms"],
               "world1_state_bytes": w1["state_bytes"], "ranks": rows}
        log(f"phase 11 (g): {arch} {shape} cell, {layers} layers, f32, its "
            f"heads padded (24, 2) -> {rows[0]['heads']} over (1, 4) vs "
            f"the unpadded world 1 ({self.smi}): " + json.dumps(out))
        out["dryrun"] = self._collect_dryrun()
        return out

    def _collect_dryrun(self):
        """Wait for ``_start_dryrun``'s processes; each exits 0 and each
        cell's record on both meshes is ``ok``: its argument GiB a rank,
        kept GiB, flops and collective bytes by axis printed."""
        if not getattr(self, "dryrun", None):
            self._start_dryrun()
        recs = {}
        for arch, shape, proc in self.dryrun["procs"]:
            out, err = proc.communicate(timeout=600)
            check(proc.returncode == 0, f"(g) launch.dryrun {arch} {shape} "
                  f"exited {proc.returncode}: {out[-1000:]} {err[-3000:]}")
            for kind in ("single", "multi"):
                with open(os.path.join(self.dryrun["out"], kind,
                                       f"{arch}__{shape}.json")) as f:
                    rec = json.load(f)
                check(rec["status"] == "ok",
                      f"(g) dry-run {kind} {arch} {shape}: {rec}")
                m = rec["memory"]
                recs[f"{kind} {arch} {shape}"] = {
                    "status": rec["status"], "layers": rec["layers"],
                    "heads": rec["heads"]["cell"],
                    "argument_gib": m["argument_bytes"] / 2 ** 30,
                    "kept_gib": m["kept_bytes"] / 2 ** 30,
                    "flops": rec["flops_per_device"],
                    "collective_bytes": rec["collective_bytes_per_device"],
                    "by_axis": {k: v["bytes"] for k, v in
                                rec["collective_by_axis"].items()},
                    "trace_s": rec["trace_s"]}
        wall = time.perf_counter() - self.dryrun["t0"]
        log(f"phase 11 (g): launch.dryrun on the host, {len(recs)} records "
            f"(meta, no card; started {wall:.1f} s ago): " + json.dumps(recs))
        self.dryrun = None
        return recs

    def _tp_world(self, subs="cdef"):
        """Sub-phases (c), (d), (e) and / or (f) in one world of two ranks
        sharing the card (``ep_world``'s ``many``: one spawn), after
        ``_warm_rank`` on both ranks at once: a rank process's first
        full-width bf16 training step takes seconds more than its next
        ones, and world 1, which runs on each rank in turn, would pay
        that twice in a row.  Each sub-phase's report, keyed by its
        letter."""
        jobs = {"c": self._ep_checkpoint_job, "d": self._dense_tp_job,
                "e": self._leaves_tp_job, "f": self._cache_tp_job}
        parts = [jobs[k]() for k in subs]
        t0 = time.perf_counter()
        ranks = self._world((1, 2), "many", {"jobs": [(_warm_rank, {})] + [
            (job, payload) for job, payload, _ in parts]}, timeout=1200)
        log(f"phase 11 ({', '.join(subs)}): one world of two ranks, "
            f"{time.perf_counter() - t0:.1f} s, the warm-up "
            f"{[r[0]['wall_s'] for r in ranks]} s")
        return {k: report([r[i + 1] for r in ranks])
                for i, (k, (_, _, report)) in enumerate(zip(subs, parts))}


    def _smoke_vs_cpu(self, label, ranks, archs, twice=False):
        """Each rank's smoke results of each mesh, in triples (card, CPU,
        CPU on weights nudged one ulp) one a config of ``archs``: logits
        within 1e-4 of max |logit|, loss 1e-5 relative, ``lr`` equal,
        ``grad_norm`` and each leaf of ``m`` 1e-3 of its max, the step's
        raised to the CPU's floor (the nudged run) where larger; with
        ``twice`` each, the logits too, raised to twice that floor, as
        phases 9 and 10 (a) hold the chaotic SSM and cross smoke configs
        (their card-vs-CPU distance is of the floor's size, so one draw
        of it lies above the floor about half the time)."""
        np = self.np
        k = 2 if twice else 1
        out = {}
        for mesh in ranks[0]["smoke"]:
            rows = {}
            for i, arch in enumerate(archs):
                for r, res in enumerate(ranks):
                    card, cpu, nudged = res["smoke"][mesh][3 * i:3 * i + 3]
                    fwd = float(np.abs(card["forward"] - cpu["forward"]).max()
                                / np.abs(cpu["forward"]).max())
                    errs = dict(zip(("loss", "grad_norm", "m"),
                                    _step_dist(card, cpu)))
                    floor = dict(zip(("loss", "grad_norm", "m"),
                                     _step_dist(nudged, cpu)))
                    floor["logits"] = float(
                        np.abs(nudged["forward"] - cpu["forward"]).max()
                        / np.abs(cpu["forward"]).max())
                    tol = {"loss": max(1e-5, k * floor["loss"]),
                           "grad_norm": max(1e-3, k * floor["grad_norm"]),
                           "m": max(1e-3, k * floor["m"])}
                    tol_fwd = max(1e-4, 2 * floor["logits"]) if twice \
                        else 1e-4
                    check(fwd <= tol_fwd and card["metrics"]["lr"]
                          == cpu["metrics"]["lr"]
                          and all(errs[n] <= tol[n] for n in tol),
                          f"{label} smoke {arch} {mesh} rank {r}: card vs "
                          f"cpu logits {fwd} (tolerance {tol_fwd}), step "
                          f"{errs} (tolerances {tol})")
                    rows.setdefault(arch, []).append({
                        "logits_err": fwd, **errs, "cpu_floor": floor,
                        "collectives_card": card["train_ledger"]["by_axis"]})
            out[mesh] = rows
        return out

    def _full_vs_world1(self, ranks, meshes):
        """A full-width model's ``_vs_world1`` results of every rank: world
        1's, its one-ulp floor (rank 0's), the tolerances, and each mesh's
        rows with their distances from world 1 step by step."""
        w1 = [res["world1"] for res in ranks]

        def apart(row, want):
            """Per step: loss and grad_norm relative, ``m``'s distances."""
            return [{"loss": abs(g["loss"] / w["loss"] - 1),
                     "grad_norm": abs(g["grad_norm"] / w["grad_norm"] - 1),
                     "m_tree": t, "m_matrix": mx,
                     "lr_equal": g["lr"] == w["lr"]}
                    for g, w, t, mx in zip(row["metrics"], want["metrics"],
                                           row["m_tree"], row["m_matrix"])]
        nudged = ranks[0]["world1_nudged"]
        floor = {"steps": apart(nudged, w1[0]),
                 "logits": nudged["logits_err"], "teacher": nudged["teacher"]}
        # twice the floor raises the logits' limit only below 1: of max
        # |logit|, all-zero logits read 1 (xlstm's bf16 floor is 0.999)
        raised = 2 * floor["logits"]
        tol = {"loss": [max(DENSE_TP_TOL["loss"], 2 * f["loss"])
                        for f in floor["steps"]],
               "logits": max(DENSE_TP_TOL["logits"],
                             raised if raised < 1 else 0.0),
               "teacher": DENSE_TP_TOL["teacher"]}
        out = {"world1": w1, "world1_floor": floor, "tol": tol}
        for mesh in meshes:
            rows = [res["full"][mesh] for res in ranks]
            for r, row in enumerate(rows):
                row["vs_world1"] = apart(row, w1[r])
                row["step_ms_vs_world1"] = [a / b for a, b in zip(
                    row["step_ms"], w1[r]["step_ms"])]
            out[mesh] = rows
        return out

    def _check_full(self, label, full):
        """``_full_vs_world1``'s gates: on every mesh and rank the logits
        and every taught output and gradient within their tolerances, and
        each step's loss finite and within its tolerance, ``grad_norm`` >
        0 and ``lr`` equal to world 1's."""
        np, tol = self.np, full["tol"]
        for mesh in (k for k in full if k not in ("world1", "world1_floor",
                                                 "tol")):
            for r, row in enumerate(full[mesh]):
                bad = {k: v for k, v in row["teacher"].items()
                       if not v <= tol["teacher"]}
                check(row["logits_err"] <= tol["logits"] and not bad,
                      f"{label} {mesh} rank {r} vs world 1: logits "
                      f"{row['logits_err']} (tolerance {tol['logits']}), "
                      f"taught {bad} (tolerance {tol['teacher']}; world 1 "
                      f"nudged one ulp {full['world1_floor']['teacher']})")
                for i, (got, d) in enumerate(zip(row["metrics"],
                                                 row["vs_world1"])):
                    check(np.isfinite(got["loss"]) and got["grad_norm"] > 0
                          and d["lr_equal"] and d["loss"] <= tol["loss"][i],
                          f"{label} {mesh} rank {r} step {i + 1} vs world 1:"
                          f" {got}, {d} (loss tolerance {tol['loss'][i]})")

    # -- phase 12: the reference's invariants on the card -------------------
    def phase12_invariants(self):
        """The reference's invariant checks over the port, on the card: (a)
        the static analysis of ``src/repro_torch`` (``python -m
        repro_torch.analysis --check``) clean, its waivers printed; (b)
        the recall guarantee through ``fdj_join`` on engine ``cuda``; (c)
        conjunct-order invariance on ``cuda`` and ``sharded``; (d) the
        3-tenant ``sharded`` fleet under the lock witness with its pull
        guard armed.  Each sub-phase's wall and kernel launches (counts
        set to 0 just before it, read just after) are printed and added
        to the kernels line as ``launches_invariants``."""
        t0 = time.perf_counter()
        self.inv = {"walls_s": {}, "launches": {}}
        for name, fn in (("analysis", self._inv_analysis),
                         ("guarantee", self._inv_guarantee),
                         ("order", self._inv_order),
                         ("fleet", self._inv_fleet)):
            self.reset_launches()
            t = time.perf_counter()
            fn()
            wall = time.perf_counter() - t
            self.inv["walls_s"][name] = wall
            self.inv["launches"][name] = counts = self.read_launches()
            log(f"phase 12 ({name}): wall {wall:.2f} s, launches "
                + json.dumps(counts))
        keys = {"cnf_join_block": "cnf_join",
                "threshold_sweep": "threshold_sweep",
                "compact_append": "compact"}
        for entry in self.kernels:
            entry["launches_invariants"] = {
                name: counts[keys[entry["name"]]]
                for name, counts in self.inv["launches"].items()}
        self.inv["wall_s"] = time.perf_counter() - t0
        log(f"phase 12: invariants ok ({self.inv['wall_s']:.1f} s, "
            f"{self.smi})")

    def _inv_analysis(self):
        """(a) The lock graph and the lint rules over the port's tree, in a
        subprocess, exactly as a user runs them: exit 0, and every waived
        hold printed with its reason."""
        dot = os.path.join(ROOT, "build", "lockgraph.dot")
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis", "--check",
             "--dot", dot], cwd=ROOT, env=dict(os.environ, PYTHONPATH=SRC),
            capture_output=True, text=True, timeout=120)
        out = proc.stdout
        check(proc.returncode == 0 and "analysis: clean" in out,
              f"phase 12 (a): analysis --check exit {proc.returncode}: "
              f"{proc.stderr[-2000:]}")
        waived = [ln.strip() for ln in out.splitlines() if "— waived:" in ln]
        check(any("PlanLibrary.lease" in w for w in waived)
              and any("_HOST_MESH_LOCK" in w for w in waived),
              f"phase 12 (a): waivers not printed: {out[-2000:]}")
        head = next(ln for ln in out.splitlines() if ln.startswith("lock"
                                                                   " nodes"))
        log(f"phase 12 (a): python -m repro_torch.analysis --check: exit 0, "
            f"{head.strip()}, {len(waived)} waived holds:")
        for w in waived:
            log(f"phase 12 (a):   {w[:160]}")

    def _inv_guarantee(self):
        """(b) Recall >= T with failure rate <= delta + 2 sigma and mean
        recall >= T over 25 seeds x biodex and police, barrier mode, through
        ``fdj_join`` on engine ``cuda`` (tests/test_torch_guarantees.py's
        sweep); on the 5 smoke seeds (biodex 0-4) each trial's theta equals
        the CPU port's and its candidates equal the CPU port's but for
        pairs within the f32 band of a threshold."""
        import math
        import types
        np = self.np
        from repro_torch.core import join as join_mod
        from repro_torch.core.join import FDJConfig, fdj_join
        from repro_torch.data import synth
        from repro_torch.data.simulated_llm import (SimulatedExtractor,
                                                    SimulatedProposer)
        target, delta = 0.9, 0.1
        datasets = {
            "biodex": lambda s: synth.biodex(n_notes=150, n_terms=40, seed=s),
            "police": lambda s: synth.police_records(
                n_incidents=35, reports_per_incident=2, seed=s)}
        seen = []
        evaluate = join_mod._evaluate_cnf

        def recording(feats, sc, theta, cfg, order=None):
            cands, stats = evaluate(feats, sc, theta, cfg, order)
            seen.append(types.SimpleNamespace(
                feats=feats, sc_local=sc, theta=np.array(theta),
                conjunct_order=order, cands=cands))
            return cands, stats

        def trial(name, seed, device):
            ds = datasets[name](seed)
            cfg = FDJConfig(recall_target=target, delta=delta, seed=seed,
                            mc_trials=5000, engine="cuda", device=device)
            seen.clear()
            res = fdj_join(ds, ds.make_oracle(), SimulatedProposer(ds),
                           SimulatedExtractor(ds, seed=seed), cfg)
            return res, (seen[0] if seen else None)

        recalls, smoke = [], []
        join_mod._evaluate_cnf = recording
        try:
            for name in datasets:
                for seed in range(25):
                    t = time.perf_counter()
                    res, got = trial(name, seed, "cuda")
                    wall = time.perf_counter() - t
                    recalls.append(res.recall)
                    if name != "biodex" or seed >= 5:
                        continue
                    cpu, want = trial(name, seed, "cpu")
                    what = f"phase 12 (b): biodex seed {seed}"
                    check(np.array_equal(res.theta, cpu.theta),
                          f"{what}: theta {res.theta} on the card, "
                          f"{cpu.theta} on the CPU")
                    check((got is None) == (want is None),
                          f"{what}: one plan is degenerate")
                    diff = set() if got is None else self._candidates_in_band(
                        got.cands, want.cands, want.feats, want, what)
                    smoke.append({"seed": seed, "recall": res.recall,
                                  "candidates": res.candidate_count,
                                  "cpu_candidates": cpu.candidate_count,
                                  "differ_in_band": len(diff),
                                  "dollars": res.cost.total,
                                  "cpu_dollars": cpu.cost.total,
                                  "wall_s": wall})
        finally:
            join_mod._evaluate_cnf = evaluate
        trials = len(recalls)
        fails = sum(r < target for r in recalls)
        slack = 2.0 * math.sqrt(delta * (1.0 - delta) / trials)
        mean = float(np.mean(recalls))
        out = {"trials": trials, "fails": fails,
               "bound": delta + slack, "mean_recall": mean,
               "min_recall": min(recalls), "smoke": smoke}
        log("phase 12 (b): recall guarantee on the card, engine cuda, "
            "barrier: " + json.dumps(out))
        check(trials >= 50 and fails / trials <= delta + slack
              and mean >= target,
              f"phase 12 (b): failure rate {fails}/{trials} over "
              f"{delta + slack:.3f} or mean recall {mean} under {target}")

    def _inv_order(self):
        """(c) ``representative_cnf`` on police_records, ragged 74 x 74
        (seed 5, the CPU test's tiles) and 1400 x 1400 (the engines'
        default tiles), through ``cuda`` and ``sharded`` on the card: every
        conjunct order, early reject on and off, and both engines give one
        candidate set; it differs from the numpy engine's only within the
        f32 band; the empty scaffold gives the cross product."""
        import itertools
        import types
        np = self.np
        from repro_torch.core.costs import CostLedger
        from repro_torch.core.join import apply_conjunct_order
        from repro_torch.data import synth
        from repro_torch.data.cnf_fixtures import representative_cnf
        from repro_torch.data.simulated_llm import SimulatedExtractor
        from repro_torch.engine import get_engine
        small = {"cuda": dict(tl=32, tr=64, l_block=32),
                 "sharded": dict(tl=32, tr=32, r_chunk=64)}
        rows = []
        for n_inc, opts in ((37, small), (700, {"cuda": {}, "sharded": {}})):
            ds = synth.police_records(n_incidents=n_inc,
                                      reports_per_incident=2, seed=5)
            specs, clauses, thetas = representative_cnf(ds)
            feats = SimulatedExtractor(ds).materialize(specs, CostLedger())
            theta = np.asarray(thetas, float)
            base, evals, runs = None, {}, 0
            for engine in ("cuda", "sharded"):
                for order in itertools.permutations(range(len(clauses))):
                    oc, ot = apply_conjunct_order(clauses, theta, list(order))
                    for er in (True, False):
                        res = get_engine(engine, early_reject=er,
                                         device="cuda", **opts[engine]
                                         ).evaluate(feats, oc, list(ot))
                        runs += 1
                        if base is None:
                            base = res.candidates
                        check(res.candidates == base,
                              f"phase 12 (c): {ds.n_l} x {ds.n_r}, {engine}, "
                              f"order {order}, early_reject {er}: "
                              f"{len(res.candidates)} candidates, want "
                              f"{len(base)}")
                        evals.setdefault(f"{engine} er={er}", set()).add(
                            res.stats.conjunct_evals)
                empty = get_engine(engine, device="cuda",
                                   **opts[engine]).evaluate(feats, [], [])
                check(len(empty.candidates) == ds.n_l * ds.n_r,
                      f"phase 12 (c): {engine} empty scaffold")
            ref = get_engine("numpy").evaluate(feats, clauses, thetas)
            plan = types.SimpleNamespace(
                sc_local=types.SimpleNamespace(clauses=clauses),
                theta=theta, conjunct_order=None)
            diff = self._candidates_in_band(base, ref.candidates, feats, plan,
                                            f"phase 12 (c) {ds.n_l} x "
                                            f"{ds.n_r}")
            check(len(base) > 0, "phase 12 (c): no candidate")
            rows.append({"shape": [ds.n_l, ds.n_r], "clauses": len(clauses),
                         "evaluations": runs, "candidates": len(base),
                         "numpy_differ_in_band": len(diff),
                         "conjunct_evals": {k: sorted(v)
                                            for k, v in evals.items()}})
        log("phase 12 (c): candidate sets identical under every conjunct "
            "order and early-reject setting, cuda == sharded: "
            + json.dumps(rows))

    def _inv_fleet(self):
        """(d) tests/test_torch_analysis_witness.py's stress test on the
        card: 3 tenants on engine ``sharded`` (two sharing a corpus), 2
        rounds of racing cold/warm queries, under ``lock_witness(
        guard_blocking=True)``, whose guard wraps ``torch.cuda.synchronize``,
        the CUDA event and stream syncs and the ring's two pull points: no
        observed order cycle, none when merged into the static graph, no
        blocking pull under a held lock, equal pairs for the tenants that
        share a corpus.  The tenants plan on an empty curve cache, as in a
        fresh checkout, so their workers compute and write the same
        Monte-Carlo curves at once."""
        import tempfile
        torch = self.torch
        from repro_torch.analysis.lockgraph import build_lock_graph
        from repro_torch.analysis.witness import lock_witness
        from repro_torch.core.join import FDJConfig
        from repro_torch.data import synth
        from repro_torch.engine import sharded
        from repro_torch.serving.fleet import JoinFleet
        static = build_lock_graph()
        check(not static.findings, f"phase 12 (d): static findings "
              f"{[str(f) for f in static.findings]}")
        calls = {"pulls": 0, "event_syncs": 0}
        raw_wait = sharded._Transfers.__dict__["wait"]
        raw_sync = torch.cuda.Event.__dict__["synchronize"]

        def counted_wait(step):
            calls["pulls"] += 1
            return raw_wait.__func__(step)

        def counted_sync(event):
            calls["event_syncs"] += 1
            return raw_sync(event)

        def police(seed):
            return synth.police_records(n_incidents=40,
                                        reports_per_incident=2, seed=seed)

        cold = tempfile.mkdtemp(prefix="adj_cold_",
                                dir=os.path.join(ROOT, "build"))
        cache_env = os.environ.get("REPRO_TORCH_ADJ_CACHE")
        os.environ["REPRO_TORCH_ADJ_CACHE"] = cold
        sharded._Transfers.wait = staticmethod(counted_wait)
        torch.cuda.Event.synchronize = counted_sync
        try:
            with lock_witness(guard_blocking=True) as w:
                cfg = FDJConfig(engine="sharded", device="cuda", seed=0,
                                mc_trials=4000, engine_opts=dict(
                                    tl=32, tr=32, r_chunk=64))
                with JoinFleet(max_concurrent=3, device="cuda") as fleet:
                    fleet.add_tenant("a", police(3), cfg)
                    fleet.add_tenant("b", police(3), cfg)
                    fleet.add_tenant("c", police(7), cfg)
                    futures = [(name, fleet.submit(name))
                               for _ in range(2) for name in ("a", "b", "c")]
                    pairs = {}
                    for name, fut in futures:
                        pairs.setdefault(name, []).append(
                            fut.result(timeout=300).pairs)
                    summary = fleet.drain()
        finally:
            sharded._Transfers.wait = raw_wait
            torch.cuda.Event.synchronize = raw_sync
            if cache_env is None:
                os.environ.pop("REPRO_TORCH_ADJ_CACHE", None)
            else:
                os.environ["REPRO_TORCH_ADJ_CACHE"] = cache_env
            shutil.rmtree(cold, ignore_errors=True)
        by_site = {(n.file, n.line) for n in static.nodes.values()}
        mapped = [s for s in w.sites if (s.file, s.line) in by_site]
        out = {"completed": summary["completed"],
               "failed": summary["failed"], "pulls": calls["pulls"],
               "event_syncs": calls["event_syncs"],
               "sites": len(w.sites), "sites_mapped": len(mapped),
               "edges": len(w.edges), "order_cycles": w.order_cycles(),
               "cycles_with_static": w.check_against(static),
               "blocking_violations": w.blocking_violations,
               "pairs": {k: [len(p) for p in v] for k, v in pairs.items()}}
        log("phase 12 (d): 3-tenant sharded fleet under the lock witness: "
            + json.dumps(out))
        check(summary["completed"] == 6 and summary["failed"] == 0,
              f"phase 12 (d): fleet summary {summary}")
        check(pairs["a"][0] == pairs["a"][1] == pairs["b"][0]
              and pairs["c"][0] == pairs["c"][1],
              "phase 12 (d): tenants sharing a corpus disagree")
        check(calls["pulls"] > 0 and calls["event_syncs"] > 0 and mapped,
              "phase 12 (d): the ring's pulls did not pass the guard")
        check(not out["order_cycles"] and not out["cycles_with_static"]
              and not out["blocking_violations"],
              "phase 12 (d): the witness found a lock-order cycle or a "
              "blocking pull under a lock")

    # -- phase 13: the join fleet over a world of ranks ----------------------
    def phase13_fleet_world(self):
        """``run_fleet`` (``launch.serve_fleet``), engine ``sharded``, on
        world 1 and on two ranks sharing the card: (a) 3 tenants on phase
        6's corpus, (b) 2 tenants on corpora of their own at half its
        size; world 1 in this process, both sub-phases of world 2 in one
        spawned world (``_fleet_world_rank``); each query's wall on each
        rank, each rank's launches and the control records printed, and
        ``launches_fleet_world`` added to the kernels line."""
        from repro_torch.launch.ep_world import run_world
        from repro_torch.launch.serve_fleet import run_fleet
        t0 = time.perf_counter()
        # a capacity no band of these corpora overflows: bytes_to_host is
        # then exactly 12 B a rank a step + 8 B a pair (a retry pulls 8 B
        # a rank more)
        # (b) at half phase 6's corpus (1400 x 1400): two plans a rank
        cases = [(sub, dict(dataset="products", engine="sharded",
                            engine_opts={"sharded": {"capacity": 65536}},
                            queries=1, **kw))
                 for sub, kw in (("a", dict(size=SERVE_SIZE, n_tenants=3,
                                            shared=True, max_concurrent=3)),
                                 ("b", dict(size=SERVE_SIZE // 2,
                                            n_tenants=2, shared=False,
                                            max_concurrent=2)))]
        world1 = {}
        for sub, payload in cases:
            self.reset_launches()
            t = time.perf_counter()
            out = run_fleet(device="cuda", **payload)
            self.torch.cuda.synchronize()
            world1[sub] = {"out": out, "wall_s": time.perf_counter() - t,
                           "launches": self.read_launches()}
        t = time.perf_counter()
        ranks = run_world((2, 1), _fleet_world_rank, {"cases": cases},
                          device="cuda", timeout=900)
        spawn_wall = time.perf_counter() - t
        self.fleet_world = {sub: self._fleet_world(sub, payload, world1[sub],
                                                   [r[sub] for r in ranks])
                            for sub, payload in cases}
        keys = {"cnf_join_block": "cnf_join",
                "threshold_sweep": "threshold_sweep",
                "compact_append": "compact"}
        for entry in self.kernels:
            k = keys[entry["name"]]
            entry["launches_fleet_world"] = {
                sub: {"world1": r["launches_world1"][k],
                      "world2": [c[k] for c in r["launches_world2"]]}
                for sub, r in self.fleet_world.items()}
        self.fleet_world["world2_spawned_wall_s"] = spawn_wall
        self.fleet_world["wall_s"] = time.perf_counter() - t0
        log(f"phase 13: fleet over a world ok "
            f"({self.fleet_world['wall_s']:.1f} s, world 2 spawned, both "
            f"sub-phases, {spawn_wall:.1f} s; {self.smi})")

    def _fleet_world(self, sub, payload, one, ranks):
        """One sub-phase's checks (the module docstring's phase 13): world
        1's run ``one`` against world 2's ranks."""
        import math
        what = f"phase 13 ({sub})"
        from repro_torch.launch.serve_join import SERVE_SCALE
        ev1, ev2 = one["out"]["events"], ranks[0]["out"]["events"]
        # tenant 0 joins phase 6's corpus at phase 6's seed and plan
        phase6 = payload["size"] == SERVE_SIZE
        steps = -(-int(700 * payload["size"] * SERVE_SCALE) // 512)
        n_q = payload["n_tenants"] * payload["queries"]
        check(len(ev1) == len(ev2) == n_q,
              f"{what}: {len(ev1)} / {len(ev2)} queries")
        pairs1, pairs2 = one["out"]["pairs"], ranks[0]["out"]["pairs"]
        differing = 0
        for e1, e2, p1, p2 in zip(ev1, ev2, pairs1, pairs2):
            check(e1["tenant"] == e2["tenant"] and e1["theta"] == e2["theta"],
                  f"{what}: tenant {e2['tenant']} theta {e2['theta']} vs "
                  f"world 1's {e1['theta']}")
            diff = self._fleet_pairs_in_band(
                e2["tenant"] if phase6 else None, p2, p1,
                f"{what} world 2 vs 1")
            differing += len(diff)
            for ev, p in ((e1, 1), (e2, 2)):
                check(ev["bytes_to_host"] == 12 * p * steps
                      + 8 * ev["candidates"],
                      f"{what}: world {p} query of {ev['tenant']}: "
                      f"bytes_to_host {ev['bytes_to_host']}, want 12 B a rank "
                      f"a step ({steps} steps) + 8 B a pair")
        cold6 = self.serve_cold
        for ev, p2 in zip(ev2, pairs2):
            if phase6 and ev["tenant"] == "t0":
                check(ev["theta"] == [float(x) for x in cold6.join.theta],
                      f"{what}: t0 theta differs from phase 6's cold query")
                diff = self._fleet_pairs_in_band(
                    "t0", p2, sorted(cold6.pairs), f"{what} vs phase 6")
                differing += len(diff)
        d1 = math.fsum(e["total_$"] for e in ev1)
        d2 = math.fsum(e["total_$"] for e in ev2)
        check(d1 == d2, f"{what}: the fleet's dollars {d2} vs world 1's {d1}")
        s1 = one["out"]["summary"]
        sums = [r["out"]["summary"] for r in ranks]
        misses = [s["plan_misses"] for s in [s1] + sums]
        check(misses == [s1["plan_misses"]] * 3 and s1["plan_misses"] ==
              (1 if payload["shared"] else payload["n_tenants"]),
              f"{what}: plans built {misses} (world 1, then each rank)")
        if payload["shared"]:
            for evs, p in ((ev1, 1), (ev2, 2)):
                cold = evs[:payload["n_tenants"]]
                check(sum(e["labeling_$"] > 0 for e in evs) == 1 and any(
                    e["extraction_$"] == 0 and e["labeling_$"] == 0
                    for e in cold),
                      f"{what}: world {p}: no cold query rode another "
                      f"tenant's plan and planes: "
                      f"{[(e['extraction_$'], e['labeling_$']) for e in evs]}")
        else:
            check([e["total_$"] for e in ev1] == [e["total_$"] for e in ev2],
                  f"{what}: per-query dollars differ from world 1's")
        for s in sums:
            check(s["world"] == 2 and s["ranks_agree"] and s["failed"] == 0
                  and s["completed"] == n_q,
                  f"{what}: rank summary world {s['world']} agree "
                  f"{s['ranks_agree']} failed {s['failed']}")
        check(sums[0]["world_ranks"] == sums[1]["world_ranks"] and all(
            r == sums[0]["world_ranks"][0] for r in sums[0]["world_ranks"]),
              f"{what}: rank digests differ: {sums[0]['world_ranks']}")
        check(sums[0]["band_steps"] == sums[1]["band_steps"] ==
              s1["band_steps"] == steps * n_q,
              f"{what}: band steps {s1['band_steps']} / "
              f"{[s['band_steps'] for s in sums]}")
        l1, l2 = one["launches"], [r["launches"] for r in ranks]
        for c in [l1] + l2:
            check(c["cnf_join"] == c["compact"] == steps * n_q and
                  c["threshold_sweep"] == s1["plan_misses"],
                  f"{what}: launches {c} (world 1, then each rank)")
        row = {
            "world1_wall_s": one["wall_s"],
            "world2_wall_s": [r["wall_s"] for r in ranks],
            "query_walls_s": {"world1": [e["wall_s"] for e in ev1],
                              "world2": [[e["wall_s"] for e in
                                          r["out"]["events"]]
                                         for r in ranks]},
            "tenants": [e["tenant"] for e in ev1],
            "pairs": [e["pairs"] for e in ev2],
            "candidates": [e["candidates"] for e in ev2],
            "differing_in_band": differing,
            "launches_world1": l1, "launches_world2": l2,
            "control_records": [s["control_records"] for s in sums],
            "grants": [s["grants"] for s in sums],
            "band_steps": sums[0]["band_steps"],
            "interleaves": [s1["interleaves"]]
            + [s["interleaves"] for s in sums],
            "collectives": [s["collectives"] for s in sums],
            "p50_wall_s": [s1["p50_wall_s"]] + [s["p50_wall_s"]
                                                for s in sums],
            "ranks_agree": all(s["ranks_agree"] for s in sums)}
        log(f"{what}: " + json.dumps(row))
        return row

    def _fleet_pairs_in_band(self, tenant, got, want, what):
        """Tenant ``tenant``'s pairs in a fleet query against another
        run's: on phase 6's corpus (tenant ``t0``) they may differ only in
        pairs within the f32 band of phase 6's plan; any other tenant's
        (``None``: not phase 6's corpus) must be equal.  Returns the
        differing pairs."""
        a = {tuple(p) for p in got}
        b = {tuple(p) for p in want}
        if a == b:
            return set()
        from repro_torch.core.costs import CostLedger
        from repro_torch.data.simulated_llm import SimulatedExtractor
        svc = self.serve_svc
        check(tenant == "t0", f"{what}: pairs of tenant {tenant} differ")
        plan = svc._plans[svc._plan_key(svc.cfg)]
        feats = SimulatedExtractor(svc.dataset, seed=0).materialize(
            plan.used_specs, CostLedger())
        return self._candidates_in_band(sorted(a), sorted(b), feats, plan,
                                        what)


# -- phase 13: the job each rank of its world runs --------------------------

def _fleet_world_rank(mesh, dev, p):
    """One rank of phase 13's world: ``run_fleet`` for each sub-phase in
    turn, its wall and this rank's launches of the three kernels (counts
    set to 0 just before it, read just after)."""
    from repro_torch.kernels.extract import kernel as ek
    from repro_torch.kernels.fused_cnf_join import kernel as ck
    from repro_torch.kernels.threshold_sweep import kernel as sk
    from repro_torch.launch.serve_fleet import run_fleet
    out = {}
    for sub, payload in p["cases"]:
        ck.launches["cnf_join"] = ek.launches["compact"] = 0
        for name in sk.launches:
            sk.launches[name] = 0
        t = time.perf_counter()
        res = run_fleet(device=str(dev), **payload)
        out[sub] = {"out": res, "wall_s": time.perf_counter() - t,
                    "launches": {"cnf_join": ck.launches["cnf_join"],
                                 "compact": ek.launches["compact"],
                                 **sk.launches}}
    return out


# -- phase 11 (d) and (e): the jobs each rank of their worlds runs ---------

def _warm_rank(mesh, dev, p):
    """One bf16 training step of phi4-mini-3.8b at full width cut to one
    layer (phase 10's settings), drawn on the card from seed 0, so that
    this rank process's first full-width step (seconds more than the
    next, which world 1 would pay on each rank in turn) runs while the
    other rank pays its own."""
    import dataclasses
    import torch
    from repro_torch.common.config import TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.models import steps, transformer
    from repro_torch.optim import adamw
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(ZOO_ARCH), num_layers=1)
    model = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    opt = adamw.init_opt_state(dict(model.named_parameters()))
    toks = torch.randint(0, cfg.vocab_size, (8, 129), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    steps.make_train_step(cfg, TrainConfig(total_steps=6, warmup_steps=1))(
        model, opt, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    torch.cuda.synchronize()
    del model, opt
    torch.cuda.empty_cache()
    return {"wall_s": round(time.perf_counter() - t0, 2)}


def _smoke_jobs(meshes, smoke):
    """``ep_world``'s ``model`` job for each payload of ``smoke[name]`` on
    each mesh ``name``."""
    import torch
    from repro_torch.launch.ep_world import JOBS
    return {name: [JOBS["model"](m, torch.device(q["device"]), q)
                   for q in smoke.get(name, ())]
            for name, m in meshes.items()}


def _dense_tp_rank(mesh, dev, p):
    """One rank of phase 11 (d)'s world (built as (1, 2); the (2, 1) mesh
    is made over the same ranks): the smoke payloads of each mesh
    (``_smoke_jobs``), then phi4-mini-3.8b cut to ``layers`` layers
    against world 1 (``_vs_world1``, layer 0 and the embedding's two uses
    taught) on both meshes."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.distributed.mesh import make_mesh
    t0 = time.perf_counter()
    meshes = {"1x2": mesh, "2x1": make_mesh((2, 1), ("data", "model"))}
    out = {"smoke": _smoke_jobs(meshes, p["smoke"])}
    cfg = dataclasses.replace(get_config(ZOO_ARCH), num_layers=p["layers"])
    out.update(_vs_world1(mesh, meshes, dev, cfg, {
        "tokens": p["tokens"], "taught": (0,), "embed": True}))
    out["wall_s"] = time.perf_counter() - t0
    return out


def _leaves_tp_rank(mesh, dev, p):
    """One rank of phase 11 (e)'s world (built as (1, 2), the (2, 1) mesh
    over the same ranks): the smoke payloads of each mesh
    (``_smoke_jobs``), then each model of ``full`` against world 1 on its
    meshes (``_vs_world1``): ``arch`` at full width cut to ``layers``, f32
    masters, or (``train`` false) bf16 parameters and the forward
    alone."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.distributed.mesh import make_mesh
    t0 = time.perf_counter()
    meshes = {"1x2": mesh, "2x1": make_mesh((2, 1), ("data", "model"))}
    out = {"smoke": _smoke_jobs(meshes, p["smoke"]), "full": {}}
    for q in p["full"]:
        cfg = (dataclasses.replace(get_config(q["arch"]),
                                   num_layers=q["layers"])
               if q["train"] else _full_width_cfg(q["arch"], q["layers"]))
        out["full"][q["arch"]] = _vs_world1(
            mesh, {k: meshes[k] for k in q["meshes"]}, dev, cfg, q)
    out["wall_s"] = time.perf_counter() - t0
    return out


def _cache_tp_rank(mesh, dev, p):
    """One rank of phase 11 (f)'s world (built as (1, 2), the (2, 1) mesh
    over the same ranks): the smoke payloads of each mesh
    (``_smoke_jobs``: a prefill and decode steps, card, CPU, CPU
    nudged), then each model of ``full`` at full width cut to ``layers``
    against world 1 on its meshes (``_decode_vs_world1``)."""
    from repro_torch.distributed.mesh import make_mesh
    t0 = time.perf_counter()
    meshes = {"1x2": mesh, "2x1": make_mesh((2, 1), ("data", "model"))}
    out = {"smoke": _smoke_jobs(meshes, p["smoke"]), "full": {}}
    for q in p["full"]:
        out["full"][q["arch"]] = _decode_vs_world1(
            mesh, {k: meshes[k] for k in q["meshes"]}, dev,
            _full_width_cfg(q["arch"], q["layers"]), q)
    out["wall_s"] = time.perf_counter() - t0
    return out


def _padded_cell_rank(mesh, dev, p):
    """One rank of phase 11 (g)'s (1, 4) world: the padded cell of
    ``p["cell"]`` run for real (``ep_world``'s ``cell`` job: the whole
    model drawn on the card, padded, this rank's blocks kept, a prefill
    into the cell's state and the decode steps), its decode ms a step;
    then, the ranks' states freed, rank 0 runs the unpadded model's
    world-1 prefill and decode on the card, plain and on weights nudged
    one ulp."""
    import torch
    from repro_torch.launch.ep_world import _job_cell
    q = p["cell"]
    row = _job_cell(mesh, dev, q)
    row["decode_ms"] = row["decode_s"] * 1e3 / q["decode"].shape[1]
    torch.cuda.empty_cache()
    torch.distributed.barrier()
    if mesh.rank == 0:
        row["world1"] = _padded_world1(dev, q)
    torch.distributed.barrier()
    return row


def _padded_world1(dev, q):
    """The unpadded model of phase 11 (g)'s cell at world 1 on the card:
    the same prefill and decode steps, on the weights drawn from seed 0
    (``plain``) and on them nudged one ulp (``nudged``); the logits, the
    state's bytes and decode ms a step."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.ep_world import _np, whole_weights
    from repro_torch.models import steps, transformer
    cfg = dataclasses.replace(get_config(q["arch"]), num_layers=q["layers"],
                              **q["overrides"])
    _, capacity, b, _ = q["shape"]
    out = {}
    for name, nudge in (("plain", None), ("nudged", 1)):
        model = transformer.Transformer(cfg, whole_weights(
            cfg, dev, dict(q, nudge=nudge)))
        prompt = torch.as_tensor(q["prompt"]).to(dev)
        toks = torch.as_tensor(q["decode"]).to(dev)
        s = prompt.shape[1]
        state, last = steps.make_prefill_step(cfg, capacity,
                                              cache_dtype="float32")(
            model, prompt)
        logits = [_np(last)]
        decode = steps.make_decode_step(cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for j in range(toks.shape[1]):
            pos = torch.full((b, 1), s + j, dtype=torch.int32, device=dev)
            state, lg = decode(model, state, toks[:, j:j + 1], pos)
            logits.append(_np(lg))
        out["decode_ms"] = (time.perf_counter() - t0) * 1e3 / toks.shape[1]
        out["state_bytes"] = sum(t.numel() * t.element_size()
                                 for layer in state for t in layer.values()
                                 if torch.is_tensor(t))
        out[name] = np.stack(logits)
        del model, state
        torch.cuda.empty_cache()
    return out


def _decode_vs_world1(mesh, meshes, dev, cfg, q):
    """``cfg`` (bf16) prefilled with ``tokens[:, :prompt]`` into
    ``capacity`` slots and decoded a token a step, teacher-forced with the
    rest, on each of ``meshes`` against world 1, the weights drawn on the
    card from seed 0.  World 1 runs on each rank in turn (the others wait
    at a barrier), also on the groups of rows a mesh splits the batch
    into (the witness of that mesh's arithmetic), and on rank 0 on
    weights nudged one ulp (its floor); then on each mesh each rank draws
    its blocks in turn and runs the same calls against its block of the
    state.  Per mesh: the logits' distance (the prefill's last and every
    step's, of max |logit|) from the witness and from plain world 1,
    decode ms a step (host walls, the card synchronized around each),
    this rank's state bytes against world 1's, its state blocks'
    distance from its blocks of world 1's (bf16 ulps of a cache block's
    max, an f32 block's relative), the ledger's calls and bytes of the
    prefill and a step by axis, peak memory."""
    import statistics as stats
    import torch
    import torch.distributed as dist
    from repro_torch.distributed.mesh import AxisEnv, axis_size
    from repro_torch.launch.ep_world import ledger_delta, nudge_
    from repro_torch.models import steps, transformer
    toks = torch.as_tensor(q["tokens"], device=dev)
    b, s = toks.shape[0], q["prompt"]

    def groups(on):
        ways = axis_size(on, AxisEnv.from_mesh(on).batch)
        return ways if b % ways == 0 else 1

    def draw(on):
        model = None
        for r in range(mesh.size if on is not None else 0):
            if r == mesh.rank:
                model = transformer.init_params(
                    cfg, torch.Generator(device=dev).manual_seed(0), dev,
                    mesh=on)
                torch.cuda.synchronize()
            dist.barrier()
        if on is None:
            model = transformer.init_params(
                cfg, torch.Generator(device=dev).manual_seed(0), dev)
        return model

    def run(model, on, t):
        """(logits (1 + steps, B, V) f32, the state, timings, ledgers)."""
        ledger = (on or mesh).axis_ledger
        ledger.reset()
        prefill = steps.make_prefill_step(cfg, q["capacity"], mesh=on)
        decode = steps.make_decode_step(cfg, mesh=on)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, last = prefill(model, t[:, :s])
        torch.cuda.synchronize()
        info = {"prefill_s": time.perf_counter() - t0, "step_ms": [],
                "prefill_ledger": ledger.summary()["by_axis"],
                "step_ledgers": []}
        logits = [last.float()]
        for j in range(t.shape[1] - s):
            pos = torch.full((t.shape[0], 1), s + j, dtype=torch.int32,
                             device=dev)
            before = ledger.summary()["by_axis"]
            t0 = time.perf_counter()
            state, lg = decode(model, state, t[:, s + j:s + j + 1], pos)
            torch.cuda.synchronize()
            info["step_ms"].append(1e3 * (time.perf_counter() - t0))
            info["step_ledgers"].append(ledger_delta(
                ledger.summary()["by_axis"], before))
            logits.append(lg.float())
        info["step_ms_median"] = stats.median(info["step_ms"])
        info["state_bytes"] = sum(v.numel() * v.element_size()
                                  for layer in state for v in layer.values()
                                  if torch.is_tensor(v))
        return torch.stack(logits), state, info

    def rel(a, want):
        return float((a - want).abs().max() / want.abs().max())

    out = {"meshes": {}}
    kept = None
    for r in range(mesh.size):
        if r == mesh.rank:
            torch.cuda.reset_peak_memory_stats()
            model = draw(None)
            lg, state, info = run(model, None, toks)
            kept = {"logits": {1: lg}, "state": state}
            for k in {groups(m) for m in meshes.values()} - {1}:
                n = b // k
                kept["logits"][k] = torch.cat([run(model, None, toks[j:j + n])[0]
                                               for j in range(0, b, n)], 1)
            if r == 0:
                nudge_(model.parameters(), 1)
                out["world1_floor"] = rel(run(model, None, toks)[0], lg)
            info.pop("prefill_ledger")
            info.pop("step_ledgers")
            out["world1"] = dict(info, peak_bytes=torch.cuda.max_memory_allocated())
            del model
            torch.cuda.empty_cache()
        dist.barrier()
    for name, on in meshes.items():
        torch.cuda.reset_peak_memory_stats()
        model = draw(on)
        lg, state, info = run(model, on, toks)
        blocks = transformer.state_blocks(cfg, kept["state"], on)
        dists = {}
        for i, (a, w) in enumerate(zip(state, blocks)):
            for n, t in a.items():
                if not torch.is_tensor(t):
                    continue
                m = float(w[n].float().abs().max())
                d = float((t.float() - w[n].float()).abs().max())
                dists[f"{i}.{n}"] = (
                    d / 2.0 ** (math.floor(math.log2(m)) - 7)
                    if t.dtype == torch.bfloat16 and m else d / (m or 1.0))
        info["step_ledger_last"] = info["step_ledgers"][-1]
        out["meshes"][name] = dict(
            info, step_ledgers=info["step_ledgers"][:2],
            logits_err=rel(lg, kept["logits"][groups(on)]),
            logits_vs_plain=rel(lg, kept["logits"][1]),
            world1_state_bytes=out["world1"]["state_bytes"],
            state_vs_world1_max=max(dists.values()),
            peak_bytes=torch.cuda.max_memory_allocated())
        del model, state
        torch.cuda.empty_cache()
    del kept
    torch.cuda.empty_cache()
    return out


def _vs_world1(mesh, meshes, dev, cfg, q):
    """``cfg`` on each of ``meshes`` against world 1, phase 10's settings
    (remat, AdamW, warmup 1 of 6), the weights drawn on the card from seed
    0 (every cross gate then 0.5).  World 1 runs on each rank in turn (the
    others wait at a barrier): the layers of ``taught`` (and with
    ``embed`` the embedding's two uses) taught, the logits of ``first``
    (the first two rows of ``tokens``' first batch, with ``memory``'s
    (2, M, F) embeds drawn from seed 7 when the config has cross layers),
    then with ``train`` (default) a step on each batch of ``tokens`` (B,
    8, S + 1), keeping what they give and ``m`` after each; world 1 on
    weights nudged one ulp on rank 0 (its floor); then on each mesh the
    model drawn by each rank in turn (a draw holds a whole leaf's f32
    scratch), its blocks kept, the same calls.  Against world 1's run on
    the mesh's groups of rows (the witness: the mesh's arithmetic on one
    rank; plain world 1 where the mesh splits no rows): the taught
    outputs and gradients and the logits (of max |logit|; plain world 1's
    distance printed beside); and after each step ``m``'s distance over
    the rank's blocks, of the whole tree and of the worst matrix leaf,
    each relative to world 1's norm there.
    Step ms by CUDA events, peak memory a run, the ledger of the calls.
    Returns {"world1": row, "world1_nudged": row (rank 0), "full": {mesh:
    row}}."""
    import torch
    import torch.distributed as dist
    from repro_torch.common.config import TrainConfig
    from repro_torch.distributed.mesh import AxisEnv, axis_size, block_slices
    from repro_torch.launch.ep_world import nudge_
    from repro_torch.models import steps, transformer
    from repro_torch.models.layers import tree_leaves
    from repro_torch.optim import adamw
    tcfg = TrainConfig(total_steps=6, warmup_steps=1)
    batches = [{"tokens": torch.as_tensor(t[:, :-1], device=dev),
                "labels": torch.as_tensor(t[:, 1:], device=dev)}
               for t in q["tokens"]]
    first = batches[0]["tokens"][:2]
    train = q.get("train", True)
    memory = None
    if cfg.cross_attn_every:
        g = torch.Generator(device=dev).manual_seed(7)
        memory = torch.randn((2, q["memory_len"], cfg.frontend_embed_dim),
                             generator=g, device=dev)
    specs = dict(tree_leaves(transformer.local_specs(
        cfg, AxisEnv.from_mesh(mesh))))
    spec_of = {}        # parameter name -> its spec, a layer's for a scan
    for path, _, names in transformer.reference_leaves(cfg):
        sp = specs[path]
        spec_of.update((n, sp[1:] if path[0] == "scanned" else sp)
                       for n in names)

    def row_groups(on):
        """The groups a mesh splits ``first``'s rows into (1: whole)."""
        if on is None:
            return 1
        ways = axis_size(on, AxisEnv.from_mesh(on).batch)
        return ways if first.shape[0] % ways == 0 else 1

    def teacher(model, on, groups=1):
        """Each layer of ``taught`` (a cross layer over a fixed memory of
        (2, M, d)), and with ``embed`` the embedding's two uses (the
        lookup of ``first`` and the tied logits), each on fixed inputs
        (seed 5) under a fixed cotangent: the outputs and the gradients
        (this rank's blocks), free of the composed model's chaos.  World 1
        with ``groups`` > 1 runs each layer on that many groups of the
        rows in turn, as a mesh that splits the batch so many ways does
        (the witness: the mesh's arithmetic on one rank)."""
        env = AxisEnv.from_mesh(on) if on is not None else None
        split = on is not None and on.size > 1
        cdt = model.compute_dtype
        g = torch.Generator(device=dev).manual_seed(5)
        b, s = first.shape
        pos = torch.arange(s, device=dev)[None].expand(b, s)
        res = {}
        for i in q["taught"]:
            blk = model.layers[i]
            x = (torch.randn((b, s, cfg.d_model), generator=g, device=dev)
                 .to(cdt).requires_grad_())
            cot = torch.randn((b, s, cfg.d_model), generator=g, device=dev)
            mem = None
            if blk.kind == "cross_attn":
                mem = torch.randn((b, q["memory_len"], cfg.d_model),
                                  generator=g, device=dev).to(cdt)
                if split:
                    mem = transformer._Rows(b, on, env).take(mem)
            if groups > 1:
                n = b // groups
                y = torch.cat([blk(
                    x[j:j + n], pos[j:j + n], None, None, None,
                    None if mem is None else mem[j:j + n], False)[0]
                    for j in range(0, b, n)])
            else:
                y = blk(x, pos, None, None, None, mem, False, on, env)[0]
            (y.float() * cot).sum().backward()
            res.update({f"layers.{i}.out": y.detach().float(),
                        f"layers.{i}.dx": x.grad.float()})
            res.update((f"layers.{i}.{n}", t.grad.float())
                       for n, t in blk.named_parameters())
        if q.get("embed"):
            x, h = (torch.randn((b, s, cfg.d_model), generator=g,
                                device=dev).to(cdt).requires_grad_()
                    for _ in range(2))
            cot = torch.randn((b, s, cfg.d_model), generator=g, device=dev)
            cot_l = torch.randn((b, s, cfg.vocab_size), generator=g,
                                device=dev)
            emb = model.embed["embedding"]
            if split:
                e, table = transformer._embed_tp(first, emb, cdt, on, env)
                logits = model._logits_tp(h, table, on, env)
            else:
                e = torch.nn.functional.embedding(first, emb).to(cdt)
                logits = torch.matmul(h, emb.to(cdt).T)
            ((e.float() * cot).sum()
             + (logits.float() * cot_l).sum()).backward()
            res.update({"embed": e.detach().float(),
                        "logits": logits.detach().float(),
                        "embed.embedding": emb.grad.float(),
                        "logits_dh": h.grad.float()})
        model.zero_grad(set_to_none=True)
        return res

    def grouped_logits(model, groups):
        """World 1's logits of ``first`` run on ``groups`` groups of its
        rows in turn (the witness of a mesh that splits the batch so many
        ways)."""
        n = first.shape[0] // groups
        with torch.no_grad():
            return torch.cat([model(
                first[j:j + n],
                memory=None if memory is None else memory[j:j + n])[0]
                .float() for j in range(0, first.shape[0], n)])

    def teacher_apart(got, want, on):
        """||got - want|| / ||want|| of each, a parameter's gradient
        against its block of world 1's."""
        out = {}
        for k, w in want.items():
            if k in spec_of and on is not None:
                w = w[block_slices(on, w.shape, spec_of[k])]
            out[k] = float((got[k].double() - w.double()).norm()
                           / w.double().norm())
        return out

    def draw(on):
        model = None
        for r in range(mesh.size if on is not None else 0):
            if r == mesh.rank:
                model = transformer.init_params(
                    cfg, torch.Generator(device=dev).manual_seed(0), dev,
                    mesh=on)
                torch.cuda.synchronize()
            dist.barrier()
        if on is None:
            model = transformer.init_params(
                cfg, torch.Generator(device=dev).manual_seed(0), dev)
        with torch.no_grad():
            for blk in model.layers:
                if blk.kind == "cross_attn":
                    blk.attn.gate.fill_(0.5)
        return model

    def run(on, keep=None, nudge=None):
        """On ``on`` (None: world 1), with ``nudge`` (a seed) every weight
        first moved one ulp up or down: ``teacher``, the logits of
        ``first``, and the steps.  Without ``keep`` the teacher's
        results, the logits and ``m`` after each step are returned; with
        it (world 1's) the distances from them are recorded."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        model = draw(on)
        if nudge is not None:
            nudge_(model.parameters(), nudge)
        row = {"metrics": [], "step_ms": [], "m_tree": [], "m_matrix": []}
        ledger = (on or mesh).axis_ledger
        ledger.reset()
        taught = teacher(model, on)
        with torch.no_grad():
            logits = model(first, memory=memory, mesh=on)[0].float()
        if keep is None:
            kept = {"teacher": {1: taught}, "logits": {1: logits}, "m": []}
            for k in {row_groups(m) for m in meshes.values()} - {1}:
                kept["teacher"][k] = teacher(model, None, k)
                kept["logits"][k] = grouped_logits(model, k)
        else:
            kept = None
            k = row_groups(on)
            row["teacher"] = teacher_apart(taught, keep["teacher"][k], on)
            row["logits_err"], row["logits_vs_plain"] = (
                float((logits - want).abs().max() / want.abs().max())
                for want in (keep["logits"][k], keep["logits"][1]))
        del logits, taught
        row["forward_collectives"] = ledger.summary()
        opt = step = None
        if train:
            opt = adamw.init_opt_state(dict(model.named_parameters()))
            step = steps.make_train_step(cfg, tcfg, mesh=on)
        ledger.reset()
        for i, batch in enumerate(batches if train else ()):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            opt, met = step(model, opt, batch)
            ev[1].record()
            ev[1].synchronize()
            row["step_ms"].append(ev[0].elapsed_time(ev[1]))
            row["metrics"].append({k: float(v) for k, v in met.items()})
            if keep is None:
                kept["m"].append({n: t.clone() for n, t in opt["m"].items()})
                continue
            # ||m - world 1's|| over this rank's blocks, of the whole tree
            # (a replicated leaf is on every rank) and of the worst matrix
            # leaf, each relative to world 1's norm there
            d2 = n2 = worst = 0.0
            for n, got in opt["m"].items():
                whole = keep["m"][i][n]
                ref = whole[block_slices(on, whole.shape, spec_of[n])
                            if on is not None else ...].double()
                dd = float((got.double() - ref).pow(2).sum())
                nn = float(ref.pow(2).sum())
                d2, n2 = d2 + dd, n2 + nn
                if ref.dim() >= 2:
                    worst = max(worst, (dd / nn) ** 0.5)
            row["m_tree"].append((d2 / n2) ** 0.5)
            row["m_matrix"].append(worst)
        row["peak_bytes"] = torch.cuda.max_memory_allocated()
        row["param_bytes"] = sum(t.numel() * t.element_size()
                                 for t in model.parameters())
        row["collectives"] = ledger.summary()
        del model, opt, step
        torch.cuda.empty_cache()
        return row, kept

    out = {"full": {}}
    kept = None
    for r in range(mesh.size):
        if r == mesh.rank:
            out["world1"], kept = run(None)
        dist.barrier()
    if mesh.rank == 0:
        # world 1's own floor: its forward and steps on weights nudged one
        # ulp
        out["world1_nudged"], _ = run(None, keep=kept, nudge=1)
    dist.barrier()
    for name, m in meshes.items():
        out["full"][name], _ = run(m, keep=kept)
    del kept
    torch.cuda.empty_cache()
    return out


# -- phase 11 (b): helpers, and the job each rank of its world runs ---------
# (module-level, so that the spawned ranks, which import this file, find
# them)

def _full_width_cfg(arch, layers):
    """``arch`` at full width cut to ``layers`` layers, drawn in the
    compute dtype."""
    import dataclasses
    from repro_torch.configs import get_config
    full = get_config(arch)
    return dataclasses.replace(full, num_layers=layers,
                               param_dtype=full.dtype)


def _set_capacity(moes, factor):
    """Every ``MoEFFN`` of ``moes`` at capacity factor ``factor``."""
    import dataclasses
    for m in moes:
        m.cfg = dataclasses.replace(m.cfg, moe=dataclasses.replace(
            m.cfg.moe, capacity_factor=factor))


def _state_on(state, dev):
    """A decode state of float32 arrays of bf16 values, back on ``dev``."""
    import torch
    return [{n: v if n == "index" else torch.as_tensor(v).to(
        dev, torch.bfloat16) for n, v in layer.items()} for layer in state]


def _combine_in_ep_order(combine, half):
    """``moe._combine`` in the order a (1, 2) expert-parallel decode adds
    a token's expert rows: those of experts below ``half`` (rank 0's) in
    ascending order, those from ``half`` on (rank 1's) likewise, each
    partial ending in zero rows (its other rank's choices, exact), then
    the two partials (the ``psum``)."""
    import torch

    def split(y, slot, ids):
        n = y.shape[0] * y.shape[1]
        cut = half * y.shape[1]
        lo = torch.where(slot < cut, slot, n)
        hi = torch.where((slot >= cut) & (slot < n), slot, n)
        return combine(y, lo, ids) + combine(y, hi, ids)
    return split


def _ep_full_width_rank(mesh, dev, p):
    """One rank of phase 11 (b)'s world: ``arch`` at full width cut to
    ``layers``, drawn from ``seed`` on the card by each rank in turn (a
    draw holds a whole leaf's f32 scratch), this rank's blocks kept.  A
    prefill of ``prompt[:, :2]`` at each factor of ``short_search`` until
    no rank drops a choice (fails if one always does); a prefill of
    ``prompt`` at the config's capacity, then at each factor of
    ``search`` until none drops (dropped choices at each); 12 decode
    steps at the config's capacity from the handed ``state``,
    teacher-forced with the columns of ``decode``; decode ms a step by
    CUDA events (5 samples of 4 steps); init s, peak memory, the
    collective ledger."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.models import steps, transformer
    cfg = _full_width_cfg(p["arch"], p["layers"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = None
    for r in range(mesh.size):
        if r == mesh.rank:
            model = transformer.init_params(
                cfg, torch.Generator(device=dev).manual_seed(p["seed"]), dev,
                mesh=mesh)
            torch.cuda.synchronize()
        dist.barrier()
    row = {"init_s": time.perf_counter() - t0,
           "init_peak_bytes": torch.cuda.max_memory_allocated(),
           "param_bytes": sum(t.numel() * t.element_size()
                              for t in model.parameters())}
    moes = Smoke._moe_layers(model)
    # each MoE call's routing, and (while ``taken`` holds a list) its
    # input, output and ids for the witness
    calls, taken = [], [None]

    def hook(mod, i, o):
        calls.append((mod.stats["ids"].cpu().numpy(),
                      int(mod.stats["dropped"])))
        if taken[0] is not None:
            taken[0].append((i[0].float().cpu().numpy(),
                             o[0].float().cpu().numpy(), calls[-1][0]))
    hooks = [m.register_forward_hook(hook) for m in moes]

    def f32(t):
        return t.float().cpu().numpy()

    def search(prefill, prompt, factors):
        """Prefills at each factor until no rank drops: [[factor,
        dropped over the world], ...] and the last prefill's logits."""
        tried = []
        for factor in factors:
            _set_capacity(moes, factor)
            calls.clear()
            last = prefill(model, prompt)[1]
            n = torch.tensor([sum(c[1] for c in calls)])
            dist.all_reduce(n)
            tried.append([factor, int(n)])
            if not int(n):
                break
        _set_capacity(moes, cfg.moe.capacity_factor)
        return tried, last

    mesh.axis_ledger.reset()
    prompt = torch.as_tensor(p["prompt"]).to(dev)
    b, s = prompt.shape
    short = steps.make_prefill_step(cfg, 2, use_ep=True, mesh=mesh)
    taken[0] = []
    row["short_search"], last = search(short, prompt[:, :2],
                                       p["short_search"])
    row["moe_calls"] = taken[0][-len(moes):]      # the last prefill's
    taken[0] = None
    if row["short_search"][-1][1]:
        raise RuntimeError(f"short prefill: choices drop at every capacity "
                           f"factor of {p['short_search']}")
    row["short_prefill"] = f32(last)
    row["short_ids"] = [c[0] for c in calls]
    prefill = steps.make_prefill_step(cfg, p["capacity"], use_ep=True,
                                      mesh=mesh)
    calls.clear()
    row["config_prefill"] = f32(prefill(model, prompt)[1])
    row["config_prefill_dropped"] = sum(c[1] for c in calls)
    row["search_dropped"], _ = search(prefill, prompt, p["search"])
    decode = steps.make_decode_step(cfg, use_ep=True, mesh=mesh)
    # world 1's no-drop cache, this rank's block of it (its latent columns)
    state = transformer.state_blocks(cfg, _state_on(p["state"], dev), mesh)
    toks = torch.as_tensor(p["decode"]).to(dev)
    calls.clear()
    logits, taken[0] = [], row["moe_calls"]
    for j in range(toks.shape[1]):
        pos = torch.full((b, 1), s + j, dtype=torch.int32, device=dev)
        state, lg = decode(model, state, toks[:, j:j + 1], pos)
        logits.append(f32(lg))
    taken[0] = None
    row["decode"] = np.stack(logits)
    row["ids"] = [c[0] for c in calls]
    row["dropped"] = [c[1] for c in calls]
    row["ledger"] = mesh.axis_ledger.summary()
    for h in hooks:
        h.remove()
    tok, pos = toks[:, :1], torch.full((b, 1), s, dtype=torch.int32,
                                       device=dev)
    times = []
    for _ in range(5):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(4):
            decode(model, state, tok, pos)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / 4)
    row["decode_ms"] = times
    row["peak_bytes"] = torch.cuda.max_memory_allocated()
    del state, model
    torch.cuda.empty_cache()
    return row


def _step_dist(got, want):
    """(loss, grad_norm, m) distances of two ``model`` job results' train
    steps: relative, and each leaf of ``m`` from its max."""
    import numpy as np
    a, b = got["metrics"], want["metrics"]
    return (abs(a["loss"] - b["loss"]) / abs(b["loss"]),
            abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"],
            max(float(np.abs(x - y).max() / (np.abs(y).max() + 1e-30))
                for x, y in zip(_leaves(got["m"]), _leaves(want["m"]))))


def _leaves(tree):
    """A nested dict's leaves, depth first in key order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


if __name__ == "__main__":
    main()
