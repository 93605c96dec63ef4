#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases, in order (any failure exits nonzero and prints no result line):

1. device and build: the card's name and power limit (``nvidia-smi``), the
   process settings (``repro_torch.env.apply()``: cuBLAS's deterministic
   workspace unless the caller set one, TF32 off; ``env.describe()``
   printed), then every CUDA source under ``src/repro_torch/csrc`` compiled
   with ``nvcc`` for sm_90a, one compiler per source, all at once;
2. kernels: each hand-written kernel (DIA, CSR, ELL, SELL, BSR) against its
   plain torch version on the card, at the HPCG 104^3 shapes of the main
   paths (BSR at block size 8) and on ragged cases (empty rows, rectangular
   DIA, offsets outside the matrix, CSR capacity padding, ELL K = 0 and
   clamped columns, SELL ghost lanes and C != 32, BSR empty block rows,
   bs 2/8/16 and K 1/8, NaN in padding that is never read), in float32 and
   bfloat16; bitwise equality over two runs; median times (CUDA events,
   after 0.2 s of warm-up) of the kernel, the plain version and one library
   call computing the same product (``torch.mv`` on a
   ``torch.sparse_csr_tensor``; for BSR ``torch.sparse_bsr_tensor`` at block
   size 8 times x; a yardstick only), beside the least time
   the card could take (bytes over the memory rate, operations over the
   float32 peak); a HYB line (the ELL and CSR kernels composed); CSR's
   long-row schedule at its edges (rows of L and L + 1 entries, CHUNK +- 1,
   a row of 2^20, 100 back-to-back calls on one plan) and on a 2^20-row
   power-law matrix (f32 and bf16: the first call with its plan under
   ``set_sync_debug_mode("error")``, time, bound, plain and library times);
   then the six SpMM kernels (``csr_spmm``, ``csr_spmm_t``, ``ell_spmm``,
   ``ell_spmm_t``, ``sell_spmm``, ``sell_spmm_t``) against their plain
   versions at minitron-8b MLP width (the up and down weights, 4096 <->
   16384 at density 0.25, pruned from numpy seed 0) at T (or K) = 1 and 256
   and on ragged cases (empty rows, NaN capacity padding and ghost lanes,
   ELL K = 0 and clamped columns, C != 32, T in {1, 3, 256}, K in {1, 3, 9,
   256, 300}, an X too wide for a shared-memory tile, a B too wide for one
   256-column tile), in float32 and bfloat16, bitwise reruns, a planted
   fault the check must catch, with their times, bounds, plain times and two
   yardsticks (``torch.sparse_csr_tensor`` times X^T or B, and the dense
   X @ W in float32 without TF32), a HYB SpMM line (ell_spmm + csr_spmm)
   and a token-tile sweep; SELL's slice schedule (sell_spmm at Kb <= 8,
   sell_spmm_t at xt = 0) at width 1 on both weights in both dtypes beside
   its bound, the library call and the dense product, and swept over T in
   {1, 2, 4, 8, 16, 32} and Kb in {1, 2, 4, 8} (checked, with a planted
   fault, timed, with the plan that ran: staged or L1-gathered rhs, the
   cluster split); then csr_spmm_t, ell_spmm_t, sell_spmm_t,
   ell_spmm, csr_spmm and sell_spmm on each of their schedules (the ``xt``
   knob: the old schedule, row or SELL slice, and the token-major one; for
   csr_spmm and sell_spmm also the ``tc`` knob, the dense-tile schedule on
   the tensor cores): each new schedule against the plain version at width
   256 (and 257 on the up weight in float32) on both weights in float32 and
   bfloat16 with a planted fault, and against the old schedule, all timed
   in turns (old, new..., ...new, old) beside the dense X @ W (csr_spmm and
   sell_spmm on both weights, in both dtypes and beside the library call;
   the earlier four on the up weight in float32), a sweep over the width
   (float32, {16, 32, 64, 128, 256}; the earlier kernels around their
   switches, {16, 32, 64}, on the up weight; bfloat16 {64, 128, 256} for
   tc) and the tile, and
   for csr_spmm and sell_spmm a density sweep at width 256 (the up weight
   pruned on the card to 0.05 and 0.01, checked and timed in turns); then
   solver_vec, the solvers' loop kernels (dot, update, direction, finish)
   on 104^3-long vectors against their plain versions in f32 and f64
   (SV_REL * sum|terms|) and in bf16 against an f64 evaluation of the same
   formula (SV_BF16_REL), an inactive iteration writing nothing, 20 reruns
   bitwise, and one CG iteration's vector work timed in a captured graph
   with L2 flushed before each replay, beside its HBM bound and the plain
   sequence;
3. reference check: the port's solve at 16^3 on the card (CUDA kernels)
   against the same solve on the CPU (plain torch path), in every format,
   MG-PCG (uniform CSR levels, and the ml picks) and the distributed solve
   (P = 2 and 4, uniform DIA/COO and Multi-Format ml) the same way;
4. main paths at HPCG's default 104^3 grid, each driven with the launch
   counts set to 0 just before and read just after:
   a. generate_problem -> to_coo on the card -> DynamicMatrix.auto(A, "ml")
      (must pick DIA) -> cg(operator(A)); then activate(CSR) -> cg; after
      the counted run, the host syncs of a solve under
      set_sync_debug_mode("warn") (ceil(iters / K), none in
      cg_fixed_iters) and ms an iteration of the captured block by the
      host clock, device-queued and by the profiler (solver_vec's share
      of it too);
   b. FormatPolicy("profile") over DEFAULT_CANDIDATES (every candidate
      timed through its kernel), the ml pick beside it, cg in the pick;
   c. cg in ELL, SELL, HYB (k=18) and BSR (block_size=8), then one SpMV of
      SELL, HYB and BSR under ``torch.cuda.set_sync_debug_mode("error")``.
   Each solve's kernel launches must equal the SpMVs the device ran. The
   solvers capture their loop (K iterations a block, the first block
   eager) and add a captured graph's launches to the kernels' counts at
   each replay; a counting closure runs in the eager block and once at
   capture, and ``loop_counts`` checks the counts against the device's
   calls (every replay runs the captured calls), with at most K - 1 masked
   iterations past convergence counted apart.
   d. sparse-weight serving at minitron-8b MLP width: LinearSparse.from_dense
      with the ml pick and with the profile pick at ncols 1 and 256 (every
      candidate's time printed), layer(x) and down(up(x)) at T = 1 and 256
      against float64, every weight format (CSR, ELL, SELL, HYB, COO) with
      launches == kernel calls (the token-major schedule's launches counted
      apart and required), agreement and no device->host sync, the
      spmm(W, x.T).T form through csr_spmm, retune(ncols=256) with its
      counters, and spmm(W, B, backend="cuda") in ELL, SELL and HYB through
      their kernels.
   e. the measured route, on a fresh store (``REPRO_TUNING_CACHE``):
      kernel_tune records (iters 3, inner 2) for spmm on the up weight in
      CSR, ELL, SELL and HYB, spmm_t on both weights in CSR, ELL and SELL, at
      widths 1 and 256, and spmv at 104^3 in DIA and CSR; each record
      round-trips, routes ``auto`` to its kernel exactly where it beat the
      reference (bitwise equal to backend="cuda" with its cfg), a width-1
      record never answers width 256, and a planted losing record routes the
      reference; the T = 1 layer call with a cold and a warm store;
      FormatPolicy("cached") miss-then-hit at both widths; LinearSparse built
      by it with backend="auto"; hpcg_solve --tune cached (131 iterations);
      the SpMM profile pick through every kernel.
   f. MG-PCG, with path (a)'s A and b: build_hierarchy(fmt=CSR) (104^3 >
      52^3 > 26^3 > 13^3; the levels, formats and build seconds printed),
      pcg(operator(DIA), apply_M=V-cycle) to 1e-7 (converged, max|x-1| <
      1e-3, at most one iteration above the JAX package's 59 and below CG's
      count, dia_spmv launches = iterations + 1 and csr_spmv launches = the
      hierarchy's 163 SpMVs a V-cycle x V-cycles); the same on the
      FormatPolicy("ml") hierarchy (every kernel format it picks launched as
      often as its SpMVs); a float64 MG-PCG through the plain versions on the
      card (the solve without float32 rounding); Jacobi-PCG for scale; ms per V-cycle by the host
      clock, by CUDA events around the run, and by CUDA events with the
      launches queued behind a spin kernel (the host's share), with the
      profiler's kernel sum; the captured MG-PCG block's ms an iteration;
      one V-cycle under ``set_sync_debug_mode("error")`` and bitwise equal
      to the one before;
      the CSR, SELL and DIA kernels on the hierarchies' color blocks
      (padding rows, x longer than the block) against their plain versions.
      The card's float32 crossings of 1e-3 ... 1e-7, and the float64 solve's,
      must lie within one iteration of the JAX package's own float64 solve
      at 104^3 (MG_JAX_F64_CROSS).
   g. the distributed layer, P shards on the card (path (a)'s problem):
      build_dist_matrix over hpcg.slab_plan at P = 8 (13 z-planes a shard,
      interior/boundary/remote split), uniform DIA/COO, then Multi-Format
      with FormatPolicy("ml") and ("analytic") (each shard's formats
      printed): one dist_spmv against the single-device CSR kernel (max rel
      1e-5), a bitwise rerun under set_sync_debug_mode("error"), CG to 1e-7
      within 2 iterations of path (a)'s DIA count with launches = SpMVs of
      each format, activate_dist(local, CSR) and back; distributed MG-PCG at
      P = 4 (ml; 104^3 > 52^3) below CG's count, launches = SpMVs, within
      one iteration of the same solve through the plain versions, one
      V-cycle within 1e-5 of the plain one, a V-cycle with no sync and
      bitwise; then every candidate variant of every part and shard, and
      every color block of every level and shard of the smoother, through
      its kernel against its plain version (rows mostly empty, rectangular
      halo columns, padding in row 0); ms a dist_spmv (uniform and ml, in
      turns with the single-device DIA kernel), the V-cycle's and a
      dist_spmv's host / device times, the padded CSR parts (the last
      level's color blocks 0 and 7, the P = 8 boundary parts of shards 0
      and 4) against their bounds, the library call and each other, the
      plain COO SpMV three ways (atomic adds, a sort a call, the kept row
      order), the build's phases; the captured blocks' ms an iteration of
      P = 8 uniform CG and P = 4 MG-PCG.
   h. observability (``repro_torch.obs``) at 104^3, after path (e) and on
      its store: (h1) under tracing("full") with the ledger on, the ml pick
      (DIA), CG with backend='auto', a P = 8 Multi-Format build and a
      dist_spmv: the trace holds the select, plan, convert, build, kernel,
      exchange and solver phases, every parent is a recorded span and no
      child starts before it, export_chrome round-trips through
      report.load_trace, the attribution and explain.render print, the
      format.select record says DIA, kernel.route records <= containers
      routed, launches = SpMVs; (h2) path (a)'s CG ms/iter (backend None
      and 'auto') and one CSR V-cycle (host clock, device with launches
      queued) with trace off and the ledger off, trace off and the ledger
      on, summary and full, in turns (launches = SpMVs in every mode); in
      off and summary modes an SpMV, a dist_spmv and a V-cycle with no sync
      (``set_sync_debug_mode("error")`` and ``torch.cuda.synchronize``
      made to raise), bitwise; (h3) explain.run_demo('powerlaw') and its
      trail; (h4) calibrate_gather_penalty() on the card and the
      analytic-calibrated pick beside analytic, ml and profile at 104^3 and
      for every shard of the P = 8 interior, boundary and remote parts (a
      finding: nothing switches to it); (h5) a 12-matrix corpus labelled
      on the card (iters 3) and trained into a temporary tree, with
      default_tree.json's sha256 unchanged.
   i. the dense decoder and the serving engine (``repro_torch.models``,
      ``repro_torch.launch.serve``) at minitron-8b's full width (32 layers,
      d_model 4096, 32 heads over 8 kv heads, head_dim 128, d_ff 16384,
      vocab 256000; random weights from seed 0; no sparse kernel on this
      path, and none may launch): (i1) bf16 params and compute,
      DecodeEngine(slots=4, max_len=1024) serving 8 requests of 64-512
      prompt tokens (numpy seed 0) and 32 new tokens each, every logit
      finite, at least two batched prefills; tokens/s, ms a decode step by
      the host clock and by CUDA events beside its bound (the weights and
      live kv rows over the memory rate), ms a batched prefill with its
      (R, P) bucket beside its bound (bf16 peak), the serve.* p50/p99, peak
      memory; (i2) float32 params: the engine's greedy tokens (batched
      prefill) equal per-token prefill-by-decode's with a float32 cache
      (the JAX engine's bf16 cache reported beside), first logits of
      prefill_cache within LOGIT_REL * max|logit| of the by-decode ones,
      decode_step's logits at every prompt position within the same bound
      of forward(logits_mode='all'); (i3) layer 0's attention block, MLP
      and one decode step over a 64-token cache in float64 against float32
      (WITNESS_REL), the int8 kv_quant step against the float32 cache's
      (INT8_REL); (i4) ``serve.main`` in this process on stablelm-1.6b at
      full size (f32 params, as the CLI makes them).
   j. every remaining family at full width (random weights from seed 0; no
      sparse kernel on this path, and none may launch; the moe ``coo``
      dispatch runs the plain COO SpMM, as in the JAX package): (j1)
      deepseek-moe-16b in bf16 (28 layers, d_model 2048, 64 experts top-6
      + 2 shared, d_ff 1408, vocab 102400; the ``sort`` dispatch),
      DecodeEngine(slots=4, max_len=1024) serving 8 requests of 64-512
      prompt tokens (numpy seed 0) and 32 new tokens each: every request
      done, finite logits, at least two batched prefills; tokens/s, ms a
      decode step (host clock, CUDA events, launches queued, profiler)
      beside its bound (every weight but the input embedding: JAX's decode
      runs all experts on C = 4 slots), ms a prefill by (R, P) beside its
      bound and the share of real-token assignments dropped, peak memory;
      (j2) one MoE layer in f32 on (4, 512) tokens: dense vs sort within
      1e-4, sort vs coo within 1e-6 (JAX's bounds), sort and coo reruns
      bitwise, float64 on the same routing within MOE_F64_REL; (j3)
      deepseek in f32 at 4 layers with capacity factor 2E/k (nothing can
      drop): the batched prefill's greedy tokens equal prefill-by-decode's
      (a difference only where the router's top-k gap is under 1e-5), first
      logits and decode_step vs forward within LOGIT_REL * max|logit|; (j4)
      mamba2-2.7b and zamba2-2.7b in bf16, DecodeEngine(slots=4,
      max_len=256) serving 6 requests of 8-48 prompt tokens, 16 new: every
      request done, finite logits, one by-decode prefill a request;
      tokens/s, ms a step beside its bound (weights but the input
      embedding, the SSM state and conv windows read and written, live kv
      rows), peak memory; (j5) each in f32 at a depth cut (8 and 12 layers):
      teacher-forced decode_step vs forward over 64 tokens, mamba_apply's
      final state vs 64 decode steps', the engine (2 slots, 5 requests,
      slot reuse) vs each request's single-request chain within ENGINE_REL
      * max|logit|, and ssd_chunked at (b, t, h, p, n) = (2, 512, 80, 64,
      128): chunk 256 vs 64 and float64 vs float32; (j6) hubert-xlarge's
      encoder forward on frames (2, 1024, 512) and internvl2-26b in bf16:
      prefill on 256 patches + 256 tokens, 8 decode steps on tokens alone.
   k. training (``repro_torch.launch.train``, ``optim``, ``checkpoint``,
      ``data``; no sparse kernel on this path, and none may launch): (k1)
      stablelm-1.6b at full size (24 layers, d_model 2048, 32 heads, d_ff
      5632, vocab 100352; random weights from seed 0; bf16 compute, f32
      params and AdamW state) through ``launch.train.main`` in this process,
      (4, 2048) tokens from ``SyntheticLM``, remat on, the chunked CE (two
      chunks of 1024), 6 steps: every loss and gradient norm finite; ms a
      step (host clock around a synchronised step, CUDA events), tokens/s,
      peak memory, the share of the bound (4 forwards' FLOPs at the bf16
      peak + AdamW's bytes at the memory rate); (k2) float32 gradients
      against float64: stablelm at full width cut to 2 layers on (2, 512)
      tokens, every leaf (GRAD_F64_REL), remat on against off bitwise under
      deterministic algorithms; flash_attention's dq/dk/dv at (2, 2048, 32,
      64), causal and not, against autograd of the unchunked float64 softmax
      attention (FLASH_F64_REL); one deepseek-moe-16b MoE layer in f32 on
      (4, 512): the dense, sort and coo gradients against each other
      (JAX's forward bounds, * max|g|) and the sort dispatch's on fixed
      routing against float64 (MOE_GRAD_F64_REL); (k3) ``launch.train.main``
      on stablelm --smoke: 8 steps checkpointing every 4, then --resume
      from the step-4 checkpoint alone: 'restoring step 4' and steps 4-7's
      losses bitwise the uninterrupted run's (deterministic algorithms);
      (k4) mamba2-2.7b at full size (64 layers, chunk 256), (2, 1024)
      tokens, 3 steps: every loss and gradient finite (the SSD decay masked
      before exp), ms a step, peak memory; (k5) ``train_moe_sparse`` at the
      example's defaults (200 steps, batch 8, seq 256): the three dispatch
      times and the pick, the loss falls, the example's LEARNING test
      reported beside it.
   l. the launch plumbing (``repro_torch.launch.pipeline``, ``dryrun``,
      ``mesh``, ``sharding``; no sparse kernel on this path, and none may
      launch): (l1) the GPipe schedule at stablelm-1.6b's full width in
      f32 (random weights from seed 0): its 24 layers cut into 4 stages of
      6 by ``stage_params``, each stage ``transformer._attn_block`` over
      its slab, 8 microbatches of (1, 1024) tokens embedded as path (k)
      embeds them; the pipeline's output within PIPE_FWD_TOL * max|y| and
      every block gradient within PIPE_GRAD_REL * max|g| of the serial
      24-layer stack on the same inputs (one batch of 8 rows); ms a
      forward + backward of each and of the serial stack run one
      microbatch at a time (CUDA events, median of PIPE_ITERS after a
      warm-up, in turns), their peak memory, the ticks and the share of
      (stage, microbatch) pairs skipped; (l2) ``python -m
      repro_torch.launch.dryrun --all --mesh both`` in this process on the
      meta device (every cell's line, the skips, the wall time), then
      stablelm-1.6b's f32 params and AdamW state made on the card with
      path (k1)'s calls: the ``memory_allocated`` delta within 1% of the
      dry-run's per-device bytes for params + AdamW state on a (1, 1)
      mesh descriptor (``dryrun.step_args``/``argument_bytes``).

``python3 chip_smoke.py --profile-train`` runs only a ``torch.profiler``
pass over one training step each of (k1) and (k4) (``profile_training``).
``python3 chip_smoke.py --spmm-phase [TREE]`` runs only the build and the
SpMM kernel phase, of this checkout or of the checkout at TREE (its own
``chip_smoke.py`` and ``src/``), so that two trees are read in turns on one
card (``spmm_phase``). ``python3 chip_smoke.py --solver-phase [TREE]``
runs only paths (a), (f) and (g)'s solves at 104^3 with TREE's
``repro_torch``, ms an iteration by the host clock (and the captured
block's readings where TREE's solvers capture), for turns of two trees
(``solver_phase``).

The last three lines of standard output are the kernels' JSON record (all
eleven kernels and solver_vec, launches summed over paths (a)-(l), and
each kernel's launches on its token-major and dense-tile schedules; a
launch captured into a CUDA graph counts at each replay), the
``nvidia-smi`` name/power-limit line, and ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
GRID = (104, 104, 104)  # HPCG's shipped hpcg.dat default local grid
SMALL_GRID = (16, 16, 16)
SEED = 0
TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# The SpMM checks, against the plain version's sum of |products| (``scale``):
# |y_k - y_p| <= atol + sum_rtol * scale + out_rtol * |y_p|. Kernel and plain
# version both multiply exactly in f32 and sum in f32, in other orders:
# sum_rtol covers that reordering (the largest sound reading is far below
# it); out_rtol covers each side's one rounding to the output type: none in
# f32 (2^-24 lies inside sum_rtol), one bf16 ulp (at most 2^-7 |y|) in bf16.
SPMM_TOL = {"float32": dict(atol=1e-4, sum_rtol=1e-4, out_rtol=0.0),
            "bfloat16": dict(atol=0.0, sum_rtol=1e-4, out_rtol=2.0 ** -7)}
# Planted fault of the SpMM checks: the plain version with every FAULT_EVERY-th
# stored entry dropped must read above the limit.
FAULT_EVERY = 64
# Largest reading (|y_k - y_p| / limit) of a sound kernel and smallest of a
# planted fault at the weight shapes, by dtype.
READINGS = {"sound": {}, "fault": {}}
CG_TOL, CG_MAXITER = 1e-7, 500
X_TOL = 1e-3  # max |x - 1|: the reference's own validation threshold
# The four formats of path (c), with the plan hints that make them real work
# at 104^3: HYB's default split (the median row, 27) leaves an empty tail;
# k=18 sends a third of the entries to the CSR tail kernel. BSR's default
# 128-block edge stores 52x the nonzeros; 8 divides 104 (7.6x fill).
NEW_FORMATS = (("ELL", {}), ("SELL", {}), ("HYB", {"k": 18}), ("BSR", {"block_size": 8}))
KERNELS_OF = {"DIA": ("dia_spmv",), "CSR": ("csr_spmv",), "ELL": ("ell_spmv",),
              "SELL": ("sell_spmv",), "HYB": ("ell_spmv", "csr_spmv"),
              "BSR": ("bsr_spmm",), "COO": ()}

# Data-sheet peaks by card: (memory bytes/s, float32 non-tensor FLOP/s).
PEAKS = {"H100 PCIe": (2.0e12, 51e12), "H100 NVL": (3.9e12, 60e12),
         "H200": (4.8e12, 67e12), "H100": (3.35e12, 67e12)}


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    print(f"  [{'ok' if ok else 'FAIL'}] {what}", flush=True)
    if not ok:
        raise SmokeFailure(what)


def peaks_for(name: str):
    for key, val in PEAKS.items():  # most specific keys first
        if key in name:
            return key, val
    raise SmokeFailure(f"no data-sheet peaks for card {name!r}")


SMI = [""]  # the nvidia-smi name and power-limit line, once main() has read it
WARMUP_S = 0.2  # launch-and-sync this long before timing, so clocks settle


def time_ms(fn, iters: int, warmup_s: float = WARMUP_S) -> float:
    """Median milliseconds of ``fn`` on the current stream (CUDA events),
    after at least 3 calls and ``warmup_s`` seconds of warm-up."""
    import torch
    t0, calls = time.perf_counter(), 0
    while calls < 3 or time.perf_counter() - t0 < warmup_s:
        fn()
        torch.cuda.synchronize()
        calls += 1
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(iters)]
    for s, e in ev:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def spmm_reading(y, y_p, scale, dtype_name) -> float:
    """max |y - y_p| / limit under ``SPMM_TOL``: at most 1 passes."""
    tol = SPMM_TOL[dtype_name]
    diff = (y.float() - y_p.float()).abs()
    limit = tol["atol"] + tol["sum_rtol"] * scale.float() + tol["out_rtol"] * y_p.float().abs()
    return float((diff / limit.clamp_min(1e-30)).max()) if y.numel() else 0.0


def compare(name, y_k, y_k2, y_p, dtype_name, scale=None, record=False):
    """Kernel vs plain within the stated tolerance, and bitwise stability.

    With ``scale`` (the plain version on |values| and |rhs|: each output's
    sum of |products|) the SpMM rule ``SPMM_TOL`` holds: two float32 sums of
    the same k products in different orders differ by up to about
    k * 2^-24 * scale, so for the 1024- and 4096-term rows of the sparse
    weights an output near zero is compared at the scale of its terms, and
    a bf16 output at one rounding of its own size. csr_spmv's long rows (up
    to 2^20 terms) are held so too: the plain version sums a row with
    ``index_add_``, whose order on the card changes from run to run, so its
    own f32 total of a cancelling row moves by more than 1e-4 of |y|.
    ``record`` keeps the reading for the summary of the weight-shape checks."""
    import torch
    torch.cuda.synchronize()
    check(y_k.shape == y_p.shape and bool(torch.isfinite(y_k).all()),
          f"{name} {dtype_name}: finite, shape {tuple(y_k.shape)}")
    err = float((y_k.float() - y_p.float()).abs().max()) if y_k.numel() else 0.0
    if scale is None:
        tol = TOL[dtype_name]
        ok = bool(torch.allclose(y_k.float(), y_p.float(), **tol))
        how = f"(rtol={tol['rtol']}, atol={tol['atol']})"
    else:
        tol = SPMM_TOL[dtype_name]
        reading = spmm_reading(y_k, y_p, scale, dtype_name)
        ok = reading <= 1.0
        how = (f"reading {reading:.3e} of the limit atol={tol['atol']} + "
               f"{tol['sum_rtol']} * sum|products| (up to {float(scale.max()):.1f}) + "
               f"{tol['out_rtol']:.4g} * |y|")
        if record:
            READINGS["sound"][dtype_name] = max(READINGS["sound"].get(dtype_name, 0.0),
                                                reading)
    check(ok, f"{name} {dtype_name}: max_abs_err={err:.3e} vs plain, {how}")
    check(torch.equal(y_k, y_k2), f"{name} {dtype_name}: bitwise equal over two runs")
    return err


def phase_build():
    from repro_torch.kernels import _build
    print("== build", flush=True)
    t0 = time.perf_counter()
    logs = _build.build_all()
    dt = time.perf_counter() - t0
    for name, log in logs.items():
        regs = sorted({ln.split("Used ")[1].split(",")[0] for ln in log.splitlines()
                       if "Used " in ln})
        print(f"  {name}: ptxas {'; '.join(regs)}")
    print(f"  built {sorted(logs)} in {dt:.2f} s")


def _rand(rng, torch, shape, dtype):
    return torch.from_numpy(rng.standard_normal(shape).astype("float32")).to("cuda", dtype)


def ragged_cases(rng, torch, dtype):
    """Small inputs at the edges of each kernel's contract."""
    from repro_torch.kernels import csr_spmv as kc, dia_spmv as kd
    from repro_torch.kernels.ref import csr_spmv_ref, dia_spmv_ref
    dev = "cuda"
    name = "float32" if dtype == torch.float32 else "bfloat16"
    # DIA: rectangular (M > N and M < N), offsets outside the matrix,
    # table entries outside the matrix left non-zero (the kernel must mask).
    for m, n, offs in ((1000, 700, [-1200, -5, 0, 3, 699, 800]),
                       (300, 1100, [-299, -1, 0, 1, 500, 1099, 1100]),
                       (1, 1, [0])):
        o = torch.tensor(offs, dtype=torch.int32, device=dev)
        d = torch.from_numpy(rng.standard_normal((len(offs), m)).astype("float32")).to(dev, dtype)
        x = torch.from_numpy(rng.standard_normal(n).astype("float32")).to(dev, dtype)
        compare(f"dia_spmv ragged {m}x{n} ndiag={len(offs)}",
                kd.dia_spmv(o, d, x, n), kd.dia_spmv(o, d, x, n),
                dia_spmv_ref(o, d, x, n), name)
    # CSR: empty rows (first, middle, last), one long row, capacity padding
    # past indptr[-1] filled with NaN (must never be read), every width.
    lens = [0, 3, 0, 0, 700, 1, 27, 0, 64, 0]
    m, n = len(lens), 900
    nnz = sum(lens)
    indptr = torch.tensor([0] + list(itertools.accumulate(lens)),
                          dtype=torch.int32, device=dev)
    cap = nnz + 37
    idx = torch.from_numpy(rng.integers(0, n, cap).astype("int32")).to(dev)
    val = torch.from_numpy(rng.standard_normal(cap).astype("float32")).to(dev, dtype)
    val[nnz:] = float("nan")
    x = torch.from_numpy(rng.standard_normal(n).astype("float32")).to(dev, dtype)
    y_p = csr_spmv_ref(indptr, idx, val, x, m)
    for vec in kc.VEC_WIDTHS:
        compare(f"csr_spmv ragged m={m} cap={cap} vec={vec}",
                kc.csr_spmv(indptr, idx, val, x, m, vec=vec),
                kc.csr_spmv(indptr, idx, val, x, m, vec=vec), y_p, name)
    long_row_cases(rng, torch, dtype, name)
    ragged_menu_cases(rng, torch, dtype, name)


def long_row_cases(rng, torch, dtype, name):
    """csr_spmv at the edges of its long-row schedule, every width: rows of
    exactly L and L + 1 entries (L = LONG_STEPS * vec: one-entry rows keep
    the average row below L / LONG_OVER_AVG), k * CHUNK +- 1, a row of 2^20
    entries, NaN capacity past indptr[-1]; 100 back-to-back calls on one
    plan launch 100 times, give the same bits and leave the arrival counters
    at 0; a second plan built for the call gives them too. Held against the
    plain version at each row's sum of |products| (``compare``'s scale)."""
    from repro_torch.kernels import csr_spmv as kc
    from repro_torch.kernels.ref import csr_spmv_ref
    n, pad = 5000, 37
    for vec in kc.VEC_WIDTHS:
        L, C = kc.LONG_STEPS * vec, kc.CHUNK
        lens = [0, L, L + 1, 0, L - 1, C - 1, C, C + 1, 2 * C - 1, 2 * C, 2 * C + 1, 1, 0,
                5 * C + 3, 1 << 20, 3, 0]
        a = L // kc.LONG_OVER_AVG
        lens += [1] * max(0, -(-(sum(lens) + pad - a * len(lens)) // (a - 1)))
        m, nnz = len(lens), sum(lens)
        ip = torch.tensor([0] + list(itertools.accumulate(lens)), dtype=torch.int32,
                          device="cuda")
        cap = nnz + pad
        ix = torch.from_numpy(rng.integers(-3, n + 3, cap).astype("int32")).cuda()
        val = _rand(rng, torch, cap, dtype)
        val[nnz:] = float("nan")
        x = _rand(rng, torch, n, dtype)
        plan = kc.long_row_plan(ip, cap, vec)
        check(plan.threshold == L, f"csr_spmv long rows vec={vec}: rows above {L} are long")
        before = kc.launches
        ys = [kc.csr_spmv(ip, ix, val, x, m, vec=vec, plan=plan) for _ in range(100)]
        torch.cuda.synchronize()
        check(kc.launches - before == 100 and all(torch.equal(ys[0], y) for y in ys[1:])
              and not bool(plan.arrive.any()),
              f"csr_spmv long rows vec={vec} {name}: 100 calls on one plan, 100 launches, the "
              f"same bits, arrival counters back at 0")
        compare(f"csr_spmv long rows vec={vec} (L={L}, chunks of {C}, a row of 2^20, m={m})",
                ys[0], kc.csr_spmv(ip, ix, val, x, m, vec=vec), csr_spmv_ref(ip, ix, val, x, m),
                name, scale=csr_spmv_ref(ip, ix, val.abs(), x.abs(), m))


# csr_spmv's power-law input (kernels/csr_spmv.py's long-row schedule): M = N
# = 2^20, row lengths 1 + floor(pareto(1.5) * 4) capped at 65,536, columns
# uniform and unique within a row, values standard normal, from SEED.
POWERLAW_M = 1 << 20
POWERLAW_LONGEST = 65536
# csr_spmv's readings beside the 104^3 one (the power-law input, path (g)'s
# padded parts), in its record of the kernels line under "readings".
CSR_READINGS = {}


def powerlaw_csr_np(np, seed, m, longest):
    """(indptr, indices, values) of the power-law CSR, made with numpy."""
    rng = np.random.default_rng(seed)
    lens = np.minimum(1 + np.floor(rng.pareto(1.5, m) * 4).astype(np.int64), longest)
    indptr = np.concatenate([[0], np.cumsum(lens)])
    nnz = int(indptr[-1])
    rows = np.repeat(np.arange(m, dtype=np.int64), lens)
    cols = rng.integers(0, m, nnz)
    while True:  # redraw the columns a row repeats until none does
        key = rows * m + cols
        order = np.argsort(key, kind="stable")
        keys = key[order]
        dup = np.zeros(nnz, bool)
        dup[order[1:]] = keys[1:] == keys[:-1]
        if not dup.any():
            break
        cols[dup] = rng.integers(0, m, int(dup.sum()))
    return (indptr.astype(np.int32), (keys - rows * m).astype(np.int32),
            rng.standard_normal(nnz).astype(np.float32))


def powerlaw_readings(torch, np, peak_bw, peak_flops):
    """csr_spmv on the power-law CSR in f32 and bf16 through the container
    route: its first call under set_sync_debug_mode("error") (the plan is
    built there), against the plain version, its time beside its bound, the
    plain version's and torch.sparse_csr_tensor @ x's."""
    from repro_torch.core.formats import CSR
    from repro_torch.kernels import csr_spmv as kc
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.ref import csr_spmv_ref
    t0 = time.perf_counter()
    indptr, idx, val = powerlaw_csr_np(np, SEED, POWERLAW_M, POWERLAW_LONGEST)
    m = n = POWERLAW_M
    nnz, lens = int(indptr[-1]), np.diff(indptr)
    ip, ix = torch.from_numpy(indptr).cuda(), torch.from_numpy(idx).cuda()
    v32 = torch.from_numpy(val).cuda()
    x32 = torch.from_numpy(np.random.default_rng(SEED + 1).standard_normal(n)
                           .astype(np.float32)).cuda()
    print(f"  power-law CSR {m}x{n}: {nnz} entries, rows of 1 + floor(pareto(1.5) * 4) up to "
          f"{POWERLAW_LONGEST} (longest {int(lens.max())}), made on the host in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        name = "float32" if dtype == torch.float32 else "bfloat16"
        v, x = v32.to(dtype), x32.to(dtype)
        A = CSR(ip, ix, v, shape=(m, n), nnz=nnz)
        vec = kops.default_config(A)["vec"]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            y1 = kops.csr_spmv(A, x)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        plan = kops.csr_plan(A, vec)
        nlong, nchunks = int((lens > plan.threshold).sum()), int(plan.chunk_end[-1])
        before = kc.launches
        y2 = kops.csr_spmv(A, x)
        check(kc.launches - before == 1, f"csr_spmv power-law {name}: one launch a call")
        err = compare(f"csr_spmv power-law vec={vec} ({nlong} rows above {plan.threshold} "
                      f"entries, {nchunks} chunks; the first call, plan included, under "
                      f"set_sync_debug_mode('error'))", y1, y2, csr_spmv_ref(ip, ix, v, x, m),
                      name, scale=csr_spmv_ref(ip, ix, v.abs(), x.abs(), m))
        ms = time_ms(lambda: kops.csr_spmv(A, x), 100)
        plain_ms = time_ms(lambda: csr_spmv_ref(ip, ix, v, x, m), 10)
        plan_ms = time_ms(lambda: kc.long_row_plan(ip, nnz, vec), 20)
        lib_ms, lib_note = None, ""
        try:
            lib = torch.sparse_csr_tensor(ip, ix, v, size=(m, n))
            lib_ms = time_ms(lambda: torch.mv(lib, x), 100)
        except (RuntimeError, NotImplementedError) as e:
            lib_note = f" ({type(e).__name__}: {str(e).splitlines()[0][:80]})"
        es = x.element_size()
        nbytes = (m + 1) * 4 + nnz * (4 + es) + n * es + m * es
        t_bytes, t_ops = nbytes / peak_bw * 1e3, 2 * nnz / peak_flops * 1e3
        bound = max(t_bytes, t_ops)
        lib_s = f"{lib_ms:.4f} ms" if lib_ms is not None else "n/a" + lib_note
        print(f"  csr_spmv power-law {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library torch.sparse_csr_tensor @ x {lib_s}, bound {bound:.4f} ms "
              f"({nbytes / 1e6:.1f} MB) -> {bound / ms:.1%} of bound; the plan built apart "
              f"{plan_ms:.4f} ms", flush=True)
        CSR_READINGS[f"powerlaw_{name}"] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": lib_ms,
            "max_abs_err": err, "plan_ms": plan_ms, "vec": vec, "long_rows": nlong,
            "chunks": nchunks}


def _ragged_dense(rng, m, n):
    """Random rows of 1..3n/4 entries, every fifth row empty."""
    import numpy as np
    a = np.zeros((m, n), np.float32)
    for i in range(m):
        if i % 5:
            ln = int(rng.integers(1, 3 * n // 4))
            a[i, rng.choice(n, ln, replace=False)] = rng.standard_normal(ln)
    return a


def ragged_menu_cases(rng, torch, dtype, name):
    """ELL, SELL, BSR and the HYB tail at the edges of their contracts."""
    import numpy as np
    from repro_torch.core.convert import convert
    from repro_torch.core.formats import COO, HYB, Format, coo_from_dense_np
    from repro_torch.kernels import bsr_spmm as kb, ell_spmv as ke, sell_spmv as ks
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.ref import bsr_spmm_ref, ell_spmv_ref, sell_spmv_ref
    # ELL: K = 0 (zeros, no launch), one shared-memory chunk, several chunks,
    # columns past both edges (clamped), rows of padding only.
    for m, n, k in ((300, 250, 0), (300, 250, 27), (257, 90, 70)):
        cols = rng.integers(-3, n + 3, (m, k)).astype(np.int32)
        vals = rng.standard_normal((m, k)).astype(np.float32)
        cols[::7], vals[::7] = -1, 0.0
        c_t = torch.from_numpy(cols).cuda()
        v_t = torch.from_numpy(vals).to("cuda", dtype)
        x = _rand(rng, torch, n, dtype)
        before = ke.launches
        y1, y2 = ke.ell_spmv(c_t, v_t, x), ke.ell_spmv(c_t, v_t, x)
        check(ke.launches - before == (2 if k else 0),
              f"ell_spmv K={k}: {ke.launches - before} launches for 2 calls")
        compare(f"ell_spmv ragged {m}x{n} K={k}", y1, y2, ell_spmv_ref(c_t, v_t, x), name)
    # SELL: 301 rows (ghost lanes in the last slice, holding NaN), empty rows,
    # C = 32, 8 and 5.
    m, n = 301, 120
    a = _ragged_dense(rng, m, n)
    for c, sigma in ((32, 256), (8, 16), (5, 5)):
        S = convert(coo_from_dense_np(a, device="cpu"), Format.SELL, c=c, sigma=sigma)
        data = S.data.clone()
        ptrs, perm = S.slice_ptrs.tolist(), S.perm.tolist()
        for lane, row in enumerate(perm):
            if row >= m:
                s, r = divmod(lane, c)
                data[ptrs[s] + r:ptrs[s + 1]:c] = float("nan")
        check(max(perm) == m, f"sell C={c}: the case has ghost lanes")
        args = [t.cuda() for t in (S.slice_ptrs, S.cols, data.to(dtype), S.perm)]
        x = _rand(rng, torch, n, dtype)
        compare(f"sell_spmv ragged m={m} C={c} sigma={sigma} (NaN ghost lanes)",
                ks.sell_spmv(*args, x, m, c), ks.sell_spmv(*args, x, m, c),
                sell_spmv_ref(*args, x, m, c), name)
    # BSR: first and last block rows empty, one block column past the edge
    # (clamped), 3 capacity blocks of NaN past indptr[-1].
    for bs, ncols in itertools.product((2, 8, 16), (1, 8)):
        mb, nbc = 9, 6
        lens = [0] + [int(v) for v in rng.integers(0, 5, mb - 2)] + [0]
        nblk = sum(lens)
        indptr = torch.tensor([0] + list(itertools.accumulate(lens)), dtype=torch.int32,
                              device="cuda")
        bcol_np = rng.integers(0, nbc, nblk + 3).astype(np.int32)
        bcol_np[0] = nbc + 2
        bcol = torch.from_numpy(bcol_np).cuda()
        blocks = _rand(rng, torch, (nblk + 3, bs, bs), dtype)
        blocks[nblk:] = float("nan")
        B = _rand(rng, torch, (nbc * bs, ncols), dtype)
        y1 = kb.bsr_spmm(indptr, bcol, blocks, B, mb * bs)
        compare(f"bsr_spmm ragged bs={bs} K={ncols} (empty block rows, NaN padding)",
                y1, kb.bsr_spmm(indptr, bcol, blocks, B, mb * bs),
                bsr_spmm_ref(indptr, bcol, blocks, B, mb * bs), name)
        check(not bool(y1[:bs].any()), f"bsr_spmm bs={bs}: empty block row writes zeros")
    # HYB: tail padding with row id M and NaN values sorts past indptr[M].
    m, n = 64, 40
    a = _ragged_dense(rng, m, n)
    H = convert(coo_from_dense_np(a, device="cuda", dtype=dtype), Format.HYB, k=3)
    pad = 5
    t = H.coo
    coo = COO(torch.cat([t.row, torch.full((pad,), m, dtype=torch.int32, device="cuda")]),
              torch.cat([t.col, torch.zeros(pad, dtype=torch.int32, device="cuda")]),
              torch.cat([t.data, torch.full((pad,), float("nan"), dtype=dtype,
                                            device="cuda")]), t.shape, t.nnz + pad)
    Hp = HYB(H.ell, coo, H.shape, H.nnz)
    x = _rand(rng, torch, n, dtype)
    compare(f"hyb (ell_spmv + csr_spmv tail) ragged m={m} k=3 (NaN tail padding)",
            kops.hyb_spmv(Hp, x), kops.hyb_spmv(Hp, x), hyb_plain(H, x), name)


def hyb_plain(H, x):
    """The plain versions of HYB's two kernels, composed as the kernels are."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.ref import csr_spmv_ref, ell_spmv_ref
    m = H.shape[0]
    return ell_spmv_ref(H.ell.cols, H.ell.data, x) + csr_spmv_ref(*kops.tail_csr(H.coo, m),
                                                                   x, m)


def sweep_launch_geometry(kname, dia, csr, x, m, n):
    """Median times over the launch knobs at the 104^3 shapes (information
    for tuning; the main path uses ``kernels.ops.default_config``)."""
    from repro_torch.kernels import csr_spmv as kc, dia_spmv as kd
    if kname == "dia_spmv":
        knobs = {f"block={b}": (lambda b=b: kd.dia_spmv(dia.offsets, dia.data, x, n, block=b))
                 for b in (128, 256, 512, 1024)}
    else:
        plans = {v: kc.long_row_plan(csr.indptr, csr.capacity, v) for v in kc.VEC_WIDTHS}
        knobs = {f"vec={v}": (lambda v=v: kc.csr_spmv(csr.indptr, csr.indices, csr.data, x, m,
                                                      vec=v, plan=plans[v]))
                 for v in kc.VEC_WIDTHS}
    times = ", ".join(f"{k} {time_ms(fn, 50):.4f}" for k, fn in knobs.items())
    print(f"  {kname} float32 launch-geometry sweep (ms): {times}", flush=True)


def _bsr_library(torch, bsr, x32):
    """``torch.sparse_bsr_tensor(...) @ x`` where this torch runs it on the
    card: (ms, None), else (None, the error)."""
    try:
        lib = torch.sparse_bsr_tensor(bsr.indptr, bsr.indices, bsr.data, size=bsr.shape)
        y = lib @ x32[:, None]
        torch.cuda.synchronize()
        if y.shape != (bsr.shape[0], 1):
            return None, f"shape {tuple(y.shape)}"
        return time_ms(lambda: lib @ x32[:, None], 50), None
    except (RuntimeError, NotImplementedError) as e:
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"


def phase_kernels(torch, np, prob, peak_bw, peak_flops):
    """Kernel vs plain at the main paths' shapes; returns the JSON records."""
    from repro_torch.core import hpcg
    from repro_torch.core.dynamic import DynamicMatrix
    from repro_torch.core.formats import Format
    from repro_torch.kernels import bsr_spmm as kb, csr_spmv as kc, dia_spmv as kd
    from repro_torch.kernels import ell_spmv as ke, sell_spmv as ks
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.ref import (bsr_spmm_ref, csr_spmv_ref, dia_spmv_ref,
                                         ell_spmv_ref, sell_spmv_ref)

    print(f"== kernels at {'x'.join(map(str, GRID))} and ragged shapes", flush=True)
    rng = np.random.default_rng(SEED)
    A = hpcg.to_coo(prob, device="cuda")
    D = DynamicMatrix(A)
    dia = D.activate(Format.DIA).concrete
    csr = D.activate(Format.CSR).concrete
    ell = D.activate(Format.ELL).concrete
    sell = D.activate(Format.SELL).concrete
    bsr = D.activate(Format.BSR, block_size=8).concrete
    hyb = D.activate(Format.HYB, k=18).concrete
    del A, D
    m, n = dia.shape
    bs = bsr.block_size
    print(f"  containers: ELL K={ell.k}, SELL C={sell.c} capacity={sell.capacity}, "
          f"BSR bs={bs} blocks={bsr.nblocks}, HYB k={hyb.k} tail={hyb.coo.nnz}", flush=True)
    x32 = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()
    cfg_csr = kops.default_config(csr)
    plan_csr = kc.long_row_plan(csr.indptr, csr.capacity, cfg_csr["vec"])  # the cached one's
    lib = torch.sparse_csr_tensor(csr.indptr, csr.indices, csr.data, size=csr.shape)
    bsr_lib_ms, bsr_lib_err = _bsr_library(torch, bsr, x32)
    print(f"  library torch.sparse_bsr_tensor @ x f32: "
          f"{f'{bsr_lib_ms:.4f} ms' if bsr_lib_ms is not None else '— (' + bsr_lib_err + ')'}",
          flush=True)
    records = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = "float32" if dtype == torch.float32 else "bfloat16"
        x = x32.to(dtype)
        d_data, c_data = dia.data.to(dtype), csr.data.to(dtype)
        e_data, s_data, b_data = ell.data.to(dtype), sell.data.to(dtype), bsr.data.to(dtype)
        es = x.element_size()
        xb = x[:, None]

        def run_dia():
            return kd.dia_spmv(dia.offsets, d_data, x, n)

        def plain_dia():
            return dia_spmv_ref(dia.offsets, d_data, x, n)

        def run_csr():
            return kc.csr_spmv(csr.indptr, csr.indices, c_data, x, m, vec=cfg_csr["vec"],
                               plan=plan_csr)

        def plain_csr():
            return csr_spmv_ref(csr.indptr, csr.indices, c_data, x, m)

        def run_ell():
            return ke.ell_spmv(ell.cols, e_data, x)

        def plain_ell():
            return ell_spmv_ref(ell.cols, e_data, x)

        def run_sell():
            return ks.sell_spmv(sell.slice_ptrs, sell.cols, s_data, sell.perm, x, m, sell.c)

        def plain_sell():
            return sell_spmv_ref(sell.slice_ptrs, sell.cols, s_data, sell.perm, x, m, sell.c)

        def run_bsr():
            return kb.bsr_spmm(bsr.indptr, bsr.indices, b_data, xb, m)

        def plain_bsr():
            return bsr_spmm_ref(bsr.indptr, bsr.indices, b_data, xb, m)

        errs = {
            "dia_spmv": compare("dia_spmv 104^3", run_dia(), run_dia(), plain_dia(), name),
            "csr_spmv": compare(f"csr_spmv 104^3 vec={cfg_csr['vec']}", run_csr(), run_csr(),
                                plain_csr(), name),
            "ell_spmv": compare(f"ell_spmv 104^3 K={ell.k}", run_ell(), run_ell(),
                                plain_ell(), name),
            "sell_spmv": compare(f"sell_spmv 104^3 C={sell.c}", run_sell(), run_sell(),
                                 plain_sell(), name),
            "bsr_spmm": compare(f"bsr_spmm 104^3 bs={bs} K=1", run_bsr(), run_bsr(),
                                plain_bsr(), name),
        }
        ragged_cases(rng, torch, dtype)

        # the least time: bytes each input read once and y written once, or
        # the multiply-adds these inputs need at the float32 peak. Only the
        # nnz live entries count (a value each, and a column index where the
        # format keeps one per entry), with the format's row, slice or block
        # index arrays: the padding of DIA, ELL and SELL and BSR's fill are
        # the format's cost, not the product's.
        xy = n * es + m * es
        nnz = csr.nnz
        rows = [
            ("dia_spmv", run_dia, plain_dia, dia.ndiag * 4 + nnz * es + xy, 2 * nnz,
             "src/repro_torch/csrc/dia_spmv.cu", "src/repro/kernels/dia_spmv.py:50"),
            ("csr_spmv", run_csr, plain_csr, (m + 1) * 4 + nnz * (4 + es) + xy, 2 * nnz,
             "src/repro_torch/csrc/csr_spmv.cu", "src/repro/kernels/csr_spmv.py:103"),
            ("ell_spmv", run_ell, plain_ell, nnz * (4 + es) + xy, 2 * nnz,
             "src/repro_torch/csrc/ell_spmv.cu", "src/repro/kernels/ell_spmv.py:65"),
            ("sell_spmv", run_sell, plain_sell,
             nnz * (4 + es) + sell.perm.numel() * 4 + (sell.nslices + 1) * 4 + xy, 2 * nnz,
             "src/repro_torch/csrc/sell_spmv.cu", "src/repro/kernels/sell_spmv.py:77"),
            ("bsr_spmm", run_bsr, plain_bsr,
             nnz * es + bsr.nblocks * 4 + (m // bs + 1) * 4 + xy, 2 * nnz,
             "src/repro_torch/csrc/bsr_spmm.cu", "src/repro/kernels/bsr_spmm.py:52"),
        ]
        for kname, run, plain, nbytes, nops, src, repl in rows:
            ms = time_ms(run, 100)
            plain_ms = time_ms(plain, 20)
            # the library call of the same product: torch.sparse_bsr_tensor @ x
            # for BSR (bs = 8), torch.mv on the CSR tensor for the others
            lib_ms = None
            if dtype == torch.float32:
                lib_ms = bsr_lib_ms if kname == "bsr_spmm" else time_ms(
                    lambda: torch.mv(lib, x32), 100)
            t_bytes, t_ops = nbytes / peak_bw * 1e3, nops / peak_flops * 1e3
            bound = max(t_bytes, t_ops)
            lib_s = f"{lib_ms:.4f}" if lib_ms is not None else "n/a"
            if kname == "bsr_spmm" and dtype == torch.float32:
                lib_s += f" (BSR; the CSR call {time_ms(lambda: torch.mv(lib, x32), 100):.4f})"
            print(f"  {kname} {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"library {lib_s} ms, bound {bound:.4f} ms "
                  f"({nbytes / 1e6:.1f} MB, {nops / 1e6:.1f} Mop) -> "
                  f"{bound / ms:.1%} of bound, {nbytes / ms / 1e6:.0f} GB/s", flush=True)
            if dtype == torch.float32:
                if kname in ("dia_spmv", "csr_spmv"):
                    sweep_launch_geometry(kname, dia, csr, x, m, n)
                records[kname] = {
                    "name": kname, "route": "cuda", "source": src, "replaces": repl,
                    "launches": 0, "max_abs_err": errs[kname], "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound,
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "library_ms": lib_ms}
            else:
                records[kname]["max_abs_err_bf16"] = errs[kname]
        hyb_line(torch, hyb, x, es, m, peak_bw, name)
    powerlaw_readings(torch, np, peak_bw, peak_flops)
    return records


def hyb_line(torch, hyb, x, es, m, peak_bw, name):
    """HYB has no kernel of its own: the ELL kernel over the regular planes
    plus the CSR kernel over the tail, after the tail's sort on the card."""
    from repro_torch.core.formats import COO, ELL, HYB
    from repro_torch.kernels import ops as kops
    H = HYB(ELL(hyb.ell.cols, hyb.ell.data.to(x.dtype), hyb.shape, hyb.nnz),
            COO(hyb.coo.row, hyb.coo.col, hyb.coo.data.to(x.dtype), hyb.shape, hyb.coo.nnz),
            hyb.shape, hyb.nnz)
    compare(f"hyb_spmv 104^3 k={hyb.k}", kops.hyb_spmv(H, x), kops.hyb_spmv(H, x),
            hyb_plain(H, x), name)
    tail = kops.tail_csr(H.coo, m)
    vec = kops.default_config(H)["csr"]["vec"]
    plan = kops._csr.long_row_plan(tail[0], tail[2].shape[0], vec)
    parts = {"whole": lambda: kops.hyb_spmv(H, x),
             "ell part": lambda: kops.ell_spmv(H.ell, x),
             "tail sort+indptr": lambda: kops.tail_csr(H.coo, m),
             "tail long-row plan": lambda: kops._csr.long_row_plan(tail[0], tail[2].shape[0],
                                                                   vec),
             "csr tail": lambda: kops._csr.csr_spmv(*tail, x, m, vec=vec, plan=plan)}
    times = {k: time_ms(fn, 50) for k, fn in parts.items()}
    ell_b = (hyb.nnz - hyb.coo.nnz) * (4 + es)
    tail_b = hyb.coo.nnz * (4 + es) + (m + 1) * 4
    bound = (ell_b + tail_b + 3 * m * es) / peak_bw * 1e3
    print(f"  hyb {name} (k={hyb.k}, tail {hyb.coo.nnz} entries): "
          + ", ".join(f"{k} {t:.4f} ms" for k, t in times.items())
          + f"; two-kernel bound {bound:.4f} ms (live entries: ELL part "
            f"{ell_b / 1e6:.1f} MB + tail {tail_b / 1e6:.1f} MB + x, y)", flush=True)


def phase_reference(torch):
    """The card's solve at 16^3 against the same solve on the CPU."""
    from repro_torch.hpcg_solve import run
    print(f"== reference check at {'x'.join(map(str, SMALL_GRID))}", flush=True)
    for fmt, hints in (("auto", {}), ("CSR", {}), ("ELL", {}), ("SELL", {}),
                       ("HYB", {"ell_k": 18}), ("BSR", {"block_size": 8})):
        g = run(SMALL_GRID, fmt, device="cuda", tol=CG_TOL, maxiter=CG_MAXITER, **hints)
        c = run(SMALL_GRID, fmt, device="cpu", tol=CG_TOL, maxiter=CG_MAXITER, **hints)
        print(f"  {fmt}: card {g['format']} {g['iters']} iters err {g['err']:.2e}; "
              f"cpu {c['format']} {c['iters']} iters err {c['err']:.2e}")
        check(g["format"] == c["format"], f"{fmt}: same format on card and cpu")
        # f32 reductions in another order can move the stopping test by one step
        check(abs(g["iters"] - c["iters"]) <= 1, f"{fmt}: iterations within 1")
        check(g["passed"] and c["passed"], f"{fmt}: max|x-1| < {X_TOL} on both")
    for fmt in ("CSR", "auto"):  # MG-PCG: uniform CSR levels, and the ml picks
        g = run(SMALL_GRID, fmt, device="cuda", tol=CG_TOL, maxiter=CG_MAXITER, precond="mg")
        c = run(SMALL_GRID, fmt, device="cpu", tol=CG_TOL, maxiter=CG_MAXITER, precond="mg")
        print(f"  MG-PCG {fmt}: card {g['iters']} iters err {g['err']:.2e} "
              f"(hierarchy {g['hier_s']:.2f} s); cpu {c['iters']} iters err {c['err']:.2e}; "
              f"levels {[(lev['A'], lev['colors'][0]) for lev in g['levels']]}")
        check(g["levels"] == c["levels"], f"MG {fmt}: same level formats on card and cpu")
        check(abs(g["iters"] - c["iters"]) <= 1, f"MG {fmt}: iterations within 1")
        check(g["passed"] and c["passed"], f"MG {fmt}: max|x-1| < {X_TOL} on both")
    for shards, mode in itertools.product((2, 4), ("uniform", "multiformat")):
        kw = dict(tol=CG_TOL, maxiter=CG_MAXITER, shards=shards, mode=mode, tune="ml")
        g, c = run(SMALL_GRID, device="cuda", **kw), run(SMALL_GRID, device="cpu", **kw)
        print(f"  P={shards} {mode}: card {g['iters']} iters err {g['err']:.2e}; cpu "
              f"{c['iters']} iters err {c['err']:.2e}; formats {g['formats']}")
        check(g["formats"] == c["formats"], f"P={shards} {mode}: same per-shard formats on "
                                            f"card and cpu")
        check(abs(g["iters"] - c["iters"]) <= 1, f"P={shards} {mode}: iterations within 1")
        check(g["passed"] and c["passed"], f"P={shards} {mode}: max|x-1| < {X_TOL} on both")


def true_residual(torch, A, b, x) -> float:
    """||b - A x|| / ||b|| with A x in float64 from the COO matrix ``A``."""
    x64 = x.double()
    ax = torch.zeros_like(x64).index_add_(0, A.row.long(), A.data.double() * x64[A.col.long()])
    return float((b.double() - ax).norm() / b.double().norm())


def solve_counted(torch, M, b, A, label, kernels):
    """cg(operator(M)) with every SpMV counted; each of the format's kernels
    must launch once per SpMV the device ran (loop_counts). The true
    residual b - A x is taken in float64 from the COO matrix ``A``."""
    from repro_torch.core.solvers import cg, operator
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import solver_vec as sv

    apply_A = operator(M)
    nspmv = 0

    def counted(v):
        nonlocal nspmv
        nspmv += 1
        return apply_A(v)

    before, sv_before = kops.launch_counts(), sum(sv.launches.values())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = cg(counted, b, tol=CG_TOL, maxiter=CG_MAXITER)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    after = kops.launch_counts()
    launched = {k: after[k] - before[k] for k in kernels}
    sv_launched = sum(sv.launches.values()) - sv_before
    err = float((res.x - 1.0).abs().max())
    rel = float(res.resnorm) / float(b.norm())
    rel_true = true_residual(torch, A, b, res.x)
    print(f"  {label}: {res.iters} iters, {dt * 1e3:.2f} ms "
          f"({dt * 1e3 / max(res.iters, 1):.4f} ms/iter), max|x-1|={err:.3e}, "
          f"cg rel residual={rel:.3e}, true rel residual={rel_true:.3e}, "
          f"launches={launched}, SpMVs={nspmv}", flush=True)
    check(res.x.shape == b.shape and bool(torch.isfinite(res.x).all()),
          f"{label}: finite x of shape {tuple(b.shape)}")
    # cg stops when ||r|| <= tol * ||r0|| (r0 = b): the same test, up to the
    # rounding of the two norms
    check(res.iters < CG_MAXITER and rel <= CG_TOL * (1 + 1e-5),
          f"{label}: converged to tol={CG_TOL}")
    check(err < X_TOL, f"{label}: max|x-1| < {X_TOL}")
    device, _ = loop_counts(label, {"SpMVs": nspmv}, {"SpMVs": 1}, sv_launched)
    for k in kernels:
        check(launched[k] == device["SpMVs"] and nspmv > 0,
              f"{label}: {k} launches {launched[k]} == the SpMVs the device ran")
    return res, dt


def read_path(torch, label, expect):
    """Launch counts of one path (set to 0 before it); every kernel the path
    runs must have launched."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import solver_vec as sv
    counts = kops.launch_counts()
    scheds = kops.schedule_counts()
    svc = sv.launch_counts()
    print(f"  launches over path {label}: {counts}; by schedule {scheds}; solver_vec {svc} "
          f"(a captured graph's launches count at each replay); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    for name in expect:
        got = sum(svc.values()) if name == "solver_vec" else counts[name]
        check(got > 0, f"{name} launched on path {label} ({got})")
    return dict(counts, **scheds, solver_vec=sum(svc.values()))


def start_path(torch):
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import solver_vec as sv
    kops.reset_launches()
    sv.reset_launches()
    torch.cuda.reset_peak_memory_stats()


def phase_main(torch, prob, t_gen):
    from repro_torch.core import hpcg
    from repro_torch.core import solvers
    from repro_torch.core.dynamic import DynamicMatrix
    from repro_torch.core.formats import Format
    from repro_torch.core.solvers import cg, cg_fixed_iters, operator

    print(f"== main path (a) at {'x'.join(map(str, GRID))}: ml pick, DIA and CSR", flush=True)
    start_path(torch)
    t0 = time.perf_counter()
    A = hpcg.to_coo(prob, device="cuda")
    b = torch.from_numpy(hpcg.rhs_for_ones(prob)).cuda()
    torch.cuda.synchronize()
    t_coo = time.perf_counter() - t0
    t0 = time.perf_counter()
    M = DynamicMatrix.auto(A, "ml")
    torch.cuda.synchronize()
    t_auto = time.perf_counter() - t0
    print(f"  n={prob.shape[0]} nnz={len(prob.val)}; generate_problem {t_gen:.2f} s (host), "
          f"to_coo+rhs {t_coo:.2f} s, ml pick + plan + convert {t_auto:.2f} s")
    check(M.active == Format.DIA, f"ml pick is {M.active.name} (DIA expected)")
    res, dt = solve_counted(torch, M, b, A, "cg DIA", KERNELS_OF["DIA"])
    # the spread of the host-clocked solve, then the same iterations with
    # no convergence test (no flag read), each three times
    for name, solve in (("cg", lambda: cg(operator(M), b, tol=CG_TOL, maxiter=CG_MAXITER)),
                        ("cg_fixed_iters", lambda: cg_fixed_iters(operator(M), b,
                                                                  iters=res.iters))):
        per_iter = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solve()
            torch.cuda.synchronize()
            per_iter.append((time.perf_counter() - t0) * 1e3 / max(res.iters, 1))
        print(f"  {name} DIA repeated ({res.iters} iters): "
              f"{', '.join(f'{t:.4f}' for t in per_iter)} ms/iter", flush=True)
    t0 = time.perf_counter()
    C = DynamicMatrix(A).activate(Format.CSR)
    torch.cuda.synchronize()
    print(f"  activate(CSR) {time.perf_counter() - t0:.2f} s")
    solve_counted(torch, C, b, A, "cg CSR", KERNELS_OF["CSR"])
    del C
    counts = read_path(torch, "(a)", ("dia_spmv", "csr_spmv", "solver_vec"))
    # outside the counted run: host syncs a solve, ms an iteration
    res_s, where = _sync_count(torch, lambda: cg(operator(M), b, tol=CG_TOL,
                                                 maxiter=CG_MAXITER))
    loop = solvers.last_loop
    want = -(-res.iters // loop.k_block)
    _, where_fixed = _sync_count(torch, lambda: cg_fixed_iters(operator(M), b, iters=res.iters))
    nsync, nsync_fixed = sum(where.values()), sum(where_fixed.values())
    print(f"  host syncs under set_sync_debug_mode('warn'): cg DIA {nsync} a solve "
          f"({res_s.iters} iterations, K = {loop.k_block}: ceil(iters / K) = {want}; "
          f"{loop}; by line {dict(where)}), cg_fixed_iters {nsync_fixed} "
          f"{dict(where_fixed)}", flush=True)
    k_block = loop.k_block
    check(want <= nsync <= want + 2 and res_s.iters == res.iters,
          f"cg DIA syncs with the host {nsync} times: once a block of {k_block} "
          f"iterations ({want}) and at most 2 before the loop")
    check(nsync_fixed == 0, "cg_fixed_iters never syncs with the host")
    SV_IN_PATH.update(loop_readings(torch, "path (a) cg DIA", operator(M), b))
    del M
    return A, b, counts, (res.iters, dt)


def phase_profile(torch, A, b):
    """The paper's run-time selection on the card: every candidate of
    DEFAULT_CANDIDATES converted and timed through its kernel."""
    from repro_torch.core.dynamic import DEFAULT_CANDIDATES, DynamicMatrix
    from repro_torch.tuning import FormatPolicy

    print(f"== main path (b) at {'x'.join(map(str, GRID))}: FormatPolicy('profile')",
          flush=True)
    start_path(torch)
    t0 = time.perf_counter()
    rep = FormatPolicy("profile").select(A)
    torch.cuda.synchronize()
    t_prof = time.perf_counter() - t0
    ml = FormatPolicy("ml").select(A).best
    print(f"  profile over {[f.name for f in DEFAULT_CANDIDATES]} in {t_prof:.2f} s: "
          + ", ".join(f"{f.name} {t * 1e3:.4f} ms" for f, t in rep.times.items())
          + f" -> pick {rep.best.name}; ml pick {ml.name}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    check(set(rep.times) == set(DEFAULT_CANDIDATES), "profile timed every candidate")
    check(rep.best in DEFAULT_CANDIDATES, f"profile pick {rep.best.name} is a candidate")
    D = DynamicMatrix(A)
    M = D.activate(rep.best, plan=D.plan(rep.best))
    solve_counted(torch, M, b, A, f"cg {rep.best.name} (profile pick)",
                  KERNELS_OF[rep.best.name])
    del M
    expect = [k for f in DEFAULT_CANDIDATES for k in KERNELS_OF[f.name]]
    return read_path(torch, "(b)", expect), rep


def phase_new_formats(torch, A, b):
    """CG in the four formats this slice ported, then one SpMV of SELL, HYB
    and BSR with any device->host sync raising."""
    from repro_torch.core.dynamic import DynamicMatrix
    from repro_torch.core.formats import Format
    from repro_torch.core.ops import spmv

    print(f"== main path (c) at {'x'.join(map(str, GRID))}: ELL, SELL, HYB, BSR", flush=True)
    start_path(torch)
    D = DynamicMatrix(A)
    no_sync = {}
    for fmt, hints in NEW_FORMATS:
        t0 = time.perf_counter()
        M = D.activate(Format[fmt], plan=D.plan(Format[fmt], **hints))
        torch.cuda.synchronize()
        print(f"  activate({fmt}, {hints}) {time.perf_counter() - t0:.2f} s", flush=True)
        solve_counted(torch, M, b, A, f"cg {fmt}", KERNELS_OF[fmt])
        if fmt != "ELL":
            no_sync[fmt] = M
        else:
            del M
    counts = read_path(torch, "(c)", ("ell_spmv", "sell_spmv", "csr_spmv", "bsr_spmm"))
    x = torch.ones(A.shape[1], device="cuda")
    torch.cuda.synchronize()
    for fmt, M in no_sync.items():
        torch.cuda.set_sync_debug_mode("error")
        try:
            y = spmv(M, x)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        check(bool(torch.allclose(y, b, rtol=1e-4, atol=1e-4)),
              f"{fmt} SpMV under set_sync_debug_mode('error'): no device->host sync, "
              f"A @ 1 == b")
    return counts


# ---------------------------------------------------------------------------
# The solvers' loop on the card: solver_vec's kernels and the captured block
# ---------------------------------------------------------------------------

SV_N = GRID[0] * GRID[1] * GRID[2]  # path (a)'s vector length
# f32 and f64, kernel vs plain: |got - want| <= SV_REL[dtype] * sum|terms|
# of each output (the products of a dot; |x| + |alpha p| of an update): the
# two sum or round in other orders (FMA against a multiply then an add).
SV_REL = {"float32": 1e-5, "float64": 1e-12}
# bf16, kernel vs an f64 evaluation of the same formula (alpha and beta as
# f32 scalars, the vectors in f64): a vector output may differ from the
# exact value by the one rounding to bf16 that the formula allows,
# |bf16(exact) - exact|, and beyond that by at most SV_BF16_REL * sum|terms|;
# a sum (f32 in the kernel) by SV_REL["float32"] * sum|terms|. The plain
# version, which rounds to bf16 after each op, is read against the same
# evaluation and not held to it.
SV_BF16_REL = 2.0 ** -8
SV_RERUNS = 20  # reruns of the kernel sequence that must be bitwise the first
SV_DTYPES = ("float32", "bfloat16", "float64")
LOOP_REPLAYS = 20  # replays a per-iteration reading
L2_FLUSH_BYTES = 256 << 20  # read before each cold call: 5x an H100's 50 MB of L2
# csrc/solver_vec.cu's kernels, by the profiler's names (an anonymous namespace)
SV_KERNEL_NAMES = tuple(f"{pre}{k}_kernel{post}" for k in ("dot", "update", "direction", "finish")
                        for pre, post in (("namespace)::", "<"), ("", "I")))  # or mangled
SV_IN_PATH = {}  # path (a)'s loop_readings: solver_vec's kernels an iteration, in the path


def _sv_inputs(torch, dtype):
    """CG-like vectors of length SV_N (p . Ap > 0) and loop state."""
    from repro_torch.kernels import solver_vec as sv
    g = torch.Generator("cuda").manual_seed(SEED)
    x, r, p, noise, z = (torch.randn(SV_N, generator=g, device="cuda", dtype=torch.float64)
                         for _ in range(5))
    ap = 2.0 * p + 0.5 * noise
    z = 0.5 * r + 0.1 * z
    acc = sv.acc_dtype(dtype)
    sc = torch.tensor([float(r @ r), float(r @ z), 1e-12], dtype=acc, device="cuda")
    st = torch.tensor([3, 1], dtype=torch.int64, device="cuda")
    return [t.to(dtype) for t in (x, r, p, ap, z)], sc, st


def _bits(t):
    """``t`` as integers of its width: torch.equal on these is bitwise (NaN too)."""
    if not t.is_floating_point():
        return t
    import torch
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def _sv_reading(torch, got, want, terms, dname):
    """max |got - want| / (SV_REL * terms): at most 1 passes."""
    lim = SV_REL[dname] * terms.double()
    return float(((got.double() - want.double()).abs() / lim.clamp_min(1e-300)).max())


def _sv_exact(torch, ins, sc, r_new):
    """The f64 evaluation of one PCG iteration's vector work on ``ins`` = (x,
    r, p, Ap, z) and the scalars ``sc``, with alpha and beta rounded to f32
    as the kernels hold them; rr and r . z are summed over ``r_new``, the
    r that is being checked. name -> (exact value, sum|terms|, whether the
    output is rounded to the vectors' dtype)."""
    def f32(v):
        return float(torch.tensor(float(v), dtype=torch.float32))
    x, r, p, ap, z = (t.double() for t in ins)
    rn = r_new.double()
    pap, rr, rz = float(p @ ap), float(rn @ rn), float(rn @ z)
    alpha = f32(f32(sc[1]) / f32(pap))
    beta = f32(f32(rz) / f32(sc[1]))
    one = torch.ones((), dtype=torch.float64, device=x.device)
    return {"dot p.Ap": (pap * one, (p * ap).abs().sum(), False),
            "update x": (x + alpha * p, x.abs() + abs(alpha) * p.abs(), True),
            "update r": (r - alpha * ap, r.abs() + abs(alpha) * ap.abs(), True),
            "direction p": (z + beta * p, z.abs() + abs(beta) * p.abs(), True),
            "finish rr": (rr * one, (rn * rn).sum(), False),
            "finish rz": (rz * one, (rn * z).abs().sum(), False),
            "finish history": (math.sqrt(f32(rr)) * one, math.sqrt(rr) * one, True)}


def _sv_bf16_reading(torch, got, exact, terms, rounded):
    """Against the f64 evaluation: max of (|got - exact| - |bf16(exact) -
    exact|) / (SV_BF16_REL * terms) for an output rounded to bf16, of |got -
    exact| / (SV_REL f32 * terms) for an f32 sum. At most 1 passes."""
    err = (got.double() - exact).abs()
    if rounded:
        err = err - (exact.to(torch.bfloat16).double() - exact).abs()
    lim = (SV_BF16_REL if rounded else SV_REL["float32"]) * terms.double()
    return float((err / lim.clamp_min(1e-300)).max())


def cold_ms(torch, fn, iters: int):
    """``fn`` with the L2 cache flushed before each call (a read of
    L2_FLUSH_BYTES): (the median ms of ``iters`` calls by CUDA events, the
    flush queued ahead of the start event so that the device is busy while
    the host queues the call; the ms a call of solver_vec's kernels take on
    the device, by the profiler, the flush's kernel left out)."""
    buf = torch.zeros(L2_FLUSH_BYTES // 4, device="cuda")
    for _ in range(3):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(iters)]
    for s, e in ev:
        buf.sum()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    _, dev = device_ms(torch, lambda: (buf.sum(), fn()), match=SV_KERNEL_NAMES)
    return statistics.median(s.elapsed_time(e) for s, e in ev), dev


def phase_solver_vec(torch, np, peak_bw):
    """solver_vec's kernels (dot, update, direction, finish) against their
    plain versions on SV_N-long vectors in f32 and f64 (SV_REL), and in bf16
    against an f64 evaluation of the same formula (SV_BF16_REL), the plain
    version read beside them; an inactive iteration leaving every state
    tensor's bits, SV_RERUNS reruns bitwise; then the f32 times of one CG
    iteration's vector work (the four kernels captured in a graph as the
    solver replays them) with the L2 cache flushed before each replay
    (cold_ms), beside its HBM bound, the same replays with the vectors left
    in L2, and the plain sequence. Returns the JSON record."""
    from repro_torch.core.solvers import _capture
    from repro_torch.kernels import solver_vec as sv

    print(f"== solver_vec kernels on {SV_N}-long vectors (104^3), f32 / bf16 / f64", flush=True)
    worst, reading = {}, {}
    for dname in SV_DTYPES:
        dtype = getattr(torch, dname)
        ins, sc, st = _sv_inputs(torch, dtype)
        x, r, p, ap, z = ins
        hist0 = torch.full((11,), math.nan, dtype=dtype, device="cuda")

        def seq(kernel):
            """One PCG iteration's vector work on copies: kernel or plain."""
            xs, rs, ps, scs, sts, hs = x.clone(), r.clone(), p.clone(), sc.clone(), st.clone(), \
                hist0.clone()
            if kernel:
                pap = sv.dot(ps, ap)
                rr = sv.update(xs, rs, ps, ap, pap, scs, sts)
                rz = sv.dot(rs, z)
                sv.direction(ps, z, rz, scs, sts)
                sv.finish(rr, rz, scs, sts, hs, 10)
            else:
                pap = sv.dot_plain(ps, ap)
                rr = sv.update_plain(xs, rs, ps, ap, pap, scs, sts)
                rz = sv.dot_plain(rs, z)
                sv.direction_plain(ps, z, rz, scs, sts)
                sv.finish_plain(rr, rz, scs, sts, hs, 10, False)
            return pap, xs, rs, ps, scs, sts, hs

        def outputs(out):
            return {"dot p.Ap": out[0].double().sum(), "update x": out[1], "update r": out[2],
                    "direction p": out[3], "finish rr": out[4][0], "finish rz": out[4][1],
                    "finish history": out[6][4]}

        k_out, p_out = seq(True), seq(False)
        if dname == "bfloat16":
            ex = _sv_exact(torch, ins, sc, k_out[2])
            ex_p = _sv_exact(torch, ins, sc, p_out[2])
            readings = {k: _sv_bf16_reading(torch, v, *ex[k]) for k, v in outputs(k_out).items()}
            plain = {k: _sv_bf16_reading(torch, v, *ex_p[k]) for k, v in outputs(p_out).items()}
            what = (f"beyond one rounding to bf16, of the limit {SV_BF16_REL:.3g} * sum|terms| "
                    f"({SV_REL['float32']:.3g} for the f32 sums), against an f64 evaluation")
        else:
            a64 = [t.double() for t in ins]
            pap_p = p_out[0].sum()
            alpha = float(sc[1]) / float(pap_p)
            beta = float(p_out[4][1]) / float(sc[1])
            rr_terms = p_out[2].double().pow(2).sum()
            terms = {"dot p.Ap": (a64[2] * a64[3]).abs().sum(),
                     "update x": a64[0].abs() + abs(alpha) * a64[2].abs(),
                     "update r": a64[1].abs() + abs(alpha) * a64[3].abs(),
                     "direction p": a64[4].abs() + abs(beta) * a64[2].abs(),
                     "finish rr": rr_terms,
                     "finish rz": (p_out[2].double() * a64[4]).abs().sum(),
                     "finish history": rr_terms.sqrt()}
            want = outputs(p_out)
            readings = {k: _sv_reading(torch, v, want[k], terms[k], dname)
                        for k, v in outputs(k_out).items()}
            plain = None
            what = f"of the limit {SV_REL[dname]:.3g} * sum|terms|, against the plain versions"
        if plain is None:  # |kernel - plain|
            pairs = list(zip(k_out[1:4], p_out[1:4])) + [(k_out[4][:2], p_out[4][:2])]
            worst[dname] = max(float((a.double() - b.double()).abs().max()) for a, b in pairs)
        else:  # |kernel - the f64 evaluation|
            worst[dname] = max(float((v.double() - ex[k][0]).abs().max())
                               for k, v in outputs(k_out).items())
        reading[dname] = max(readings.values())
        print(f"  {dname}: readings ({what}): "
              + ", ".join(f"{k} {v:.3e}" for k, v in readings.items()), flush=True)
        if plain is not None:
            print(f"  {dname}: the plain versions' readings against the same evaluation (not "
                  f"checked): " + ", ".join(f"{k} {v:.3e}" for k, v in plain.items()),
                  flush=True)
        check(all(v <= 1.0 for v in readings.values()) and all(
            bool(torch.isfinite(t).all()) for t in k_out[1:4]),
            f"solver_vec {dname}: dot, update, direction, finish within their limits ({what})")
        check(torch.equal(k_out[5], p_out[5]) and k_out[5].tolist() == [4, 1],
              f"solver_vec {dname}: finish's k and flag {k_out[5].tolist()} == plain's")
        reruns = [seq(True) for _ in range(SV_RERUNS)]
        check(all(all(torch.equal(_bits(a), _bits(b)) for a, b in zip(run, k_out))
                  for run in reruns),
              f"solver_vec {dname}: {SV_RERUNS} reruns bitwise the first")
        # the flag off: nothing is written
        xs, rs, ps, scs, hs = x.clone(), r.clone(), p.clone(), sc.clone(), hist0.clone()
        off = torch.tensor([3, 0], dtype=torch.int64, device="cuda")
        rr = sv.update(xs, rs, ps, ap, sv.dot(ps, ap), scs, off)
        sv.direction(ps, z, sv.dot(rs, z), scs, off)
        sv.finish(rr, sv.dot(rs, z), scs, off, hs, 10)
        check(all(torch.equal(_bits(a), _bits(b))
                  for a, b in ((xs, x), (rs, r), (ps, p), (scs, sc), (hs, hist0)))
              and off.tolist() == [3, 0], f"solver_vec {dname}: an inactive iteration leaves "
                                          f"x, r, p, the scalars, k and history bit for bit")

    # f32 times: one CG iteration's vector work (z = r), as the solver runs it.
    # Cold: on the main path the SpMV between two iterations (~120 MB at
    # 104^3) evicts these 4.5 MB vectors from L2, so the replays are timed
    # with L2 flushed; the warm reading (vectors left in L2) beside it.
    (x, r, p, ap, _), sc, st = _sv_inputs(torch, torch.float32)
    sc[1] = sc[0]
    kmax = 1 << 20  # more iterations than the timing runs: the flag stays on
    hist = torch.full((kmax + 1,), math.nan, device="cuda")

    def cg_vec():
        rr = sv.update(x, r, p, ap, sv.dot(p, ap), sc, st)
        sv.direction(p, r, rr, sc, st)
        sv.finish(rr, None, sc, st, hist, kmax, True)

    def cg_vec_plain():
        rr = sv.update_plain(x, r, p, ap, sv.dot_plain(p, ap), sc, st)
        sv.direction_plain(p, r, rr, sc, st)
        sv.finish_plain(rr, None, sc, st, hist, kmax, True)

    pap = sv.dot(p, ap)
    one = {"dot": lambda: sv.dot(p, ap), "update": lambda: sv.update(x, r, p, ap, pap, sc, st),
           "direction": lambda: sv.direction(p, r, pap, sc, st),
           "finish": lambda: sv.finish(pap, None, sc, st, hist, kmax, True)}
    es, G = 4, sv.grid(SV_N)
    nbytes = {"dot": 2 * SV_N * es, "update": 6 * SV_N * es, "direction": 3 * SV_N * es,
              "finish": 2 * G * 4}
    line = []
    for kname, fn in one.items():
        ms, dev = cold_ms(torch, fn, 100)
        bound = nbytes[kname] / peak_bw * 1e3
        line.append(f"{kname} {ms:.4f} events, {dev:.4f} device (bound {bound:.4f}, "
                    f"{bound / dev if dev else math.nan:.1%})")
    print("  f32 kernels alone, L2 flushed before each call, ms (CUDA events, median of 100; "
          "device: profiler): " + "; ".join(line), flush=True)
    cg_vec()
    graph = _capture(cg_vec, torch.device("cuda"))
    ms, cold_dev = cold_ms(torch, graph.replay, 100)
    warm = time_ms(graph.replay, 100)
    dev = device_ms(torch, graph.replay)
    plain_ms = time_ms(cg_vec_plain, 20)
    lib_ms = time_ms(lambda: torch.dot(p, ap), 100)
    nb = sum(nbytes.values())
    bound = nb / peak_bw * 1e3
    print(f"  one CG iteration's vector work (dot, update, direction, finish; 4 launches) in a "
          f"captured graph: {ms:.4f} ms with L2 flushed before each replay (CUDA events, median "
          f"of 100) -> {bound / ms:.1%} of bound, {cold_dev:.4f} ms of kernels (profiler) -> "
          f"{bound / cold_dev if cold_dev else math.nan:.1%}; bound {bound:.4f} ms ({nb / 1e6:.1f} MB at "
          f"{peak_bw / 1e12:.2f} TB/s); with the vectors left in L2 (not held to the HBM bound) "
          f"{warm:.4f} ms events, {dev if dev is None else round(dev, 4)} ms of kernels "
          f"(profiler); plain sequence {plain_ms:.4f} ms; torch.dot(p, Ap) alone {lib_ms:.4f} ms",
          flush=True)
    del graph
    return {"name": "solver_vec", "route": "cuda", "source": "src/repro_torch/csrc/solver_vec.cu",
            "replaces": "src/repro/core/solvers.py:96", "launches": 0,
            "max_abs_err": worst["float32"], "max_abs_err_bf16": worst["bfloat16"],
            "max_abs_err_f64": worst["float64"], "readings_of_limit": reading,
            "ms": ms, "device_ms": cold_dev, "warm_ms": warm, "warm_device_ms": dev,
            "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "bytes", "library_ms": None}


def _sync_count(torch, fn):
    """fn() under set_sync_debug_mode("warn"): (result, the synchronizing
    operations it warned of, counted by the source line that made them)."""
    import collections
    import warnings
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, collections.Counter(f"{os.path.relpath(m.filename, HERE)}:{m.lineno}"
                                    for m in w if "synchronizing" in str(m.message)
                                    and "prototype" not in str(m.message))  # torch's notice


def loop_readings(torch, label, apply_A, b, apply_M=None):
    """ms an iteration of the solver's captured block (never stopping:
    fixed iterations), the block replayed LOOP_REPLAYS times: by the host
    clock with the flag read after each replay as cg does, and on the
    device with the replays queued behind a spin (CUDA events), and the
    profiler's kernel time a replay."""
    from repro_torch.core.solvers import _capture, _Loop, block_iters
    k = block_iters(apply_M is not None)
    loop = _Loop(apply_A, apply_M, b, None, 0.0, k * (4 * LOOP_REPLAYS + 16), fixed=True)

    def block():
        for _ in range(k):
            loop.iteration()
    block()
    graph = _capture(block, b.device)
    graph.replay()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LOOP_REPLAYS):
        graph.replay()
        loop.st.tolist()
    host = (time.perf_counter() - t0) * 1e3 / (LOOP_REPLAYS * k)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e6 * 2.0))
    e0.record()
    for _ in range(LOOP_REPLAYS):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    queued = e0.elapsed_time(e1) / (LOOP_REPLAYS * k)
    dev, vec = device_ms(torch, graph.replay, match=SV_KERNEL_NAMES)
    dev_s = "not measured (no device events)" if dev is None else \
        f"{dev / k:.4f}, of them solver_vec's {vec / k:.4f}"
    print(f"  {label}: ms an iteration of the captured block (K = {k}): host clock "
          f"{host:.4f} (a flag read a replay), device-queued {queued:.4f} (events), kernels "
          f"{dev_s} (profiler) [{SMI[0]}]", flush=True)
    del graph
    return {"host": host, "queued": queued, "kernels": None if dev is None else dev / k,
            "solver_vec": None if dev is None else vec / k}


def device_calls(setup: int) -> int:
    """Calls of an ``apply_A`` (or ``apply_M``) closure that the device ran
    in the last solve: ``setup`` before the loop, then one an iteration
    issued (``solvers.last_loop``: every block, eager or replayed)."""
    from repro_torch.core import solvers
    L = solvers.last_loop
    return setup + L.k_block * (L.eager + L.replays)


def loop_counts(label, py_calls: dict, setup: dict, sv_launched: int):
    """The counting closures' Python calls -> the device's calls, from
    ``solvers.last_loop``: a closure runs in Python in the eager block and
    once at capture, and the device runs the captured calls at every
    replay. Checks that every block issued K calls of each, that at most
    K - 1 iterations past convergence ran masked, and that solver_vec's
    launch count over the solve (``sv_launched``; the solver adds a
    captured graph's launches at each replay) is what the device ran: a
    dot a preconditioned residual before the loop (rr; PCG also r . z),
    then 4 kernels an iteration issued (PCG 5). Returns (device calls by
    closure, masked iterations)."""
    from repro_torch.core import solvers
    L = solvers.last_loop
    blocks_py = L.eager + int(L.captured)
    issued = L.k_block * (L.eager + L.replays)
    masked = issued - L.iters
    device = {}
    for name, n in py_calls.items():
        per_block = (n - setup[name]) / blocks_py
        check(per_block == L.k_block, f"{label}: {name} runs {L.k_block} times a block "
                                      f"({n} Python calls, {setup[name]} before the loop)")
        device[name] = setup[name] + issued
    check(0 <= masked < L.k_block or (L.iters == 0 and masked == L.k_block),
          f"{label}: {masked} masked iterations past convergence (< K = {L.k_block})")
    precond = "M" in py_calls
    sv_want = (2 if precond else 1) + (5 if precond else 4) * issued
    check(sv_launched == sv_want, f"{label}: solver_vec launched {sv_launched} kernels == "
                                  f"{sv_want} the device ran ({issued} iterations issued)")
    print(f"  {label}: loop of {L.eager} eager block(s) + "
          f"{'a capture' if L.captured else 'no capture'} replayed {L.replays} times, K = "
          f"{L.k_block}, {L.syncs} flag reads; on the device: {device} calls "
          f"({L.iters} iterations active, {masked} masked, whose calls are counted in)",
          flush=True)
    return device, masked


# ---------------------------------------------------------------------------
# Path (f): MG-PCG, the multigrid preconditioner on the card
# ---------------------------------------------------------------------------

# Relative residuals at which the solves are held against each other.
# Below the float32 floor of the true residual (~3e-6 at 104^3) PCG's
# updated residual follows the rounding, so a float32 count at 1e-7 may
# differ from a float64 one (tests/test_torch_mg_tail.py: the port and the
# JAX package at 40^3 cross 1e-3 ... 1e-6 together and stop at 25 and 26
# iterations; tests/test_torch_mg_f64.py: in float64 the two are one solve).
MG_CROSS = (1e-3, 1e-4, 1e-5, 1e-6, 1e-7)
# The JAX package's own MG-PCG at 104^3 in float64 (jax_enable_x64;
# repro.mg.build_hierarchy(fmt=CSR, backend="ref"), 4 levels, then pcg to
# tol 1e-7 over operator(CSR, backend="ref"); run on a CPU, PERF.md §6's
# witness table): the iterations at which ||r|| first falls below each t of
# MG_CROSS ||r_0||. Its float32 run agrees through 1e-4 (30, 36), then
# stalls between 1.2e-5 and 2.0e-5 and stops at 69: rounding of that CPU
# run, not the cycle.
MG_JAX_F64_CROSS = (30, 36, 40, 46, 59)
MG_JAX_ITERS = MG_JAX_F64_CROSS[-1]
MG_CYCLES_TIMED = 20


def cycle_spmvs(hier) -> dict:
    """SpMVs one V-cycle issues, by kernel name (from the hierarchy: a level
    operator SpMV on every level but the coarsest, two per color block and
    SymGS sweep; COO has no kernel). ``"total"`` counts every SpMV."""
    out = {"total": 0}

    def add(fmt, k):
        out["total"] += k
        for name in KERNELS_OF[fmt.name]:
            out[name] = out.get(name, 0) + k

    for i, lev in enumerate(hier.levels):
        last = i == hier.nlevels - 1
        sweeps = hier.coarse_sweeps if last else hier.pre + hier.post
        if not last:
            add(lev.format, 1)
        for blk, rows in zip(lev.smoother.blocks, lev.smoother.counts):
            if rows:
                add(blk.format, 2 * sweeps)
    return out


def print_levels(hier, label, dt):
    print(f"  {label}: {hier} built in {dt:.2f} s", flush=True)
    for rec, lev in zip(hier.formats(), hier.levels):
        blocks = lev.smoother.blocks
        print(f"    level {rec['level']} {'x'.join(map(str, rec['dims']))}: n={rec['n']} "
              f"stored={lev.A.nnz} A={rec['A']} colors={rec['colors']} "
              f"(block {blocks[0].shape[0]} x {blocks[0].shape[1]}, "
              f"rows {min(lev.smoother.counts)}-{max(lev.smoother.counts)})", flush=True)


def mg_solve_counted(torch, M, b, A, hier, label, cg_iters):
    """pcg(operator(M), apply_M=V-cycle) with every operator SpMV and every
    V-cycle counted; each kernel must launch exactly as often as the
    hierarchy says those calls issue on the device (loop_counts). Returns
    (result, seconds)."""
    from repro_torch.core.solvers import operator, pcg
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import solver_vec as sv

    apply_A, apply_M = operator(M), hier.apply_M()
    calls = {"A": 0, "M": 0}

    def counted_A(v):
        calls["A"] += 1
        return apply_A(v)

    def counted_M(r):
        calls["M"] += 1
        return apply_M(r)

    before, sv_before = kops.launch_counts(), sum(sv.launches.values())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pcg(counted_A, b, tol=CG_TOL, maxiter=CG_MAXITER, apply_M=counted_M)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    after = kops.launch_counts()
    launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    sv_launched = sum(sv.launches.values()) - sv_before
    per_cycle = cycle_spmvs(hier)
    err = float((res.x - 1.0).abs().max())
    rel = float(res.resnorm) / float(b.norm())
    rel_true = true_residual(torch, A, b, res.x)
    print(f"  {label}: {res.iters} iters (cg {cg_iters}), {dt * 1e3:.2f} ms "
          f"({dt * 1e3 / max(res.iters, 1):.4f} ms/iter), max|x-1|={err:.3e}, "
          f"pcg rel residual={rel:.3e}, true rel residual={rel_true:.3e}; "
          f"operator SpMVs {calls['A']}, V-cycles {calls['M']} x {per_cycle['total']} "
          f"SpMVs; launches={launched}", flush=True)
    check(res.x.shape == b.shape and bool(torch.isfinite(res.x).all()),
          f"{label}: finite x of shape {tuple(b.shape)}")
    check(res.iters < CG_MAXITER and rel <= CG_TOL * (1 + 1e-5),
          f"{label}: converged to tol={CG_TOL}")
    check(err < X_TOL, f"{label}: max|x-1| < {X_TOL}")
    device, masked = loop_counts(label, calls, {"A": 1, "M": 1}, sv_launched)
    check(device["A"] == device["M"] == res.iters + 1 + masked,
          f"{label}: one operator SpMV and one V-cycle per iteration issued, plus the first")
    want = dict.fromkeys(KERNELS_OF[M.active.name], device["A"])
    for name, k in per_cycle.items():
        if name != "total":
            want[name] = want.get(name, 0) + k * device["M"]
    check(launched == want, f"{label}: launches {launched} == the SpMVs the device ran {want} "
                            f"(calls x launches a call)")
    return res, dt


def time_v_cycle(torch, apply_M, r, label):
    """ms per call of ``apply_M`` (a V-cycle, or a distributed SpMV) three
    ways: the host clock between syncs; CUDA events around the same run (the
    device's span, which waits on the host); and CUDA events around calls
    queued behind a spin kernel, so the device runs them back to back (the
    device's own time). Their ratio is the host's share. Also the
    profiler's kernel sum, where it sees the card."""
    for _ in range(3):
        apply_M(r)
    torch.cuda.synchronize()
    n = MG_CYCLES_TIMED
    t0 = time.perf_counter()
    for _ in range(n):
        apply_M(r)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        apply_M(r)
    e1.record()
    torch.cuda.synchronize()
    span_ms = e0.elapsed_time(e1) / n
    # one V-cycle at a time behind a spin long enough for the host to
    # enqueue all of it before the device reaches it
    queued = []
    spin = int(2e6 * max(4.0, 3 * host_ms))  # ~2 GHz clock: cycles for 3x the host time
    for _ in range(5):
        torch.cuda._sleep(spin)
        e0.record()
        apply_M(r)
        e1.record()
        torch.cuda.synchronize()
        queued.append(e0.elapsed_time(e1))
    dev_ms = statistics.median(queued)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            apply_M(r)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]

    def ms_of(events):
        return sum(getattr(e, "self_device_time_total", None)
                   or getattr(e, "self_cuda_time_total", 0) for e in events) / 1e3 / 3

    kern_ms = ms_of(kern)
    spmv = [e for e in kern if "spmv" in e.key]
    nkern = sum(e.count for e in kern) / 3
    prof_txt = (f"profiler: {nkern:.0f} kernels, {kern_ms:.4f} ms of kernel time a call, "
                f"{ms_of(spmv):.4f} of it in {sum(e.count for e in spmv) / 3:.0f} SpMV "
                f"kernels" if kern else "profiler: no device events (not measured)")
    print(f"  {label}: {host_ms:.4f} ms a call by the host clock, {span_ms:.4f} by CUDA "
          f"events around the same run, {dev_ms:.4f} on the device with the launches "
          f"queued ahead (events; spins of {spin:.2e} cycles; runs "
          f"{', '.join(f'{t:.4f}' for t in queued)}); host share "
          f"{1 - dev_ms / host_ms:.3f}; {prof_txt}", flush=True)
    return {"host_ms": host_ms, "span_ms": span_ms, "device_ms": dev_ms,
            "kernel_ms": kern_ms if kern else None}


def crossings(np, res, thresholds):
    """The first iteration at which ``res``'s residual falls below t·||r_0||,
    for each t (None where it never does)."""
    h = res.history.cpu().double().numpy()
    h = h[:res.iters + 1] / h[0]
    return [int(np.argmax(h < t)) if (h < t).any() else None for t in thresholds]


def phase_mg(torch, np, prob, A, b, cg_dia):
    """Path (f): MG-PCG at 104^3 on the uniform-CSR hierarchy and on the ml
    hierarchy, held against a float64 solve through the plain versions,
    Jacobi-PCG for scale, the V-cycle's time and host share, one V-cycle
    with any device->host sync raising, and a bitwise rerun."""
    from repro_torch.core import hpcg
    from repro_torch.core.dynamic import DynamicMatrix
    from repro_torch.core.formats import Format
    from repro_torch.core.ops import extract_diagonal, spmv
    from repro_torch.core.solvers import operator, pcg
    from repro_torch.mg import build_hierarchy
    from repro_torch.tuning import FormatPolicy

    cg_iters, cg_s = cg_dia
    print(f"== main path (f) at {'x'.join(map(str, GRID))}: MG-PCG", flush=True)
    start_path(torch)
    M = DynamicMatrix(A).activate(Format.DIA)
    t0 = time.perf_counter()
    hier = build_hierarchy(prob, fmt=Format.CSR, A=A)
    torch.cuda.synchronize()
    print_levels(hier, "uniform CSR hierarchy", time.perf_counter() - t0)
    check(hier.nlevels == 4 and [lev.dims for lev in hier.levels][-1] == (13, 13, 13),
          "104^3 coarsens to 52^3, 26^3, 13^3 (13 is odd: the coarsest level)")
    res, dt = mg_solve_counted(torch, M, b, A, hier, "pcg DIA, MG CSR", cg_iters)
    check(res.iters <= MG_JAX_ITERS + 1 and res.iters < cg_iters,
          f"MG-PCG iterations {res.iters}: at most one above JAX's float64 {MG_JAX_ITERS} and "
          f"below CG's {cg_iters}")
    check(cycle_spmvs(hier)["csr_spmv"] == 163, "a V-cycle issues 163 CSR SpMVs at 104^3")
    t0 = time.perf_counter()
    hier_ml = build_hierarchy(prob, policy=FormatPolicy("ml"), A=A)
    torch.cuda.synchronize()
    print_levels(hier_ml, "ml hierarchy", time.perf_counter() - t0)
    print(f"  ml formats: {hier_ml.formats()}", flush=True)
    res_ml, dt_ml = mg_solve_counted(torch, M, b, A, hier_ml, "pcg DIA, MG ml", cg_iters)
    check(res_ml.iters < cg_iters, "the ml hierarchy's MG-PCG takes fewer iterations than CG")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    jac = pcg(operator(M), b, extract_diagonal(M.concrete), tol=CG_TOL, maxiter=CG_MAXITER)
    torch.cuda.synchronize()
    dt_jac = time.perf_counter() - t0
    print(f"  Jacobi-PCG DIA: {jac.iters} iters, {dt_jac * 1e3:.2f} ms "
          f"({dt_jac * 1e3 / max(jac.iters, 1):.4f} ms/iter), max|x-1|="
          f"{float((jac.x - 1).abs().max()):.3e}", flush=True)
    check(jac.iters < CG_MAXITER and float((jac.x - 1).abs().max()) < X_TOL,
          "Jacobi-PCG converges")
    print(f"  time to solution: CG {cg_s * 1e3:.2f} ms ({cg_iters} iters, "
          f"{cg_s * 1e3 / cg_iters:.4f} ms/iter, path (a)); MG-PCG CSR {dt * 1e3:.2f} ms "
          f"({res.iters}, {dt * 1e3 / res.iters:.4f} ms/iter); MG-PCG ml {dt_ml * 1e3:.2f} ms "
          f"({res_ml.iters}, {dt_ml * 1e3 / res_ml.iters:.4f} ms/iter); Jacobi-PCG "
          f"{dt_jac * 1e3:.2f} ms ({jac.iters})", flush=True)
    counts = read_path(torch, "(f)", ("dia_spmv", "csr_spmv", "solver_vec"))

    # the witness without float32 rounding: the same solve in float64, its
    # SpMVs and V-cycle through the plain versions (outside the counted run;
    # no SpMV kernel); its loop runs solver_vec's float64 kernels, which
    # phase_solver_vec holds against their plain versions
    t0 = time.perf_counter()
    A64 = hpcg.to_coo(prob, dtype=torch.float64, device="cuda")
    hier64 = build_hierarchy(prob, fmt=Format.CSR, backend="ref", A=A64)
    b64 = torch.from_numpy(hpcg.rhs_for_ones(prob, np.float64)).cuda()
    ref = pcg(operator(DynamicMatrix(A64).activate(Format.CSR), backend="ref"), b64,
              tol=CG_TOL, maxiter=CG_MAXITER, apply_M=hier64.apply_M())
    torch.cuda.synchronize()
    cross = {"f64": crossings(np, ref, MG_CROSS), "CSR": crossings(np, res, MG_CROSS),
             "ml": crossings(np, res_ml, MG_CROSS)}
    print(f"  float64 MG-PCG (plain versions): {ref.iters} iters, max|x-1|="
          f"{float((ref.x - 1).abs().max()):.3e}, {time.perf_counter() - t0:.2f} s; "
          f"iterations to ||r|| < t ||r_0|| for t = {MG_CROSS}: f64 {cross['f64']}, "
          f"f32 CSR {cross['CSR']}, f32 ml {cross['ml']}; the JAX package's float64 "
          f"{list(MG_JAX_F64_CROSS)}", flush=True)
    check(ref.x.dtype == torch.float64 and ref.iters < CG_MAXITER
          and float((ref.x - 1).abs().max()) < X_TOL, "the float64 MG-PCG converges")
    check(all(a is not None and abs(a - f) <= 1 for name in ("CSR", "ml", "f64")
              for a, f in zip(cross[name], MG_JAX_F64_CROSS)),
          f"both float32 hierarchies and the float64 solve cross {MG_CROSS} (the last: their "
          f"iteration counts) within one iteration of the JAX package's float64 solve")

    # outside the counted run: the loop's and the cycle's time, no sync,
    # bitwise reruns
    loop_readings(torch, "path (f) MG-PCG, CSR hierarchy", operator(M), b,
                  apply_M=hier.apply_M())
    r = b.clone()
    apply_M = hier.apply_M()
    cyc = time_v_cycle(torch, apply_M, r, "V-cycle, CSR")
    time_v_cycle(torch, hier_ml.apply_M(), r, "V-cycle, ml")
    z1 = apply_M(r)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        z2 = apply_M(r)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(torch.equal(z1, z2), "V-cycle under set_sync_debug_mode('error'): no device->host "
                               "sync, and a bitwise rerun")
    # the kernels on the color blocks against their plain versions
    x = torch.randn(A.shape[0], device="cuda", generator=torch.Generator("cuda").manual_seed(SEED))
    for hname, h in (("CSR", hier), ("ml", hier_ml)):
        for li in (0, h.nlevels - 1):
            cs = h.levels[li].smoother
            xl = x[:cs.shape[0]].contiguous()
            for c in (0, 7):
                blk = cs.blocks[c]
                if blk.format == Format.COO:
                    continue
                compare(f"{hname} level {li} color {c} {blk.format.name} block "
                        f"{blk.shape[0]}x{blk.shape[1]} ({cs.counts[c]} rows)",
                        spmv(blk, xl), spmv(blk, xl), spmv(blk, xl, backend="ref"), "float32")
    return counts, cyc


# ---------------------------------------------------------------------------
# Path (g): the distributed layer, P shards on the card
# ---------------------------------------------------------------------------

DIST_SHARDS = 8  # (g1), (g2): z-slabs of 13 planes at 104^3
DIST_MG_SHARDS = 4  # (g3): 26 planes a slab; the depth rule stops at 104^3 > 52^3
DIST_CG_SLACK = 2  # distributed CG iterations within this many of path (a)'s
DIST_SPMV_RTOL = 1e-5  # max |y_dist - y_csr| / max |y_csr|: the JAX distributed tests' bound
DIST_CYCLE_RTOL = 1e-5  # max |z - z_plain| / max |z_plain| of one V-cycle: the CPU tests' bound
DIST_TIMED = 50  # dist_spmv calls a timing


def _merge(*counts) -> dict:
    out = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return {k: v for k, v in out.items() if v}


def _times(d: dict, k: int) -> dict:
    return {name: n * k for name, n in d.items()}


def dist_launches(A) -> dict:
    """Kernel launches of one dist_spmv: one a shard and part, by the part's
    active format (COO has no kernel)."""
    return _merge(*({k: 1 for k in KERNELS_OF[name]}
                    for part in A.shard_parts for name in A.formats(part)))


def dist_cycle_launches(hier) -> dict:
    """Kernel launches of one distributed V-cycle, from the hierarchy: two
    color-block SpMVs a shard, color and sweep; a remote SpMV a shard and
    sweep but the first from a zero guess; one dist_spmv (the residual) on
    every level but the coarsest."""
    out = []
    for i, lev in enumerate(hier.levels):
        last = i == hier.nlevels - 1
        smooths = ((hier.coarse_sweeps, True),) if last else ((hier.pre, True), (hier.post, False))
        for sweeps, from_zero in smooths:
            if sweeps <= 0:
                continue
            remotes = 0 if lev.A.remote_empty else sweeps - int(from_zero)
            out += [_times({k: 1 for k in KERNELS_OF[f]}, remotes)
                    for f in lev.A.formats("remote")]
            for c, blocks in enumerate(lev.colored.shard_blocks):
                if lev.colored.live_rows[c].numel():
                    out += [_times({k: 1 for k in KERNELS_OF[b.format.name]}, 2 * sweeps)
                            for b in blocks]
        if not last:
            out.append(dist_launches(lev.A))
    return _merge(*out)


def print_dist(A, label, dt):
    print(f"  {label}: {A} built in {dt:.2f} s; per-shard formats: "
          + "; ".join(f"{'interior' if p == 'local' and A.split else p} {list(A.formats(p))}"
                      for p in A.shard_parts), flush=True)


def dist_solve_counted(torch, D, b, A, label, cg_iters):
    """cg(operator(D)) over a DistSparseMatrix with every SpMV counted: each
    kernel must launch as often as the device's dist_spmv calls issue it."""
    from repro_torch.core.solvers import cg, operator
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import solver_vec as sv

    apply_A = operator(D)
    calls = [0]

    def counted(v):
        calls[0] += 1
        return apply_A(v)

    before, sv_before = kops.launch_counts(), sum(sv.launches.values())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = cg(counted, b, tol=CG_TOL, maxiter=CG_MAXITER)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    after = kops.launch_counts()
    launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    device, _ = loop_counts(label, {"dist_spmv": calls[0]}, {"dist_spmv": 1},
                            sum(sv.launches.values()) - sv_before)
    want = _times(dist_launches(D), device["dist_spmv"])
    err = float((res.x - 1.0).abs().max())
    rel = float(res.resnorm) / float(b.norm())
    print(f"  {label}: {res.iters} iters (path (a) DIA: {cg_iters}), {dt * 1e3:.2f} ms "
          f"({dt * 1e3 / max(res.iters, 1):.4f} ms/iter), max|x-1|={err:.3e}, cg rel "
          f"residual={rel:.3e}, true rel residual={true_residual(torch, A, b, res.x):.3e}, "
          f"dist_spmv calls {calls[0]}, launches={launched}", flush=True)
    check(res.x.shape == b.shape and bool(torch.isfinite(res.x).all()),
          f"{label}: finite x of shape {tuple(b.shape)}")
    check(res.iters < CG_MAXITER and rel <= CG_TOL * (1 + 1e-5), f"{label}: converged to tol={CG_TOL}")
    check(err < X_TOL, f"{label}: max|x-1| < {X_TOL}")
    check(abs(res.iters - cg_iters) <= DIST_CG_SLACK,
          f"{label}: iterations within {DIST_CG_SLACK} of path (a)'s DIA count {cg_iters}")
    check(launched == want, f"{label}: launches {launched} == the SpMVs the device ran {want}")
    return res, dt, want


def dist_spmv_checks(torch, D, x, y_csr, label):
    """One dist_spmv against the single-device CSR kernel's y, a bitwise
    rerun, and one run with any device->host sync raising."""
    from repro_torch.core.distributed import dist_spmv
    y = dist_spmv(D, x)
    rel = float((y - y_csr).abs().max() / y_csr.abs().max())
    check(rel <= DIST_SPMV_RTOL, f"{label}: dist_spmv within {DIST_SPMV_RTOL} of the "
                                 f"single-device CSR kernel SpMV (max rel {rel:.3e})")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y2 = dist_spmv(D, x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(torch.equal(y, y2), f"{label}: dist_spmv under set_sync_debug_mode('error'): no "
                              f"device->host sync, and a bitwise rerun")
    return y


def dist_parts_vs_plain(torch, np, D, label):
    """Every candidate variant of the interior, boundary and remote parts,
    on every shard, through its kernel against its plain version (COO has
    no kernel), and a bitwise rerun; one line a part and format."""
    from repro_torch.core.convert import part_of
    from repro_torch.core.ops import spmv
    rng = np.random.default_rng(SEED)
    tol = TOL["float32"]
    for part in D.shard_parts:
        union = getattr(D, part)
        x = torch.from_numpy(rng.standard_normal(union.shape[1]).astype(np.float32)).cuda()
        for fmt, var in zip(union.candidates, union.variants):
            if not KERNELS_OF[fmt.name]:
                continue
            worst, close, same, rows = 0.0, True, True, []
            for p in range(D.nshards):
                C = part_of(var, p)
                y1, y2, y_p = spmv(C, x), spmv(C, x), spmv(C, x, backend="ref")
                worst = max(worst, float((y1 - y_p).abs().max()))
                close &= bool(torch.allclose(y1, y_p, **tol))
                same &= bool(torch.equal(y1, y2))
                rows.append(int((y_p != 0).sum()))
            check(close and same, f"{label} {part} {fmt.name} {union.shape[0]}x{union.shape[1]} "
                                  f"on {D.nshards} shards (rows with a nonzero sum: {min(rows)}-"
                                  f"{max(rows)}): max_abs_err={worst:.3e} vs plain (rtol="
                                  f"{tol['rtol']}, atol={tol['atol']}), bitwise reruns")


def dist_color_blocks_vs_plain(torch, np, hier, label):
    """The smoother's color blocks on every level, color and shard (what
    v_cycle_dist runs: stacked (rmax, mp) blocks whose capacity padding
    sits in row 0) through their kernels against their plain versions, and
    a bitwise rerun; one line a level and format (COO has no kernel)."""
    from repro_torch.core.ops import spmv
    rng = np.random.default_rng(SEED)
    tol = TOL["float32"]
    for li, lev in enumerate(hier.levels):
        x = torch.from_numpy(rng.standard_normal(lev.A.mp).astype(np.float32)).cuda()
        seen = {}
        for c, blocks in enumerate(lev.colored.shard_blocks):
            for blk in blocks:
                if not KERNELS_OF[blk.format.name]:
                    continue
                y1, y2, y_p = spmv(blk, x), spmv(blk, x), spmv(blk, x, backend="ref")
                n, worst, close, same = seen.get(blk.format.name, (0, 0.0, True, True))
                seen[blk.format.name] = (n + 1, max(worst, float((y1 - y_p).abs().max())),
                                         close and bool(torch.allclose(y1, y_p, **tol)),
                                         same and bool(torch.equal(y1, y2)))
        for name, (n, worst, close, same) in seen.items():
            check(close and same, f"{label} level {li} {'x'.join(map(str, lev.dims))}: {n} "
                                  f"{name} color blocks (colors x shards) max_abs_err="
                                  f"{worst:.3e} vs plain (rtol={tol['rtol']}, atol="
                                  f"{tol['atol']}), bitwise reruns")


def coo_plain_times(torch, A, hyb, Du, x):
    """ms a call (CUDA events, median of DIST_TIMED, in turns) of the plain
    COO SpMV, which is what runs on the card (COO has no kernel), three
    ways: atomic adds over the entries (index_add_: the single-device
    version before the distributed layer, which does not rerun bitwise), a
    stable sort by row on every call, and the row order made once a
    container (ops.coo_row_order: what the port runs). On the 104^3 COO, on
    HYB's plain version (ELL part + COO tail) and on the exchange phase of
    the P = 8 uniform DIA/COO dist_spmv (halo gather + the COO remote parts)."""
    from repro_torch.core import ops
    from repro_torch.core.distributed import dist_spmv_phase
    from repro_torch.core.formats import COO

    def atomic(C, v):
        return ops.segment_sum(C.data * ops.take_clip(v, C.col), C.row, C.shape[0])

    def resort(C, v):
        cols, data, offsets = ops.coo_row_order(C)
        return torch.segment_reduce(data * v.index_select(0, cols), "sum", offsets=offsets)

    variants = {"atomic": atomic, "sort each call": resort, "row order kept": ops._spmv_coo}
    cases = {f"COO {A.shape[0]}x{A.shape[1]} ({A.nnz} entries)": lambda f: f(A, x),
             f"HYB plain (k={hyb.k}, tail {hyb.coo.nnz})":
                 lambda f: ops._spmv_ell(hyb.ell, x) + f(hyb.coo, x),
             f"dist_spmv exchange phase, P={Du.nshards} uniform DIA/COO":
                 lambda f: dist_spmv_phase(Du, x, "exchange")}
    y_a, y_k = atomic(A, x), ops._spmv_coo(A, x)
    check(bool(torch.allclose(y_a, y_k, **TOL["float32"])),
          "the plain COO SpMV with atomic adds and in the kept row order agree")
    for case, run in cases.items():
        ms = {}
        for name in list(variants) + list(variants)[::-1]:
            ops._SPMV[COO] = variants[name]
            try:
                ms.setdefault(name, []).append(
                    time_ms(lambda: run(variants[name]), DIST_TIMED))
            finally:
                ops._SPMV[COO] = ops._spmv_coo
        print(f"  plain COO SpMV, {case}, ms a call (CUDA events, median of {DIST_TIMED}, in "
              f"turns): " + ", ".join(f"{k} {v}" for k, v in ms.items()), flush=True)


def queued_ms(torch, fn, x, calls: int = 20) -> float:
    """Device ms a call of ``fn(x)``: ``calls`` calls queued behind a spin
    long enough for the host to enqueue them all, timed by CUDA events."""
    fn(x)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e6 * calls * 0.1))  # ~0.1 ms of spin a call
    e0.record()
    for _ in range(calls):
        fn(x)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / calls


def dist_padding_probe(torch, hier, D, peak_bw):
    """The CSR parts of stacked containers keep their capacity padding (row
    0, value 0: the JAX package's layout) at the end of row 0, which the CSR
    kernel's long-row schedule cuts into chunks: device ms of the last
    level's color blocks 0 and 7 and of the boundary parts of shards 0 and
    P/2, each beside its bound, the library call (torch.sparse_csr_tensor @
    x on the same arrays, launches queued alike) and a check against the
    plain version; then the padded part's time over the unpadded one's (the
    schedule's goal: at most 2x)."""
    from repro_torch.core.ops import spmv
    lev = hier.levels[-1]
    cases = [(f"level {hier.nlevels - 1} color {c} block {blk.shape[0]}x{blk.shape[1]}",
              f"color{c}", blk)
             for c, blk in ((c, lev.colored.shard_blocks[c][0]) for c in (0, 7))]
    if "boundary" in D.shard_parts:
        for p in (0, D.nshards // 2):
            cases.append((f"P={D.nshards} shard {p} boundary", f"boundary{p}",
                          D.shard_parts["boundary"][p]))
    tol = TOL["float32"]
    got = {}
    for label, key, C in cases:
        if C.format.name != "CSR":
            print(f"  {label}: {C.format.name}, not CSR", flush=True)
            continue
        m, n = C.shape
        x = torch.ones(n, device="cuda")
        nnz = int(C.indptr[-1])
        dead = int((C.data == 0).sum())
        row0 = int(C.indptr[1] - C.indptr[0])
        y_k, y_p = spmv(C, x), spmv(C, x, backend="ref")
        check(bool(torch.allclose(y_k, y_p, **tol)) and torch.equal(y_k, spmv(C, x)),
              f"{label} CSR: kernel within rtol={tol['rtol']}, atol={tol['atol']} of plain "
              f"(max_abs_err={float((y_k - y_p).abs().max()):.3e}), bitwise rerun")
        ms = queued_ms(torch, lambda v: spmv(C, v), x)
        lib = torch.sparse_csr_tensor(C.indptr, C.indices[:nnz], C.data[:nnz], size=C.shape)
        lib_ms = queued_ms(torch, lambda v: torch.mv(lib, v), x)
        nbytes = (m + 1) * 4 + nnz * 8 + (n + m) * 4  # every entry in a row, padding too
        bound = nbytes / peak_bw * 1e3
        print(f"  {label} CSR: {C.capacity} stored, {dead} dead (padding), row 0 holds {row0}; "
              f"{ms:.4f} ms a call on the device (launches queued), bound {bound:.4f} ms "
              f"({nbytes / 1e6:.2f} MB), library torch.sparse_csr_tensor @ x {lib_ms:.4f} ms",
              flush=True)
        got[key] = (ms, row0)
        CSR_READINGS[f"{key}_P{D.nshards if key.startswith('boundary') else DIST_MG_SHARDS}"] = {
            "ms": ms, "bound_ms": bound, "bound_by": "bytes", "library_ms": lib_ms,
            "stored": C.capacity, "dead": dead, "row0": row0}
    for a, b in (("color0", "color7"), ("boundary0", f"boundary{D.nshards // 2}")):
        if a in got and b in got:
            (pad, _), (plain, _) = sorted((got[a], got[b]), key=lambda t: -t[1])
            r = pad / plain
            print(f"  {a} / {b}: the part whose row 0 holds the padding takes {r:.2f}x the "
                  f"other's time (the long-row schedule's goal, at most 2x: "
                  f"{'met' if r <= 2 else 'missed'})", flush=True)


def dist_build_phases(torch, prob, nshards):
    """Seconds of each phase of a Multi-Format build, run apart and
    synchronised: the slab plan (host), the partition scatter, the split,
    the batched plan and conversion of every candidate, the ml selection."""
    from repro_torch.core import hpcg
    from repro_torch.core.convert import convert_execute_batch, plan_switch_batch
    from repro_torch.core.distributed import partition_execute, split_local_execute
    from repro_torch.core.dynamic import DEFAULT_CANDIDATES
    from repro_torch.tuning import FormatPolicy

    out = {}

    def lap(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        out[name] = time.perf_counter() - t0
        return r

    plan = lap("slab plan", lambda: hpcg.slab_plan(prob, nshards))
    local, remote = lap("partition", lambda: partition_execute(prob.row, prob.col, prob.val,
                                                               plan, device="cuda"))
    interior, boundary = lap("split", lambda: split_local_execute(
        local, remote, plan.mp, plan.interior_cap, plan.boundary_cap))
    parts = (interior, boundary, remote)
    for f in DEFAULT_CANDIDATES:
        lap(f"convert {f.name}", lambda: [convert_execute_batch(C, plan_switch_batch(C, f))
                                         for C in parts])
    lap("ml selection", lambda: [FormatPolicy("ml").select_batch(C) for C in parts])
    return out


def phase_dist(torch, np, prob, A, b, cg_dia, peak_bw):
    """Path (g): the distributed layer at 104^3 on one card. (g1) uniform
    DIA/COO and (g2) Multi-Format (ml, then analytic) at P = 8: dist_spmv
    against the single-device CSR kernel, bitwise and without a sync, CG
    with launches = SpMVs, every part's kernels against their plain
    versions, activate_dist and back; (g3) distributed MG-PCG at P = 4
    (ml), held within one iteration of the same solve through the plain
    versions; (g4) times."""
    from repro_torch.core.distributed import activate_dist, build_dist_matrix, dist_spmv
    from repro_torch.core import hpcg
    from repro_torch.core.dynamic import DynamicMatrix
    from repro_torch.core.formats import Format
    from repro_torch.core.ops import spmv
    from repro_torch.core.solvers import operator, pcg
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import solver_vec as sv
    from repro_torch.mg import build_dist_hierarchy

    cg_iters, cg_s = cg_dia
    P = DIST_SHARDS
    print(f"== main path (g) at {'x'.join(map(str, GRID))}: the distributed layer, P = {P} "
          f"(uniform DIA/COO, Multi-Format ml and analytic) and P = {DIST_MG_SHARDS} (MG-PCG)",
          flush=True)
    # outside the counted run: the single-device references of this run
    D = DynamicMatrix(A)
    csr, dia = D.activate(Format.CSR), D.activate(Format.DIA)
    x = torch.randn(A.shape[0], device="cuda", generator=torch.Generator("cuda").manual_seed(SEED))
    y_csr = spmv(csr, x)
    del csr
    plan = hpcg.slab_plan(prob, P)
    print(f"  slab plan: mp={plan.mp} hw={plan.hw} local_cap={plan.local_cap} remote_cap="
          f"{plan.remote_cap} interior_cap={plan.interior_cap} boundary_cap={plan.boundary_cap}",
          flush=True)
    check(plan.mp == 140608 and plan.hw == 10816, "P = 8 z-slabs of 13 planes, halo 104 x 104")

    start_path(torch)
    mats, want = {}, []
    for label, kw in (("uniform DIA/COO", dict(local_format=Format.DIA, remote_format=Format.COO)),
                      ("multiformat ml", dict(mode="multiformat", tune="ml")),
                      ("multiformat analytic", dict(mode="multiformat", tune="analytic"))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Dm = build_dist_matrix(prob.row, prob.col, prob.val, prob.shape, P, device="cuda",
                               plan=plan, check_plan=False, **kw)
        torch.cuda.synchronize()
        print_dist(Dm, label, time.perf_counter() - t0)
        check(Dm.split and Dm.halo_mode == "neighbor", f"{label}: split, neighbor halo")
        before = kops.launch_counts()
        dist_spmv_checks(torch, Dm, x, y_csr, label)
        after = kops.launch_counts()
        want.append(_times(dist_launches(Dm), 2))
        check(_merge({k: after[k] - before[k] for k in after}) == want[-1],
              f"{label}: one dist_spmv launches {dist_launches(Dm)}")
        res, dt, want_cg = dist_solve_counted(torch, Dm, b, A, f"dist cg {label}", cg_iters)
        want.append(want_cg)
        if label == "multiformat ml":
            B = activate_dist(Dm, "local", Format.CSR)
            y_b = dist_spmv(B, x)
            y_back = dist_spmv(activate_dist(B, "local", Dm.local.active_id), x)
            rel = float((y_b - y_csr).abs().max() / y_csr.abs().max())
            check(B.formats("local") == ("CSR",) * P and rel <= DIST_SPMV_RTOL
                  and torch.equal(y_back, dist_spmv(Dm, x)),
                  f"activate_dist(local, CSR): y within {DIST_SPMV_RTOL} ({rel:.3e}); "
                  f"and back: bitwise the first y")
            want.append(_times(dist_launches(B), 1))
            want.append(_times(dist_launches(Dm), 2))
        mats[label] = (Dm, res, dt)

    # (g3) distributed MG-PCG
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hier = build_dist_hierarchy(prob, DIST_MG_SHARDS, device="cuda", mode="multiformat",
                                tune="ml")
    torch.cuda.synchronize()
    dt_h = time.perf_counter() - t0
    print(f"  {hier} built in {dt_h:.2f} s", flush=True)
    for rec in hier.formats():
        print(f"    level {rec['level']} {'x'.join(map(str, rec['dims']))}: interior "
              f"{rec['local']} boundary {rec['boundary']} remote {rec['remote']} colors "
              f"{rec['colors']}", flush=True)
    check([lev.dims for lev in hier.levels] == [GRID, tuple(d // 2 for d in GRID)],
          "JAX's depth rule at P = 4: 104^3 > 52^3 ((26 / 2) % 4 != 0 stops it)")
    A0 = hier.levels[0].A
    apply_A, apply_M = operator(A0), hier.apply_M()
    calls = {"A": 0, "M": 0}

    def counted_A(v):
        calls["A"] += 1
        return apply_A(v)

    def counted_M(r):
        calls["M"] += 1
        return apply_M(r)

    before, sv_before = kops.launch_counts(), sum(sv.launches.values())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mg = pcg(counted_A, b, tol=CG_TOL, maxiter=CG_MAXITER, apply_M=counted_M)
    torch.cuda.synchronize()
    dt_mg = time.perf_counter() - t0
    after = kops.launch_counts()
    launched = _merge({k: after[k] - before[k] for k in after})
    device, masked = loop_counts("dist MG-PCG", calls, {"A": 1, "M": 1},
                                 sum(sv.launches.values()) - sv_before)
    per_cycle = dist_cycle_launches(hier)
    want_mg = _merge(_times(dist_launches(A0), device["A"]), _times(per_cycle, device["M"]))
    want.append(want_mg)
    err = float((mg.x - 1).abs().max())
    print(f"  dist MG-PCG P={DIST_MG_SHARDS}: {mg.iters} iters (cg {cg_iters}), {dt_mg * 1e3:.2f} ms "
          f"({dt_mg * 1e3 / max(mg.iters, 1):.4f} ms/iter), max|x-1|={err:.3e}, true rel "
          f"residual={true_residual(torch, A, b, mg.x):.3e}; V-cycles {calls['M']} x "
          f"{per_cycle}; launches={launched}", flush=True)
    check(mg.iters < cg_iters and err < X_TOL and bool(torch.isfinite(mg.x).all()),
          f"dist MG-PCG converges (max|x-1| < {X_TOL}) in fewer iterations than CG's {cg_iters}")
    check(device["A"] == device["M"] == mg.iters + 1 + masked and launched == want_mg,
          f"dist MG-PCG: launches {launched} == the SpMVs the device ran {want_mg}")
    counts = read_path(torch, "(g)", sorted(_merge(*want)) + ["solver_vec"])
    check({k: counts[k] for k in kops.LAUNCH_COUNTERS if counts[k]} == _merge(*want),
          f"path (g): every launch is an SpMV the path issued ({_merge(*want)})")

    # outside the counted run: the plain versions, kernels on the parts,
    # times. The solve through the plain SpMVs and V-cycle still runs its
    # loop through solver_vec's kernels (held against their plain versions
    # in phase_solver_vec)
    t0 = time.perf_counter()
    hier_ref = dataclasses.replace(hier, backend="ref")
    ref = pcg(operator(A0, backend="ref"), b, tol=CG_TOL, maxiter=CG_MAXITER,
              apply_M=hier_ref.apply_M())
    torch.cuda.synchronize()
    print(f"  dist MG-PCG through the plain versions: {ref.iters} iters, max|x-1|="
          f"{float((ref.x - 1).abs().max()):.3e}, {time.perf_counter() - t0:.2f} s", flush=True)
    check(abs(ref.iters - mg.iters) <= 1, "dist MG-PCG within one iteration of the same solve "
                                          "through the plain versions")
    r = b.clone()
    z1 = apply_M(r)
    z_p = hier_ref.apply_M()(r)
    rel = float((z1 - z_p).abs().max() / z_p.abs().max())
    check(rel <= DIST_CYCLE_RTOL, f"one dist V-cycle within {DIST_CYCLE_RTOL} of the V-cycle "
                                  f"through the plain versions (max rel {rel:.3e})")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        z2 = apply_M(r)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(torch.equal(z1, z2), "dist V-cycle under set_sync_debug_mode('error'): no "
                               "device->host sync, and a bitwise rerun")
    dist_parts_vs_plain(torch, np, mats["multiformat ml"][0], f"P={P}")
    dist_parts_vs_plain(torch, np, A0, f"P={DIST_MG_SHARDS}")
    dist_color_blocks_vs_plain(torch, np, hier, f"P={DIST_MG_SHARDS}")

    # (g4) times
    cyc = time_v_cycle(torch, apply_M, r, f"dist V-cycle, P={DIST_MG_SHARDS} ml")
    Du, Dml = mats["uniform DIA/COO"][0], mats["multiformat ml"][0]
    loop_readings(torch, f"path (g) dist CG P={P} uniform DIA/COO", operator(Du), b)
    loop_readings(torch, f"path (g) dist MG-PCG P={DIST_MG_SHARDS} ml", operator(A0), b,
                  apply_M=apply_M)
    spmv_ms = {}
    for name, fn in (("dia", lambda: spmv(dia, x)), ("uniform", lambda: dist_spmv(Du, x)),
                     ("ml", lambda: dist_spmv(Dml, x)), ("ml ", lambda: dist_spmv(Dml, x)),
                     ("uniform ", lambda: dist_spmv(Du, x)), ("dia ", lambda: spmv(dia, x))):
        spmv_ms.setdefault(name.strip(), []).append(time_ms(fn, DIST_TIMED))
    print("  ms a call (CUDA events, median of "
          f"{DIST_TIMED}, in turns dia, uniform, ml, ml, uniform, dia): single-device DIA "
          f"kernel {spmv_ms['dia']}, dist_spmv P={P} uniform DIA/COO {spmv_ms['uniform']}, "
          f"Multi-Format ml {spmv_ms['ml']}", flush=True)
    time_v_cycle(torch, lambda v: dist_spmv(Du, v), x, f"dist_spmv P={P} uniform DIA/COO")
    time_v_cycle(torch, lambda v: dist_spmv(Dml, v), x, f"dist_spmv P={P} Multi-Format ml")
    dist_padding_probe(torch, hier, mats["multiformat analytic"][0], peak_bw)
    coo_plain_times(torch, A, D.activate(Format.HYB, k=18).concrete, Du, x)
    phases = dist_build_phases(torch, prob, P)
    print("  build seconds, P=8 Multi-Format, each phase apart: "
          + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()), flush=True)
    print(f"  time to solution: CG single-device DIA {cg_s * 1e3:.2f} ms ({cg_iters}); dist CG "
          + "; ".join(f"{k} {v[2] * 1e3:.2f} ms ({v[1].iters}, {v[2] * 1e3 / v[1].iters:.4f} "
                      f"ms/iter)" for k, v in mats.items())
          + f"; dist MG-PCG P={DIST_MG_SHARDS} {dt_mg * 1e3:.2f} ms ({mg.iters}, "
            f"{dt_mg * 1e3 / mg.iters:.4f} ms/iter, V-cycle {cyc['host_ms']:.4f} ms host / "
            f"{cyc['device_ms']:.4f} device)", flush=True)
    return counts


# ---------------------------------------------------------------------------
# Sparse-weight serving: the SpMM kernels and path (d)
# ---------------------------------------------------------------------------

# minitron-8b's MLP linears, (d_in, d_out): d_model 4096, d_ff 16384
# (src/repro/configs/minitron_8b.py), magnitude-pruned to density 0.25.
MINITRON_MLP = {"up": (4096, 16384), "down": (16384, 4096)}
DENSITY = 0.25
DECODE, PREFILL = 1, 256
LAYER_FORMATS = ("CSR", "ELL", "SELL", "HYB", "COO")
SPMM_T_KERNELS_OF = {"CSR": ("csr_spmm_t",), "ELL": ("ell_spmm_t",), "SELL": ("sell_spmm_t",),
                     "HYB": ("ell_spmm_t", "csr_spmm_t"), "COO": ()}
SPMM_KERNELS = ("csr_spmm", "csr_spmm_t", "ell_spmm", "ell_spmm_t", "sell_spmm", "sell_spmm_t")
SPMM_REPLACES = {"csr_spmm": "src/repro/kernels/csr_spmm.py:158",
                 "csr_spmm_t": "src/repro/kernels/csr_spmm.py:209",
                 "ell_spmm": "src/repro/kernels/ell_spmv.py:156",
                 "ell_spmm_t": "src/repro/kernels/ell_spmv.py:194",
                 "sell_spmm": "src/repro/kernels/sell_spmv.py:133",
                 "sell_spmm_t": "src/repro/kernels/sell_spmv.py:190"}
ORACLE_RTOL = 1e-4  # max |y - oracle| / max |oracle|, float32 against float64
# SELL's slice schedule (sell_spmm for Kb <= 8, sell_spmm_t at xt = 0): its
# width-1 cells on both weights and dtypes, and its sweep of widths
SELL_SLICE_KERNELS = ("sell_spmm", "sell_spmm_t")
SLICE_SWEEP_T = (1, 2, 4, 8, 16, 32)  # below ops.SELL_XT_FROM = 64
SLICE_SWEEP_KB = (1, 2, 4, 8)  # up to sell_spmm.SLICE_MAX_TOKENS
SELL_WIDTH1 = {}  # "kernel weight dtype" -> the width-1 readings


def make_weights(np):
    """Both MLP weights and biases, from numpy seed SEED (host, once)."""
    from repro_torch.models import prune_magnitude
    rng = np.random.default_rng(SEED)
    out = {}
    for name, (d_in, d_out) in MINITRON_MLP.items():
        w = prune_magnitude(rng.standard_normal((d_in, d_out)).astype(np.float32), DENSITY)
        out[name] = (w, rng.standard_normal(d_out).astype(np.float32))
    return out


def ragged_spmm_cases(rng, torch, dtype, name):
    """The SpMM kernels at the edges of their contracts: empty rows, CSR
    capacity padding of NaN, ELL K = 0 and clamped columns, SELL ghost lanes
    holding NaN and C != 32, T in {1, 3, 256}, a 70000-wide X, B widths
    K in {1, 3, 9, 256, 300} (300: past one 256-column tile), and a HYB
    whose tail padding holds NaN."""
    import numpy as np
    from repro_torch.core.convert import convert
    from repro_torch.core.formats import COO, HYB, Format, coo_from_dense_np
    from repro_torch.kernels import csr_spmm as kcm, ell_spmm as kem, sell_spmm as ksm
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.ref import (csr_spmm_ref, csr_spmm_t_ref, ell_spmm_ref,
                                         ell_spmm_t_ref, sell_spmm_ref, sell_spmm_t_ref)
    lens = [0, 3, 0, 0, 700, 1, 27, 0, 64, 0, 1030]
    m, nnz = len(lens), sum(lens)
    for n in (900, 70000):
        indptr = torch.tensor([0] + list(itertools.accumulate(lens)), dtype=torch.int32,
                              device="cuda")
        idx = torch.from_numpy(rng.integers(-2, n + 2, nnz + 37).astype("int32")).cuda()
        val = _rand(rng, torch, nnz + 37, dtype)
        val[nnz:] = float("nan")
        for t in (1, 3, 256, 257):
            X = _rand(rng, torch, (t, n), dtype)
            y_p = csr_spmm_t_ref(indptr, idx, val, X, m)
            scale = csr_spmm_t_ref(indptr, idx, val.abs(), X.abs(), m)
            for vec, tt in ((4, 1), (32, 8), (8, 2), (16, 4)):
                compare(f"csr_spmm_t ragged m={m} n={n} T={t} vec={vec} tt={tt}",
                        kcm.csr_spmm_t(indptr, idx, val, X, m, vec=vec, tt=tt),
                        kcm.csr_spmm_t(indptr, idx, val, X, m, vec=vec, tt=tt),
                        y_p, name, scale=scale)
            for xt in kcm.XT_TILES:  # unsorted, out-of-range columns: filtered rows
                compare(f"csr_spmm_t ragged m={m} n={n} T={t} xt={xt}",
                        kcm.csr_spmm_t(indptr, idx, val, X, m, vec=32, xt=xt),
                        kcm.csr_spmm_t(indptr, idx, val, X, m, vec=32, xt=xt),
                        y_p, name, scale=scale)
        if n == 900:
            for k in (1, 3, 256):
                B = _rand(rng, torch, (n, k), dtype)
                y1 = kcm.csr_spmm(indptr, idx, val, B, m, vec=8)
                compare(f"csr_spmm ragged m={m} K={k}", y1,
                        kcm.csr_spmm(indptr, idx, val, B, m, vec=8),
                        csr_spmm_ref(indptr, idx, val, B, m), name,
                        scale=csr_spmm_ref(indptr, idx, val.abs(), B.abs(), m))
                check(not bool(y1[0].any()), f"csr_spmm K={k}: an empty row writes zeros")
    for m, n, k in ((300, 250, 0), (300, 250, 27), (257, 90, 70)):
        cols = rng.integers(-3, n + 3, (m, k)).astype(np.int32)
        vals = rng.standard_normal((m, k)).astype(np.float32)
        cols[::7], vals[::7] = -1, 0.0
        c_t, v_t = torch.from_numpy(cols).cuda(), torch.from_numpy(vals).to("cuda", dtype)
        for t in (1, 3, 256):
            X = _rand(rng, torch, (t, n), dtype)
            before = kem.launches_t
            y1 = kem.ell_spmm_t(c_t, v_t, X, vec=8)
            y2 = kem.ell_spmm_t(c_t, v_t, X, vec=8)
            check(kem.launches_t - before == (2 if k else 0),
                  f"ell_spmm_t K={k}: {kem.launches_t - before} launches for 2 calls")
            y_p = ell_spmm_t_ref(c_t, v_t, X)
            scale = ell_spmm_t_ref(c_t, v_t.abs(), X.abs())
            compare(f"ell_spmm_t ragged {m}x{n} K={k} T={t}", y1, y2, y_p, name, scale=scale)
            for xt in kcm.XT_TILES:
                before = kem.launches_xt
                y1 = kem.ell_spmm_t(c_t, v_t, X, vec=8, xt=xt)
                compare(f"ell_spmm_t ragged {m}x{n} K={k} T={t} xt={xt}", y1,
                        kem.ell_spmm_t(c_t, v_t, X, vec=8, xt=xt), y_p, name, scale=scale)
                check(kem.launches_xt - before == (2 if k else 0),
                      f"ell_spmm_t K={k} xt={xt}: {kem.launches_xt - before} token-major "
                      "launches for 2 calls")
        for kb, vec in ((1, 2), (3, 8), (9, 8), (256, 8), (300, 8)):
            B = _rand(rng, torch, (n, kb), dtype)
            y_p, scale = ell_spmm_ref(c_t, v_t, B), ell_spmm_ref(c_t, v_t.abs(), B.abs())
            for xt in (0,) + (kcm.XT_TILES if kb >= 32 else ()):
                before = (kem.launches, kem.launches_kxt)
                y1 = kem.ell_spmm(c_t, v_t, B, vec=vec, xt=xt)
                y2 = kem.ell_spmm(c_t, v_t, B, vec=vec, xt=xt)
                launched = (kem.launches - before[0], kem.launches_kxt - before[1])
                check(launched == ((2, 2 * bool(xt)) if k else (0, 0)),
                      f"ell_spmm K={k} xt={xt}: {launched} (all, token-major) launches for "
                      "2 calls")
                compare(f"ell_spmm ragged {m}x{n} K={k} Kb={kb} vec={vec} xt={xt}", y1, y2,
                        y_p, name, scale=scale)
    m, n = 301, 120
    a = _ragged_dense(rng, m, n)
    for c, sigma in ((32, 256), (8, 16), (5, 5)):
        S = convert(coo_from_dense_np(a, device="cpu"), Format.SELL, c=c, sigma=sigma)
        data = S.data.clone()
        ptrs, perm = S.slice_ptrs.tolist(), S.perm.tolist()
        for lane, row in enumerate(perm):
            if row >= m:
                s, r = divmod(lane, c)
                data[ptrs[s] + r:ptrs[s + 1]:c] = float("nan")
        args = [t.cuda() for t in (S.slice_ptrs, S.cols, data.to(dtype), S.perm)]
        for t in (1, 3, 256):
            X = _rand(rng, torch, (t, n), dtype)
            s_abs = [args[0], args[1], args[2].abs(), args[3]]  # ghost lanes: dropped
            y_p, scale = sell_spmm_t_ref(*args, X, m, c), sell_spmm_t_ref(*s_abs, X.abs(), m, c)
            for xt in (0,) + kcm.XT_TILES:
                compare(f"sell_spmm_t ragged m={m} C={c} T={t} xt={xt} (NaN ghost lanes)",
                        ksm.sell_spmm_t(*args, X, m, c, xt=xt),
                        ksm.sell_spmm_t(*args, X, m, c, xt=xt), y_p, name, scale=scale)
        s_abs = [args[0], args[1], args[2].abs(), args[3]]
        for kb in (1, 3, 9, 256, 300):
            B = _rand(rng, torch, (n, kb), dtype)
            compare(f"sell_spmm ragged m={m} C={c} Kb={kb} (NaN ghost lanes)",
                    ksm.sell_spmm(*args, B, m, c), ksm.sell_spmm(*args, B, m, c),
                    sell_spmm_ref(*args, B, m, c), name,
                    scale=sell_spmm_ref(*s_abs, B.abs(), m, c))
    if name != "float32":
        return  # HYB adds two outputs rounded to bf16: its parts are checked above
    # HYB SpMM: tail padding with row id M and NaN values sorts past indptr[M]
    m, n = 64, 40
    H = convert(coo_from_dense_np(_ragged_dense(rng, m, n), device="cuda", dtype=dtype),
                Format.HYB, k=3)
    pad = 5
    t = H.coo
    Hp = HYB(H.ell, COO(torch.cat([t.row, torch.full((pad,), m, dtype=torch.int32,
                                                     device="cuda")]),
                        torch.cat([t.col, torch.zeros(pad, dtype=torch.int32, device="cuda")]),
                        torch.cat([t.data, torch.full((pad,), float("nan"), dtype=dtype,
                                                      device="cuda")]), t.shape, t.nnz + pad),
             H.shape, H.nnz)
    tail = kops.tail_csr(H.coo, m)
    for kb in (1, 9, 300):
        B = _rand(rng, torch, (n, kb), dtype)
        compare(f"hyb_spmm ragged m={m} k=3 Kb={kb} (NaN tail padding)",
                kops.hyb_spmm(Hp, B), kops.hyb_spmm(Hp, B),
                ell_spmm_ref(H.ell.cols, H.ell.data, B) + csr_spmm_ref(*tail, B, m), name,
                scale=ell_spmm_ref(H.ell.cols, H.ell.data.abs(), B.abs())
                + csr_spmm_ref(tail[0], tail[1], tail[2].abs(), B.abs(), m))


def weight_containers(torch, w):
    """The stored (d_out, d_in) weight on the card as CSR, ELL, SELL and HYB."""
    from repro_torch.core.convert import convert
    from repro_torch.core.formats import Format, coo_from_dense_np
    coo = coo_from_dense_np(w.T, device="cuda")
    return {f: convert(coo, Format[f]) for f in ("CSR", "ELL", "SELL", "HYB")}


def phase_spmm_kernels(torch, np, weights, peak_bw, peak_flops):
    """The four SpMM kernels against their plain versions at the slice's
    shapes (both MLP weights, T = 1 and 256) and on ragged cases; returns
    their JSON records (the up projection's numbers)."""
    from repro_torch.kernels import csr_spmm as kcm, ell_spmm as kem, sell_spmm as ksm
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.ref import (csr_spmm_ref, csr_spmm_t_ref, ell_spmm_ref,
                                         ell_spmm_t_ref, sell_spmm_ref, sell_spmm_t_ref)

    print("== SpMM kernels at minitron-8b MLP width (density 0.25) and ragged shapes",
          flush=True)
    rng = np.random.default_rng(SEED + 1)
    records = {}
    for lname, (w, _) in weights.items():
        mats = weight_containers(torch, w)
        csr, ell, sell, hyb = mats["CSR"], mats["ELL"], mats["SELL"], mats["HYB"]
        m, n = csr.shape
        print(f"  {lname} weight stored {m}x{n}: nnz={csr.nnz}, ELL K={ell.k}, "
              f"SELL C={sell.c} capacity={sell.capacity}, HYB k={hyb.k} tail={hyb.coo.nnz}",
              flush=True)
        lib = torch.sparse_csr_tensor(csr.indptr, csr.indices, csr.data, size=csr.shape)
        w_dense = torch.from_numpy(w).cuda()
        for dtype in (torch.float32, torch.bfloat16):
            name = "float32" if dtype == torch.float32 else "bfloat16"
            es = torch.empty((), dtype=dtype).element_size()
            cd, ed, sd = (c.data.to(dtype) for c in (csr, ell, sell))
            # the library call in this dtype (f32: the weight as stored) and
            # the dense product in this dtype, timed for every cell of the
            # slice schedule's width-1 rows and the up f32 cells
            lib_dt = lib if dtype == torch.float32 else torch.sparse_csr_tensor(
                csr.indptr, csr.indices, cd, size=csr.shape)
            w_dt = w_dense.to(dtype)
            for t in (DECODE, PREFILL):
                X = _rand(rng, torch, (t, n), dtype)
                B = X.T.contiguous()
                cfg_c = kops.default_config(csr, op="spmm_t", ncols=t)
                cfg_e = kops.default_config(ell, op="spmm_t", ncols=t)
                cfg_s = kops.default_config(sell, op="spmm_t", ncols=t)
                cfg_cb = kops.default_config(_with_values(csr, cd), op="spmm", ncols=t)
                cfg_sb = kops.default_config(_with_values(sell, sd), op="spmm", ncols=t)
                cfg_eb = kops.default_config(ell, op="spmm", ncols=t)
                Xa, Ba = X.abs(), B.abs()
                runs = {
                    "csr_spmm": (lambda: kcm.csr_spmm(csr.indptr, csr.indices, cd, B, m,
                                                      **cfg_cb),
                                 lambda: csr_spmm_ref(csr.indptr, csr.indices, cd, B, m),
                                 lambda: csr_spmm_ref(csr.indptr, csr.indices, cd.abs(), Ba, m),
                                 lambda: lib_dt @ B, f"K={t} {cfg_cb}"),
                    "csr_spmm_t": (lambda: kcm.csr_spmm_t(csr.indptr, csr.indices, cd, X, m,
                                                          **cfg_c),
                                   lambda: csr_spmm_t_ref(csr.indptr, csr.indices, cd, X, m),
                                   lambda: csr_spmm_t_ref(csr.indptr, csr.indices, cd.abs(),
                                                          Xa, m),
                                   lambda: lib_dt @ X.T, f"T={t} {cfg_c}"),
                    "ell_spmm_t": (lambda: kem.ell_spmm_t(ell.cols, ed, X, **cfg_e),
                                   lambda: ell_spmm_t_ref(ell.cols, ed, X),
                                   lambda: ell_spmm_t_ref(ell.cols, ed.abs(), Xa),
                                   lambda: lib_dt @ X.T, f"T={t} {cfg_e}"),
                    "sell_spmm_t": (lambda: ksm.sell_spmm_t(sell.slice_ptrs, sell.cols, sd,
                                                            sell.perm, X, m, sell.c, **cfg_s),
                                    lambda: sell_spmm_t_ref(sell.slice_ptrs, sell.cols, sd,
                                                            sell.perm, X, m, sell.c),
                                    lambda: sell_spmm_t_ref(sell.slice_ptrs, sell.cols,
                                                            sd.abs(), sell.perm, Xa, m, sell.c),
                                    lambda: lib_dt @ X.T, f"T={t} {cfg_s}"),
                    "ell_spmm": (lambda: kem.ell_spmm(ell.cols, ed, B, **cfg_eb),
                                 lambda: ell_spmm_ref(ell.cols, ed, B),
                                 lambda: ell_spmm_ref(ell.cols, ed.abs(), Ba),
                                 lambda: lib_dt @ B, f"K={t} {cfg_eb}"),
                    "sell_spmm": (lambda: ksm.sell_spmm(sell.slice_ptrs, sell.cols, sd,
                                                        sell.perm, B, m, sell.c, **cfg_sb),
                                  lambda: sell_spmm_ref(sell.slice_ptrs, sell.cols, sd,
                                                        sell.perm, B, m, sell.c),
                                  lambda: sell_spmm_ref(sell.slice_ptrs, sell.cols, sd.abs(),
                                                        sell.perm, Ba, m, sell.c),
                                  lambda: lib_dt @ B, f"K={t} {cfg_sb}"),
                }
                # the planted fault: each checked kernel's plain version on its
                # values with every FAULT_EVERY-th stored entry dropped
                faults = {"csr_spmm_t": (cd, lambda d: csr_spmm_t_ref(csr.indptr, csr.indices,
                                                                      d, X, m)),
                          "ell_spmm_t": (ed, lambda d: ell_spmm_t_ref(ell.cols, d, X)),
                          "sell_spmm_t": (sd, lambda d: sell_spmm_t_ref(sell.slice_ptrs,
                                                                        sell.cols, d, sell.perm,
                                                                        X, m, sell.c)),
                          "ell_spmm": (ed, lambda d: ell_spmm_ref(ell.cols, d, B)),
                          "sell_spmm": (sd, lambda d: sell_spmm_ref(sell.slice_ptrs, sell.cols,
                                                                    d, sell.perm, B, m,
                                                                    sell.c))}
                for kname, (run, plain, plain_abs, library, what) in runs.items():
                    y_p, scale = plain(), plain_abs()
                    err = compare(f"{kname} {lname} {what}", run(), run(), y_p, name,
                                  scale=scale, record=True)
                    if kname in faults:
                        planted_fault(*faults[kname], y_p, scale, f"{kname} {lname} {what}",
                                      name)
                    del y_p, scale
                    # the least time: each input read once, Y written once;
                    # the live entries (a column index and a value each) and
                    # the format's row or slice arrays, 2 flops per live entry
                    # and token (ELL's and SELL's padding slots not counted)
                    sell_idx = sell.perm.numel() * 4 + (sell.nslices + 1) * 4
                    extra = {"csr_spmm": (m + 1) * 4, "csr_spmm_t": (m + 1) * 4,
                             "ell_spmm_t": 0, "sell_spmm_t": sell_idx,
                             "ell_spmm": 0, "sell_spmm": sell_idx}
                    nbytes = csr.nnz * (4 + es) + extra[kname] + t * n * es + t * m * es
                    nops = 2 * csr.nnz * t
                    t_bytes, t_ops = nbytes / peak_bw * 1e3, nops / peak_flops * 1e3
                    bound = max(t_bytes, t_ops)
                    ms = time_ms(run, 20)
                    full = lname == "up" and dtype == torch.float32
                    width1 = kname in SELL_SLICE_KERNELS and t == DECODE
                    plan = ksm.last_plan.describe() if width1 else None
                    plain_ms = time_ms(plain, 3) if full else None
                    lib_ms = time_ms(library, 10) if full or width1 else None
                    dense_ms = (time_ms(lambda: X @ w_dt, 20) if full or width1 else None)
                    print(f"  {kname} {lname} {name} {what}: kernel {ms:.4f} ms, bound "
                          f"{bound:.4f} ms ({nbytes / 1e6:.1f} MB, {nops / 1e9:.2f} Gop, "
                          f"{'bytes' if t_bytes >= t_ops else 'operations'}) -> "
                          f"{bound / ms:.1%} of bound"
                          + (f"; plain {plain_ms:.4f} ms" if full else "")
                          + (f"; library sparse_csr @ {lib_ms:.4f} ms, dense X @ W {name} "
                             f"{dense_ms:.4f} ms" if full or width1 else "")
                          + (f"; slice plan: {plan}" if width1 else ""), flush=True)
                    if width1:
                        SELL_WIDTH1[f"{kname} {lname} {name}"] = {
                            "ms": ms, "bound_ms": bound, "share": bound / ms,
                            "library_ms": lib_ms, "dense_ms": dense_ms, "plan": plan}
                    if full:
                        sfx = "" if t == PREFILL else "_t1"
                        rec = records.setdefault(kname, {
                            "name": kname, "route": "cuda",
                            "source": f"src/repro_torch/csrc/{kname.removesuffix('_t')}.cu",
                            "replaces": SPMM_REPLACES[kname],
                            "launches": 0, "shape": f"{m}x{n} nnz={csr.nnz}"})
                        rec.update({f"max_abs_err{sfx}": err, f"ms{sfx}": ms,
                                    f"plain_ms{sfx}": plain_ms, f"bound_ms{sfx}": bound,
                                    f"bound_by{sfx}": "bytes" if t_bytes >= t_ops
                                    else "operations",
                                    f"library_ms{sfx}": lib_ms, f"dense_ms{sfx}": dense_ms})
                    elif lname == "up":
                        records[kname][f"max_abs_err_bf16{'' if t == PREFILL else '_t1'}"] = err
                if dtype == torch.float32:
                    hyb_spmm_line(torch, hyb, B, lib, peak_bw, peak_flops, f"{lname} K={t}")
                if dtype == torch.float32 and t == PREFILL and lname == "up":
                    sweep_token_tiles(lname, csr, sell, cd, sd, X, cfg_c["vec"])
                if dtype == torch.float32 and t == DECODE:
                    from repro_torch.kernels import csr_spmv as kc
                    x1 = X[0].contiguous()
                    vec = kops.default_config(csr)["vec"]
                    plan = kc.long_row_plan(csr.indptr, csr.capacity, vec)
                    spmv_ms = time_ms(lambda: kc.csr_spmv(csr.indptr, csr.indices, cd, x1, m,
                                                          vec=vec, plan=plan), 20)
                    print(f"  {lname} T=1 beside SpMV at the same nnz: csr_spmv {spmv_ms:.4f} ms "
                          f"(vec={vec}: rows above {plan.threshold} entries in "
                          f"{int(plan.chunk_end[-1]) if plan.k_max else 0} chunks)", flush=True)
            sweep_slice_schedule(torch, lname, csr, sell, sd, lib_dt, w_dt, rng, name,
                                 peak_bw, peak_flops)
            del lib_dt, w_dt
        del mats, csr, ell, sell, hyb, lib, w_dense
        torch.cuda.empty_cache()
    print(f"  sell width-1 readings (kernel ms, bound ms, share of bound, library ms, dense "
          f"ms, plan): {json.dumps(SELL_WIDTH1)}", flush=True)
    print("  weight-shape readings (|y_k - y_p| / limit; at most 1 passes): largest sound "
          + ", ".join(f"{k} {v:.3e}" for k, v in READINGS["sound"].items())
          + f"; smallest planted fault (every {FAULT_EVERY}th entry dropped) "
          + ", ".join(f"{k} {v:.3e}" for k, v in READINGS["fault"].items()), flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        ragged_spmm_cases(rng, torch, dtype, "float32" if dtype == torch.float32 else "bfloat16")
    return records


DEVICE_CALLS = 20  # calls device_ms reads


def device_ms(torch, fn, match=None):
    """Milliseconds a call of ``fn`` keeps the card busy: the durations of
    every kernel that DEVICE_CALLS calls launch (torch.profiler's CUDA
    events), summed, over DEVICE_CALLS; without the gaps the host leaves
    between launches, which a CUDA-event median of a ~50 us call can
    include. None where the profiler sees no kernel. With ``match`` (names'
    substrings) also the part of kernels whose name holds one: a pair."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(DEVICE_CALLS):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type.name == "CUDA"]
    total = sum(e.time_range.elapsed_us() for e in evs) / 1e3 / DEVICE_CALLS if evs else None
    if match is None:
        return total
    part = sum(e.time_range.elapsed_us() for e in evs if any(m in e.name for m in match))
    return total, part / 1e3 / DEVICE_CALLS


def device_readings(torch, np, weights):
    """Times on the device (device_ms) at both weights in both dtypes: rows
    6-11 (the six SpMM kernels on their default configuration) and the
    library call at width 1, and SELL's slice schedule across its sweep
    (SLICE_SWEEP_T, SLICE_SWEEP_KB), with this process's ``repro_torch``, so
    that ``--spmm-phase TREE`` reads any tree's kernels the same way. Run
    after the CUDA-event timings: on an H100, width-1 event medians taken
    after a profiler session in the same process spread by up to 60%
    (PERF.md)."""
    from repro_torch.kernels import csr_spmm as kcm, ell_spmm as kem, sell_spmm as ksm
    from repro_torch.kernels import ops as kops
    print(f"== times on the device (ms a call, torch.profiler, {DEVICE_CALLS} calls)",
          flush=True)
    rng = np.random.default_rng(SEED + 2)
    for lname, (w, _) in weights.items():
        mats = weight_containers(torch, w)
        csr, ell, sell = mats["CSR"], mats["ELL"], mats["SELL"]
        m, n = csr.shape
        for dtype in (torch.float32, torch.bfloat16):
            name = "float32" if dtype == torch.float32 else "bfloat16"
            cd, ed, sd = (c.data.to(dtype) for c in (csr, ell, sell))
            lib = torch.sparse_csr_tensor(csr.indptr, csr.indices, cd, size=csr.shape)
            X = _rand(rng, torch, (1, n), dtype)
            B = X.T.contiguous()
            cfg = {k: kops.default_config(a, op=op, ncols=1) for k, a, op in (
                ("csr_spmm", _with_values(csr, cd), "spmm"), ("csr_spmm_t", csr, "spmm_t"),
                ("ell_spmm", ell, "spmm"), ("ell_spmm_t", ell, "spmm_t"))}
            calls = {
                "csr_spmm": lambda: kcm.csr_spmm(csr.indptr, csr.indices, cd, B, m,
                                                 **cfg["csr_spmm"]),
                "csr_spmm_t": lambda: kcm.csr_spmm_t(csr.indptr, csr.indices, cd, X, m,
                                                     **cfg["csr_spmm_t"]),
                "ell_spmm": lambda: kem.ell_spmm(ell.cols, ed, B, **cfg["ell_spmm"]),
                "ell_spmm_t": lambda: kem.ell_spmm_t(ell.cols, ed, X, **cfg["ell_spmm_t"]),
                "library": lambda: lib @ B}
            for kname, widths in (("sell_spmm_t", SLICE_SWEEP_T),
                                  ("sell_spmm", SLICE_SWEEP_KB)):
                for width in widths:
                    Xw = _rand(rng, torch, (width, n), dtype)
                    rhs = Xw if kname == "sell_spmm_t" else Xw.T.contiguous()
                    calls[f"{kname} {width}"] = functools.partial(
                        getattr(ksm, kname), sell.slice_ptrs, sell.cols, sd, sell.perm, rhs, m,
                        sell.c)
            print(f"  {lname} {name}: " + ", ".join(
                f"{k} {_ms_str(device_ms(torch, f))}" for k, f in calls.items()), flush=True)
        del mats, csr, ell, sell
        torch.cuda.empty_cache()


def _ms_str(ms):
    return "n/a" if ms is None else f"{ms:.4f} ms"


def sweep_slice_schedule(torch, lname, csr, sell, sd, lib_dt, w_dt, rng, name, peak_bw,
                         peak_flops):
    """The slice schedule of both SELL kernels across its widths on one
    weight in one dtype: sell_spmm_t at T in SLICE_SWEEP_T (the default
    token tile, xt = 0) and sell_spmm at Kb in SLICE_SWEEP_KB, each against
    its plain version (SPMM_TOL, bitwise reruns, the planted fault), its
    median time beside its bound, the library call and the dense product,
    and the plan that ran (staged or L1-gathered rhs, the split). Their
    times on the device come later, from device_readings."""
    from repro_torch.kernels import sell_spmm as ksm
    from repro_torch.kernels.ref import sell_spmm_ref, sell_spmm_t_ref
    m, n = csr.shape
    es = sd.element_size()
    args = (sell.slice_ptrs, sell.cols, sd, sell.perm)
    absargs = (sell.slice_ptrs, sell.cols, sd.abs(), sell.perm)
    cells = [("sell_spmm_t", t) for t in SLICE_SWEEP_T] + [("sell_spmm", k)
                                                          for k in SLICE_SWEEP_KB]
    for kname, width in cells:
        X = _rand(rng, torch, (width, n), sd.dtype)
        if kname == "sell_spmm_t":
            rhs, fn, ref, lib_call = X, ksm.sell_spmm_t, sell_spmm_t_ref, lambda: lib_dt @ X.T
        else:
            rhs = X.T.contiguous()
            fn, ref, lib_call = ksm.sell_spmm, sell_spmm_ref, lambda: lib_dt @ rhs

        def run():
            return fn(*args, rhs, m, sell.c)
        what = f"{kname} {lname} {'T' if kname == 'sell_spmm_t' else 'Kb'}={width} slice sweep"
        y_p, scale = ref(*args, rhs, m, sell.c), ref(*absargs, rhs.abs(), m, sell.c)
        compare(what, run(), run(), y_p, name, scale=scale, record=True)
        planted_fault(sd, lambda d: ref(sell.slice_ptrs, sell.cols, d, sell.perm, rhs, m,
                                        sell.c), y_p, scale, what, name)
        del y_p, scale
        plan = ksm.last_plan.describe()
        sell_idx = sell.perm.numel() * 4 + (sell.nslices + 1) * 4
        nbytes = csr.nnz * (4 + es) + sell_idx + width * n * es + width * m * es
        t_bytes = nbytes / peak_bw * 1e3
        t_ops = 2 * csr.nnz * width / peak_flops * 1e3
        bound = max(t_bytes, t_ops)
        ms = time_ms(run, 20, SWEEP_WARMUP_S)
        lib_ms = time_ms(lib_call, 10, SWEEP_WARMUP_S)
        dense_ms = time_ms(lambda: X @ w_dt, 20, SWEEP_WARMUP_S)
        print(f"  {what} {name}: kernel {ms:.4f} ms, bound {bound:.4f} ms "
              f"({'bytes' if t_bytes >= t_ops else 'operations'}) -> {bound / ms:.1%} of "
              f"bound; library sparse_csr @ {lib_ms:.4f} ms, dense X @ W {dense_ms:.4f} ms; "
              f"plan: {plan}", flush=True)


def planted_fault(vals, plain_of, y_p, scale, what, dtype_name):
    """The SpMM check must catch a kernel that skips entries: the plain
    version (``plain_of`` the stored values) with every ``FAULT_EVERY``-th
    stored entry dropped reads above the limit against the sound plain
    version."""
    dropped = vals.clone()
    dropped.view(-1)[::FAULT_EVERY] = 0
    y_f = plain_of(dropped)
    reading = spmm_reading(y_f, y_p, scale, dtype_name)
    READINGS["fault"][dtype_name] = min(READINGS["fault"].get(dtype_name, float("inf")),
                                        reading)
    check(reading > 1.0, f"planted fault {what} {dtype_name}: every {FAULT_EVERY}th entry "
                         f"dropped reads {reading:.3e} > 1 (the check catches it)")


def hyb_spmm_line(torch, hyb, B, lib, peak_bw, peak_flops, what):
    """HYB SpMM has no kernel of its own: ell_spmm over the regular planes
    plus csr_spmm over the tail (sorted on the card each call); checked
    against the two plain versions composed, timed whole and by part."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.ref import csr_spmm_ref, ell_spmm_ref
    m, n = hyb.shape
    k = B.shape[1]
    tail = kops.tail_csr(hyb.coo, m)

    def plain():
        return ell_spmm_ref(hyb.ell.cols, hyb.ell.data, B) + csr_spmm_ref(*tail, B, m)
    scale = (ell_spmm_ref(hyb.ell.cols, hyb.ell.data.abs(), B.abs())
             + csr_spmm_ref(tail[0], tail[1], tail[2].abs(), B.abs(), m))
    compare(f"hyb_spmm {what}", kops.hyb_spmm(hyb, B), kops.hyb_spmm(hyb, B), plain(),
            "float32", scale=scale, record=True)
    cfg = kops.default_config(hyb, op="spmm", ncols=k)
    parts = {"whole": lambda: kops.hyb_spmm(hyb, B),
             "ell part": lambda: kops.ell_spmm(hyb.ell, B),
             "tail sort+indptr": lambda: kops.tail_csr(hyb.coo, m),
             "csr tail": lambda: kops._csr_mm.csr_spmm(*tail, B, m, vec=cfg["csr"]["vec"]),
             "plain": plain, "library sparse_csr @ B": lambda: lib @ B}
    times = {p: time_ms(fn, 3 if p == "plain" else 10) for p, fn in parts.items()}
    nbytes = ((hyb.nnz - hyb.coo.nnz) * 8 + hyb.coo.nnz * 8 + (m + 1) * 4
              + (n + m) * k * 4)
    bound = max(nbytes / peak_bw, 2 * hyb.nnz * k / peak_flops) * 1e3
    print(f"  hyb_spmm {what} float32 (k={hyb.k}, tail {hyb.coo.nnz} entries): "
          + ", ".join(f"{p} {t:.4f} ms" for p, t in times.items())
          + f"; bound {bound:.4f} ms", flush=True)


def sweep_token_tiles(lname, csr, sell, cd, sd, X, vec):
    """Median times over the token tile at T = 256, tt = 4 and 8 (the main
    path takes ``csr_spmm.token_tile`` of T; the smaller tiles lost by 2-3x,
    PERF.md). The SELL kernel copies its tile into shared memory where it
    fits."""
    from repro_torch.kernels import csr_spmm as kcm, sell_spmm as ksm
    m = csr.shape[0]
    runs = {"csr_spmm_t": lambda tt: kcm.csr_spmm_t(csr.indptr, csr.indices, cd, X, m,
                                                    vec=vec, tt=tt),
            "sell_spmm_t": lambda tt: ksm.sell_spmm_t(sell.slice_ptrs, sell.cols, sd,
                                                      sell.perm, X, m, sell.c, tt=tt)}
    for kname, run in runs.items():
        times = ", ".join(f"tt={tt} {time_ms(lambda tt=tt: run(tt), 10):.4f}"
                          for tt in kcm.TOKEN_TILES if tt >= 4)  # the two contenders
        print(f"  {kname} {lname} float32 T={X.shape[0]} token-tile sweep (ms): {times}",
              flush=True)


SWEEP_T = (16, 32, 64, 128, 256)  # the widths that place default_config's switches
SWEEP_T_PLACED = (16, 32, 64)  # around the switches placed by earlier runs (PERF.md)
SWEEP_T_TC = (64, 128, 256)  # bfloat16 cells that place TC_FROM
SWEEP_WARMUP_S = 0.05  # the sweep's cells follow each other on a warm card
# The Y = A @ B kernels of the dense-tile schedule (``tc``): timed in both
# dtypes in phase_token_major, beside the library call, and in the density
# sweep; the earlier token-major kernels in float32 only.
TC_KERNELS = ("csr_spmm", "sell_spmm")
AB_KERNELS = ("ell_spmm",) + TC_KERNELS  # rhs B = X^T (N, Kb)
# Densities of the sweep that places kernels/ops.py::TC_MIN_DENSITY and
# AB_XT_MIN_DENSITY: the up weight pruned further (its 0.25 is the main one).
SWEEP_DENSITY = (0.05, 0.01)


def _schedule_knobs(kname, A, width):
    """The new schedules of a kernel at ``width``: the token-major tile
    ``xt_tile(width)``, and for CSR/SELL SpMM the dense-tile strip the
    default takes at this shape (``tc_tile``, else 128)."""
    from repro_torch.kernels import csr_spmm as kcm
    from repro_torch.kernels import ops as kops
    knobs = [{"xt": kcm.xt_tile(width)}]
    if kname in TC_KERNELS:
        knobs.append({"tc": kops.tc_tile(A, width) or max(kcm.TC_TILES)})
    return knobs


def _knob_str(k):
    return ",".join(f"{a}={b}" for a, b in k.items()) or "row"


def phase_token_major(torch, np, weights, records):
    """The six kernels with a token-major schedule (the ``xt`` knob):
    csr_spmm_t, ell_spmm_t, sell_spmm_t (Y = X @ A^T, T tokens) and ell_spmm,
    csr_spmm, sell_spmm (Y = A @ B, Kb columns of B in the tokens' place),
    the last two also on the dense-tile schedule (the ``tc`` knob), at both
    weights: each new schedule against the plain version at width 256 (and
    257 on the up weight in float32) in float32 and bfloat16 (with a planted
    fault), against the old schedule (the row schedule; SELL's slice kernel)
    at 256; all timed in turns (old, new..., ...new, old) beside the dense X
    @ W (csr_spmm and sell_spmm in bfloat16 too and beside the library
    call); a sweep over the width and the tile (but for ell_spmm_t, whose
    switch is csr_spmm_t's); and for csr_spmm and sell_spmm a sweep over the
    density at width 256. Adds the old schedule's width-256 time (and the
    new schedules') to the up weight's records."""
    from repro_torch.core.convert import convert
    from repro_torch.core.formats import Format, coo_from_dense_np
    from repro_torch.kernels import csr_spmm as kcm, ell_spmm as kem, sell_spmm as ksm
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.ref import (csr_spmm_ref, csr_spmm_t_ref, ell_spmm_ref,
                                         ell_spmm_t_ref, sell_spmm_ref, sell_spmm_t_ref)

    print("== token-major (xt) and dense-tile (tc) schedules against the old schedules",
          flush=True)
    rng = np.random.default_rng(SEED + 4)

    def kernels_of(csr, ell, sell):
        """kernel -> (run(rhs, values, **knobs), plain(rhs, values), stored
        values, the old schedule's knobs, the other knobs of the new ones,
        library(rhs), its matrix); the rhs is X (T, N), or B = X^T (N, Kb)
        for the A @ B kernels."""
        m = csr.shape[0]
        sp = (sell.slice_ptrs, sell.cols)
        lib = torch.sparse_csr_tensor(csr.indptr, csr.indices, csr.data, size=csr.shape)
        vec_t = {k: kops.default_config(A, op="spmm_t", ncols=PREFILL)["vec"]
                 for k, A in (("csr", csr), ("ell", ell))}
        vec_e = kops.default_config(ell, op="spmm", ncols=PREFILL)["vec"]
        vec_c = kops.default_config(csr, op="spmm", ncols=PREFILL)["vec"]
        return {
            "csr_spmm_t": (lambda R, d, **kw: kcm.csr_spmm_t(csr.indptr, csr.indices, d, R, m,
                                                             **kw),
                           lambda R, d: csr_spmm_t_ref(csr.indptr, csr.indices, d, R, m),
                           csr.data, {"vec": vec_t["csr"], "tt": kcm.MAX_TOKEN_TILE},
                           {"vec": 32}, lambda R: lib @ R.T, csr),
            "ell_spmm_t": (lambda R, d, **kw: kem.ell_spmm_t(ell.cols, d, R, **kw),
                           lambda R, d: ell_spmm_t_ref(ell.cols, d, R), ell.data,
                           {"vec": vec_t["ell"], "tt": kcm.MAX_TOKEN_TILE}, {"vec": 32},
                           lambda R: lib @ R.T, ell),
            "sell_spmm_t": (lambda R, d, **kw: ksm.sell_spmm_t(*sp, d, sell.perm, R, m, sell.c,
                                                               **kw),
                            lambda R, d: sell_spmm_t_ref(*sp, d, sell.perm, R, m, sell.c),
                            sell.data, {"tt": kcm.MAX_TOKEN_TILE}, {}, lambda R: lib @ R.T,
                            sell),
            "ell_spmm": (lambda R, d, **kw: kem.ell_spmm(ell.cols, d, R, **kw),
                         lambda R, d: ell_spmm_ref(ell.cols, d, R), ell.data, {"vec": vec_e},
                         {"vec": vec_e}, lambda R: lib @ R, ell),
            "csr_spmm": (lambda R, d, **kw: kcm.csr_spmm(csr.indptr, csr.indices, d, R, m,
                                                         **kw),
                         lambda R, d: csr_spmm_ref(csr.indptr, csr.indices, d, R, m),
                         csr.data, {"vec": vec_c}, {"vec": vec_c}, lambda R: lib @ R, csr),
            "sell_spmm": (lambda R, d, **kw: ksm.sell_spmm(*sp, d, sell.perm, R, m, sell.c,
                                                           **kw),
                          lambda R, d: sell_spmm_ref(*sp, d, sell.perm, R, m, sell.c),
                          sell.data, {}, {}, lambda R: lib @ R, sell),
        }

    def rhs_of(kname, X):
        return X.T.contiguous() if kname in AB_KERNELS else X

    for lname, (w, _) in weights.items():
        coo = coo_from_dense_np(w.T, device="cuda")
        csr, ell, sell = (convert(coo, Format[f]) for f in ("CSR", "ELL", "SELL"))
        del coo
        n = csr.shape[1]
        w_dense = torch.from_numpy(w).cuda()
        kern = kernels_of(csr, ell, sell)
        for dtype in (torch.float32, torch.bfloat16):
            name = "float32" if dtype == torch.float32 else "bfloat16"
            for t in (PREFILL, PREFILL + 1) if name == "float32" and lname == "up" else (PREFILL,):
                X = _rand(rng, torch, (t, n), dtype)
                for kname, (run, plain, vals, old, new, _, A) in kern.items():
                    R, d = rhs_of(kname, X), vals.to(dtype)
                    y_p = plain(R, d)
                    scale = plain(R.abs(), d.abs())
                    width = f"{'Kb' if kname in AB_KERNELS else 'T'}={t}"
                    y_old = run(R, d, **old) if t == PREFILL else None
                    for knob in _schedule_knobs(kname, A, t):
                        what = f"{kname} {lname} {width} {_knob_str(knob)}"
                        y = run(R, d, **knob, **new)
                        compare(what, y, run(R, d, **knob, **new), y_p, name, scale=scale,
                                record=True)
                        if y_old is not None:
                            reading = spmm_reading(y, y_old, scale, name)
                            check(reading <= 1.0, f"{what} {name}: against the old schedule "
                                                  f"{old}, reading {reading:.3e} <= 1")
                        del y
                    planted_fault(d, lambda dd, p=plain, R=R: p(R, dd), y_p, scale,
                                  f"{kname} {lname} {width}", name)
                    del y_p, scale, y_old
        for dtype in (torch.float32, torch.bfloat16):
            name = "float32" if dtype == torch.float32 else "bfloat16"
            X = _rand(rng, torch, (PREFILL, n), dtype)
            wd = w_dense.to(dtype)
            dense = time_ms(lambda: X @ wd, 20)
            for kname, (run, _, vals, old, new, library, A) in kern.items():
                if kname not in TC_KERNELS and (dtype != torch.float32 or lname != "up"):
                    continue  # the earlier kernels' other turns are in PERF.md
                R, d = rhs_of(kname, X), vals.to(dtype)
                knobs = _schedule_knobs(kname, A, PREFILL)
                turns = [old] + [dict(k, **new) for k in knobs]
                turns += turns[:0:-1] + [old]  # old, new..., ...new, old
                times = [time_ms(lambda k=k: run(R, d, **k), 20,
                                 WARMUP_S if i == 0 else SWEEP_WARMUP_S)
                         for i, k in enumerate(turns)]  # the first warms the card
                lib_ms = (time_ms(lambda: library(R), 5)
                          if kname in TC_KERNELS and dtype == torch.float32 else None)
                best = {}
                for k, tm in zip(turns, times):
                    key = _knob_str({a: b for a, b in k.items() if a in ("xt", "tc")})
                    best[key] = min(best.get(key, tm), tm)
                t_old = best.pop("row")
                print(f"  {kname} {lname} {name} width {PREFILL} (ms, in turns): "
                      + ", ".join(f"{_knob_str(k)} {tm:.4f}" for k, tm in zip(turns, times))
                      + f"; dense X @ W {name} {dense:.4f}"
                      + (f"; library sparse_csr @ {lib_ms:.4f}" if lib_ms else "")
                      + "; " + ", ".join(f"{k} / old {tm / t_old:.3f}, / dense {tm / dense:.3f}"
                                         for k, tm in best.items()), flush=True)
                if lname == "up" and dtype == torch.float32 and kname in records:
                    records[kname]["ms_old_schedule"] = t_old
                    if kname in TC_KERNELS:
                        for k, tm in best.items():
                            records[kname][f"ms_{k.split('=')[0]}"] = tm
        for dtype, widths in ((torch.float32, SWEEP_T), (torch.bfloat16, SWEEP_T_TC)):
            name = "float32" if dtype == torch.float32 else "bfloat16"
            for t in widths:
                Xt = _rand(rng, torch, (t, n), dtype)
                for kname, (run, _, vals, old, new, _, A) in kern.items():
                    if kname == "ell_spmm_t":
                        continue  # its switch is csr_spmm_t's
                    if kname not in TC_KERNELS and (dtype != torch.float32 or lname != "up"
                                                    or t not in SWEEP_T_PLACED):
                        continue  # placed in earlier runs (PERF.md): the up weight's cells
                    R, d = rhs_of(kname, Xt), vals.to(dtype)
                    if dtype == torch.float32:
                        knobs = [{k: v for k, v in old.items() if k != "tt"}]  # tt follows T
                        knobs += [{"xt": x} for x in kcm.XT_TILES]
                        knobs += [{"tc": x} for x in kcm.TC_TILES] if kname in TC_KERNELS else []
                    else:
                        knobs = [{"xt": kcm.xt_tile(t)}, {"tc": max(kcm.TC_TILES)}]
                    cells = [f"{_knob_str({a: b for a, b in k.items() if a in ('xt', 'tc')})} "
                             + f"{time_ms(lambda k=k: run(R, d, **dict(new, **k)), 10, SWEEP_WARMUP_S):.4f}"
                             for k in knobs]
                    op = "spmm" if kname in AB_KERNELS else "spmm_t"
                    cfg = kops.default_config(_with_values(A, d), op=op, ncols=t)
                    print(f"  {kname} {lname} {name} width {t} sweep (ms): " + ", ".join(cells)
                          + f"; default {cfg}", flush=True)
        del csr, ell, sell, w_dense, kern
        torch.cuda.empty_cache()
    # the density sweep: csr_spmm and sell_spmm at width 256 on the up weight
    # pruned further (on the card: the largest |w| of the 0.25 weight, which
    # is prune_magnitude's cut of the same seed), each schedule in turns
    # (row, xt, tc, tc, xt, row); density 0.25 is timed in turns above
    coo = coo_from_dense_np(weights["up"][0].T, device="cuda")
    for density in SWEEP_DENSITY:
        keep = coo.data.abs() >= torch.topk(coo.data.abs(), int(density * coo.data.numel()
                                                                / DENSITY)).values.min()
        pruned = type(coo)(coo.row[keep], coo.col[keep], coo.data[keep], coo.shape,
                           int(keep.sum()))
        csr, sell = convert(pruned, Format.CSR), convert(pruned, Format.SELL)
        del keep, pruned
        kern = kernels_of(csr, csr, sell)  # ELL unbuilt: its entries go unused
        n = csr.shape[1]
        for dtype in (torch.float32, torch.bfloat16):
            name = "float32" if dtype == torch.float32 else "bfloat16"
            X = _rand(rng, torch, (PREFILL, n), dtype)
            B = X.T.contiguous()
            for kname in TC_KERNELS:
                run, plain, vals, old, new, _, A = kern[kname]
                d = vals.to(dtype)
                knobs = [old] + [dict(k, **new) for k in _schedule_knobs(kname, A, PREFILL)]
                y_p, scale = plain(B, d), plain(B.abs(), d.abs())
                for k in knobs[1:]:
                    compare(f"{kname} up density {density} Kb={PREFILL} {_knob_str(k)}",
                            run(B, d, **k), run(B, d, **k), y_p, name, scale=scale)
                del y_p, scale
                turns = knobs + knobs[::-1]
                times = [time_ms(lambda k=k: run(B, d, **k), 10,
                                 WARMUP_S if i == 0 else SWEEP_WARMUP_S)
                         for i, k in enumerate(turns)]
                cfg = kops.default_config(_with_values(A, d), op="spmm", ncols=PREFILL)
                print(f"  {kname} up {name} density {density} (nnz {A.nnz}) width {PREFILL} "
                      "(ms, in turns): "
                      + ", ".join(f"{_knob_str(k)} {tm:.4f}" for k, tm in zip(turns, times))
                      + f"; default {cfg}", flush=True)
        del csr, sell, kern
        torch.cuda.empty_cache()
    del coo


def _with_values(A, data):
    """``A`` holding ``data`` (default_config reads the values' dtype)."""
    import dataclasses
    return dataclasses.replace(A, data=data)


def recorded_policy(mode):
    """A FormatPolicy over the weight candidates that keeps its last report
    (the candidates' times of a ``from_dense(tune=...)`` build)."""
    from repro_torch.models import WEIGHT_CANDIDATES
    from repro_torch.tuning import FormatPolicy

    class Recorded(FormatPolicy):
        def select(self, A, x=None, op="spmv", ncols=None):
            self.report = super().select(A, x=x, op=op, ncols=ncols)
            return self.report
    return Recorded(mode, candidates=WEIGHT_CANDIDATES, profile_iters=3)


def _rel_err(torch, y, ref):
    return float((y.double() - ref).abs().max() / ref.abs().max())


# ms a COO layer call of path (d) in run R2 (PERF.md §5), when the plain COO
# SpMM still summed with index_add_ (atomics on the card)
COO_R2_MS = {("up", DECODE): 1.4284, ("up", PREFILL): 109.2533,
             ("down", DECODE): 2.3472, ("down", PREFILL): 119.0319}


def phase_serving(torch, np, weights):
    """Path (d): LinearSparse at minitron-8b MLP width on the card."""
    from repro_torch.core.formats import Format
    from repro_torch.core.ops import spmm
    from repro_torch.kernels import ops as kops
    from repro_torch.models import LinearSparse
    from repro_torch.obs import metrics

    from repro_torch.kernels import csr_spmm as kcm, ell_spmm as kem, sell_spmm as ksm
    print("== main path (d): sparse-weight serving, LinearSparse at minitron-8b MLP "
          f"width {MINITRON_MLP} density {DENSITY}", flush=True)
    start_path(torch)
    xt_before = {"csr_spmm_t": kcm.launches_xt, "ell_spmm_t": kem.launches_xt,
                 "sell_spmm_t": ksm.launches_xt}
    dev_w = {k: (torch.from_numpy(w).cuda().double(), torch.from_numpy(b).cuda().double())
             for k, (w, b) in weights.items()}
    layers = {}
    for lname, (w, b) in weights.items():
        t0 = time.perf_counter()
        ml = LinearSparse.from_dense(w, tune="ml", bias=b)
        torch.cuda.synchronize()
        print(f"  {lname}: from_dense(tune='ml') -> {ml.format.name} in "
              f"{time.perf_counter() - t0:.2f} s (host COO build included)", flush=True)
        layers[lname] = {"ml": ml}
        for width in (DECODE, PREFILL):
            pol = recorded_policy("profile")
            t0 = time.perf_counter()
            layer = LinearSparse.from_dense(w, tune=pol, ncols=width, bias=b)
            torch.cuda.synchronize()
            rep = pol.report
            print(f"  {lname}: from_dense(tune='profile', ncols={width}) in "
                  f"{time.perf_counter() - t0:.2f} s: "
                  + ", ".join(f"{f.name} {t * 1e3:.4f} ms" for f, t in rep.times.items())
                  + f" -> pick {rep.best.name}", flush=True)
            check(set(rep.times) == set(Format[f] for f in LAYER_FORMATS),
                  f"{lname} profile at ncols={width} timed every weight candidate")
            layers[lname][width] = layer
    # the layers, alone and chained, against float64 at both widths
    rng = np.random.default_rng(SEED + 2)
    for width in (DECODE, PREFILL):
        x = _rand(rng, torch, (width, MINITRON_MLP["up"][0]), torch.float32)
        up, down = layers["up"][width], layers["down"][width]
        (wu, bu), (wd, bd) = dev_w["up"], dev_w["down"]
        ref_up = x.double() @ wu + bu
        ref_chain = ref_up @ wd + bd
        h = up(x)
        y = down(h)
        torch.cuda.synchronize()
        for label, got, ref in (("up", h, ref_up), ("down(up(x))", y, ref_chain)):
            e = _rel_err(torch, got, ref)
            check(got.shape == ref.shape and bool(torch.isfinite(got).all())
                  and e <= ORACLE_RTOL,
                  f"T={width} {label} in {up.format.name}/{down.format.name}: "
                  f"max|y - f64| / max|f64| = {e:.2e} <= {ORACLE_RTOL}")
        xd = _rand(rng, torch, (width, MINITRON_MLP["down"][0]), torch.float32)
        e = _rel_err(torch, down(xd), xd.double() @ wd + bd)
        check(e <= ORACLE_RTOL, f"T={width} down alone: {e:.2e} <= {ORACLE_RTOL}")
    # every weight format at both widths: launches == kernel calls, no sync
    for lname, (d_in, _) in MINITRON_MLP.items():
        base = layers[lname]["ml"]
        w64, b64 = dev_w[lname]
        for width in (DECODE, PREFILL):
            x = _rand(rng, torch, (width, d_in), torch.float32)
            ref = x.double() @ w64 + b64
            outs, times = {}, {}
            for fmt in LAYER_FORMATS:
                L = base.activate(Format[fmt])
                before = kops.launch_counts()
                outs[fmt] = L(x)
                torch.cuda.synchronize()
                after = kops.launch_counts()
                launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
                check(launched == {k: 1 for k in SPMM_T_KERNELS_OF[fmt]},
                      f"{lname} T={width} {fmt}: launches {launched} == kernel calls")
                e = _rel_err(torch, outs[fmt], ref)
                check(e <= ORACLE_RTOL, f"{lname} T={width} {fmt} vs f64: {e:.2e}")
                if SPMM_T_KERNELS_OF[fmt]:
                    torch.cuda.set_sync_debug_mode("error")
                    try:
                        L(x)
                    finally:
                        torch.cuda.set_sync_debug_mode("default")
                times[fmt] = time_ms(lambda L=L: L(x), 3 if fmt == "COO" else 20)
                if fmt == "CSR":
                    before = kops.launch_counts()["csr_spmm"]
                    y_old = spmm(L.weight, x.T.contiguous()).T + L.bias
                    torch.cuda.synchronize()
                    check(kops.launch_counts()["csr_spmm"] == before + 1
                          and _rel_err(torch, y_old, ref) <= ORACLE_RTOL,
                          f"{lname} T={width} CSR: spmm(W, x.T).T (csr_spmm) == layer(x)")
                del L
            agree = max(float((outs[f] - outs["CSR"]).abs().max()) for f in LAYER_FORMATS)
            scale = float(ref.abs().max())
            check(agree <= ORACLE_RTOL * scale,
                  f"{lname} T={width}: all formats agree (max diff {agree:.3e}, "
                  f"scale {scale:.1f}); no sync in any kernel format's call")
            print(f"  {lname} T={width} ms per call: "
                  + ", ".join(f"{f} {t:.4f}" for f, t in times.items())
                  + f" (COO before its rows were reduced in order, run R2: "
                  f"{COO_R2_MS[lname, width]})", flush=True)
    # retune the decode build for prefill
    for lname in MINITRON_MLP:
        dec = layers[lname][DECODE]
        with metrics.scope() as s:
            t0 = time.perf_counter()
            pre = dec.retune(ncols=PREFILL, tune="profile")
            torch.cuda.synchronize()
            switched = pre.format != dec.format
            print(f"  {lname}: retune(ncols={PREFILL}) {dec.format.name} -> "
                  f"{pre.format.name} in {time.perf_counter() - t0:.2f} s", flush=True)
            check(s.delta("serve.retune") == 1
                  and s.delta("serve.format_switch") == int(switched),
                  f"{lname}: serve.retune +1, serve.format_switch +{int(switched)}")
    # Y = A @ B on the weight in ELL, SELL and HYB runs their kernels
    wu = dev_w["up"][0]
    B = _rand(rng, torch, (MINITRON_MLP["up"][0], 2), torch.float32)
    ref = wu.T @ B.double()
    for fmt, kernels in (("ELL", ("ell_spmm",)), ("SELL", ("sell_spmm",)),
                         ("HYB", ("ell_spmm", "csr_spmm"))):
        W = layers["up"]["ml"].activate(Format[fmt]).weight.concrete
        before = kops.launch_counts()
        y = spmm(W, B, backend="cuda")
        torch.cuda.synchronize()
        after = kops.launch_counts()
        launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        e = _rel_err(torch, y, ref)
        check(launched == {k: 1 for k in kernels} and e <= ORACLE_RTOL,
              f"up {fmt}: spmm(W, B, backend='cuda') launches {launched}, vs f64 {e:.2e}")
        del W
    del layers, dev_w
    xt_launches = {"csr_spmm_t": kcm.launches_xt - xt_before["csr_spmm_t"],
                   "ell_spmm_t": kem.launches_xt - xt_before["ell_spmm_t"],
                   "sell_spmm_t": ksm.launches_xt - xt_before["sell_spmm_t"]}
    print(f"  token-major (xt) launches over path (d): {xt_launches}", flush=True)
    check(all(v > 0 for v in xt_launches.values()),
          "csr_spmm_t, ell_spmm_t and sell_spmm_t ran the token-major schedule on path (d)")
    return read_path(torch, "(d)", SPMM_KERNELS)


# ---------------------------------------------------------------------------
# Path (e): the measured route (kernel_tune records, backend="auto", cached)
# ---------------------------------------------------------------------------

# What path (e) tunes: (weight, format, op) at both widths, and HPCG SpMV.
TUNED_SPMM = [("up", f, "spmm") for f in ("CSR", "ELL", "SELL", "HYB")] + \
    [(w, f, "spmm_t") for w in ("up", "down") for f in ("CSR", "ELL", "SELL")]
TUNED_SPMV = ("DIA", "CSR")
TUNE_ITERS, TUNE_INNER = 3, 2
# The kernels each (format, op) launches once a call.
KERNELS_OF_OP = {("ELL", "spmm"): ("ell_spmm",), ("SELL", "spmm"): ("sell_spmm",),
                 ("HYB", "spmm"): ("ell_spmm", "csr_spmm"), ("CSR", "spmm"): ("csr_spmm",),
                 ("CSR", "spmm_t"): ("csr_spmm_t",), ("ELL", "spmm_t"): ("ell_spmm_t",),
                 ("SELL", "spmm_t"): ("sell_spmm_t",), ("DIA", "spmv"): ("dia_spmv",),
                 ("CSR", "spmv"): ("csr_spmv",)}


def _launched(kops, before):
    after = kops.launch_counts()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def check_route(torch, A, rec, x, op, label, cache_path):
    """One record: it round-trips through a fresh store; kernel_route gives
    ("cuda", rec.cfg) exactly where it beat the reference; op(backend="auto")
    then launches the kernel once a call and equals backend="cuda",
    cfg=rec.cfg bitwise (else it runs the reference, counted as a veto)."""
    from repro_torch.core import ops
    from repro_torch.kernels import ops as kops
    from repro_torch.obs import metrics
    from repro_torch.tuning import SelectionCache, kernel_tune
    fn = {"spmv": ops.spmv, "spmm": ops.spmm, "spmm_t": ops.spmm_t}[op]
    ncols = {"spmv": None, "spmm": x.shape[-1], "spmm_t": x.shape[0]}[op]
    fresh = kernel_tune.best_config(A, op=op, ncols=ncols, cache=SelectionCache(cache_path))
    check(fresh == rec, f"{label}: the record round-trips through a fresh store")
    won = rec.speedup >= 1.0
    route = ops.kernel_route(A, op=op, ncols=ncols)
    check(route == (("cuda", rec.cfg) if won else ("ref", None)),
          f"{label}: kernel_route {route[0]} (speedup {rec.speedup:.2f})")
    with metrics.scope() as s:
        before = kops.launch_counts()
        y = fn(A, x, backend="auto")
        torch.cuda.synchronize()
        launched = _launched(kops, before)
        counted = {k: s.delta(f"kernel.route.{k}") for k in ("cuda", "veto", "ref")}
    want = {k: 1 for k in KERNELS_OF_OP[(type(A).__name__, op)]} if won else {}
    check(launched == want and counted["cuda" if won else "veto"] == 1,
          f"{label}: auto launched {launched}, route counts {counted}")
    if won:
        check(torch.equal(y, fn(A, x, backend="cuda", cfg=rec.cfg)),
              f"{label}: auto == backend='cuda', cfg={rec.cfg} bitwise")


def phase_measured(torch, np, weights, prob):
    """Path (e): kernel_tune records at full width, the auto route, the
    cached policy, LinearSparse with backend='auto', hpcg_solve --tune
    cached and the SpMM profile pick, on a fresh store, whose directory is
    returned beside the counts (path (h) routes through its records)."""
    import tempfile
    from repro_torch import hpcg_solve
    from repro_torch.core import hpcg, ops
    from repro_torch.core.convert import convert
    from repro_torch.core.dynamic import DynamicMatrix
    from repro_torch.core.formats import Format, coo_from_dense_np
    from repro_torch.kernels import ops as kops
    from repro_torch.models import WEIGHT_CANDIDATES, LinearSparse
    from repro_torch.obs import metrics
    from repro_torch.tuning import (CACHE_PATH_ENV, FormatPolicy, KernelRecord,
                                    SelectionCache, kernel_tune)

    print("== path (e): the measured route (kernel_tune, backend='auto', cached) at "
          f"minitron-8b MLP width and HPCG {'x'.join(map(str, GRID))}", flush=True)
    start_path(torch)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    path = os.path.join(tmp, "selections.json")
    os.environ[CACHE_PATH_ENV] = path
    rng = np.random.default_rng(SEED + 3)
    coos = {k: coo_from_dense_np(w.T, device="cuda") for k, (w, _) in weights.items()}
    mats = {("up", "ELL"): convert(coos["up"], Format.ELL)}
    # the T = 1 layer call with no record (the default store is empty)
    w_up, b_up = weights["up"]
    ell_layer = LinearSparse(DynamicMatrix(mats[("up", "ELL")]), torch.from_numpy(b_up).cuda())
    x1 = _rand(rng, torch, (DECODE, MINITRON_MLP["up"][0]), torch.float32)
    cold_ms = time_ms(lambda: ell_layer(x1), 50)
    t0 = time.perf_counter()
    cache = SelectionCache(path)
    records = []
    for wname, fmt, op in TUNED_SPMM:
        A = mats.setdefault((wname, fmt), convert(coos[wname], Format[fmt]))
        for width in (DECODE, PREFILL):
            shape = (A.shape[1], width) if op == "spmm" else (width, A.shape[1])
            x = _rand(rng, torch, shape, torch.float32)
            rec = kernel_tune.tune_kernel(A, x, op=op, cache=cache, iters=TUNE_ITERS,
                                          inner=TUNE_INNER)
            label = f"{wname} {fmt} {op} width {width}"
            print(f"  tuned {label}: cfg={rec.cfg} kernel {rec.kernel_us:.1f} us, ref "
                  f"{rec.ref_us:.1f} us, speedup {rec.speedup:.2f}", flush=True)
            if width == DECODE:
                check(kernel_tune.best_config(A, op=op, ncols=PREFILL,
                                              cache=SelectionCache(path)) is None,
                      f"{label}: the b1 record is invisible at ncols={PREFILL}")
            check_route(torch, A, rec, x, op, label, path)
            records.append((label, rec))
    hp = hpcg.to_coo(prob, device="cuda")
    for fmt in TUNED_SPMV:
        A = convert(hp, Format[fmt])
        x = _rand(rng, torch, A.shape[1], torch.float32)
        rec = kernel_tune.tune_kernel(A, x, op="spmv", cache=cache, iters=TUNE_ITERS,
                                      inner=TUNE_INNER)
        label = f"HPCG {fmt} spmv"
        print(f"  tuned {label}: cfg={rec.cfg} kernel {rec.kernel_us:.1f} us, ref "
              f"{rec.ref_us:.1f} us, speedup {rec.speedup:.2f}", flush=True)
        check_route(torch, A, rec, x, "spmv", label, path)
        records.append((label, rec))
        del A
    del hp
    print(f"  {len(records)} records tuned and checked in {time.perf_counter() - t0:.2f} s; "
          f"{sum(r.speedup >= 1 for _, r in records)} beat the reference", flush=True)
    # a planted losing record (written here, not measured) must route ref
    csr = convert(coos["up"], Format.CSR)
    loser = KernelRecord("CSR", "spmm", kops.default_config(csr, op="spmm", ncols=1),
                         kernel_us=200.0, ref_us=100.0)
    cache.put_raw(kernel_tune.kernel_key(csr.format, *csr.shape, csr.nnz, op="spmm", ncols=1,
                                         device=csr.device), loser.to_json())
    B1 = _rand(rng, torch, (csr.shape[1], 1), torch.float32)
    with metrics.scope() as s:
        before = kops.launch_counts()
        route = ops.kernel_route(csr, op="spmm", ncols=1)
        y = ops.spmm(csr, B1, backend="auto")
        torch.cuda.synchronize()
        launched = _launched(kops, before)
        vetoes = s.delta("kernel.route.veto")
    # the reference sums with index_add_ (atomics): compare at the f32 limit
    e = _rel_err(torch, y, ops.spmm(csr, B1, backend="ref").double())
    check(route == ("ref", None) and launched == {} and vetoes == 2 and e <= ORACLE_RTOL,
          f"planted losing record (speedup 0.50, written by this script): auto routes "
          f"{route[0]}, launches {launched}, kernel.route.veto +{vetoes}, vs ref {e:.2e}")
    del csr
    # the T = 1 layer call with the warm store, then backend='auto'
    warm_ms = time_ms(lambda: ell_layer(x1), 50)
    auto_layer = LinearSparse(ell_layer.weight, ell_layer.bias, backend="auto")
    auto_ms = time_ms(lambda: auto_layer(x1), 50)
    os.environ[CACHE_PATH_ENV] = os.path.join(tmp, "empty.json")
    cold2_ms = time_ms(lambda: ell_layer(x1), 50)
    os.environ[CACHE_PATH_ENV] = path
    knobs = kops.default_config(mats[("up", "ELL")], op="spmm_t", ncols=DECODE)
    pinned_ms = time_ms(lambda: ops.spmm_t(ell_layer.weight, x1, cfg=knobs) + ell_layer.bias, 50)
    A_ell = mats[("up", "ELL")]
    t0 = time.perf_counter()
    for _ in range(1000):
        kops.resolve_config(A_ell, None, "spmm_t", DECODE)
    lookup_us = (time.perf_counter() - t0) * 1e3
    print(f"  up ELL layer T=1 ms per call: backend=None cold store {cold_ms:.4f}, warm store "
          f"{warm_ms:.4f}, backend='auto' {auto_ms:.4f}, cold store again {cold2_ms:.4f}, "
          f"spmm_t(W, x, cfg={knobs}) + bias with no lookup {pinned_ms:.4f}; host lookup "
          f"kops.resolve_config {lookup_us:.2f} us a call", flush=True)
    del ell_layer, auto_layer
    # the cached policy: per width bucket, a miss pins, the next call hits
    policy = FormatPolicy("cached", candidates=WEIGHT_CANDIDATES, cache=path)
    for width in (DECODE, PREFILL):
        cold = policy.select(coos["up"], op="spmm_t", ncols=width)
        warm = policy.select(coos["up"], op="spmm_t", ncols=width)
        print(f"  cached policy up ncols={width}: {cold.mode} -> {cold.best.name} "
              f"{cold.backend} {cold.cfg}; then {warm.mode}", flush=True)
        check(cold.mode.startswith("cached-miss") and warm.mode == "cached"
              and (cold.best, cold.backend, cold.cfg) == (warm.best, warm.backend, warm.cfg),
              f"cached policy ncols={width}: miss then hit, the same (fmt, backend, cfg)")
    # LinearSparse built by that policy, backend='auto', at both widths
    layer = LinearSparse.from_dense(w_up, tune=policy, ncols=PREFILL, bias=b_up,
                                    backend="auto")
    wu64 = torch.from_numpy(w_up).cuda().double()
    bu64 = torch.from_numpy(b_up).cuda().double()
    for width in (DECODE, PREFILL):
        x = _rand(rng, torch, (width, MINITRON_MLP["up"][0]), torch.float32)
        kernels = KERNELS_OF_OP.get((layer.format.name, "spmm_t"), ())
        before = kops.launch_counts()
        calls = 3
        for _ in range(calls):
            y = layer(x)
        torch.cuda.synchronize()
        launched = _launched(kops, before)
        e = _rel_err(torch, y, x.double() @ wu64 + bu64)
        check(e <= ORACLE_RTOL and launched == {k: calls for k in kernels} and kernels,
              f"LinearSparse({layer.format.name}, backend='auto') T={width}: vs f64 {e:.2e}, "
              f"launches {launched} for {calls} calls")
    del layer, wu64, bu64
    # hpcg_solve with the cached pick and its pinned launch knobs
    r = hpcg_solve.run(GRID, "auto", tune="cached", tol=CG_TOL, maxiter=CG_MAXITER)
    print(f"  hpcg_solve --tune cached: {r['format']} ({r['pick_mode']}, cfg {r['cfg']}), "
          f"{r['iters']} iters, max|x-1| {r['err']:.2e}, solve {r['solve_s']:.3f} s", flush=True)
    check(r["passed"] and r["iters"] == 131, "hpcg_solve --tune cached converges in 131 iters")
    # the SpMM profile pick times ELL, SELL and HYB through their kernels
    before = kops.launch_counts()
    rep = FormatPolicy("profile", candidates=WEIGHT_CANDIDATES, profile_iters=3).select(
        coos["up"], op="spmm", ncols=PREFILL)
    launched = _launched(kops, before)
    print("  profile op='spmm' ncols=256 on up: "
          + ", ".join(f"{f.name} {t * 1e3:.4f} ms" for f, t in rep.times.items())
          + f" -> pick {rep.best.name}; launches {launched}", flush=True)
    check(set(rep.times) == set(WEIGHT_CANDIDATES)
          and all(launched.get(k, 0) > 0 for k in ("ell_spmm", "sell_spmm", "csr_spmm")),
          "profile op='spmm' timed every weight candidate, ELL/SELL/HYB through kernels")
    del mats, coos
    os.environ.pop(CACHE_PATH_ENV, None)
    counts = read_path(torch, "(e)", ("ell_spmm", "sell_spmm", "csr_spmm", "csr_spmm_t",
                                      "ell_spmm_t", "sell_spmm_t", "dia_spmv", "csr_spmv"))
    return counts, tmp  # path (h) reads this store, then removes it


# ---------------------------------------------------------------------------
# Path (h): observability on the card (repro_torch.obs)
# ---------------------------------------------------------------------------

OBS_SHARDS = 8  # the P of path (g)'s Multi-Format build
OBS_MODES = (("off", False), ("off", True), ("summary", True), ("full", True))
OBS_TURNS = 4  # the modes are timed in turns: forward, backward, forward, backward
OBS_SOLVES = 3  # CG solves a mode and turn
OBS_CYCLES = 20  # V-cycles a host-clock reading
PHASES_EXPECTED = {"select", "plan", "convert", "build", "kernel", "exchange", "solver"}


def _mode_name(mode, led):
    return f"trace {mode}, ledger {'on' if led else 'off'}"


def _host_and_queued_ms(torch, fn, x, calls):
    """ms a call of ``fn(x)`` by the host clock over ``calls`` calls between
    syncs, and on the device with the calls queued behind a spin (median of
    three)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(x)
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3 / calls
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    runs = []
    for _ in range(3):
        torch.cuda._sleep(int(2e6 * max(4.0, 3 * host)))
        e0.record()
        fn(x)
        e1.record()
        torch.cuda.synchronize()
        runs.append(e0.elapsed_time(e1))
    return host, statistics.median(runs)


def _no_sync(torch, label, fns):
    """Run each of ``fns`` with any implicit device->host sync raising and
    ``torch.cuda.synchronize`` replaced by a function that raises."""
    real = torch.cuda.synchronize

    def boom(*a):
        raise SmokeFailure(f"{label}: torch.cuda.synchronize called on a hot path")
    outs = []
    torch.cuda.synchronize = boom
    torch.cuda.set_sync_debug_mode("error")
    try:
        for fn in fns:
            outs.append(fn())
    finally:
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize = real
    torch.cuda.synchronize()
    return outs


def obs_traced_solve(torch, A, b, prob, tmp):
    """(h1) One traced run: the ml pick, CG with backend='auto' on path
    (e)'s store, a P = 8 Multi-Format build and a dist_spmv, under
    tracing('full') with the ledger on; the trace's phases, parentage,
    Chrome export, attribution and the ledger's decisions."""
    from repro_torch.core import hpcg
    from repro_torch.core.distributed import build_dist_matrix, dist_spmv
    from repro_torch.core.dynamic import DynamicMatrix
    from repro_torch.core.solvers import cg, operator
    from repro_torch.kernels import ops as kops
    from repro_torch.obs import explain, ledger, report, trace

    ledger.set_enabled(True)
    ledger.clear()
    trace.clear()
    nspmv = 0
    with trace.tracing("full"):
        t0 = time.perf_counter()
        M = DynamicMatrix.auto(A, "ml")
        apply_A = operator(M, backend="auto")

        def counted(v):
            nonlocal nspmv
            nspmv += 1
            return apply_A(v)
        before = kops.launch_counts()
        with trace.span("solver.solve", precond="none") as sp:
            res = cg(counted, b, tol=CG_TOL, maxiter=CG_MAXITER)
            sp.sync(res.x)
        launched = _launched(kops, before)
        D = build_dist_matrix(prob.row, prob.col, prob.val, prob.shape, OBS_SHARDS,
                              device="cuda", mode="multiformat", tune="ml",
                              plan=hpcg.slab_plan(prob, OBS_SHARDS), check_plan=False)
        y = dist_spmv(D, b)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        evs = trace.events()
    err = float((res.x - 1.0).abs().max())
    recs = ledger.records()
    routes = ledger.records(kind="kernel.route")
    sel = ledger.records(kind="format.select")
    print(f"  traced run (full, ledger on): {dt:.2f} s, {len(evs)} events, CG {res.iters} "
          f"iters max|x-1| {err:.2e}, launches {launched} for {nspmv} SpMVs; ledger "
          f"{len(recs)} records by kind "
          f"{ {k: sum(r['kind'] == k for r in recs) for k in sorted({r['kind'] for r in recs})} }",
          flush=True)
    check(res.iters < CG_MAXITER and err < X_TOL, "traced CG converges")
    check(sel and sel[0]["chosen"] == "DIA", f"format.select record says DIA "
                                             f"({[r['chosen'] for r in sel]})")
    check(len(routes) <= 1, f"kernel.route records ({len(routes)}) do not exceed the "
                            f"distinct containers routed (1: the DIA matrix)")
    route = routes[0]["route"] if routes else None
    want = {"dia_spmv": device_calls(1)} if route == "cuda" else {}
    check(launched == want, f"traced auto CG: route {route}, launches {launched} == {want} "
                            f"(the SpMVs the device ran; {nspmv} calls in Python)")
    phases = {report.phase_of(e["name"]) for e in evs}
    check(PHASES_EXPECTED <= phases, f"the trace's phases {sorted(phases)} hold "
                                     f"{sorted(PHASES_EXPECTED)}")
    by_id = {e["id"]: e for e in evs}
    orphans = [e["name"] for e in evs if e["parent"] is not None and e["parent"] not in by_id]
    early = [e["name"] for e in evs if e["parent"] in by_id
             and e["ts"] < by_id[e["parent"]]["ts"] - 1e-3]
    check(not orphans and not early and trace.dropped() == 0,
          f"every parent is a recorded span ({len(orphans)} orphans), no child starts "
          f"before its parent ({len(early)}), nothing dropped")
    path = trace.export_chrome(os.path.join(tmp, "trace.json"))
    back = report.load_trace(path)
    check(len(back) == len(evs) and {e["name"] for e in back} == {e["name"] for e in evs},
          "export_chrome round-trips through report.load_trace")
    rows = report.attribution(back)
    print("  phase attribution (self time, host clock):")
    print("\n".join("    " + line for line in report.render_attribution(rows).splitlines()))
    print("  trace summary:")
    print("\n".join("    " + line for line in trace.summary().splitlines()))
    dump = ledger.dump_json(os.path.join(tmp, "ledger.json"))
    text = explain.render(ledger.load_json(dump)["records"])
    check("format.select" in text and "kernel.route" in text, "explain.render over the dump")
    print("  explain over the ledger dump:")
    print("\n".join("    " + line for line in text.splitlines()))
    trace.clear()
    ref = dist_spmv(D, b, backend="ref")
    check(bool(torch.allclose(y, ref, rtol=1e-4, atol=1e-4)), "traced dist_spmv == ref")
    return M, D


def obs_overhead(torch, A, b, M, D, prob):
    """(h2) Path (a)'s CG (backend None and 'auto') and one CSR V-cycle in
    each trace/ledger mode, in turns; launches = SpMVs in every mode; in
    off and summary modes an SpMV, a dist_spmv and a V-cycle with no sync."""
    from repro_torch.core.distributed import dist_spmv
    from repro_torch.core.formats import Format
    from repro_torch.core.ops import spmv
    from repro_torch.core.solvers import cg, operator
    from repro_torch.kernels import ops as kops
    from repro_torch.mg import build_hierarchy
    from repro_torch.obs import ledger, trace

    hier = build_hierarchy(prob, fmt=Format.CSR, A=A)
    per_cycle = cycle_spmvs(hier)["csr_spmv"]
    apply_M = hier.apply_M()
    r = b.clone()
    times = {m: {"cg": [], "cg_auto": [], "vc_host": [], "vc_dev": []} for m in OBS_MODES}
    for backend in (None, "auto"):  # warm: first-use lookups happen here
        cg(operator(M, backend=backend), b, tol=CG_TOL, maxiter=CG_MAXITER)
    apply_M(r)
    order = list(OBS_MODES) + list(reversed(OBS_MODES))
    for mode, led in order * (OBS_TURNS // 2):
        ledger.set_enabled(led)
        trace.clear()
        with trace.tracing(mode):
            for key, backend in (("cg", None), ("cg_auto", "auto")) * OBS_SOLVES:
                apply_A = operator(M, backend=backend)
                nspmv = 0

                def counted(v):
                    nonlocal nspmv
                    nspmv += 1
                    return apply_A(v)
                before = kops.launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = cg(counted, b, tol=CG_TOL, maxiter=CG_MAXITER)
                torch.cuda.synchronize()
                times[(mode, led)][key].append((time.perf_counter() - t0) * 1e3 / res.iters)
                launched = _launched(kops, before).get("dia_spmv", 0)
                check(launched == device_calls(1), f"{_mode_name(mode, led)}: {key} launches "
                      f"{launched} == the SpMVs the device ran ({nspmv} calls in Python)")
            before = kops.launch_counts()["csr_spmv"]
            host, dev = _host_and_queued_ms(torch, apply_M, r, OBS_CYCLES)
            got = kops.launch_counts()["csr_spmv"] - before
            check(got == per_cycle * (OBS_CYCLES + 3), f"{_mode_name(mode, led)}: V-cycle "
                  f"launches {got} == {per_cycle} SpMVs x {OBS_CYCLES + 3} cycles")
            times[(mode, led)]["vc_host"].append(host)
            times[(mode, led)]["vc_dev"].append(dev)
            if mode in ("off", "summary"):
                x = torch.ones(A.shape[1], device="cuda")
                y0, yd0, z0 = spmv(M, x), dist_spmv(D, x), apply_M(r)
                y, yd, z = _no_sync(torch, _mode_name(mode, led),
                                    (lambda: spmv(M, x), lambda: dist_spmv(D, x),
                                     lambda: apply_M(r)))
                check(torch.equal(y, y0) and torch.equal(yd, yd0) and torch.equal(z, z0),
                      f"{_mode_name(mode, led)}: SpMV, dist_spmv and V-cycle with no "
                      f"device->host sync, bitwise reruns")
    trace.clear()
    ledger.set_enabled(True)
    print(f"  overhead by mode ({OBS_TURNS} turns, forward and backward in turn; CG "
          f"{res.iters} iters at 104^3 in DIA, backend None and 'auto', ms/iter by the "
          f"host clock, {OBS_SOLVES} solves a turn; one CSR V-cycle, {per_cycle} SpMVs, ms "
          f"by the host clock over {OBS_CYCLES} and on the device with the launches "
          f"queued, one reading a turn); median [min, max]:", flush=True)

    def stat(v):
        return f"{statistics.median(v):.4f} [{min(v):.4f}, {max(v):.4f}]"
    for m in OBS_MODES:
        t = times[m]
        print(f"    {_mode_name(*m)}: cg {stat(t['cg'])}; cg auto {stat(t['cg_auto'])}; "
              f"V-cycle host {stat(t['vc_host'])}, device {stat(t['vc_dev'])}", flush=True)
    return times


def obs_calibration(torch, A, prob):
    """(h4) The gather penalty measured on the card, and the calibrated
    analytic pick beside analytic, ml and profile for the 104^3 matrix and
    each P = 8 part, shard by shard. A finding only: nothing uses it."""
    from repro_torch.core import hpcg
    from repro_torch.core.distributed import split_local_execute
    from repro_torch.core.formats import COO
    from repro_torch.tuning import FormatPolicy, analytic_select, engines
    from repro_torch.tuning.features import PatternFeatures, batch_features

    name = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    pen = engines.calibrate_gather_penalty()
    check(pen >= 1.0 and engines.calibrate_gather_penalty() == pen,
          "calibrate_gather_penalty() >= 1, cached for the card")
    check(list(engines._CALIBRATED_PENALTY) == [("cuda", name)],
          f"penalty cached under (cuda, {name})")
    engines._CALIBRATED_PENALTY.clear()  # a vector past the L2 cache, for the finding
    big = engines.calibrate_gather_penalty(n=1 << 26)
    engines._CALIBRATED_PENALTY[("cuda", name)] = pen
    print(f"  calibrate_gather_penalty() on {name}: {pen:.4f} (n = 2^18, the default; "
          f"n = 2^26: {big:.4f}); fixed GATHER_PENALTY {engines.GATHER_PENALTY} "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)

    def picks(C):
        stats = PatternFeatures.from_coo(C).to_stats()
        return {"analytic-calibrated": analytic_select(stats, calibrate=True).best.name,
                "analytic": FormatPolicy("analytic").select(C).best.name,
                "ml": FormatPolicy("ml").select(C).best.name,
                "profile": FormatPolicy("profile", profile_iters=3).select(C).best.name}
    t0 = time.perf_counter()
    whole = picks(A)
    print(f"  picks at 104^3: {whole}", flush=True)
    check(whole["ml"] == "DIA", "ml picks DIA at 104^3")
    local, remote, plan = hpcg.partition_problem(prob, OBS_SHARDS, device="cuda")
    interior, boundary = split_local_execute(local, remote, plan.mp, plan.interior_cap,
                                             plan.boundary_cap)
    for pname, C in (("interior", interior), ("boundary", boundary), ("remote", remote)):
        cands = FormatPolicy("analytic").candidates
        cal = [analytic_select(f.to_stats(), calibrate=True).best.name
               for f in batch_features(C)]
        row = {"analytic-calibrated": cal}
        for mode in ("analytic", "ml"):
            row[mode] = [cands[i].name for i in FormatPolicy(mode).select_batch(C)]
        row["profile"] = [FormatPolicy("profile", profile_iters=3).select(
            COO(C.row[p], C.col[p], C.data[p], C.shape, C.nnz)).best.name
            for p in range(OBS_SHARDS)]
        print(f"  P={OBS_SHARDS} {pname} per shard: "
              + "; ".join(f"{k} {v}" for k, v in row.items()), flush=True)
    print(f"  picks in {time.perf_counter() - t0:.2f} s", flush=True)
    return pen


def obs_corpus(torch, tmp):
    """(h5) A small corpus labelled on the card and trained into a
    temporary tree; the shipped default_tree.json stays byte-identical."""
    import hashlib
    from repro_torch.tuning import corpus
    from repro_torch.tuning.tree import DEFAULT_TREE_PATH, DecisionTree

    def sha():
        with open(DEFAULT_TREE_PATH, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()
    before = sha()
    out = os.path.join(tmp, "tree.json")
    t0 = time.perf_counter()
    check(corpus.main(["--samples", "12", "--iters", "3", "--out", out]) == 0,
          "corpus.main on the card")
    mats, _ = corpus.generate_corpus(12, seed=0)
    pred = DecisionTree.load(out).predict(corpus.build_dataset(mats))
    print(f"  corpus of 12 labelled and trained on the card in {time.perf_counter() - t0:.2f} s;"
          f" the tree predicts {[int(v) for v in pred]}", flush=True)
    check(set(int(v) for v in pred) <= {int(f) for f in corpus.DEFAULT_CANDIDATES},
          "the trained tree loads and predicts candidates")
    check(sha() == before, f"default_tree.json unchanged (sha256 {before[:16]}...)")


def phase_obs(torch, np, prob, store):
    """Path (h): observability on the card at 104^3, on path (e)'s store."""
    import shutil
    from repro_torch.core import hpcg
    from repro_torch.obs import explain, ledger
    from repro_torch.tuning import CACHE_PATH_ENV

    print(f"== path (h): observability at {'x'.join(map(str, GRID))}", flush=True)
    start_path(torch)
    os.environ[CACHE_PATH_ENV] = os.path.join(store, "selections.json")
    A = hpcg.to_coo(prob, device="cuda")
    b = torch.from_numpy(hpcg.rhs_for_ones(prob)).cuda()
    M, D = obs_traced_solve(torch, A, b, prob, store)
    obs_overhead(torch, A, b, M, D, prob)
    del D
    ledger.clear()
    explain.run_demo("powerlaw")
    kinds = [r["kind"] for r in ledger.records()]
    print("  explain.run_demo('powerlaw') on the card:")
    print("\n".join("    " + line for line in explain.render(ledger.records()).splitlines()),
          flush=True)
    check(kinds[:2] == ["format.select", "plan.switch"] and "kernel.route" in kinds
          and kinds[-1] == "format.select", f"the demo's trail: {kinds}")
    os.environ.pop(CACHE_PATH_ENV, None)
    obs_calibration(torch, A, prob)
    obs_corpus(torch, store)
    del M, A, b
    shutil.rmtree(store, ignore_errors=True)
    return read_path(torch, "(h)", ("dia_spmv", "csr_spmv"))


# ---------------------------------------------------------------------------
# Path (i): the dense decoder and the serving engine at minitron-8b's width
# ---------------------------------------------------------------------------

SERVE_ARCH = "minitron_8b"
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_REQUESTS, SERVE_MAX_NEW = 4, 1024, 8, 32
SERVE_PROMPT_LENS = (64, 512)  # inclusive range of the prompt lengths (numpy seed 0)
PARITY_LENS, PARITY_NEW, PARITY_MAX_LEN = (37, 61), 8, 128
LOGIT_REL = 1e-3   # |a - b| <= LOGIT_REL * max|logit| (float32 prefill vs decode)
WITNESS_REL = 1e-4  # float32 vs float64: max|a - b| <= WITNESS_REL * max|b|
# int8 cache vs the same step on a float32 cache of the same k/v: each entry
# is off by at most 0.5 * scale (rounding) + 127 * scale * 2^-9 (bf16 scale),
# < 0.6% of its row's largest |entry|; the step's output is held within
# INT8_REL of its largest |entry| (tests/test_torch_models.py states the same)
INT8_REL = 2.0 ** -6
BF16_PEAK = 989e12  # H100 SXM data sheet, dense bf16 tensor-core FLOP/s


def _tree_bytes(tree) -> int:
    from repro_torch.models.spec import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _rel(torch, a, b) -> float:
    """max|a - b| / max|b|, in float64."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def _serve_timers(torch, engine, finite):
    """Wrap the engine's step and prefill: CUDA events around each decode
    step and prefill, the host clock around each ``engine.step`` (which
    ends by reading the tokens, so it waits for the device), and a finite
    check of every logit (one reduction on the device, read at the end)."""
    rec = {"step_ev": [], "step_rows": [], "step_host": [], "prefill": [], "step_bytes": []}
    step, prefill, outer = engine._step, engine._prefill, engine.step

    def timed_step(params, cache, tokens, pos):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        logits, cache = step(params, cache, tokens, pos)
        e.record()
        finite.append(torch.isfinite(logits).all())
        rec["step_ev"].append((s, e))
        rec["step_rows"].append(int(tokens.shape[0]))
        return logits, cache

    def timed_prefill(params, cache, tokens, slots, lengths):
        torch.cuda.synchronize()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        s.record()
        logits, cache = prefill(params, cache, tokens, slots, lengths)
        e.record()
        torch.cuda.synchronize()
        finite.append(torch.isfinite(logits).all())
        rec["prefill"].append((tuple(tokens.shape), (time.perf_counter() - t0) * 1e3, s, e))
        return logits, cache

    def timed_outer(max_new, eos=-1):
        live = int((engine.pos[engine.active] + 1).sum())  # cache rows the step reads
        t0 = time.perf_counter()
        out = outer(max_new, eos=eos)
        rec["step_host"].append((time.perf_counter() - t0) * 1e3)
        rec["step_bytes"].append(live)
        return out

    engine._step, engine._prefill, engine.step = timed_step, timed_prefill, timed_outer
    return rec


def serve_full_width(torch, np, smi, peak_bw, dev):
    """(i1) minitron-8b at full width in bf16 params and compute: 8 requests
    through DecodeEngine(slots=4, max_len=1024)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import DecodeEngine, serve
    from repro_torch.models import build_model
    from repro_torch.obs import metrics

    cfg = dataclasses.replace(get_config(SERVE_ARCH), dtype="bfloat16")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(SEED, param_dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n, nbytes = model.n_params(), _tree_bytes(params)
    emb_bytes = params["embed"]["tokens"].numel() * 2
    print(f"  (i1) {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} "
          f"heads over {cfg.n_kv} kv heads, head_dim {cfg.hd}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}: {n:,} params, {nbytes / 1e9:.2f} GB in bf16 ({(nbytes - emb_bytes) / 1e9:.2f} "
          f"GB without the input embedding), made on the card in {t_init:.2f} s [{smi}]",
          flush=True)
    check(n == cfg.n_params() and nbytes == 2 * n,
          f"(i1) the params are {cfg.name}'s {cfg.n_params():,}, two bytes each")
    rng = np.random.default_rng(SEED)
    lo, hi = SERVE_PROMPT_LENS
    lens = rng.integers(lo, hi + 1, SERVE_REQUESTS)
    reqs = [(i, rng.integers(0, cfg.vocab, (int(L),)).astype(np.int32))
            for i, L in enumerate(lens)]
    engine = DecodeEngine(model, params, SERVE_SLOTS, SERVE_MAX_LEN, device=dev)
    cache_bytes = _tree_bytes(engine.cache)
    print(f"  (i1) DecodeEngine(slots={SERVE_SLOTS}, max_len={SERVE_MAX_LEN}): kv cache "
          f"{cache_bytes / 1e9:.3f} GB (bf16); prompt lengths {lens.tolist()}, max_new "
          f"{SERVE_MAX_NEW}", flush=True)
    serve(engine, [(-1, reqs[0][1][:8])], 2)  # warm-up: cuBLAS handles, first launches
    warm_calls = engine.prefill_calls
    metrics.reset(["serve.requests", "serve.tokens", "serve.latency_us", "serve.queue_us",
                   "serve.prefill_us", "serve.decode_us", "serve.queue_depth"])
    finite = []
    rec = _serve_timers(torch, engine, finite)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done, steps = serve(engine, reqs, SERVE_MAX_NEW)
    wall = time.perf_counter() - t0
    ntok = sum(len(o) for _, o in done)
    check(sorted(r for r, _ in done) == list(range(SERVE_REQUESTS))
          and all(len(o) == SERVE_MAX_NEW for _, o in done),
          f"(i1) all {SERVE_REQUESTS} requests finished with {SERVE_MAX_NEW} tokens")
    check(bool(torch.stack(finite).all()), f"(i1) every logit finite ({len(finite)} calls)")
    prefills = engine.prefill_calls - warm_calls
    check(prefills >= 2, f"(i1) {prefills} batched prefills: a refill between steps")
    step_ev = [s.elapsed_time(e) for s, e in rec["step_ev"]]
    host, ev = statistics.median(rec["step_host"]), statistics.median(step_ev)
    # the least time of a decode step: the weights it reads (all but the
    # input embedding, of which it reads one row a slot), the live kv rows
    # of the cache, the logits written
    kv_row = cfg.n_layers * cfg.n_kv * cfg.hd * 2 * 2
    live = statistics.median(rec["step_bytes"])
    step_bytes = (nbytes - emb_bytes + SERVE_SLOTS * cfg.d_model * 2 + live * kv_row
                  + SERVE_SLOTS * cfg.padded_vocab * 4)
    bound_step = step_bytes / peak_bw * 1e3
    print(f"  (i1) served {len(done)} requests, {ntok} tokens in {wall:.3f} s: "
          f"{ntok / wall:.1f} tokens/s, {steps} engine steps [{smi}]")
    print(f"  (i1) decode step (4 slots): median {host:.3f} ms by the host clock, {ev:.3f} ms "
          f"by CUDA events (min {min(step_ev):.3f}, max {max(step_ev):.3f}, {len(step_ev)} "
          f"steps); bound {bound_step:.3f} ms ({step_bytes / 1e9:.2f} GB at "
          f"{peak_bw / 1e12:.2f} TB/s) -> {bound_step / ev:.1%} of bound [{smi}]")
    lin_flops = 2 * (n - cfg.padded_vocab * cfg.d_model * 2)  # a token through the layers
    for (R, P), host_ms, s, e in rec["prefill"]:
        flops = (R * P * lin_flops + 2 * cfg.n_layers * R * cfg.n_heads * P * P * cfg.hd
                 + 2 * R * cfg.d_model * cfg.padded_vocab)
        bound = max(flops / BF16_PEAK, (nbytes - emb_bytes) / peak_bw) * 1e3
        ms = s.elapsed_time(e)
        print(f"  (i1) batched prefill (R, P) = ({R}, {P}): {host_ms:.3f} ms host, {ms:.3f} ms "
              f"by CUDA events; bound {bound:.3f} ms ({flops / 1e12:.2f} TFLOP at "
              f"{BF16_PEAK / 1e12:.0f} TFLOP/s bf16) -> {bound / ms:.1%} of bound [{smi}]")
    for name in ("serve.queue_us", "serve.prefill_us", "serve.decode_us", "serve.latency_us",
                 "serve.queue_depth"):
        q = metrics.quantiles(name, (0.5, 0.99))
        unit = "" if name.endswith("depth") else " ms"
        scale = 1.0 if name.endswith("depth") else 1e-3
        print(f"  (i1) {name}: p50 {q['p50'] * scale:.3f}{unit}, p99 {q['p99'] * scale:.3f}{unit} "
              f"[{smi}]")
    # the step's own device time (launches queued behind a spin) and the
    # profiler's kernel sum: how far the host holds the card back
    tokens = torch.tensor(engine.tokens, device=dev)
    pos = torch.tensor(engine.pos, device=dev)
    time_v_cycle(torch, lambda _: model.decode_step(params, engine.cache, tokens, pos), None,
                 f"(i1) decode_step, {SERVE_SLOTS} slots [{smi}]")
    print(f"  (i1) peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"[{smi}]", flush=True)
    del engine, params


def greedy_by_decode(torch, model, params, prompt, max_new, max_len, cache_dtype, dev):
    """Per-token prefill-by-decode, then greedy decode of one request: the
    tokens, and the logits at every prompt position."""
    cache = model.init_cache(1, max_len, cache_dtype, device=dev)
    rows = []
    for i, t in enumerate(prompt):
        logits, cache = model.decode_step(params, cache, torch.tensor([int(t)], device=dev),
                                          torch.tensor([i], device=dev))
        rows.append(logits[0])
    tok = int(torch.argmax(logits[0]))
    out, pos = [tok], len(prompt)
    while len(out) < max_new:
        logits, cache = model.decode_step(params, cache, torch.tensor([tok], device=dev),
                                          torch.tensor([pos], device=dev))
        tok = int(torch.argmax(logits[0]))
        out.append(tok)
        pos += 1
    return out, torch.stack(rows)


def parity_full_width(torch, np, smi, dev):
    """(i2) float32 at full width: the engine's batched prefill against
    per-token prefill-by-decode, and decode_step against forward."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import DecodeEngine, serve
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config(SERVE_ARCH), dtype="float32")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(SEED, device=dev)
    torch.cuda.synchronize()
    print(f"  (i2) {cfg.name} float32: {_tree_bytes(params) / 1e9:.2f} GB of params made in "
          f"{time.perf_counter() - t0:.2f} s; requests of {PARITY_LENS} tokens, "
          f"{PARITY_NEW} new [{smi}]", flush=True)
    rng = np.random.default_rng(SEED)
    reqs = [(i, rng.integers(0, cfg.vocab, (n,)).astype(np.int32))
            for i, n in enumerate(PARITY_LENS)]
    for cache_dtype in (torch.float32, torch.bfloat16):
        cname = str(cache_dtype).replace("torch.", "")
        engine = DecodeEngine(model, params, len(reqs), PARITY_MAX_LEN, device=dev)
        engine.cache = model.init_cache(len(reqs), PARITY_MAX_LEN, cache_dtype, device=dev)
        t0 = time.perf_counter()
        done, _ = serve(engine, reqs, PARITY_NEW)
        t_engine = time.perf_counter() - t0
        got = dict(done)
        t0 = time.perf_counter()
        refs = [greedy_by_decode(torch, model, params, p, PARITY_NEW, PARITY_MAX_LEN,
                                 cache_dtype, dev) for _, p in reqs]
        t_ref = time.perf_counter() - t0
        same = [got[rid] == ref for (rid, _), (ref, _) in zip(reqs, refs)]
        print(f"  (i2) {cname} cache: engine {[got[r] for r, _ in reqs]} ({t_engine:.2f} s, "
              f"{engine.prefill_calls} batched prefill); by decode "
              f"{[ref for ref, _ in refs]} ({t_ref:.2f} s) [{smi}]", flush=True)
        if cache_dtype == torch.float32:
            check(all(same), f"(i2) float32 cache: batched prefill's greedy tokens == per-token "
                             f"prefill-by-decode's, every request [{smi}]")
            # first logits: one batched prefill_cache against the by-decode rows
            cache = model.init_cache(len(reqs), PARITY_MAX_LEN, cache_dtype, device=dev)
            P = max(PARITY_LENS)
            tokens = np.zeros((len(reqs), P), np.int32)
            for i, (_, p) in enumerate(reqs):
                tokens[i, :len(p)] = p
            first, _ = model.prefill_cache(
                params, cache, torch.from_numpy(tokens).to(dev),
                torch.arange(len(reqs), device=dev), torch.tensor(PARITY_LENS, device=dev))
            for i, (_, rows) in enumerate(refs):
                rel = float((first[i] - rows[-1]).abs().max() / rows[-1].abs().max())
                check(rel <= LOGIT_REL, f"(i2) request {i}: first logits of prefill_cache vs "
                                        f"by decode: max|diff| = {rel:.3e} * max|logit| "
                                        f"(<= {LOGIT_REL}) [{smi}]")
            # decode_step's logits at every prompt position against forward
            _, p = reqs[-1]
            full, _ = model.forward(params, {"tokens": torch.from_numpy(p[None]).to(dev)},
                                    logits_mode="all")
            rows = refs[-1][1]
            rel = float((full[0] - rows).abs().max() / full[0].abs().max())
            check(rel <= LOGIT_REL, f"(i2) decode_step logits at all {len(p)} positions vs "
                                    f"forward(logits_mode='all'): max|diff| = {rel:.3e} * "
                                    f"max|logit| (<= {LOGIT_REL}) [{smi}]")
        else:
            print(f"  (i2) bf16 cache (the JAX engine's default): batched == by decode for "
                  f"{sum(same)} of {len(same)} requests (reported, not required: the two "
                  f"read the prompt's k/v unrounded and bf16-rounded) [{smi}]", flush=True)
        del engine
    return model, params


def witness_f64(torch, np, model, params, smi, dev):
    """(i3) layer 0 at full width in float64 against float32: the attention
    block and the MLP over 64 tokens, one decode step over a 64-token cache,
    and the int8 cache's step against the float32 cache's."""
    from repro_torch.models import attention as attn
    from repro_torch.models import layers
    from repro_torch.models.spec import tree_map
    from repro_torch.models.transformer import layer_view

    cfg = model.cfg
    rng = np.random.default_rng(SEED + 3)
    p32 = layer_view(params["blocks"], 0)
    p64 = tree_map(lambda t: t.double(), p32)
    x = torch.from_numpy(rng.standard_normal((1, 64, cfg.d_model))).to(dev)
    h = torch.from_numpy(rng.standard_normal((1, 1, cfg.d_model))).to(dev)
    res = {}
    outs = {}
    for name, p, dt in (("f32", p32, torch.float32), ("f64", p64, torch.float64)):
        xa = x.to(dt)
        a, (k, v) = attn.attention_block(p["attn"], xa, cfg, causal=True, return_kv=True)
        m = layers.mlp_apply(p["mlp"], xa, cfg.mlp_act)
        kc = torch.zeros((1, 128, cfg.n_kv, cfg.hd), dtype=dt, device=dev)
        vc = torch.zeros_like(kc)
        kc[:, :64], vc[:, :64] = k, v
        pos = torch.tensor([64], device=dev)
        d = attn.decode_attention(p["attn"], h.to(dt), kc, vc, pos, cfg)[0]
        outs[name] = (a, m, d, k, v)
    for i, what in enumerate(("attention block (64 tokens)", "MLP (64 tokens)",
                              "decode_attention over a 64-token cache")):
        res[what] = _rel(torch, outs["f32"][i], outs["f64"][i])
        check(res[what] <= WITNESS_REL, f"(i3) layer 0 {what}, float32 vs float64: "
                                        f"{res[what]:.3e} (<= {WITNESS_REL}) [{smi}]")
    _, _, d32, k, v = outs["f32"]
    kq, ks = attn._quantize_kv(k)
    vq, vs = attn._quantize_kv(v)
    kc = torch.zeros((1, 128, cfg.n_kv, cfg.hd), dtype=torch.int8, device=dev)
    vc = torch.zeros_like(kc)
    kcs = torch.zeros((1, 128, cfg.n_kv), dtype=torch.bfloat16, device=dev)
    vcs = torch.zeros_like(kcs)
    kc[:, :64], vc[:, :64], kcs[:, :64], vcs[:, :64] = kq, vq, ks, vs
    dq = attn.decode_attention(p32["attn"], h.float(), kc, vc, torch.tensor([64], device=dev),
                               cfg, kcs, vcs)[0]
    rel = _rel(torch, dq, d32)
    check(rel <= INT8_REL, f"(i3) int8 kv_quant step vs the float32 cache's: {rel:.3e} * "
                           f"max|out| (<= {INT8_REL:.4g}, the stated int8 bound) [{smi}]")


def serve_cli(torch, smi, dev):
    """(i4) the CLI in this process: stablelm-1.6b at full size, f32 params."""
    import contextlib
    import io
    from repro_torch.launch import serve as serve_mod

    argv = ["--arch", "stablelm_1_6b", "--requests", "8", "--slots", "4"]
    if dev.type != "cuda":  # a rehearsal off the card; on it, the CLI's default device
        argv += ["--device", dev.type]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = serve_mod.main(argv)
    text = buf.getvalue()
    print("\n".join(f"  (i4) {line}" for line in text.splitlines()))
    check(rc == 0 and "served 8 requests, 128 tokens" in text and f"on {dev.type}" in text,
          f"(i4) python -m repro_torch.launch.serve {' '.join(argv)}: served "
          f"({time.perf_counter() - t0:.2f} s in all) [{smi}]")


def phase_decoder(torch, np, smi, peak_bw, dev):
    """Path (i): the dense decoder and DecodeEngine at minitron-8b's full
    width (i1, i2, i3) and the serve CLI (i4)."""
    import gc
    print(f"== path (i): the dense decoder and the serving engine, {SERVE_ARCH} at full "
          f"width [{smi}]", flush=True)
    print(f"  device memory held before path (i): "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    start_path(torch)
    serve_full_width(torch, np, smi, peak_bw, dev)
    gc.collect()
    torch.cuda.empty_cache()
    model, params = parity_full_width(torch, np, smi, dev)
    witness_f64(torch, np, model, params, smi, dev)
    print(f"  (i2, i3) peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"[{smi}]", flush=True)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    serve_cli(torch, smi, dev)
    counts = read_path(torch, "(i)", ())
    from repro_torch.kernels import ops as kops
    check(all(counts[k] == 0 for k in kops.LAUNCH_COUNTERS),
          "path (i) launches none of the eleven sparse kernels (the dense decoder reaches "
          "no Pallas kernel in the JAX package either)")
    return counts


# ---------------------------------------------------------------------------
# Path (j): the moe, ssm, hybrid, vlm and audio families at full width
# ---------------------------------------------------------------------------

MOE_ARCH = "deepseek_moe_16b"
MOE_SLOTS, MOE_MAX_LEN, MOE_REQUESTS, MOE_NEW = 4, 1024, 8, 32
MOE_PROMPT_LENS = (64, 512)  # inclusive range of the prompt lengths (numpy seed 0)
MOE_LAYER_TOKENS = (4, 512)  # (j2): one MoE layer on (B, T) tokens
MOE_F32_LAYERS = 4  # (j3): deepseek in f32 is 67.5 GB: a depth cut, full width
RECURRENT_ARCHS = ("mamba2_2_7b", "zamba2_2_7b")
SSM_SLOTS, SSM_MAX_LEN, SSM_REQUESTS, SSM_NEW = 4, 256, 6, 16
SSM_PROMPT_LENS = (8, 48)
# (j5) depth cuts in f32: 8 Mamba2 layers; zamba2's 12 (its layers come in
# groups of attn_every = 6, each followed by the shared attention block)
SSM_F32_LAYERS = {"mamba2_2_7b": 8, "zamba2_2_7b": 12}
SSM_TF_TOKENS = 64  # (j5) teacher-forced decode vs forward
SSD_SHAPE = (2, 512, 80, 64, 128)  # (j5) ssd_chunked at mamba2's head width: b, t, h, p, n
ENGINE_REL = 1e-4  # (j5) engine logits vs the single-request chain, * max|logit|
SSD_CHUNK_REL, SSD_F64_REL, STATE_REL = 1e-4, 1e-5, 1e-4
MOE_F64_REL = 1e-5  # (j2) float64 vs float32 on the same routing
AUDIO_ARCH, VLM_ARCH = "hubert_xlarge", "internvl2_26b"
AUDIO_FRAMES = (2, 1024)  # (j6) hubert: frames (B, S, frontend_dim)
VLM_TOKENS, VLM_DECODE = 256, 8  # (j6) internvl2: 256 patches + 256 tokens, 8 steps


def full_config(arch, **kw):
    """The architecture's published configuration (``configs/``), with the
    dtype and any cut named in ``kw``."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), **kw)


def _free(torch):
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def _peak(torch) -> str:
    return f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"


def _made(torch, model, param_dtype, dev, what, smi):
    """Params made leaf by leaf on the card, with their count and bytes."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(SEED, param_dtype=param_dtype, device=dev)
    torch.cuda.synchronize()
    nbytes = _tree_bytes(params)
    cfg = model.cfg
    print(f"  {what} {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}: "
          f"{model.n_params():,} params, {nbytes / 1e9:.2f} GB in "
          f"{str(param_dtype).replace('torch.', '')}, made on the card in "
          f"{time.perf_counter() - t0:.2f} s (peak {_peak(torch)}) [{smi}]", flush=True)
    return params, nbytes


def _requests(np, vocab, n, lens):
    rng = np.random.default_rng(SEED)
    lo, hi = lens
    sizes = rng.integers(lo, hi + 1, n)
    return [(i, rng.integers(0, vocab, (int(L),)).astype(np.int32))
            for i, L in enumerate(sizes)], sizes


def _drop_counter(moe):
    """Wrap moe._assignments: per prefill call, the real tokens' routed
    assignments and how many were dropped (device sums, read at the end).
    Pad tokens of a prefill bucket are not counted; they sort after the
    real ones of their row and never displace one."""
    rec = {"real": None, "calls": []}
    orig = moe._assignments

    def counted(x, gates, idx, cfg):
        out = orig(x, gates, idx, cfg)
        if rec["real"] is not None:
            lengths, rows = rec["real"]
            token, keep = out[1], out[3]
            real = (token < lengths[:, None].long()) & rows[:, None]
            rec["calls"][-1].append(((real & ~keep).sum(), real.sum()))
        return out
    return rec, orig, counted


def moe_serve_full_width(torch, np, smi, peak_bw, dev):
    """(j1) deepseek-moe-16b at full width in bf16, the ``sort`` dispatch:
    8 requests through DecodeEngine(slots=4, max_len=1024)."""
    from repro_torch.launch.serve import DecodeEngine, serve
    from repro_torch.models import build_model, moe
    from repro_torch.obs import metrics

    cfg = full_config(MOE_ARCH, dtype="bfloat16")
    check(cfg.moe_dispatch == "sort", f"(j1) {cfg.name} dispatches by sort (its default)")
    model = build_model(cfg)
    params, nbytes = _made(torch, model, torch.bfloat16, dev, "(j1)", smi)
    emb_bytes = params["embed"]["tokens"].numel() * 2
    check(nbytes == 2 * model.n_params(), f"(j1) {model.n_params():,} params, 2 bytes each")
    reqs, lens = _requests(np, cfg.vocab, MOE_REQUESTS, MOE_PROMPT_LENS)
    engine = DecodeEngine(model, params, MOE_SLOTS, MOE_MAX_LEN, device=dev)
    print(f"  (j1) DecodeEngine(slots={MOE_SLOTS}, max_len={MOE_MAX_LEN}): kv cache "
          f"{_tree_bytes(engine.cache) / 1e9:.3f} GB (bf16); prompt lengths {lens.tolist()}, "
          f"max_new {MOE_NEW}; E {cfg.n_experts} top-{cfg.top_k} + {cfg.n_shared_experts} "
          f"shared, capacity factor {cfg.capacity_factor}", flush=True)
    serve(engine, [(-1, reqs[0][1][:8])], 2)  # warm-up: cuBLAS handles, first launches
    warm_calls = engine.prefill_calls
    metrics.reset(["serve.requests", "serve.tokens", "serve.latency_us", "serve.queue_us",
                   "serve.prefill_us", "serve.decode_us", "serve.queue_depth"])
    finite = []
    rec = _serve_timers(torch, engine, finite)
    drops, orig, counted = _drop_counter(moe)
    inner = engine._prefill

    def prefill_counted(params, cache, tokens, slots, lengths):
        # the bucket's pad rows repeat the last request's slot: count each once
        seen = slots.tolist()
        rows = torch.tensor([v not in seen[:i] for i, v in enumerate(seen)], device=dev)
        drops["real"] = (lengths, rows)
        drops["calls"].append([])
        try:
            return inner(params, cache, tokens, slots, lengths)
        finally:
            drops["real"] = None
    engine._prefill = prefill_counted
    moe._assignments = counted
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    try:
        t0 = time.perf_counter()
        done, steps = serve(engine, reqs, MOE_NEW)
        wall = time.perf_counter() - t0
    finally:
        moe._assignments = orig
    ntok = sum(len(o) for _, o in done)
    check(sorted(r for r, _ in done) == list(range(MOE_REQUESTS))
          and all(len(o) == MOE_NEW for _, o in done),
          f"(j1) all {MOE_REQUESTS} requests finished with {MOE_NEW} tokens")
    check(bool(torch.stack(finite).all()), f"(j1) every logit finite ({len(finite)} calls)")
    prefills = engine.prefill_calls - warm_calls
    check(prefills >= 2, f"(j1) {prefills} batched prefills: a refill between steps")
    step_ev = [s.elapsed_time(e) for s, e in rec["step_ev"]]
    host, ev = statistics.median(rec["step_host"]), statistics.median(step_ev)
    # the least time of a decode step, as JAX's decode computes it: every
    # expert runs on its C = 4 slots, so the step reads every weight but the
    # input embedding (one row a slot), the live kv rows, the logits written
    kv_row = cfg.n_layers * cfg.n_kv * cfg.hd * 2 * 2
    live = statistics.median(rec["step_bytes"])
    step_bytes = (nbytes - emb_bytes + MOE_SLOTS * cfg.d_model * 2 + live * kv_row
                  + MOE_SLOTS * cfg.padded_vocab * 4)
    bound_step = step_bytes / peak_bw * 1e3
    print(f"  (j1) served {len(done)} requests, {ntok} tokens in {wall:.3f} s: "
          f"{ntok / wall:.1f} tokens/s, {steps} engine steps [{smi}]")
    print(f"  (j1) decode step ({MOE_SLOTS} slots): median {host:.3f} ms by the host clock, "
          f"{ev:.3f} ms by CUDA events (min {min(step_ev):.3f}, max {max(step_ev):.3f}, "
          f"{len(step_ev)} steps); bound {bound_step:.3f} ms ({step_bytes / 1e9:.2f} GB at "
          f"{peak_bw / 1e12:.2f} TB/s) -> {bound_step / ev:.1%} of bound [{smi}]")
    # a prefill's least time: per token the attention and shared-expert
    # linears and the router, per kept assignment one expert's three
    # (d, ff) products, the causal attention, the last token's logits
    d, ff = cfg.d_model, cfg.d_ff
    attn_w = d * cfg.n_heads * cfg.hd * 2 + 2 * d * cfg.n_kv * cfg.hd
    tok_flops = 2 * cfg.n_layers * (attn_w + cfg.n_shared_experts * 3 * d * ff
                                    + d * cfg.n_experts)
    for ((R, P), host_ms, s, e), calls in zip(rec["prefill"], drops["calls"]):
        dropped = sum(int(a) for a, _ in calls)
        routed = sum(int(b) for _, b in calls)
        kept = routed - dropped
        flops = (R * P * tok_flops + kept * 2 * 3 * d * ff
                 + 2 * cfg.n_layers * R * cfg.n_heads * P * P * cfg.hd
                 + 2 * R * d * cfg.padded_vocab)
        bound = max(flops / BF16_PEAK, (nbytes - emb_bytes) / peak_bw) * 1e3
        ms = s.elapsed_time(e)
        print(f"  (j1) batched prefill (R, P) = ({R}, {P}): {host_ms:.3f} ms host, {ms:.3f} ms "
              f"by CUDA events; bound {bound:.3f} ms ({flops / 1e12:.2f} TFLOP at "
              f"{BF16_PEAK / 1e12:.0f} TFLOP/s bf16; weights {(nbytes - emb_bytes) / 1e9:.2f} GB)"
              f" -> {bound / ms:.1%} of bound; capacity {moe._capacity(cfg, P)} a row: "
              f"{dropped} of {routed} real-token assignments dropped over {cfg.n_layers} "
              f"layers ({dropped / max(routed, 1):.2%}) [{smi}]")
    for name in ("serve.prefill_us", "serve.decode_us", "serve.latency_us"):
        q = metrics.quantiles(name, (0.5, 0.99))
        print(f"  (j1) {name}: p50 {q['p50'] * 1e-3:.3f} ms, p99 {q['p99'] * 1e-3:.3f} ms "
              f"[{smi}]")
    tokens = torch.tensor(engine.tokens, device=dev)
    pos = torch.tensor(engine.pos, device=dev)
    time_v_cycle(torch, lambda _: model.decode_step(params, engine.cache, tokens, pos), None,
                 f"(j1) decode_step, {MOE_SLOTS} slots [{smi}]")
    print(f"  (j1) peak device memory while serving {_peak(torch)} [{smi}]", flush=True)


def moe_layer_full_width(torch, np, smi, dev):
    """(j2) one MoE layer of deepseek-moe-16b at full width in f32 on (4, 512)
    tokens: the three dispatches against each other, bitwise reruns, and a
    float64 run on the same routing."""
    from repro_torch.models import moe
    from repro_torch.models.spec import init_params, tree_map

    cfg = full_config(MOE_ARCH, dtype="float32")
    p = init_params(moe.moe_specs(cfg), SEED + 5, dev)
    b, t = MOE_LAYER_TOKENS
    x = torch.from_numpy(np.random.default_rng(SEED + 5).standard_normal(
        (b, t, cfg.d_model)).astype(np.float32)).to(dev)
    gates, idx, aux = moe._route(p, x, cfg)
    keep = moe._assignments(x, gates, idx, cfg)[3]
    c = moe._capacity(cfg, t)
    print(f"  (j2) one MoE layer, f32, x {tuple(x.shape)}: capacity {c} a row, "
          f"{int((~keep).sum())} of {keep.numel()} assignments dropped, aux "
          f"{float(aux.mean()):.4f} [{smi}]", flush=True)
    outs, ms = {}, {}
    for name, fn in moe.DISPATCH.items():
        outs[name] = fn(p, x, gates, idx, cfg)
        ms[name] = time_ms(lambda fn=fn: fn(p, x, gates, idx, cfg), 10)
    check(torch.allclose(outs["dense"], outs["sort"], rtol=1e-4, atol=1e-4),
          f"(j2) dense vs sort within 1e-4 (JAX's bound): max|diff| "
          f"{float((outs['dense'] - outs['sort']).abs().max()):.3e} [{smi}]")
    check(torch.allclose(outs["sort"], outs["coo"], rtol=1e-6, atol=1e-6),
          f"(j2) sort vs coo within 1e-6 (JAX's bound): max|diff| "
          f"{float((outs['sort'] - outs['coo']).abs().max()):.3e} [{smi}]")
    for name in ("sort", "coo"):
        check(torch.equal(moe.DISPATCH[name](p, x, gates, idx, cfg), outs[name]),
              f"(j2) {name}: a rerun is bitwise equal (no atomics) [{smi}]")
    p64 = tree_map(lambda a: a.double(), p)
    y64 = moe.DISPATCH["sort"](p64, x.double(), gates.double(), idx, cfg)
    rel = _rel(torch, outs["sort"], y64)
    check(rel <= MOE_F64_REL, f"(j2) float64 on the same (gates, idx) vs float32: "
                              f"{rel:.3e} * max|y| (<= {MOE_F64_REL}) [{smi}]")
    print(f"  (j2) ms a dispatch (experts included, CUDA events): "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()) + f" [{smi}]", flush=True)
    del p, p64, outs


def _topk_gap(torch, moe, fn):
    """Run ``fn`` with moe._route wrapped: the least gap, over the routed
    tokens of every layer, between the k-th and the (k+1)-th probability."""
    gaps, orig = [], moe._route

    def wrapped(p, x, cfg):
        out = orig(p, x, cfg)
        logits = x.to(torch.float32) @ p["router"].to(torch.float32)
        top = torch.topk(torch.softmax(logits, dim=-1), cfg.top_k + 1, dim=-1).values
        gaps.append(float((top[..., -2] - top[..., -1]).min()))
        return out
    moe._route = wrapped
    try:
        fn()
    finally:
        moe._route = orig
    return min(gaps)


def moe_parity_f32(torch, np, smi, dev):
    """(j3) deepseek at full width in f32, 4 layers, at a capacity that drops
    nothing: the engine's batched prefill against prefill-by-decode token
    for token, and decode_step against forward."""
    from repro_torch.launch.serve import DecodeEngine, serve
    from repro_torch.models import build_model, moe

    cfg0 = full_config(MOE_ARCH)
    cf = 2 * cfg0.n_experts / cfg0.top_k
    cfg = full_config(MOE_ARCH, dtype="float32", n_layers=MOE_F32_LAYERS, capacity_factor=cf)
    model = build_model(cfg)
    params, _ = _made(torch, model, torch.float32, dev, f"(j3) capacity factor {cf:.4g},", smi)
    rng = np.random.default_rng(SEED)
    reqs = [(i, rng.integers(0, cfg.vocab, (n,)).astype(np.int32))
            for i, n in enumerate(PARITY_LENS)]
    engine = DecodeEngine(model, params, len(reqs), PARITY_MAX_LEN, device=dev,
                          record_logits=True)
    engine.cache = model.init_cache(len(reqs), PARITY_MAX_LEN, torch.float32, device=dev)
    done, _ = serve(engine, reqs, PARITY_NEW)
    got = dict(done)
    check(engine.prefill_calls == 1, "(j3) one batched prefill for both requests")
    for rid, prompt in reqs:
        ref, rows = greedy_by_decode(torch, model, params, prompt, PARITY_NEW, PARITY_MAX_LEN,
                                     torch.float32, dev)
        first = engine.logits_log[rid][0]
        rel = float((first - rows[-1]).abs().max() / rows[-1].abs().max())
        check(rel <= LOGIT_REL, f"(j3) request {rid}: first logits of the batched prefill vs "
                                f"by decode: {rel:.3e} * max|logit| (<= {LOGIT_REL}) [{smi}]")
        if got[rid] == ref:
            check(True, f"(j3) request {rid}: batched prefill's {PARITY_NEW} greedy tokens == "
                        f"prefill-by-decode's {ref} [{smi}]")
            continue
        j = next(i for i, (a, b) in enumerate(zip(got[rid], ref)) if a != b)
        fed = list(prompt) + ref[:j]
        cache = model.init_cache(1, PARITY_MAX_LEN, torch.float32, device=dev)

        def chain():
            for i, tok in enumerate(fed):
                model.decode_step(params, cache, torch.tensor([int(tok)], device=dev),
                                  torch.tensor([i], device=dev))
        gap = _topk_gap(torch, moe, chain)
        check(gap < 1e-5, f"(j3) request {rid}: tokens differ first at new token {j} "
                          f"({got[rid]} vs {ref}); the router's least top-k gap up to that "
                          f"step is {gap:.3e} (a near-tie only below 1e-5) [{smi}]")
    _, p = reqs[-1]
    full, _ = model.forward(params, {"tokens": torch.from_numpy(p[None]).to(dev)},
                            logits_mode="all")
    _, rows = greedy_by_decode(torch, model, params, p, 1, PARITY_MAX_LEN, torch.float32, dev)
    rel = float((full[0] - rows).abs().max() / full[0].abs().max())
    check(rel <= LOGIT_REL, f"(j3) decode_step logits at all {len(p)} positions vs "
                            f"forward(logits_mode='all'): {rel:.3e} * max|logit| "
                            f"(<= {LOGIT_REL}) [{smi}]")
    print(f"  (j3) peak device memory {_peak(torch)} [{smi}]", flush=True)
    del params, engine


def recurrent_serve_full_width(torch, np, smi, peak_bw, dev, arch):
    """(j4) mamba2-2.7b or zamba2-2.7b at full width in bf16: 6 requests
    through DecodeEngine(slots=4, max_len=256), each prefilled by decode
    steps on its own slot."""
    from repro_torch.launch.serve import DecodeEngine, serve
    from repro_torch.models import build_model

    cfg = full_config(arch, dtype="bfloat16")
    model = build_model(cfg)
    params, nbytes = _made(torch, model, torch.bfloat16, dev, "(j4)", smi)
    emb_bytes = params["embed"]["tokens"].numel() * 2
    reqs, lens = _requests(np, cfg.vocab, SSM_REQUESTS, SSM_PROMPT_LENS)
    engine = DecodeEngine(model, params, SSM_SLOTS, SSM_MAX_LEN, device=dev)
    cache_bytes = {k: t.numel() * t.element_size() for k, t in engine.cache.items()}
    print(f"  (j4) {cfg.name}: d_inner {cfg.d_inner}, {cfg.ssm_heads} SSM heads of "
          f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, chunk {cfg.ssm_chunk}"
          + (f", shared attention after every {cfg.attn_every} layers" if cfg.attn_every else "")
          + f"; DecodeEngine(slots={SSM_SLOTS}, max_len={SSM_MAX_LEN}) cache "
          + ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in cache_bytes.items())
          + f"; prompt lengths {lens.tolist()}, max_new {SSM_NEW}", flush=True)
    serve(engine, [(-1, reqs[0][1][:4])], 2)  # warm-up
    warm_calls = engine.prefill_calls
    finite = []
    rec = _serve_timers(torch, engine, finite)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done, steps = serve(engine, reqs, SSM_NEW)
    wall = time.perf_counter() - t0
    ntok = sum(len(o) for _, o in done)
    check(sorted(r for r, _ in done) == list(range(SSM_REQUESTS))
          and all(len(o) == SSM_NEW for _, o in done),
          f"(j4) {cfg.name}: all {SSM_REQUESTS} requests finished with {SSM_NEW} tokens")
    check(bool(torch.stack(finite).all()), f"(j4) every logit finite ({len(finite)} calls)")
    check(engine.prefill_calls - warm_calls == SSM_REQUESTS,
          f"(j4) prefill_calls == {SSM_REQUESTS}: one by-decode prefill a request "
          f"({SSM_REQUESTS} requests through {SSM_SLOTS} slots: slots reused)")
    # the engine's decode steps run every slot; a prefill's steps one
    step_ev = [s.elapsed_time(e) for (s, e), n in zip(rec["step_ev"], rec["step_rows"])
               if n == SSM_SLOTS]
    prefill_ev = [s.elapsed_time(e) for (s, e), n in zip(rec["step_ev"], rec["step_rows"])
                  if n == 1]
    host, ev = statistics.median(rec["step_host"]), statistics.median(step_ev)
    # least time of a 4-slot step: the weights but the input embedding, the
    # SSM state read and written (float32), the conv windows read and
    # written, the live kv rows (zamba2), the logits written
    state = 2 * (cache_bytes["ssm"] + cache_bytes["conv"])
    kv = 0
    if "k" in engine.cache:
        kv_row = (cfg.n_layers // cfg.attn_every) * cfg.n_kv * cfg.hd * 2 * 2
        kv = statistics.median(rec["step_bytes"]) * kv_row
    step_bytes = nbytes - emb_bytes + state + kv + SSM_SLOTS * cfg.padded_vocab * 4
    bound = step_bytes / peak_bw * 1e3
    print(f"  (j4) {cfg.name}: served {len(done)} requests, {ntok} tokens in {wall:.3f} s: "
          f"{ntok / wall:.1f} tokens/s, {steps} engine steps; {len(prefill_ev)} one-slot "
          f"prefill steps, median {statistics.median(prefill_ev):.3f} ms by CUDA events "
          f"[{smi}]")
    print(f"  (j4) {cfg.name} decode step ({SSM_SLOTS} slots): median {host:.3f} ms by the "
          f"host clock, {ev:.3f} ms by CUDA events (min {min(step_ev):.3f}, max "
          f"{max(step_ev):.3f}, {len(step_ev)} steps); bound {bound:.3f} ms "
          f"({step_bytes / 1e9:.2f} GB: weights {(nbytes - emb_bytes) / 1e9:.2f}, state "
          f"{state / 1e9:.3f}, kv {kv / 1e9:.3f}) -> {bound / ev:.1%} of bound [{smi}]")
    tokens = torch.tensor(engine.tokens, device=dev)
    pos = torch.tensor(engine.pos, device=dev)
    time_v_cycle(torch, lambda _: model.decode_step(params, engine.cache, tokens, pos), None,
                 f"(j4) {cfg.name} decode_step, {SSM_SLOTS} slots [{smi}]")
    print(f"  (j4) {cfg.name} peak device memory while serving {_peak(torch)} [{smi}]",
          flush=True)


def recurrent_parity_f32(torch, np, smi, dev, arch):
    """(j5) mamba2 or zamba2 at full width in f32, at a depth cut: decode vs
    forward, mamba_apply's final state vs the decode chain's, ssd_chunked at
    full head width (chunk and float64), the engine vs the single-request
    chain across slot reuse."""
    from repro_torch.launch.serve import DecodeEngine, serve
    from repro_torch.models import build_model, mamba2
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.transformer import layer_view

    cfg = full_config(arch, dtype="float32", n_layers=SSM_F32_LAYERS[arch])
    model = build_model(cfg)
    params, _ = _made(torch, model, torch.float32, dev, "(j5)", smi)
    rng = np.random.default_rng(SEED + 6)
    toks = rng.integers(0, cfg.vocab, (SSM_TF_TOKENS,)).astype(np.int32)
    full, _ = model.forward(params, {"tokens": torch.from_numpy(toks[None]).to(dev)})
    cache = model.init_cache(1, SSM_TF_TOKENS, torch.float32, device=dev)
    rows = torch.stack([model.decode_step(params, cache, torch.tensor([int(t)], device=dev),
                                          torch.tensor([i], device=dev))[0][0]
                        for i, t in enumerate(toks)])
    rel = float((full[0] - rows).abs().max() / full[0].abs().max())
    check(rel <= LOGIT_REL, f"(j5) {cfg.name}: teacher-forced decode_step at {SSM_TF_TOKENS} "
                            f"positions vs forward: {rel:.3e} * max|logit| (<= {LOGIT_REL}) "
                            f"[{smi}]")
    # layer 0's mixer: the final state of mamba_apply vs the decode chain's
    mixer = layer_view(params["blocks"], 0)
    x = torch.from_numpy(rng.standard_normal((2, SSM_TF_TOKENS, cfg.d_model))
                         .astype(np.float32)).to(dev)
    h = rms_norm(x, mixer["ln"], cfg.norm_eps)
    _, (conv_a, ssm_a) = mamba2.mamba_apply(mixer["mixer"], h, cfg, return_state=True)
    conv = torch.zeros_like(conv_a)
    ssm = torch.zeros_like(ssm_a)
    for i in range(SSM_TF_TOKENS):
        mamba2.mamba_decode(mixer["mixer"], h[:, i:i + 1], conv, ssm, cfg)
    rel_s, rel_c = _rel(torch, ssm, ssm_a), _rel(torch, conv, conv_a)
    check(rel_s <= STATE_REL and rel_c <= STATE_REL,
          f"(j5) {cfg.name}: mamba_apply(return_state=True) vs {SSM_TF_TOKENS} decode steps: "
          f"ssm state {rel_s:.3e}, conv tail {rel_c:.3e} relative (<= {STATE_REL}) [{smi}]")
    # the engine: 2 slots, 5 requests, each request's logits vs its chain
    reqs = [(i, rng.integers(0, cfg.vocab, (n,)).astype(np.int32))
            for i, n in enumerate((5, 9, 3, 7, 4))]
    engine = DecodeEngine(model, params, 2, 14, device=dev, record_logits=True)
    engine.cache = model.init_cache(2, 14, torch.float32, device=dev)
    done, _ = serve(engine, reqs, 6)
    worst = 0.0
    for rid, prompt in reqs:
        fed = list(prompt) + dict(done)[rid][:-1]
        cache = model.init_cache(1, 14, torch.float32, device=dev)
        ref = torch.stack([model.decode_step(params, cache, torch.tensor([int(t)], device=dev),
                                             torch.tensor([i], device=dev))[0][0]
                           for i, t in enumerate(fed)])
        got = torch.stack(engine.logits_log[rid])
        worst = max(worst, float((got - ref).abs().max() / ref.abs().max()))
    check(engine.prefill_calls == len(reqs) and worst <= ENGINE_REL,
          f"(j5) {cfg.name}: DecodeEngine(slots=2) over {len(reqs)} requests (slot reuse, a "
          f"refill while the other slot decodes): every request's logits vs its single-request "
          f"chain within {worst:.3e} * max|logit| (<= {ENGINE_REL}) [{smi}]")
    del params, engine
    _free(torch)


def ssd_full_width(torch, np, smi, dev):
    """(j5) ssd_chunked at mamba2's head width: chunk 256 vs 64, float64 vs
    float32."""
    from repro_torch.models import mamba2

    b, t, h, p, n = SSD_SHAPE
    rng = np.random.default_rng(SEED + 7)
    arrs = [rng.standard_normal((b, t, h, p)), rng.uniform(0.001, 0.1, (b, t, h)),
            -rng.uniform(0.5, 4.0, h), rng.standard_normal((b, t, n)),
            rng.standard_normal((b, t, n))]
    x, dt, A, B, C = (torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrs)
    y256, s256 = mamba2.ssd_chunked(x, dt, A, B, C, 256)
    y64, s64 = mamba2.ssd_chunked(x, dt, A, B, C, 64)
    yd, sd = mamba2.ssd_chunked(*(a.double() for a in (x, dt, A, B, C)), 256)
    r_chunk = max(_rel(torch, y256, y64), _rel(torch, s256, s64))
    r_f64 = max(_rel(torch, y256, yd), _rel(torch, s256, sd))
    ms = {q: time_ms(lambda q=q: mamba2.ssd_chunked(x, dt, A, B, C, q), 5) for q in (64, 256)}
    check(r_chunk <= SSD_CHUNK_REL and r_f64 <= SSD_F64_REL,
          f"(j5) ssd_chunked {SSD_SHAPE} (b, t, h, p, n): chunk 256 vs 64 {r_chunk:.3e} "
          f"(<= {SSD_CHUNK_REL}), float64 vs float32 {r_f64:.3e} (<= {SSD_F64_REL}); ms "
          f"chunk 64 {ms[64]:.3f}, chunk 256 {ms[256]:.3f} [{smi}]")


def frontends_full_size(torch, np, smi, dev):
    """(j6) hubert-xlarge's encoder forward on frames, internvl2-26b's prefill
    on patches and tokens and decode steps on tokens, both in bf16."""
    from repro_torch.models import build_model

    cfg = full_config(AUDIO_ARCH, dtype="bfloat16")
    model = build_model(cfg)
    params, _ = _made(torch, model, torch.bfloat16, dev, "(j6)", smi)
    rng = np.random.default_rng(SEED + 8)
    b, s = AUDIO_FRAMES
    frames = torch.from_numpy(rng.standard_normal((b, s, cfg.frontend_dim))
                              .astype(np.float32)).to(dev)
    out, _ = model.forward(params, {"frames": frames})
    ms = time_ms(lambda: model.forward(params, {"frames": frames}), 3)
    check(tuple(out.shape) == (b, s, cfg.padded_vocab) and bool(torch.isfinite(out).all()),
          f"(j6) {cfg.name} encoder forward on frames {tuple(frames.shape)}: logits "
          f"{tuple(out.shape)}, finite; {ms:.3f} ms (CUDA events); peak {_peak(torch)} [{smi}]")
    del params, out
    _free(torch)
    cfg = full_config(VLM_ARCH, dtype="bfloat16")
    model = build_model(cfg)
    params, _ = _made(torch, model, torch.bfloat16, dev, "(j6)", smi)
    patches = torch.from_numpy(rng.standard_normal((1, cfg.n_patches, cfg.frontend_dim))
                               .astype(np.float32)).to(dev)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (1, VLM_TOKENS))).to(dev)
    batch = {"patches": patches, "tokens": tokens}
    last, _ = model.prefill(params, batch)
    ms = time_ms(lambda: model.prefill(params, batch), 3)
    check(tuple(last.shape) == (1, 1, cfg.padded_vocab) and bool(torch.isfinite(last).all()),
          f"(j6) {cfg.name} prefill on {cfg.n_patches} patches + {VLM_TOKENS} tokens: "
          f"last logits finite; {ms:.3f} ms (CUDA events) [{smi}]")
    cache = model.init_cache(1, VLM_DECODE, device=dev)
    step_ms, rows = [], []
    for i in range(VLM_DECODE):
        s_, e_ = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s_.record()
        lg, _ = model.decode_step(params, cache, tokens[0, i:i + 1], torch.tensor([i], device=dev))
        e_.record()
        rows.append(lg)
        step_ms.append((s_, e_))
    torch.cuda.synchronize()
    ev = [s_.elapsed_time(e_) for s_, e_ in step_ms]
    check(all(bool(torch.isfinite(r).all()) for r in rows),
          f"(j6) {cfg.name}: {VLM_DECODE} decode_steps on a fresh cache (tokens alone), finite;"
          f" median {statistics.median(ev):.3f} ms a step (1 slot, CUDA events); peak "
          f"{_peak(torch)} [{smi}]")
    del params, cache


def phase_families(torch, np, smi, peak_bw, dev):
    """Path (j): the moe, ssm, hybrid, vlm and audio families at full width."""
    print(f"== path (j): every remaining family at full width: {MOE_ARCH}, "
          f"{', '.join(RECURRENT_ARCHS)}, {AUDIO_ARCH}, {VLM_ARCH} [{smi}]", flush=True)
    start_path(torch)
    t = {}
    t0 = time.perf_counter()
    moe_serve_full_width(torch, np, smi, peak_bw, dev)
    _free(torch)
    moe_layer_full_width(torch, np, smi, dev)
    _free(torch)
    moe_parity_f32(torch, np, smi, dev)
    _free(torch)
    t["moe"] = time.perf_counter() - t0
    for arch in RECURRENT_ARCHS:
        t0 = time.perf_counter()
        recurrent_serve_full_width(torch, np, smi, peak_bw, dev, arch)
        _free(torch)
        recurrent_parity_f32(torch, np, smi, dev, arch)
        t[arch] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ssd_full_width(torch, np, smi, dev)
    _free(torch)
    frontends_full_size(torch, np, smi, dev)
    _free(torch)
    t["ssd, frontends"] = time.perf_counter() - t0
    print("  path (j) seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in t.items()), flush=True)
    counts = read_path(torch, "(j)", ())
    from repro_torch.kernels import ops as kops
    check(all(counts[k] == 0 for k in kops.LAUNCH_COUNTERS),
          "path (j) launches none of the eleven sparse kernels (the JAX model stack reaches "
          "no Pallas kernel; the moe coo dispatch's COO has none)")
    return counts


# ---------------------------------------------------------------------------
# Path (k): training at full width
# ---------------------------------------------------------------------------

TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "stablelm_1_6b", 4, 2048, 6  # (k1)
SSM_TRAIN_ARCH, SSM_TRAIN_BATCH, SSM_TRAIN_SEQ, SSM_TRAIN_STEPS = "mamba2_2_7b", 2, 1024, 3
GRAD_LAYERS, GRAD_TOKENS = 2, (2, 512)  # (k2) stablelm cut to 2 layers, (B, S) tokens
FLASH_GRAD_SHAPE = (2, 2048, 32, 64)  # (k2) q, k, v: (B, S, H, D)
# (k2) float32 gradients against float64, per leaf: max|g32 - g64| <= REL *
# max|g64|. The model's bound covers its bf16-free f32 path over 2 layers
# and a 100352-way softmax; flash's the chunked f32 sums over 2048 keys.
GRAD_F64_REL, FLASH_F64_REL, MOE_GRAD_F64_REL = 1e-4, 2e-5, 1e-5
# (k2) the MoE dispatches' gradients against each other, * max|g|: JAX's
# forward bounds of tests/test_moe.py (dense vs sort 1e-4, sort vs coo 1e-6)
MOE_GRAD_DENSE_REL, MOE_GRAD_COO_REL = 1e-4, 1e-6
RESUME_STEPS, RESUME_EVERY = 8, 4  # (k3) stablelm --smoke on the card
BF16_PEAK = 989e12  # H100 SXM data sheet, dense bf16 tensor-core FLOP/s


def _train_flops(cfg, b, s) -> float:
    """Forward FLOPs of one training batch: 2 a parameter a token for every
    matmul weight (the input embedding is a gather), the causal attention
    (QK^T and PV over half the S x S scores) or the SSD scan's chunk
    einsums. A step's work is 4 of these: the forward, the remat recompute
    (layers and CE chunks) and the backward's two."""
    from repro_torch.models import build_model
    from repro_torch.models.spec import tree_leaves
    specs = build_model(cfg).specs()
    mm = sum(math.prod(p.shape) for p in tree_leaves(specs) if len(p.shape) >= 2)
    mm -= math.prod(specs["embed"]["tokens"].shape)
    flops = 2.0 * mm * b * s
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        flops += cfg.n_layers * 2.0 * b * s * s * cfg.n_heads * cfg.hd  # causal: half of 4BS^2HD
    if cfg.family in ("ssm", "hybrid"):
        q, h, p, n = min(cfg.ssm_chunk, s), cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        per_chunk = 2 * b * q * q * n + 2 * b * h * q * q * p + 4 * b * q * n * h * p
        flops += cfg.n_layers * (s // q) * per_chunk
    return flops


def _timed_training(torch, argv, what, smi, peak_bw):
    """``launch.train.main(argv)`` in this process with each step timed
    (host clock around a synchronised step; CUDA events) and each step's
    global gradient norm recorded as AdamW receives it. Every loss and norm
    must be finite. Returns main's result and the timings."""
    from repro_torch.launch import train
    from repro_torch.models.spec import tree_leaves
    from repro_torch.optim import adamw

    rec = {"host": [], "events": [], "gnorm": []}
    make_step, update = train.make_train_step, adamw.AdamW.update

    def timed_make_step(*a, **kw):
        fn = make_step(*a, **kw)

        def step(state, batch):
            torch.cuda.synchronize()
            s_, e_ = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            s_.record()
            out = fn(state, batch)
            e_.record()
            torch.cuda.synchronize()
            rec["host"].append((time.perf_counter() - t0) * 1e3)
            rec["events"].append(s_.elapsed_time(e_))
            return out
        return step

    def recorded_update(self, grads, state, params):
        rec["gnorm"].append(torch.sqrt(sum(torch.dot(g.reshape(-1).float(), g.reshape(-1).float())
                                           for g in tree_leaves(grads))))
        return update(self, grads, state, params)

    train.make_train_step, adamw.AdamW.update = timed_make_step, recorded_update
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        out = train.main(argv)
    finally:
        train.make_train_step, adamw.AdamW.update = make_step, update
    wall = time.perf_counter() - t0
    losses = [lv for _, lv in out["losses"]]
    norms = [float(g) for g in rec["gnorm"]]
    check(len(losses) == len(norms) == len(rec["host"]) and all(map(math.isfinite, losses + norms)),
          f"{what}: {len(losses)} steps, every loss and gradient norm finite: losses "
          + ", ".join(f"{v:.4f}" for v in losses) + "; grad norms "
          + ", ".join(f"{v:.3f}" for v in norms) + f" [{smi}]")
    return out, rec, wall


def _report_steps(torch, cfg, b, s, n_params, rec, wall, what, smi, peak_bw):
    """ms a step after the first (host, events), tokens/s, peak memory, and
    the share of the bound: 4 forwards' FLOPs over the bf16 peak plus
    AdamW's bytes (params, m, v read and written, grads read: 7 f32 words a
    parameter) over the memory rate."""
    host = statistics.median(rec["host"][1:])
    ev = statistics.median(rec["events"][1:])
    flops = 4 * _train_flops(cfg, b, s)
    bound = (flops / BF16_PEAK + 7 * 4 * n_params / peak_bw) * 1e3
    print(f"  {what}: ms a step (median of steps 1..{len(rec['host']) - 1}) host {host:.3f}, "
          f"CUDA events {ev:.3f}; first step {rec['host'][0]:.3f} ms; {b * s / host * 1e3:,.0f} "
          f"tokens/s; bound {bound:.3f} ms ({flops / 1e12:.2f} TFLOP at the bf16 peak + AdamW's "
          f"{7 * 4 * n_params / 1e9:.2f} GB) = {bound / ev:.1%} of it; peak "
          f"{_peak(torch)}; main() {wall:.1f} s [{smi}]", flush=True)


def train_full_width(torch, smi, peak_bw):
    """(k1) stablelm-1.6b at full size trained through launch.train.main:
    bf16 compute, f32 params and AdamW state, remat on, the chunked CE."""
    from repro_torch.models import build_model
    cfg = full_config(TRAIN_ARCH)
    check(TRAIN_SEQ % 1024 == 0 and TRAIN_SEQ // 1024 > 1
          and TRAIN_SEQ * cfg.padded_vocab > 2 ** 27,
          f"(k1) {TRAIN_SEQ} x {cfg.padded_vocab} > 2^27: Model.loss takes the chunked CE "
          f"({TRAIN_SEQ // 1024} chunks of 1024)")
    argv = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--batch", str(TRAIN_BATCH),
            "--seq", str(TRAIN_SEQ), "--log-every", "1"]
    out, rec, wall = _timed_training(torch, argv, "(k1) " + cfg.name, smi, peak_bw)
    _report_steps(torch, cfg, TRAIN_BATCH, TRAIN_SEQ, build_model(cfg).n_params(), rec, wall,
                  f"(k1) {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}), "
                  f"({TRAIN_BATCH}, {TRAIN_SEQ}) tokens", smi, peak_bw)
    del out


def _leaf_reading(torch, got, want):
    """max over leaves of max|got - want| / max|want|, and the worst leaf."""
    from repro_torch.models.spec import tree_leaves
    worst, at = 0.0, -1
    for i, (a, b) in enumerate(zip(tree_leaves(got), tree_leaves(want))):
        r = _rel(torch, a, b)
        if r > worst:
            worst, at = r, i
    return worst, at


def _model_grads(torch, model, params, batch, **kw):
    from repro_torch.launch import train
    from repro_torch.models.spec import tree_map
    params = train.trainable(params)
    loss = model.loss(params, batch, **kw)
    loss.backward()
    return loss.detach(), tree_map(lambda t: t.grad, params)


def grad_witness_dense(torch, np, smi, dev):
    """(k2) stablelm-1.6b at full width cut to GRAD_LAYERS layers: the loss's
    gradient in float32 against float64, every leaf; remat on against off,
    bitwise under deterministic algorithms."""
    from repro_torch.data.pipeline import SyntheticLM, to_device
    from repro_torch.models import build_model
    from repro_torch.models.spec import tree_leaves, tree_map

    b, s = GRAD_TOKENS
    cfg32 = full_config(TRAIN_ARCH, n_layers=GRAD_LAYERS, dtype="float32")
    model32 = build_model(cfg32)
    base = model32.init(SEED, device=dev)
    batch = to_device(SyntheticLM(cfg32.vocab, s, b, seed=SEED).batch_at(0), dev)
    kw = dict(q_chunk=512, kv_chunk=512)
    loss32, g32 = _model_grads(torch, model32, tree_map(lambda t: t.clone(), base), batch, **kw)
    torch.use_deterministic_algorithms(True)
    try:
        la, ga = _model_grads(torch, model32, tree_map(lambda t: t.clone(), base), batch, **kw)
        lb, gb = _model_grads(torch, model32, tree_map(lambda t: t.clone(), base), batch,
                              remat=False, **kw)
    finally:
        torch.use_deterministic_algorithms(False)
    same = torch.equal(la, lb) and all(torch.equal(x, y) for x, y in
                                        zip(tree_leaves(ga), tree_leaves(gb)))
    check(same, f"(k2) {cfg32.name} at {GRAD_LAYERS} layers: loss and every gradient leaf "
                f"bitwise equal with remat on and off (deterministic algorithms) [{smi}]")
    del ga, gb
    model64 = build_model(full_config(TRAIN_ARCH, n_layers=GRAD_LAYERS, dtype="float64"))
    loss64, g64 = _model_grads(torch, model64, tree_map(lambda t: t.double(), base), batch, **kw)
    worst, at = _leaf_reading(torch, g32, g64)
    n = len(tree_leaves(g32))
    check(worst <= GRAD_F64_REL and all(bool(torch.isfinite(g).all()) for g in tree_leaves(g32)),
          f"(k2) {cfg32.name} at {GRAD_LAYERS} layers, full width, {GRAD_TOKENS} tokens: loss "
          f"f32 {float(loss32):.6f} vs f64 {float(loss64):.6f}; the float32 gradient of every "
          f"one of {n} leaves within {worst:.3e} * max|g64| (leaf {at}; <= {GRAD_F64_REL}) "
          f"[{smi}]")


def _softmax_attention(torch, q, k, v, causal):
    g = q.shape[2] // k.shape[2]
    k, v = k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)
    sc = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    if causal:
        n = q.shape[1]
        sc = sc.masked_fill(~torch.tril(torch.ones(n, n, dtype=torch.bool, device=q.device)),
                            float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, dim=-1), v)


def grad_witness_flash(torch, np, smi, dev):
    """(k2) flash_attention's dq/dk/dv at FLASH_GRAD_SHAPE in float32 (the
    training chunks, 512 x 1024) against autograd of the unchunked float64
    softmax attention, causal and not."""
    from repro_torch.models.flash import flash_attention

    rng = np.random.default_rng(SEED + 9)
    arrs = [rng.standard_normal(FLASH_GRAD_SHAPE).astype(np.float32) for _ in range(4)]

    def grads(dtype, fn):
        ts = [torch.tensor(a, dtype=dtype, device=dev, requires_grad=True) for a in arrs[:3]]
        (fn(*ts) * torch.tensor(arrs[3], dtype=dtype, device=dev)).sum().backward()
        return [t.grad for t in ts]

    for causal in (True, False):
        got = grads(torch.float32, lambda a, b, c: flash_attention(a, b, c, causal, 512, 1024))
        want = grads(torch.float64, lambda a, b, c: _softmax_attention(torch, a, b, c, causal))
        rels = [_rel(torch, g, w) for g, w in zip(got, want)]
        check(max(rels) <= FLASH_F64_REL,
              f"(k2) flash_attention backward {FLASH_GRAD_SHAPE} (B, S, H, D), causal={causal}: "
              f"dq/dk/dv within " + ", ".join(f"{r:.3e}" for r in rels)
              + f" * max|g64| (<= {FLASH_F64_REL}) [{smi}]")
        del got, want


def grad_witness_moe(torch, np, smi, dev):
    """(k2) one deepseek-moe-16b MoE layer at full width in f32 on (4, 512)
    tokens, as (j2): the gradients (x and every layer param) of the three
    dispatches against each other, and the sort dispatch's on fixed routing
    against float64."""
    from repro_torch.models import moe
    from repro_torch.models.spec import init_params, tree_leaves, tree_map

    cfg = full_config(MOE_ARCH, dtype="float32")
    p0 = init_params(moe.moe_specs(cfg), SEED + 5, dev)
    b, t = MOE_LAYER_TOKENS
    rng = np.random.default_rng(SEED + 5)
    x0 = torch.from_numpy(rng.standard_normal((b, t, cfg.d_model)).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.standard_normal((b, t, cfg.d_model)).astype(np.float32)).to(dev)

    def grads(dispatch):
        p = tree_map(lambda a: a.clone().requires_grad_(True), p0)
        x = x0.clone().requires_grad_(True)
        y, aux = moe.moe_apply(p, x, cfg, dispatch=dispatch)
        ((y * w).sum() + aux).backward()
        return {"x": x.grad, "p": tree_map(lambda a: a.grad, p)}

    g = {name: grads(name) for name in moe.DISPATCH}
    r_dense, _ = _leaf_reading(torch, g["dense"], g["sort"])
    r_coo, _ = _leaf_reading(torch, g["coo"], g["sort"])
    n = len(tree_leaves(g["sort"]))
    check(r_dense <= MOE_GRAD_DENSE_REL and r_coo <= MOE_GRAD_COO_REL,
          f"(k2) one {cfg.name} MoE layer, f32, x {tuple(x0.shape)}: gradients of x and every "
          f"param ({n} leaves) dense vs sort {r_dense:.3e}, coo vs sort {r_coo:.3e} * max|g| "
          f"(<= {MOE_GRAD_DENSE_REL}, {MOE_GRAD_COO_REL}) [{smi}]")
    del g
    gates, idx, _ = moe._route(p0, x0, cfg)
    out = {}
    for dt in (torch.float32, torch.float64):
        leaf = lambda a: a.detach().to(dt, copy=True).requires_grad_(True)  # noqa: E731
        p, x, gt = {"experts": tree_map(leaf, p0["experts"])}, leaf(x0), leaf(gates)
        (moe.DISPATCH["sort"](p, x, gt, idx, cfg) * w.to(dt)).sum().backward()
        out[dt] = {"x": x.grad, "gates": gt.grad, "p": tree_map(lambda a: a.grad, p)}
    rel, at = _leaf_reading(torch, out[torch.float32], out[torch.float64])
    check(rel <= MOE_GRAD_F64_REL,
          f"(k2) the sort dispatch's gradients (x, gates, experts) on fixed routing: float32 "
          f"vs float64 {rel:.3e} * max|g| (leaf {at}; <= {MOE_GRAD_F64_REL}) [{smi}]")


def train_resume(torch, smi):
    """(k3) launch.train.main on stablelm --smoke on the card: RESUME_STEPS
    steps checkpointing every RESUME_EVERY, then --resume in a fresh state
    from a directory holding only the step-RESUME_EVERY checkpoint; the
    resumed losses equal the uninterrupted run's bitwise under
    deterministic algorithms."""
    import shutil
    import tempfile
    from repro_torch.launch import train

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    base = ["--arch", TRAIN_ARCH, "--smoke", "--steps", str(RESUME_STEPS), "--batch", "4",
            "--seq", "128", "--log-every", "1"]
    torch.use_deterministic_algorithms(True)
    try:
        full = train.main(base + ["--ckpt-dir", os.path.join(tmp, "a"),
                                  "--ckpt-every", str(RESUME_EVERY)])
        step_dir = f"step_{RESUME_EVERY:08d}"
        shutil.copytree(os.path.join(tmp, "a", step_dir), os.path.join(tmp, "b", step_dir))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            resumed = train.main(base + ["--ckpt-dir", os.path.join(tmp, "b"), "--resume"])
        text = buf.getvalue()
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(tmp, ignore_errors=True)
    print(text, end="", flush=True)
    check(f"[resume] restoring step {RESUME_EVERY}" in text,
          f"(k3) --resume printed 'restoring step {RESUME_EVERY}' [{smi}]")
    want = full["losses"][RESUME_EVERY:]
    check(resumed["losses"] == want,
          f"(k3) steps {RESUME_EVERY}..{RESUME_STEPS - 1} after the resume equal the "
          f"uninterrupted run's bitwise (deterministic algorithms): "
          + ", ".join(f"{a!r}" for _, a in resumed["losses"]) + f" vs "
          + ", ".join(f"{a!r}" for _, a in want) + f" [{smi}]")


def train_ssm_full_width(torch, smi, peak_bw):
    """(k4) mamba2-2.7b at full size (64 layers, chunk 256) through
    launch.train.main: bf16 compute, f32 params and AdamW state."""
    from repro_torch.models import build_model
    cfg = full_config(SSM_TRAIN_ARCH)
    argv = ["--arch", SSM_TRAIN_ARCH, "--steps", str(SSM_TRAIN_STEPS), "--batch",
            str(SSM_TRAIN_BATCH), "--seq", str(SSM_TRAIN_SEQ), "--log-every", "1"]
    out, rec, wall = _timed_training(torch, argv, f"(k4) {cfg.name}, chunk {cfg.ssm_chunk}",
                                     smi, peak_bw)
    _report_steps(torch, cfg, SSM_TRAIN_BATCH, SSM_TRAIN_SEQ, build_model(cfg).n_params(), rec,
                  wall, f"(k4) {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}), "
                  f"({SSM_TRAIN_BATCH}, {SSM_TRAIN_SEQ}) tokens", smi, peak_bw)
    del out


def train_moe_example(torch, smi):
    """(k5) train_moe_sparse at the example's defaults: the three dispatch
    times and the pick; the loss must fall."""
    from repro_torch import train_moe_sparse
    t0 = time.perf_counter()
    out = train_moe_sparse.main([])
    check(out["last"] < out["first"],
          f"(k5) train_moe_sparse (200 steps, batch 8, seq 256): dispatch forward ms "
          + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in out["times"].items())
          + f" -> '{out['dispatch']}'; loss {out['first']:.4f} -> {out['last']:.4f} falls "
          f"(the example's own test, a drop > 0.5: "
          f"{'LEARNING' if out['learning'] else 'not met'}); training {out['seconds']:.1f} s, "
          f"all {time.perf_counter() - t0:.1f} s [{smi}]")


def phase_training(torch, np, smi, peak_bw, dev):
    """Path (k): training at full width, its gradients, resume, the MoE
    example."""
    print(f"== path (k): training: {TRAIN_ARCH} and {SSM_TRAIN_ARCH} at full size, gradient "
          f"witnesses, resume, train_moe_sparse [{smi}]", flush=True)
    start_path(torch)
    t = {}
    for name, fn in (("k1", lambda: train_full_width(torch, smi, peak_bw)),
                     ("k2 dense", lambda: grad_witness_dense(torch, np, smi, dev)),
                     ("k2 flash", lambda: grad_witness_flash(torch, np, smi, dev)),
                     ("k2 moe", lambda: grad_witness_moe(torch, np, smi, dev)),
                     ("k3", lambda: train_resume(torch, smi)),
                     ("k4", lambda: train_ssm_full_width(torch, smi, peak_bw)),
                     ("k5", lambda: train_moe_example(torch, smi))):
        t0 = time.perf_counter()
        fn()
        _free(torch)
        t[name] = time.perf_counter() - t0
    print("  path (k) seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in t.items()), flush=True)
    counts = read_path(torch, "(k)", ())
    from repro_torch.kernels import ops as kops
    check(all(counts[k] == 0 for k in kops.LAUNCH_COUNTERS),
          "path (k) launches none of the eleven sparse kernels (the JAX training path reaches "
          "no Pallas kernel; the moe coo dispatch's COO has none)")
    return counts


# ---------------------------------------------------------------------------
# Path (l): the launch plumbing: the GPipe pipeline at full width, the dry-run
# ---------------------------------------------------------------------------

PIPE_ARCH, PIPE_STAGES, PIPE_MICRO, PIPE_TOKENS = "stablelm_1_6b", 4, 8, 1024  # (l1)
PIPE_ITERS = 3  # (l1) timed forward + backward passes of each, after one warm-up
# (l1) the pipeline against the serial stack: tests/test_pipeline.py's limits
PIPE_FWD_TOL, PIPE_GRAD_REL = 1e-5, 1e-4
DRYRUN_BYTES_REL = 0.01  # (l2) allocated vs predicted bytes of params + AdamW state


def _fwd_bwd(torch, fn, params):
    """One forward + backward of ``fn(params)`` (loss: the mean square of the
    output); returns the output and the gradients, and clears them."""
    from repro_torch.models.spec import tree_leaves
    y = fn(params)
    y.square().mean().backward()
    leaves = tree_leaves(params)
    grads = [p.grad for p in leaves]
    for p in leaves:
        p.grad = None
    return y.detach(), grads


def pipeline_full_width(torch, np, smi, peak_flops, dev):
    """(l1) stablelm-1.6b's 24 layers as 4 GPipe stages against the serial
    stack: outputs, gradients, ms, peak memory."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.pipeline import pipeline_apply, schedule, stage_params
    from repro_torch.models import build_model
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import embed_apply
    from repro_torch.models.spec import tree_leaves, tree_map
    cfg = full_config(PIPE_ARCH, dtype="float32")
    s, m, t = PIPE_STAGES, PIPE_MICRO, PIPE_TOKENS
    params = build_model(cfg).init(SEED, device=dev)
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(0, cfg.vocab, (m, t))).to(dev)
    x = embed_apply(params["embed"], tokens, tfm.compute_dtype(cfg))  # (M, T, d), as forward
    blocks = tree_map(lambda a: a.requires_grad_(True), params["blocks"])
    staged = tree_map(lambda a: a.requires_grad_(True),
                      stage_params(tree_map(lambda a: a.detach().clone(), blocks), s))
    del params
    pos = torch.arange(t, dtype=torch.int32, device=dev)[None, :]
    n_block = sum(a.numel() for a in tree_leaves(blocks))

    def stack(slab, h):
        for p in tfm.layer_views(slab, tree_leaves(slab)[0].shape[0]):
            h, _ = tfm._attn_block(p, h, cfg, causal=True, positions=pos, q_chunk=512,
                                   kv_chunk=1024)
        return h

    mesh = make_mesh((s,), ("stage",))
    # the serial stack on the whole batch, and one microbatch at a time (the
    # pipeline's GEMM shapes without its recompute)
    runs = {"pipeline": lambda: _fwd_bwd(torch, lambda p: pipeline_apply(
                stack, p, x[:, None], mesh)[:, 0], staged),
            "serial": lambda: _fwd_bwd(torch, lambda p: stack(p, x), blocks),
            "serial by microbatch": lambda: _fwd_bwd(
                torch, lambda p: torch.cat([stack(p, x[i:i + 1]) for i in range(m)]), blocks)}
    ms, peak, out = {k: [] for k in runs}, {}, {}
    for k, run in runs.items():  # warm-up: the readings, the peak memory
        _free(torch)
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res = run()
        torch.cuda.synchronize()
        peak[k] = (torch.cuda.max_memory_allocated(), torch.cuda.max_memory_allocated() - held)
        if k in ("pipeline", "serial"):
            out[k] = res
        del res
    for _ in range(PIPE_ITERS):  # in turns
        for k, run in runs.items():
            s_, e_ = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s_.record()
            run()
            e_.record()
            torch.cuda.synchronize()
            ms[k].append(s_.elapsed_time(e_))
    (y_p, g_p), (y_s, g_s) = out["pipeline"], out["serial"]
    fwd = float((y_p - y_s).abs().max()) / float(y_s.abs().max())
    grad = max(float((a.reshape(b.shape) - b).abs().max()) / float(b.abs().max())
               for a, b in zip(g_p, g_s))
    ticks = schedule(s, m)
    ran = sum(len(tk) for tk in ticks)
    med = {k: statistics.median(v) for k, v in ms.items()}
    flops = 6.0 * n_block * m * t  # the block matmuls' forward + backward, no attention
    print(f"  (l1) {cfg.name} f32, {cfg.n_layers} layers ({n_block:,} block params) in {s} "
          f"stages of {cfg.n_layers // s}, {m} microbatches of (1, {t}) tokens: "
          f"{len(ticks)} ticks, {ran} of {s * len(ticks)} (stage, microbatch) pairs run, "
          f"{s * len(ticks) - ran} skipped ({(s * len(ticks) - ran) / (s * len(ticks)):.1%}) "
          f"[{smi}]", flush=True)
    for k in runs:
        print(f"  (l1) {k}: forward + backward {med[k]:.3f} ms (median of {PIPE_ITERS}: "
              + ", ".join(f"{v:.3f}" for v in ms[k]) + f"; CUDA events), peak "
              f"{peak[k][0] / 2**30:.2f} GiB ({peak[k][1] / 2**30:.2f} above the "
              f"{(peak[k][0] - peak[k][1]) / 2**30:.2f} held); block matmuls "
              f"{flops / 1e12:.1f} TFLOP = {flops / peak_flops / med[k] * 1e3:.1%} of the "
              f"f32 peak [{smi}]", flush=True)
    by_mb = med["serial by microbatch"]
    print(f"  (l1) pipeline / serial: {med['pipeline'] / med['serial']:.3f}x the time "
          f"(microbatching {by_mb / med['serial']:.3f}x, then recompute and schedule "
          f"{med['pipeline'] / by_mb:.3f}x), {peak['pipeline'][1] / peak['serial'][1]:.3f}x "
          f"the memory above held [{smi}]", flush=True)
    check(math.isfinite(fwd) and fwd <= PIPE_FWD_TOL,
          f"(l1) pipeline output vs the serial stack: max|dy| / max|y| {fwd:.3e} <= "
          f"{PIPE_FWD_TOL:g} [{smi}]")
    check(len(g_p) == len(g_s) and math.isfinite(grad) and grad <= PIPE_GRAD_REL,
          f"(l1) every block gradient ({len(g_s)} leaves) vs the serial stack: worst "
          f"max|dg| / max|g| {grad:.3e} <= {PIPE_GRAD_REL:g} [{smi}]")


def dryrun_against_card(torch, smi, dev):
    """(l2) the dry-run over every cell on the meta device, then its bytes
    for params + AdamW state against what the card allocates for them."""
    from repro_torch.configs import SHAPES, list_archs, skip_reason
    from repro_torch.launch import dryrun, train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamW
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = dryrun.main(["--all", "--mesh", "both"])
    wall = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    cells = [ln for ln in lines if ln.startswith("[")]
    for ln in cells:
        print("    " + ln)
    skips = sum(1 for ln in cells if "] SKIP: " in ln)
    want_skips = 2 * sum(skip_reason(full_config(a), sh) is not None
                         for a in list_archs() for sh in SHAPES)
    check(rc == 0 and len(cells) == 2 * len(list_archs()) * len(SHAPES) and skips == want_skips,
          f"(l2) python -m repro_torch.launch.dryrun --all --mesh both: {len(cells)} cells, "
          f"{skips} skipped (skip_reason: {want_skips}), {wall:.2f} s wall on the meta device "
          f"[{smi}]")

    cfg = full_config(TRAIN_ARCH)
    model = build_model(cfg)
    mesh = make_mesh((1, 1), ("data", "model"))
    args, pspecs = dryrun.step_args(model, cfg, SHAPES["train_4k"], mesh)
    parts = dryrun.argument_bytes(args, pspecs, mesh)
    want = parts["params"] + parts["opt_state"]
    _free(torch)
    before = torch.cuda.memory_allocated()
    params = train.trainable(model.init(SEED, device=dev))  # path (k1)'s calls
    opt = AdamW().init(params)
    torch.cuda.synchronize()
    got = torch.cuda.memory_allocated() - before
    rel = abs(got - want) / want
    print(f"  (l2) {cfg.name} f32 params + AdamW state on the card: memory_allocated delta "
          f"{got:,} B; the dry-run on a (1, 1) mesh: params {parts['params']:,} + AdamW "
          f"{parts['opt_state']:,} = {want:,} B [{smi}]", flush=True)
    del params, opt
    check(rel <= DRYRUN_BYTES_REL,
          f"(l2) allocated within {DRYRUN_BYTES_REL:.0%} of the dry-run's bytes: "
          f"|got - want| / want {rel:.3e} [{smi}]")


def phase_launch(torch, np, smi, peak_flops, dev):
    """Path (l): the launch plumbing on the card."""
    print(f"== path (l): the launch plumbing: the GPipe pipeline at {PIPE_ARCH}'s full width, "
          f"the dry-run against the card [{smi}]", flush=True)
    start_path(torch)
    t = {}
    for name, fn in (("l1", lambda: pipeline_full_width(torch, np, smi, peak_flops, dev)),
                     ("l2", lambda: dryrun_against_card(torch, smi, dev))):
        t0 = time.perf_counter()
        fn()
        _free(torch)
        t[name] = time.perf_counter() - t0
    print("  path (l) seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in t.items()), flush=True)
    counts = read_path(torch, "(l)", ())
    from repro_torch.kernels import ops as kops
    check(all(counts[k] == 0 for k in kops.LAUNCH_COUNTERS),
          "path (l) launches none of the eleven sparse kernels (no Pallas kernel in the JAX "
          "launch layer)")
    return counts


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke run needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    import numpy as np
    import repro_torch  # noqa: F401  (fails when run outside the checkout)
    from repro_torch import env
    # before the first GEMM: path (k) checks remat and resume bitwise under
    # torch.use_deterministic_algorithms(True), which refuses cuBLAS without
    # one of its deterministic workspace settings; TF32 off for f32 parity.
    # The backend is named: REPRO_BACKEND must not switch TF32 back on here.
    env.apply("cuda")

    t_start = time.perf_counter()
    laps, t_lap = [], [t_start]

    def lap(label):  # seconds since the last lap, printed before the total
        now = time.perf_counter()
        laps.append(f"{label} {now - t_lap[0]:.1f}")
        t_lap[0] = now
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    SMI[0] = smi
    kind = torch.cuda.get_device_name(0)
    card, (peak_bw, peak_flops) = peaks_for(kind)
    print(f"== device: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"peaks used for bounds ({card} data sheet): {peak_bw / 1e12:.2f} TB/s, "
          f"{peak_flops / 1e12:.0f} TFLOP/s f32", flush=True)
    print(f"== process settings (repro_torch.env.describe()): {json.dumps(env.describe())}",
          flush=True)
    check(env.describe()["tf32"] == {"matmul": False, "cudnn": False},
          "env.apply('cuda') turned TF32 off for matmul and cuDNN")
    phase_build()
    lap("build")

    from repro_torch.core import hpcg
    t0 = time.perf_counter()
    prob = hpcg.generate_problem(*GRID)
    t_gen = time.perf_counter() - t0

    t0 = time.perf_counter()
    weights = make_weights(np)
    print(f"== minitron-8b MLP weights pruned on the host in {time.perf_counter() - t0:.2f} s",
          flush=True)
    records = phase_kernels(torch, np, prob, peak_bw, peak_flops)
    lap("problem, weights, kernels")
    torch.cuda.empty_cache()
    records.update(phase_spmm_kernels(torch, np, weights, peak_bw, peak_flops))
    lap("SpMM kernels")
    torch.cuda.empty_cache()
    phase_token_major(torch, np, weights, records)
    lap("token-major")
    records["solver_vec"] = phase_solver_vec(torch, np, peak_bw)
    lap("solver_vec")
    phase_reference(torch)
    A, b, counts_a, cg_dia = phase_main(torch, prob, t_gen)
    counts_b, _ = phase_profile(torch, A, b)
    counts_c = phase_new_formats(torch, A, b)
    lap("reference, paths (a)-(c)")
    torch.cuda.empty_cache()
    counts_f, _ = phase_mg(torch, np, prob, A, b, cg_dia)
    lap("path (f)")
    device_readings(torch, np, weights)  # after path (f), whose profiler runs first
    lap("SpMM times on the device")
    torch.cuda.empty_cache()
    counts_g = phase_dist(torch, np, prob, A, b, cg_dia, peak_bw)
    lap("path (g)")
    del A, b
    torch.cuda.empty_cache()
    counts_d = phase_serving(torch, np, weights)
    lap("path (d)")
    torch.cuda.empty_cache()
    counts_e, store = phase_measured(torch, np, weights, prob)
    lap("path (e)")
    del weights
    torch.cuda.empty_cache()
    counts_h = phase_obs(torch, np, prob, store)
    lap("path (h)")
    del prob
    torch.cuda.empty_cache()
    print(f"== after paths (a)-(h), empty_cache: max_memory_allocated (since path (h) began) "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, held "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB [{smi}]", flush=True)
    counts_i = phase_decoder(torch, np, smi, peak_bw, torch.device("cuda"))
    lap("path (i)")
    torch.cuda.empty_cache()
    counts_j = phase_families(torch, np, smi, peak_bw, torch.device("cuda"))
    lap("path (j)")
    torch.cuda.empty_cache()
    counts_k = phase_training(torch, np, smi, peak_bw, torch.device("cuda"))
    lap("path (k)")
    torch.cuda.empty_cache()
    counts_l = phase_launch(torch, np, smi, peak_flops, torch.device("cuda"))
    lap("path (l)")
    paths = (counts_a, counts_b, counts_c, counts_d, counts_e, counts_f, counts_g, counts_h,
             counts_i, counts_j, counts_k, counts_l)
    for name, rec in records.items():
        rec["launches"] = sum(c.get(name, 0) for c in paths)
    records["csr_spmv"]["readings"] = CSR_READINGS
    # solver_vec's four kernels an iteration inside path (a)'s captured block,
    # where the SpMV between iterations leaves L2 cold (profiler)
    records["solver_vec"]["in_path_ms"] = SV_IN_PATH.get("solver_vec")
    from repro_torch.kernels import ops as kops
    for sched in kops.SCHEDULE_COUNTERS:  # "kernel:schedule"
        kname, knob = sched.split(":")
        if kname in records:
            records[kname][f"launches_{knob}"] = sum(c[sched] for c in paths)
    missing = [k for k in (*kops.LAUNCH_COUNTERS, "solver_vec")
               if k not in records or records[k]["launches"] <= 0]
    check(not missing, f"every kernel has a record with launches > 0 (missing: {missing})")
    idle = [f"{k}:{s}" for k in TC_KERNELS for s in ("xt", "tc")
            if records[k].get(f"launches_{s}", 0) <= 0]
    check(not idle, f"csr_spmm and sell_spmm ran both new schedules on the main paths "
                    f"(idle: {idle})")
    print(f"== seconds by phase: {', '.join(laps)}")
    print(f"== total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(records.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


PROFILE_CELLS = ((TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ), (SSM_TRAIN_ARCH, SSM_TRAIN_BATCH,
                                                         SSM_TRAIN_SEQ))


def profile_training() -> int:
    """``python3 chip_smoke.py --profile-train``: one training step each of
    (k1) and (k4) (full size, after two warm-up steps) under
    ``torch.profiler``: the step's host time, the kernels' device time and
    the share of the step it fills, the kernel and aten-call counts, and
    the ops by device time. Not part of the default run."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("chip_smoke --profile-train: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch import env
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamW

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    env.apply("cuda")
    for arch, b, s in PROFILE_CELLS:
        cfg = get_config(arch)
        model = build_model(cfg)
        params = train.trainable(model.init(SEED, device="cuda"))
        opt = AdamW(lr=3e-3, total_steps=10, warmup_steps=1)
        step = train.make_train_step(model, opt, "cuda", q_chunk=min(s, 512),
                                     kv_chunk=min(s, 1024))
        state = train.TrainState(params, opt.init(params))
        src = SyntheticLM(cfg.vocab, s, b, seed=SEED)
        for i in range(2):
            state, _ = step(state, src.batch_at(i))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, _ = step(state, src.batch_at(2))
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        ev = prof.key_averages()
        kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
        dev_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
        naten = sum(e.count for e in ev if e.key.startswith("aten::"))
        print(f"== {arch} ({b}, {s}): step {wall:.1f} ms (host clock, profiled), kernels "
              f"{dev_ms:.1f} ms ({dev_ms / wall:.1%} of the step), {len(kernels)} kernels, "
              f"{naten} aten calls [{smi}]", flush=True)
        print(ev.table(sort_by="self_device_time_total", row_limit=18,
                       max_name_column_width=70), flush=True)
        del state, params
        _free(torch)
    return 0


def spmm_phase(argv) -> int:
    """``python3 chip_smoke.py --spmm-phase [TREE]``: the build and the SpMM
    kernel phase alone (``phase_spmm_kernels``: every SpMM kernel at both
    minitron-8b MLP weights, f32 and bf16, T = 1 and 256), run by the
    ``chip_smoke.py`` of TREE (default: this checkout) on its own ``src/``
    and its own build directory, then this script's times on the device
    of TREE's kernels (``device_readings``). Two trees read in turns
    (A, B, B, A), each in a process of its own, compare on one card. Not
    part of the default run."""
    import importlib.util
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke --spmm-phase: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    tree = os.path.abspath(argv[0]) if argv else HERE
    sys.path.insert(0, os.path.join(tree, "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke_of_tree",
                                                  os.path.join(tree, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    import numpy as np
    from repro_torch import env
    env.apply("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    _, (peak_bw, peak_flops) = mod.peaks_for(kind)
    print(f"== SpMM kernel phase of {tree} [{smi}]", flush=True)
    mod.phase_build()
    weights = mod.make_weights(np)
    t0 = time.perf_counter()
    mod.phase_spmm_kernels(torch, np, weights, peak_bw, peak_flops)
    print(f"== SpMM kernel phase of {tree}: {time.perf_counter() - t0:.1f} s")
    device_readings(torch, np, weights)
    print(smi)
    return 0


def solver_phase(argv) -> int:
    """``python3 chip_smoke.py --solver-phase [TREE]``: ms an iteration of
    paths (a) (CG, DIA), (f) (MG-PCG, CSR hierarchy) and (g) (CG, P = 8
    uniform DIA/COO) at 104^3 by the host clock (whole solves, after a
    warm one), with TREE's ``repro_torch`` (default: this checkout), so
    that two trees are read in turns on one card, each in a process of its
    own; where TREE's solvers capture their loop, also the captured block's
    device-queued ms an iteration (``loop_readings``). Builds into
    ``$REPRO_TORCH_BUILD_DIR`` when set (trees with equal sources share a
    build). Not part of the default run."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke --solver-phase: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    tree = os.path.abspath(argv[0]) if argv else HERE
    sys.path.insert(0, os.path.join(tree, "src"))
    import numpy as np
    from repro_torch import env
    env.apply("cuda")
    from repro_torch.core import hpcg, solvers
    from repro_torch.core.distributed import build_dist_matrix
    from repro_torch.core.dynamic import DynamicMatrix
    from repro_torch.core.formats import Format
    from repro_torch.kernels import _build
    from repro_torch.mg import build_hierarchy
    SMI[0] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"], capture_output=True, text=True,
                            check=True).stdout.strip()
    captured = hasattr(solvers, "_Loop")
    t0 = time.perf_counter()
    _build.build_all([n for n in ("dia_spmv", "csr_spmv", "solver_vec") if n in _build.sources()])
    print(f"== solver phase of {tree} (loop {'captured' if captured else 'eager'}); build "
          f"{time.perf_counter() - t0:.1f} s [{SMI[0]}]", flush=True)
    prob = hpcg.generate_problem(*GRID)
    A = hpcg.to_coo(prob, device="cuda")
    b = torch.from_numpy(hpcg.rhs_for_ones(prob)).cuda()
    M = DynamicMatrix(A).activate(Format.DIA)
    hier = build_hierarchy(prob, fmt=Format.CSR, A=A)
    D = build_dist_matrix(prob.row, prob.col, prob.val, prob.shape, DIST_SHARDS, device="cuda",
                          plan=hpcg.slab_plan(prob, DIST_SHARDS), check_plan=False,
                          local_format=Format.DIA, remote_format=Format.COO)
    cases = (("(a) cg DIA", solvers.operator(M), None, 3),
             ("(f) MG-PCG CSR", solvers.operator(M), hier.apply_M(), 2),
             (f"(g) cg P={DIST_SHARDS} uniform DIA/COO", solvers.operator(D), None, 2))
    for label, apply_A, apply_M, reps in cases:
        def solve():
            if apply_M is None:
                return solvers.cg(apply_A, b, tol=CG_TOL, maxiter=CG_MAXITER)
            return solvers.pcg(apply_A, b, tol=CG_TOL, maxiter=CG_MAXITER, apply_M=apply_M)
        solve()
        per_iter = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = solve()
            torch.cuda.synchronize()
            per_iter.append((time.perf_counter() - t0) * 1e3 / res.iters)
        print(f"  {label}: {res.iters} iterations, {', '.join(f'{t:.4f}' for t in per_iter)} "
              f"ms an iteration (host clock, whole solves) [{SMI[0]}]", flush=True)
        if captured:
            loop_readings(torch, label, apply_A, b, apply_M=apply_M)
    print(SMI[0])
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--spmm-phase"]:
        sys.exit(spmm_phase(sys.argv[2:]))
    if sys.argv[1:2] == ["--solver-phase"]:
        sys.exit(solver_phase(sys.argv[2:]))
    sys.exit(profile_training() if sys.argv[1:] == ["--profile-train"] else main())
