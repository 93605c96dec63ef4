#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases, in order (any failure exits nonzero and prints no result line):

1. device and build: the card's name and power limit (``nvidia-smi``), then
   every CUDA source under ``src/repro_torch/csrc`` compiled with ``nvcc``
   for sm_90a, one compiler per source, all at once;
2. kernels: each hand-written kernel (DIA, CSR, ELL, SELL, BSR) against its
   plain torch version on the card, at the HPCG 104^3 shapes of the main
   paths (BSR at block size 8) and on ragged cases (empty rows, rectangular
   DIA, offsets outside the matrix, CSR capacity padding, ELL K = 0 and
   clamped columns, SELL ghost lanes and C != 32, BSR empty block rows,
   bs 2/8/16 and K 1/8, NaN in padding that is never read), in float32 and
   bfloat16; bitwise equality over two runs; median times (CUDA events,
   after 0.2 s of warm-up) of the kernel, the plain version and one library
   call computing the same product (``torch.mv`` on a
   ``torch.sparse_csr_tensor``, a yardstick only), beside the least time
   the card could take (bytes over the memory rate, operations over the
   float32 peak); a HYB line (the ELL and CSR kernels composed);
3. reference check: the port's solve at 16^3 on the card (CUDA kernels)
   against the same solve on the CPU (plain torch path), in every format;
4. main paths at HPCG's default 104^3 grid, each driven with the launch
   counts set to 0 just before and read just after:
   a. generate_problem -> to_coo on the card -> DynamicMatrix.auto(A, "ml")
      (must pick DIA) -> cg(operator(A)); then activate(CSR) -> cg;
   b. FormatPolicy("profile") over DEFAULT_CANDIDATES (every candidate
      timed through its kernel), the ml pick beside it, cg in the pick;
   c. cg in ELL, SELL, HYB (k=18) and BSR (block_size=8), then one SpMV of
      SELL, HYB and BSR under ``torch.cuda.set_sync_debug_mode("error")``.
   Each solve's kernel launches must equal the SpMVs it issued.

The last three lines of standard output are the kernels' JSON record, the
``nvidia-smi`` name/power-limit line, and ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import itertools
import json
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


WARMUP_S = 0.2  # launch-and-sync this long before timing, so clocks settle


def time_ms(fn, iters: int) -> float:
    """Median milliseconds of ``fn`` on the current stream (CUDA events),
    after at least 3 calls and ``WARMUP_S`` seconds of warm-up."""
    import torch
    t0, calls = time.perf_counter(), 0
    while calls < 3 or time.perf_counter() - t0 < WARMUP_S:
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


def compare(name, y_k, y_k2, y_p, dtype_name):
    """Kernel vs plain within the stated tolerance, and bitwise stability."""
    import torch
    tol = TOL[dtype_name]
    torch.cuda.synchronize()
    check(y_k.shape == y_p.shape and bool(torch.isfinite(y_k).all()),
          f"{name} {dtype_name}: finite, shape {tuple(y_k.shape)}")
    err = float((y_k.float() - y_p.float()).abs().max()) if y_k.numel() else 0.0
    ok = bool(torch.allclose(y_k.float(), y_p.float(), **tol))
    check(ok, f"{name} {dtype_name}: max_abs_err={err:.3e} vs plain "
              f"(rtol={tol['rtol']}, atol={tol['atol']})")
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
    ragged_menu_cases(rng, torch, dtype, name)


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
        knobs = {f"vec={v}": (lambda v=v: kc.csr_spmv(csr.indptr, csr.indices, csr.data, x, m,
                                                      vec=v))
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
    lib = torch.sparse_csr_tensor(csr.indptr, csr.indices, csr.data, size=csr.shape)
    bsr_lib_ms, bsr_lib_err = _bsr_library(torch, bsr, x32)
    print(f"  library torch.sparse_bsr_tensor @ x f32: "
          f"{f'{bsr_lib_ms:.4f} ms' if bsr_lib_ms is not None else '— (' + bsr_lib_err + ')'}",
          flush=True)
    cols = torch.arange(m, device="cuda")[None, :] + dia.offsets.long()[:, None]
    dia_pairs = int(((cols >= 0) & (cols < n)).sum())
    del cols
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
            return kc.csr_spmv(csr.indptr, csr.indices, c_data, x, m, vec=cfg_csr["vec"])

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
        # the multiply-adds these inputs need at the float32 peak. DIA reads
        # only the table entries whose column lies inside the matrix; ELL,
        # SELL and BSR read every stored slot (padding included).
        xy = n * es + m * es
        slots_ell = m * ell.k
        rows = [
            ("dia_spmv", run_dia, plain_dia, dia.ndiag * 4 + dia_pairs * es + xy,
             2 * dia_pairs, "src/repro_torch/csrc/dia_spmv.cu",
             "src/repro/kernels/dia_spmv.py:50"),
            ("csr_spmv", run_csr, plain_csr, (m + 1) * 4 + csr.nnz * (4 + es) + xy,
             2 * csr.nnz, "src/repro_torch/csrc/csr_spmv.cu",
             "src/repro/kernels/csr_spmv.py:103"),
            ("ell_spmv", run_ell, plain_ell, slots_ell * (4 + es) + xy, 2 * slots_ell,
             "src/repro_torch/csrc/ell_spmv.cu", "src/repro/kernels/ell_spmv.py:65"),
            ("sell_spmv", run_sell, plain_sell,
             sell.capacity * (4 + es) + sell.perm.numel() * 4 + (sell.nslices + 1) * 4 + xy,
             2 * sell.capacity, "src/repro_torch/csrc/sell_spmv.cu",
             "src/repro/kernels/sell_spmv.py:77"),
            ("bsr_spmm", run_bsr, plain_bsr,
             bsr.nblocks * (bs * bs * es + 4) + (m // bs + 1) * 4 + xy,
             2 * bsr.nblocks * bs * bs, "src/repro_torch/csrc/bsr_spmm.cu",
             "src/repro/kernels/bsr_spmm.py:52"),
        ]
        for kname, run, plain, nbytes, nops, src, repl in rows:
            ms = time_ms(run, 100)
            plain_ms = time_ms(plain, 20)
            lib_ms = time_ms(lambda: torch.mv(lib, x32), 100) if dtype == torch.float32 else None
            t_bytes, t_ops = nbytes / peak_bw * 1e3, nops / peak_flops * 1e3
            bound = max(t_bytes, t_ops)
            lib_s = f"{lib_ms:.4f}" if lib_ms is not None else "n/a"
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
    parts = {"whole": lambda: kops.hyb_spmv(H, x),
             "ell part": lambda: kops.ell_spmv(H.ell, x),
             "tail sort+indptr": lambda: kops.tail_csr(H.coo, m),
             "csr tail": lambda: kops._csr.csr_spmv(*tail, x, m, vec=vec)}
    times = {k: time_ms(fn, 50) for k, fn in parts.items()}
    ell_b = m * hyb.k * (4 + es)
    tail_b = hyb.coo.nnz * (4 + es) + (m + 1) * 4
    bound = (ell_b + tail_b + 3 * m * es) / peak_bw * 1e3
    print(f"  hyb {name} (k={hyb.k}, tail {hyb.coo.nnz} entries): "
          + ", ".join(f"{k} {t:.4f} ms" for k, t in times.items())
          + f"; two-kernel bound {bound:.4f} ms "
            f"(ELL {ell_b / 1e6:.1f} MB + tail {tail_b / 1e6:.1f} MB + x, y)", flush=True)


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


def solve_counted(torch, M, b, A, label, kernels):
    """cg(operator(M)) with every SpMV counted; each of the format's kernels
    must launch once per SpMV issued. The true residual b - A x is taken in
    float64 from the COO matrix ``A``."""
    from repro_torch.core.solvers import cg, operator
    from repro_torch.kernels import ops as kops

    apply_A = operator(M)
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
    dt = time.perf_counter() - t0
    after = kops.launch_counts()
    launched = {k: after[k] - before[k] for k in kernels}
    err = float((res.x - 1.0).abs().max())
    rel = float(res.resnorm) / float(b.norm())
    x64 = res.x.double()
    ax = torch.zeros_like(x64).index_add_(0, A.row.long(),
                                          A.data.double() * x64[A.col.long()])
    rel_true = float((b.double() - ax).norm() / b.double().norm())
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
    for k in kernels:
        check(launched[k] == nspmv and nspmv > 0, f"{label}: {k} launches == SpMVs issued")
    return res, dt


def read_path(torch, label, expect):
    """Launch counts of one path (set to 0 before it); every kernel the path
    runs must have launched."""
    from repro_torch.kernels import ops as kops
    counts = kops.launch_counts()
    print(f"  launches over path {label}: {counts}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    for name in expect:
        check(counts[name] > 0, f"{name} launched on path {label} ({counts[name]})")
    return counts


def start_path(torch):
    from repro_torch.kernels import ops as kops
    kops.reset_launches()
    torch.cuda.reset_peak_memory_stats()


def phase_main(torch, prob, t_gen):
    from repro_torch.core import hpcg
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
    # the spread of the host-clocked solve, then the same iterations
    # without the per-iteration convergence sync, each three times
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
    del M
    t0 = time.perf_counter()
    C = DynamicMatrix(A).activate(Format.CSR)
    torch.cuda.synchronize()
    print(f"  activate(CSR) {time.perf_counter() - t0:.2f} s")
    solve_counted(torch, C, b, A, "cg CSR", KERNELS_OF["CSR"])
    del C
    counts = read_path(torch, "(a)", ("dia_spmv", "csr_spmv"))
    return A, b, counts


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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke run needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    import numpy as np
    import repro_torch  # noqa: F401  (fails when run outside the checkout)

    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    card, (peak_bw, peak_flops) = peaks_for(kind)
    print(f"== device: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"peaks used for bounds ({card} data sheet): {peak_bw / 1e12:.2f} TB/s, "
          f"{peak_flops / 1e12:.0f} TFLOP/s f32", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()

    from repro_torch.core import hpcg
    t0 = time.perf_counter()
    prob = hpcg.generate_problem(*GRID)
    t_gen = time.perf_counter() - t0

    records = phase_kernels(torch, np, prob, peak_bw, peak_flops)
    torch.cuda.empty_cache()
    phase_reference(torch)
    A, b, counts_a = phase_main(torch, prob, t_gen)
    counts_b, _ = phase_profile(torch, A, b)
    counts_c = phase_new_formats(torch, A, b)
    for name, rec in records.items():
        rec["launches"] = counts_a[name] + counts_b[name] + counts_c[name]
    print(f"== total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(records.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
