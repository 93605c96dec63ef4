#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases, in order (any failure exits nonzero and prints no result line):

1. device and build: the card's name and power limit (``nvidia-smi``), then
   every CUDA source under ``src/repro_torch/csrc`` compiled with ``nvcc``
   for sm_90a, one compiler per source, all at once;
2. kernels: each hand-written kernel against its plain torch version on the
   card, at the HPCG 104^3 shapes of the main path and on ragged cases
   (empty rows, rectangular DIA, offsets outside the matrix, CSR capacity
   padding), in float32 and bfloat16; bitwise equality over two runs;
   median times (CUDA events, after 0.2 s of warm-up) of the kernel, the
   plain version and one
   library call computing the same product (``torch.mv`` on a
   ``torch.sparse_csr_tensor``, a yardstick only), beside the least time
   the card could take (bytes over the memory rate, operations over the
   float32 peak);
3. reference check: the port's solve at 16^3 on the card (CUDA kernels)
   against the same solve on the CPU (plain torch path);
4. main path at HPCG's default 104^3 grid: generate_problem -> to_coo on the
   card -> DynamicMatrix.auto(A, "ml") (must pick DIA) -> cg(operator(A));
   then activate(CSR) -> cg. The launch counts are set to 0 just before and
   read just after; each solve's kernel launches must equal the SpMVs it
   issued.

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


def phase_kernels(torch, np, prob, peak_bw, peak_flops):
    """Kernel vs plain at the main path's shapes; returns the JSON records."""
    from repro_torch.core import hpcg
    from repro_torch.core.dynamic import DynamicMatrix
    from repro_torch.core.formats import Format
    from repro_torch.kernels import csr_spmv as kc, dia_spmv as kd
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.ref import csr_spmv_ref, dia_spmv_ref

    print(f"== kernels at {'x'.join(map(str, GRID))} and ragged shapes", flush=True)
    rng = np.random.default_rng(SEED)
    A = hpcg.to_coo(prob, device="cuda")
    dia = DynamicMatrix(A).activate(Format.DIA).concrete
    csr = DynamicMatrix(A).activate(Format.CSR).concrete
    m, n = dia.shape
    x32 = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()
    cfg_csr = kops.default_config(csr)
    lib = torch.sparse_csr_tensor(csr.indptr, csr.indices, csr.data, size=csr.shape)
    records = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = "float32" if dtype == torch.float32 else "bfloat16"
        x = x32.to(dtype)
        d_data, c_data = dia.data.to(dtype), csr.data.to(dtype)
        es = x.element_size()

        def run_dia():
            return kd.dia_spmv(dia.offsets, d_data, x, n)

        def plain_dia():
            return dia_spmv_ref(dia.offsets, d_data, x, n)

        def run_csr():
            return kc.csr_spmv(csr.indptr, csr.indices, c_data, x, m, vec=cfg_csr["vec"])

        def plain_csr():
            return csr_spmv_ref(csr.indptr, csr.indices, c_data, x, m)

        err_d = compare("dia_spmv 104^3", run_dia(), run_dia(), plain_dia(), name)
        err_c = compare(f"csr_spmv 104^3 vec={cfg_csr['vec']}", run_csr(), run_csr(),
                        plain_csr(), name)
        ragged_cases(rng, torch, dtype)

        # the least time: bytes each input read once and y written once, or
        # the multiply-adds these inputs need at the float32 peak. DIA reads
        # only the table entries whose column lies inside the matrix.
        cols = torch.arange(m, device="cuda")[None, :] + dia.offsets.long()[:, None]
        dia_pairs = int(((cols >= 0) & (cols < n)).sum())
        dia_bytes = dia.ndiag * 4 + dia_pairs * es + n * es + m * es
        csr_bytes = (m + 1) * 4 + csr.nnz * (4 + es) + n * es + m * es
        rows = [("dia_spmv", run_dia, plain_dia, dia_bytes, 2 * dia_pairs, err_d,
                 "src/repro_torch/csrc/dia_spmv.cu", "src/repro/kernels/dia_spmv.py:50"),
                ("csr_spmv", run_csr, plain_csr, csr_bytes, 2 * csr.nnz, err_c,
                 "src/repro_torch/csrc/csr_spmv.cu", "src/repro/kernels/csr_spmv.py:103")]
        for kname, run, plain, nbytes, nops, err, src, repl in rows:
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
                sweep_launch_geometry(kname, dia, csr, x, m, n)
                records[kname] = {
                    "name": kname, "route": "cuda", "source": src, "replaces": repl,
                    "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "library_ms": lib_ms}
    return records


def phase_reference(torch):
    """The card's solve at 16^3 against the same solve on the CPU."""
    from repro_torch.hpcg_solve import run
    print(f"== reference check at {'x'.join(map(str, SMALL_GRID))}", flush=True)
    for fmt in ("auto", "CSR"):
        g = run(SMALL_GRID, fmt, device="cuda", tol=CG_TOL, maxiter=CG_MAXITER)
        c = run(SMALL_GRID, fmt, device="cpu", tol=CG_TOL, maxiter=CG_MAXITER)
        print(f"  {fmt}: card {g['format']} {g['iters']} iters err {g['err']:.2e}; "
              f"cpu {c['format']} {c['iters']} iters err {c['err']:.2e}")
        check(g["format"] == c["format"], f"{fmt}: same format on card and cpu")
        # f32 reductions in another order can move the stopping test by one step
        check(abs(g["iters"] - c["iters"]) <= 1, f"{fmt}: iterations within 1")
        check(g["passed"] and c["passed"], f"{fmt}: max|x-1| < {X_TOL} on both")


def solve_counted(torch, M, b, label, kernel):
    """cg(operator(M)) with every SpMV counted; the kernel's launches over
    the solve must equal the SpMVs it issued."""
    from repro_torch.core.ops import spmv
    from repro_torch.core.solvers import cg, operator
    from repro_torch.kernels import ops as kops

    apply_A = operator(M)
    nspmv = 0

    def counted(v):
        nonlocal nspmv
        nspmv += 1
        return apply_A(v)

    before = kops.launch_counts()[kernel]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = cg(counted, b, tol=CG_TOL, maxiter=CG_MAXITER)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launched = kops.launch_counts()[kernel] - before
    err = float((res.x - 1.0).abs().max())
    r_true = b.double() - spmv(M, res.x, backend="ref").double()
    rel = float(r_true.norm() / b.double().norm())
    print(f"  {label}: {res.iters} iters, {dt * 1e3:.2f} ms "
          f"({dt * 1e3 / max(res.iters, 1):.4f} ms/iter), max|x-1|={err:.3e}, "
          f"true rel residual={rel:.3e}, {kernel} launches={launched}, SpMVs={nspmv}",
          flush=True)
    check(res.x.shape == b.shape and bool(torch.isfinite(res.x).all()),
          f"{label}: finite x of shape {tuple(b.shape)}")
    check(res.iters < CG_MAXITER, f"{label}: converged to tol={CG_TOL}")
    check(err < X_TOL, f"{label}: max|x-1| < {X_TOL}")
    check(launched == nspmv and nspmv > 0, f"{label}: {kernel} launches == SpMVs issued")
    return res, dt


def phase_main(torch, prob, t_gen):
    from repro_torch.core import hpcg
    from repro_torch.core.dynamic import DynamicMatrix
    from repro_torch.core.formats import Format
    from repro_torch.core.solvers import cg, cg_fixed_iters, operator
    from repro_torch.kernels import ops as kops

    print(f"== main path at {'x'.join(map(str, GRID))}", flush=True)
    kops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
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
    res, dt = solve_counted(torch, M, b, "cg DIA", "dia_spmv")
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
    t0 = time.perf_counter()
    C = DynamicMatrix(A).activate(Format.CSR)
    torch.cuda.synchronize()
    print(f"  activate(CSR) {time.perf_counter() - t0:.2f} s")
    solve_counted(torch, C, b, "cg CSR", "csr_spmv")
    counts = kops.launch_counts()
    print(f"  launches over the main path: {counts}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for name, n in counts.items():
        check(n > 0, f"{name} launched on the main path ({n})")
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
    phase_reference(torch)
    counts = phase_main(torch, prob, t_gen)
    for name, rec in records.items():
        rec["launches"] = counts[name]
    print(f"== total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(records.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
