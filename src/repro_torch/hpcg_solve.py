"""Single-device HPCG solve on the port: the paper's workflow end to end.

  1. problem setup    — 27-point-stencil Poisson system on a 3D grid
  2. optimization     — COO container, format picked by a FormatPolicy
                        (``--tune ml|analytic|profile|cached``) or named,
                        plan + conversion on the device
  3. timed solve      — CG, one SpMV per iteration through DynamicMatrix;
                        with ``--precond mg`` PCG preconditioned by a
                        multigrid V-cycle (``repro_torch.mg``: colored
                        SymGS, every level and color block in the picked
                        format or picked by the policy), with ``--precond``
                        alone PCG with the Jacobi preconditioner diag(A)
  4. validation       — the solution must be the all-ones vector

With ``--shards P`` (P > 1) step 2 partitions the rows into P z-slabs
(``core.distributed``, all on one device): each shard's interior, boundary
and remote parts in ``--local``/``--remote`` formats (``--mode uniform``)
or picked per shard by the ``--tune`` policy (``--mode multiformat``), as
``examples/hpcg_solve.py`` does on a mesh; ``--precond mg`` then builds the
distributed hierarchy (``repro_torch.mg.build_dist_hierarchy``). Run:

  python -m repro_torch.hpcg_solve --grid 104 104 104
  python -m repro_torch.hpcg_solve --grid 104 104 104 --tune profile
  python -m repro_torch.hpcg_solve --grid 104 104 104 --tune cached --cache /tmp/sel.json
  python -m repro_torch.hpcg_solve --grid 16 16 16 --format HYB --ell-k 18 --device cpu
  python -m repro_torch.hpcg_solve --grid 16 16 16 --format BSR --block-size 8 --device cpu
  python -m repro_torch.hpcg_solve --grid 104 104 104 --format CSR --precond mg
  python -m repro_torch.hpcg_solve --grid 16 16 16 --precond mg --mg-levels 2 --device cpu --verbose
  python -m repro_torch.hpcg_solve --grid 104 104 104 --shards 8
  python -m repro_torch.hpcg_solve --grid 8 8 16 --shards 4 --mode multiformat --device cpu
  python -m repro_torch.hpcg_solve --grid 104 104 104 --shards 4 --mode multiformat --precond mg
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.core import hpcg
from repro_torch.core.distributed import build_dist_matrix
from repro_torch.core.dynamic import DynamicMatrix
from repro_torch.core.formats import Format
from repro_torch.core.ops import extract_diagonal
from repro_torch.core.solvers import cg, operator, pcg
from repro_torch.device import resolve_device
from repro_torch.mg import build_dist_hierarchy, build_hierarchy
from repro_torch.tuning.policy import FormatPolicy

TOL_X = 1e-3  # validation: max |x - 1|, as examples/hpcg_solve.py
FORMATS = ("auto", "DIA", "CSR", "ELL", "SELL", "HYB", "BSR")
TUNE_MODES = ("ml", "analytic", "profile", "cached")
PRECONDS = ("none", "jacobi", "mg")
MODES = ("uniform", "multiformat")
PART_FORMATS = tuple(f.name for f in Format)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def plan_hints(fmt: Format, ell_k=None, block_size=None) -> dict:
    """The ``plan_switch`` hints that apply to ``fmt``: ``k`` for ELL and
    HYB (HYB's split), ``block_size`` for BSR."""
    if fmt in (Format.ELL, Format.HYB) and ell_k is not None:
        return {"k": int(ell_k)}
    if fmt == Format.BSR and block_size is not None:
        return {"block_size": int(block_size)}
    return {}


def _solve(apply_A, b, precond: str, tol: float, maxiter: int, diag=None, apply_M=None):
    if precond == "mg":
        return pcg(apply_A, b, tol=tol, maxiter=maxiter, apply_M=apply_M)
    if precond == "jacobi":
        return pcg(apply_A, b, diag, tol=tol, maxiter=maxiter)
    return cg(apply_A, b, tol=tol, maxiter=maxiter)


def _build_single(prob, A, dev, fmt, tune, cache, ell_k, block_size, precond, mg_levels):
    """The single-device operator: the policy's pick (or ``fmt``) and, with
    ``mg``, the hierarchy in that format (or picked by the same policy)."""
    D = DynamicMatrix(A)
    rep = FormatPolicy(tune, cache=cache).select(A) if fmt == "auto" else None
    target = rep.best if rep is not None else Format[fmt]
    M = D.activate(target, plan=D.plan(target, **plan_hints(target, ell_k, block_size)))
    _sync(dev)
    out = {"format": M.active.name, "pick_mode": rep.mode if rep is not None else "named",
           "cfg": rep.cfg if rep is not None else None}
    apply_M = None
    if precond == "mg":
        t0 = time.perf_counter()
        policy = FormatPolicy(tune, cache=cache) if fmt == "auto" else None
        hier = build_hierarchy(prob, nlevels=mg_levels, fmt=target, policy=policy, A=A)
        _sync(dev)
        apply_M = hier.apply_M()
        out.update(hier_s=time.perf_counter() - t0, levels=hier.formats(),
                   hierarchy=repr(hier))
    return operator(M, cfg=out["cfg"]), apply_M, out


def _build_dist(prob, dev, shards, mode, local, remote, tune, precond, mg_levels):
    """The distributed operator over ``shards`` z-slabs on one device:
    ``hpcg.slab_plan``'s partition, unchecked, when ``nz`` divides into the
    shards, else planned from the triplets; with ``mg`` the distributed
    hierarchy, whose level 0 is the operator."""
    kw = dict(mode=mode, tune=tune, local_format=Format[local], remote_format=Format[remote])
    apply_M, out = None, {}
    if precond == "mg":
        hier = build_dist_hierarchy(prob, shards, device=dev, nlevels=mg_levels, **kw)
        A = hier.levels[0].A
        apply_M = hier.apply_M()
        out.update(levels=hier.formats(), hierarchy=repr(hier))
    else:
        plan = hpcg.slab_plan(prob, shards) if prob.nz % shards == 0 else None
        A = build_dist_matrix(prob.row, prob.col, prob.val, prob.shape, shards, device=dev,
                              plan=plan, check_plan=plan is None, **kw)
    out.update(shards=shards, mode=mode,
               format="multiformat" if mode == "multiformat" else f"{local}/{remote}",
               pick_mode=tune if mode == "multiformat" else "named", cfg=None,
               matrix=repr(A), formats={part: list(A.formats(part)) for part in A.shard_parts},
               plan=A.plan, split=A.split)
    return operator(A), apply_M, out


def run(grid, fmt: str = "auto", device=None, tol: float = 1e-7,
        maxiter: int = 500, tune: str = "ml", ell_k=None, block_size=None,
        cache=None, precond: str = "none", mg_levels=None, shards: int = 1,
        mode: str = "uniform", local: str = "DIA", remote: str = "COO") -> dict:
    """Build, select/convert and solve; returns the numbers ``main`` prints.

    ``fmt="auto"`` takes the pick of ``FormatPolicy(tune, cache=cache)``
    (``cache``: the selection cache's path, default ``$REPRO_TUNING_CACHE``),
    and the solve runs with the launch knobs the pick pins (``cached``
    mode, where a tuned record beat the reference); the hints ``ell_k``
    and ``block_size`` reach the plan of the format that uses them.

    ``precond="mg"`` builds the multigrid hierarchy on the same device
    (at most ``mg_levels`` levels) with every level operator and color
    block in the picked format, or, under ``fmt="auto"``, picked by the
    same policy, and solves with ``pcg(..., apply_M=V-cycle)``;
    ``"jacobi"`` solves with ``pcg`` over diag(A); ``"none"`` with ``cg``.
    The result then also holds ``hier_s`` (hierarchy build seconds) and
    ``levels`` (``MGHierarchy.formats()``).

    ``shards > 1`` partitions the rows into that many z-slabs
    (``fmt`` must stay ``"auto"``): ``mode="uniform"`` puts every shard's
    interior and boundary parts in ``local`` and its remote part in
    ``remote``, ``"multiformat"`` lets ``FormatPolicy(tune)`` pick each
    shard's, and ``mg`` builds the distributed hierarchy (its build is
    part of ``optimize_s``). The result also holds each part's per-shard
    formats (``formats``), the ``DistPlan`` (``plan``) and, with ``mg``,
    ``levels`` (``DistMGHierarchy.formats()``)."""
    if precond not in PRECONDS:
        raise ValueError(f"precond {precond!r} not in {PRECONDS}")
    if shards > 1 and fmt != "auto":
        raise ValueError("fmt picks the single-device format; with shards > 1 "
                         "use mode/local/remote")
    if shards > 1 and mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    if precond == "mg" and fmt == "BSR":
        raise ValueError("--precond mg needs a format for the color blocks, whose "
                         "(rows of one color x n) shape no BSR block divides: "
                         "pick another --format")
    dev = resolve_device(device)
    t0 = time.perf_counter()
    prob = hpcg.generate_problem(*grid)
    A = hpcg.to_coo(prob, device=dev)
    b = torch.from_numpy(hpcg.rhs_for_ones(prob)).to(dev)
    _sync(dev)
    t_setup = time.perf_counter() - t0

    t0 = time.perf_counter()
    if shards > 1:
        apply_A, apply_M, out = _build_dist(prob, dev, shards, mode, local, remote, tune,
                                            precond, mg_levels)
    else:
        apply_A, apply_M, out = _build_single(prob, A, dev, fmt, tune, cache, ell_k,
                                              block_size, precond, mg_levels)
    _sync(dev)
    t_opt = time.perf_counter() - t0 - out.get("hier_s", 0.0)

    t0 = time.perf_counter()
    res = _solve(apply_A, b, precond, tol, maxiter,
                 diag=extract_diagonal(A) if precond == "jacobi" else None, apply_M=apply_M)
    _sync(dev)
    t_solve = time.perf_counter() - t0

    x_exact = torch.from_numpy(hpcg.exact_solution(prob)).to(dev)
    err = float((res.x - x_exact).abs().max())
    return {"n": prob.shape[0], "nnz": int(len(prob.val)), **out,
            "iters": res.iters, "resnorm": float(res.resnorm), "err": err,
            "setup_s": t_setup, "optimize_s": t_opt, "solve_s": t_solve,
            "device": str(dev), "passed": err < TOL_X, "precond": precond,
            "history": res.history}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--grid", type=int, nargs=3, default=[104, 104, 104])
    p.add_argument("--format", default="auto", choices=FORMATS,
                   help="auto = the pick of the --tune FormatPolicy")
    p.add_argument("--tune", default="ml", choices=TUNE_MODES,
                   help="selection policy behind --format auto")
    p.add_argument("--cache", default=None,
                   help="selection cache path for --tune cached (default: $REPRO_TUNING_CACHE "
                        "or ~/.cache/repro-tuning/selections.json)")
    p.add_argument("--ell-k", type=int, default=None,
                   help="ELL width / HYB split (default: max / median row length)")
    p.add_argument("--block-size", type=int, default=None,
                   help="BSR block edge (default: plan_switch's 128)")
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="default: cuda (raises without a card)")
    p.add_argument("--tol", type=float, default=1e-7)
    p.add_argument("--maxiter", type=int, default=500)
    p.add_argument("--precond", nargs="?", const="jacobi", default="none", choices=PRECONDS,
                   help="preconditioner: 'mg' = geometric multigrid V-cycle with the "
                        "multicolored SymGS smoother (repro_torch.mg), 'jacobi' = diag(A); "
                        "bare --precond means jacobi")
    p.add_argument("--mg-levels", type=int, default=None,
                   help="cap the MG hierarchy depth (default: coarsen while dims stay even)")
    p.add_argument("--verbose", action="store_true",
                   help="print the per-iteration convergence curve (||r_k|| from the "
                        "solver's residual history)")
    p.add_argument("--shards", type=int, default=1,
                   help="row slabs of the distributed matrix, all on one device (default 1: "
                        "the single-device path; --mode/--local/--remote need P > 1)")
    p.add_argument("--mode", default="uniform", choices=MODES,
                   help="with --shards > 1: fixed --local/--remote formats, or each "
                        "shard's formats picked by the --tune policy")
    p.add_argument("--local", default="DIA", choices=PART_FORMATS,
                   help="interior/boundary format of --mode uniform")
    p.add_argument("--remote", default="COO", choices=PART_FORMATS,
                   help="remote-part format of --mode uniform")
    args = p.parse_args(argv)

    if args.shards > 1 and args.format != "auto":
        p.error("--format picks the single-device format; with --shards use "
                "--mode/--local/--remote")
    r = run(args.grid, args.format, args.device, args.tol, args.maxiter, tune=args.tune,
            ell_k=args.ell_k, block_size=args.block_size, cache=args.cache,
            precond=args.precond, mg_levels=args.mg_levels, shards=args.shards,
            mode=args.mode, local=args.local, remote=args.remote)
    shards = f"shards: {args.shards}, " if args.shards > 1 else ""
    print(f"device: {r['device']}, {shards}grid: {args.grid}, n={r['n']} nnz={r['nnz']} "
          f"(setup {r['setup_s']:.2f}s)")
    if args.shards > 1:
        _print_dist(r)
    else:
        how = f"{args.tune} pick" if args.format == "auto" else "named"
        pin = f", {r['pick_mode']}, kernel cfg {r['cfg']}" if args.tune == "cached" else ""
        print(f"format: {r['format']} ({how}{pin}, {r['optimize_s']:.3f}s)")
        if args.precond == "mg":
            print(f"preconditioner: {r['hierarchy']} ({r['hier_s']:.3f}s)")
            for lev in r["levels"]:
                print(f"  level {lev['level']} {'x'.join(map(str, lev['dims']))}: n={lev['n']} "
                      f"A={lev['A']} colors={lev['colors']}")
    if args.precond == "jacobi":
        print("preconditioner: Jacobi, diag(A)")
    _report(r, args.verbose)
    return 0 if r["passed"] else 1


def _print_dist(r: dict) -> None:
    if r["precond"] == "mg":
        print(f"optimization: {r['hierarchy']}, operator {r['matrix']} "
              f"({r['optimize_s']:.3f}s)")
        for lev in r["levels"]:
            bnd = f" boundary={lev['boundary']}" if "boundary" in lev else ""
            print(f"  level {lev['level']} {'x'.join(map(str, lev['dims']))}: "
                  f"local={lev['local']}{bnd} remote={lev['remote']} colors={lev['colors']}")
    else:
        print(f"optimization: {r['matrix']} ({r['optimize_s']:.3f}s)")
    label = "interior" if r["split"] else "local"
    for part, names in r["formats"].items():
        print(f"  per-shard {label if part == 'local' else part} formats: {names}")


def _report(r: dict, verbose: bool) -> None:
    gflops = 2 * r["nnz"] * r["iters"] / max(r["solve_s"], 1e-12) / 1e9
    print(f"solve: {r['iters']} iters, {r['solve_s'] * 1e3:.1f} ms, "
          f"||r||={r['resnorm']:.2e}, SpMV-rate ~{gflops:.2f} GFLOP/s")
    if verbose:
        hist = r["history"].cpu().double().numpy()
        hist = hist[~np.isnan(hist)]
        r0 = hist[0] if hist.size and hist[0] > 0 else 1.0
        print("convergence (||r_k||, relative to ||r_0||):")
        for k, rn in enumerate(hist):
            print(f"  iter {k:4d}: {rn:.3e}  rel={rn / r0:.3e}")
    print(f"validation: max|x - 1| = {r['err']:.2e} -> "
          f"{'PASS' if r['passed'] else 'FAIL'}")


if __name__ == "__main__":
    sys.exit(main())
