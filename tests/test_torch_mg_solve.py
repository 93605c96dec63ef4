"""The port's MG-PCG against the JAX package, and the entry points that
drive the multigrid (``hpcg_solve --precond``, ``build_hierarchy`` without
a card, ``python -m repro_torch.quickstart``). The hierarchy and the
V-cycle alone: ``tests/test_torch_mg_hierarchy.py``.

JAX runs on the CPU through its jnp reference (``backend="ref"``); the
port on its CPU path. Inputs are HPCG grids and numpy vectors from fixed
seeds.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core.hpcg as jhpcg
import repro.core.ops as jops
import repro.core.solvers as jsol
import repro.mg as jmg
from repro_torch import hpcg_solve, quickstart
from repro_torch.core import hpcg
from repro_torch.core.convert import convert
from repro_torch.core.formats import Format
from repro_torch.core.solvers import cg, operator, pcg
from repro_torch.mg import build_hierarchy
from torch_parity import DEV, jconv
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _private_selection_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "selections.json"))


def test_mg_pcg_takes_jax_iterations():
    """At 8^3 the port's MG-PCG takes JAX's iteration count, computed here
    (tol 1e-7, jnp reference). At 16^3 JAX's count is 11 against CG's 23
    (measured with the same settings; tests/test_mg.py runs that solve), and
    the port takes the same counts."""
    for g, want_mg, want_cg in ((8, None, None), (16, 11, 23)):
        prob = hpcg.generate_problem(g, g, g)
        A = convert(hpcg.to_coo(prob, device=DEV), Format.CSR)
        b = torch.from_numpy(hpcg.rhs_for_ones(prob))
        hier = build_hierarchy(prob, device=DEV)
        res = pcg(operator(A), b, tol=1e-7, maxiter=500, apply_M=hier.apply_M())
        res_cg = cg(operator(A), b, tol=1e-7, maxiter=500)
        if want_mg is None:
            jprob = jhpcg.generate_problem(g, g, g)
            Aj = jconv.convert(jhpcg.to_coo(jprob), Format.CSR)
            bj = jnp.asarray(jhpcg.rhs_for_ones(jprob))
            hj = jmg.build_hierarchy(jprob, backend="ref")
            rj = jsol.pcg(lambda v: jops.spmv(Aj, v, backend="ref"), bj, tol=1e-7,
                          maxiter=500, apply_M=hj.apply_M())
            want_mg = int(rj.iters)
            # the residual curves agree, relative to ||r_0|| (both reach the
            # 1e-7 test steeply here; on large grids the f32 tail below ~3e-6
            # wanders: chip_smoke.py's MG_CROSS)
            hj_ = np.asarray(rj.history)[:want_mg + 1]
            np.testing.assert_allclose(res.history.numpy()[:want_mg + 1] / hj_[0],
                                       hj_ / hj_[0], rtol=1e-3, atol=1e-7)
            want_cg = int(jsol.cg(lambda v: jops.spmv(Aj, v, backend="ref"), bj, tol=1e-7,
                                  maxiter=500).iters)
        assert (res.iters, res_cg.iters) == (want_mg, want_cg)
        assert res.iters < res_cg.iters and float((res.x - 1).abs().max()) < 1e-3
        hist = res.history.numpy()
        assert np.isnan(hist[res.iters + 1:]).all() and not np.isnan(hist[:res.iters + 1]).any()


def test_build_hierarchy_options_and_errors():
    prob = hpcg.generate_problem(8, 8, 8)
    with pytest.raises(ValueError, match="unknown smoother"):
        build_hierarchy(prob, smoother="chebyshev", device=DEV)
    with pytest.raises(ValueError, match="prolong"):
        build_hierarchy(prob, prolong="cubic", device=DEV)
    two = build_hierarchy(prob, nlevels=2, fmt=Format.ELL, device=DEV)
    assert [lev["dims"] for lev in two.formats()] == [(8, 8, 8), (4, 4, 4)]
    assert {lev["A"] for lev in two.formats()} == {"ELL"}
    assert two.levels[-1].coarsen is None and two.levels[0].coarsen is not None
    odd = build_hierarchy(hpcg.generate_problem(6, 6, 6), device=DEV)
    assert [lev.dims for lev in odd.levels] == [(6, 6, 6), (3, 3, 3)]  # 3 is odd: stop


def test_build_hierarchy_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_hierarchy(hpcg.generate_problem(4, 4, 4))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        hpcg_solve.run((4, 4, 4), precond="mg")


@pytest.mark.parametrize("argv,pre,levels", [
    (["--precond", "mg"], "MGHierarchy(16x16x16 > 8x8x8 > 4x4x4 > 2x2x2", 4),
    (["--precond"], "Jacobi", 0),
    (["--precond", "jacobi", "--format", "CSR"], "Jacobi", 0),
    (["--precond", "mg", "--mg-levels", "2", "--format", "CSR", "--verbose"],
     "MGHierarchy(16x16x16 > 8x8x8;", 2),
])
def test_hpcg_solve_precond_from_the_command_line(capsys, argv, pre, levels):
    assert hpcg_solve.main(["--grid", "16", "16", "16", "--device", "cpu", *argv]) == 0
    out = capsys.readouterr().out
    assert f"preconditioner: {pre}" in out and "-> PASS" in out
    assert out.count("  level ") == levels
    if "--verbose" in argv:
        assert "convergence (||r_k||" in out and "iter   11:" in out


def test_hpcg_solve_run_reports_the_hierarchy():
    r = hpcg_solve.run((16, 16, 16), "CSR", device="cpu", precond="mg")
    assert r["passed"] and r["iters"] == 11 and r["precond"] == "mg"
    assert r["hier_s"] > 0 and [lev["A"] for lev in r["levels"]] == ["CSR"] * 4
    j = hpcg_solve.run((16, 16, 16), "CSR", device="cpu", precond="jacobi")
    assert j["passed"] and j["iters"] == 23 and "levels" not in j  # diag(A) = 26 I
    with pytest.raises(ValueError, match="precond"):
        hpcg_solve.run((16, 16, 16), device="cpu", precond="ilu")
    with pytest.raises(ValueError, match="BSR"):
        hpcg_solve.run((16, 16, 16), "BSR", device="cpu", precond="mg")


def test_quickstart_as_a_module_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    p = subprocess.run([sys.executable, "-m", "repro_torch.quickstart", "--device", "cpu"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    lines = p.stdout.strip().splitlines()
    assert lines[-3:] == ["switch-dispatch spmv matches: True",
                          "plain DIA kernel matches: True", "plain CSR kernel matches: True"]
    assert "planned switch -> DIA (ndiag=5, zero host syncs)" in lines


def test_quickstart_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        quickstart.main([])
    assert "matches" not in capsys.readouterr().out


def test_quickstart_exits_1_on_a_mismatch(monkeypatch, capsys):
    monkeypatch.setattr(quickstart, "spmv", lambda A, x: torch.zeros(A.shape[0]))
    assert quickstart.main(["--device", "cpu"]) == 1
    assert "plain DIA kernel matches: False" in capsys.readouterr().out
