"""The port's first slice end to end: ``python -m repro_torch.hpcg_solve``.

generate_problem -> COO -> ``ml`` pick -> DIA/CSR -> CG, on the CPU at
16^3, held against the same workflow in the JAX package. Also: the entry
point refuses to run without a card unless asked for the CPU, and
``chip_smoke.py`` fails (and prints no result line) where there is no card.
"""
import os
import shutil
import subprocess
import sys

import pytest
import torch

import jax.numpy as jnp

import repro.core.hpcg as jhpcg
import repro.core.ops as jops
import repro.core.solvers as jsol
from repro.tuning import FormatPolicy as JPolicy
from repro_torch import hpcg_solve
from torch_parity import jconv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = ["16", "16", "16"]


@pytest.fixture(autouse=True)
def _private_selection_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "selections.json"))


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def test_slice_matches_jax_workflow(capsys):
    """Same pick and (within one) the same CG iterations as JAX's ml policy
    and jnp-reference CG on the same problem, at a tolerance above the f32
    floor (see tests/test_torch_solvers.py)."""
    assert hpcg_solve.main(["--grid", *GRID, "--device", "cpu", "--tol", "1e-6"]) == 0
    out = capsys.readouterr().out
    assert "format: DIA (ml pick" in out and "-> PASS" in out
    r = hpcg_solve.run(tuple(map(int, GRID)), "auto", device="cpu", tol=1e-6)
    prob = jhpcg.generate_problem(*map(int, GRID))
    A = jhpcg.to_coo(prob)
    pick = JPolicy("ml").select(A).best
    assert r["format"] == pick.name == "DIA"
    Aj = jconv.convert(A, pick)
    res = jsol.cg(lambda v: jops.spmv(Aj, v, backend="ref"),
                  jnp.asarray(jhpcg.rhs_for_ones(prob)), tol=1e-6, maxiter=500)
    assert abs(r["iters"] - int(res.iters)) <= 1
    assert r["passed"] and r["err"] < 1e-3 and r["nnz"] == len(prob.val)


def test_slice_in_csr_and_from_the_command_line():
    r = hpcg_solve.run((8, 8, 8), "CSR", device="cpu")
    assert r["format"] == "CSR" and r["passed"] and r["device"] == "cpu"
    p = subprocess.run([sys.executable, "-m", "repro_torch.hpcg_solve", "--grid", "8", "8", "8",
                        "--device", "cpu"], capture_output=True, text=True, env=_env(),
                       timeout=120)
    assert p.returncode == 0, p.stderr
    assert "validation: max|x - 1|" in p.stdout and "-> PASS" in p.stdout


def test_slice_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hpcg_solve.main(["--grid", "4", "4", "4"])


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_a_card(where, tmp_path):
    """No card (CUDA hidden), or the script without the program beside it:
    a nonzero exit and no result line."""
    script = os.path.join(ROOT, "chip_smoke.py")
    if where == "alone":
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    p = subprocess.run([sys.executable, script], capture_output=True, text=True,
                       cwd=os.path.dirname(script), timeout=120,
                       env=_env(CUDA_VISIBLE_DEVICES="", PYTHONPATH=""))
    assert p.returncode != 0
    assert '"ok"' not in p.stdout and '"kernels"' not in p.stdout
