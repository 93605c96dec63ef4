"""The plain reference: its CG, its colour-order Gauss-Seidel and its
V-cycle, and that it imports nothing of either package or of JAX."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import BENCH
from harness import guard, problem
from reference import solvers, stencil


def dense(grid):
    r, c, v = problem.stencil_triplets(grid, torch.float64, "cpu")
    n = grid[0] * grid[1] * grid[2]
    A = np.zeros((n, n))
    A[r.numpy(), c.numpy()] = v.numpy()
    return A


def test_reference_cg_at_16():
    grid = (16, 16, 16)
    A = dense(grid)
    xs = 1.0 + 0.1 * np.random.default_rng(1).uniform(-1, 1, A.shape[0])
    b = torch.from_numpy(A @ xs)
    sol = solvers.cg(grid, b, 1e-10, 1000)
    assert 0 < sol.iters < 1000 and len(sol.history) == sol.iters + 1
    assert float(sol.history[-1]) <= 1e-10 * float(sol.history[0])
    np.testing.assert_allclose(sol.x.numpy(), np.linalg.solve(A, b.numpy()), atol=1e-8)
    assert solvers.residual_norm(grid, b, sol.x) < 1e-9


def test_symgs_is_gauss_seidel_over_colour_ordered_rows():
    grid = (6, 4, 8)
    nx, ny, nz = grid
    A = dense(grid)
    n = A.shape[0]
    rng = np.random.default_rng(2)
    b, x0 = rng.standard_normal(n), rng.standard_normal(n)
    idx = np.arange(n)
    colour = (idx % nx) % 2 + 2 * (((idx // nx) % ny) % 2) + 4 * ((idx // (nx * ny)) % 2)
    order = np.lexsort((idx, colour))
    x = x0.copy()
    for rows in (order, order[::-1]):  # one symmetric sweep, row by row
        for i in rows:
            x[i] += (b[i] - A[i] @ x) / A[i, i]
    got = solvers.symgs(stencil.grid_view(torch.from_numpy(x0.copy()), grid),
                        stencil.grid_view(torch.from_numpy(b), grid), 1)
    np.testing.assert_allclose(got.reshape(-1).numpy(), x, rtol=0, atol=1e-12)


def test_vcycle_is_a_symmetric_preconditioner():
    grid = (8, 8, 8)
    n = 512
    M = lambda r: solvers.vcycle(stencil.grid_view(r, grid), 3).reshape(-1)  # noqa: E731
    rng = np.random.default_rng(3)
    u, v = (torch.from_numpy(rng.standard_normal(n)) for _ in range(2))
    assert abs(float(u @ M(v) - v @ M(u))) < 1e-10 * float(u.norm() * v.norm())
    assert float(u @ M(u)) > 0


def test_mg_pcg_beats_cg():
    grid = (16, 16, 16)
    b = torch.ones(4096, dtype=torch.float64)
    mg = solvers.mg_pcg(grid, b, 1e-7, 200, 3)
    cg = solvers.cg(grid, b, 1e-7, 200)
    assert mg.iters <= cg.iters // 2


def test_grids_halve_or_raise():
    assert solvers.grids((192, 192, 192), 4)[-1] == (24, 24, 24)
    with pytest.raises(ValueError):
        solvers.grids((6, 6, 6), 3)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_neither_package_nor_jax(path):
    names = list(_imports(path))
    assert not guard.forbidden_loaded(names, guard.REFERENCE_FORBIDDEN), names
