"""The harness's device-built stencil and the reference's grid operator."""
import numpy as np
import pytest
import torch

from harness import problem
from reference import stencil


def brute_force(grid):
    """HPCG's matrix by a loop over every point and its 27 neighbours."""
    nx, ny, nz = grid
    rows, cols, vals = [], [], []
    for z in range(nz):
        for y in range(ny):
            for x in range(nx):
                i = x + nx * (y + ny * z)
                for dz in (-1, 0, 1):
                    for dy in (-1, 0, 1):
                        for dx in (-1, 0, 1):
                            a, b, c = x + dx, y + dy, z + dz
                            if 0 <= a < nx and 0 <= b < ny and 0 <= c < nz:
                                j = a + nx * (b + ny * c)
                                rows.append(i)
                                cols.append(j)
                                vals.append(26.0 if i == j else -1.0)
    order = np.lexsort((cols, rows))
    return np.array(rows)[order], np.array(cols)[order], np.array(vals)[order]


@pytest.mark.parametrize("grid", [(8, 8, 8), (16, 16, 16), (6, 4, 10)])
def test_triplets_match_brute_force(grid):
    r, c, v = problem.stencil_triplets(grid, torch.float32, "cpu")
    br, bc, bv = brute_force(grid)
    assert r.dtype == torch.int32 and c.dtype == torch.int32
    np.testing.assert_array_equal(r.numpy(), br)
    np.testing.assert_array_equal(c.numpy(), bc)
    np.testing.assert_array_equal(v.numpy(), bv.astype(np.float32))
    assert len(v) == stencil.nnz(grid)


@pytest.mark.parametrize("grid", [(8, 8, 8), (5, 7, 6)])
def test_grid_operator_matches_the_matrix(grid):
    r, c, v = problem.stencil_triplets(grid, torch.float64, "cpu")
    n = grid[0] * grid[1] * grid[2]
    A = np.zeros((n, n))
    A[r.numpy(), c.numpy()] = v.numpy()
    x = np.random.default_rng(0).standard_normal(n)
    y = stencil.apply(stencil.grid_view(torch.from_numpy(x), grid)).reshape(-1).numpy()
    np.testing.assert_allclose(y, A @ x, rtol=0, atol=1e-12)


def test_pool_is_the_seeds_and_only_the_seeds():
    grid = (8, 8, 8)
    a = problem.rhs_pool(grid, 3, 1.0, 0.1, 2**31 + 5, torch.float32, "cpu")
    b = problem.rhs_pool(grid, 3, 1.0, 0.1, 2**31 + 5, torch.float32, "cpu")
    c = problem.rhs_pool(grid, 3, 1.0, 0.1, 2**31 + 6, torch.float32, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[0], a[1])
    # b = A x*, x* = 1 + 0.1 u: A 1 vanishes inside the grid, so b is small there
    assert float(a[0].abs().max()) < 26 * 1.1 * 27
