"""The port's CG, fixed-iteration CG and PCG against the JAX package at 16^3.

The HPCG problem at 16^3 is converted to DIA and to CSR in both packages;
JAX solves through its jnp reference SpMV (``backend="ref"``), the port
through its CPU path. Iteration counts may differ by one: both stop on an
f32 residual test whose reductions run in a different order (XLA vs
torch), which can move the crossing by a step. The stopping tolerance is
1e-6, above the f32 floor: at 1e-7 the JAX residual stalls near 4e-7 of
its start at 16^3 while the port's keeps falling, and the counts part by
three. ``x`` must be within 1e-3 of the exact all-ones solution, the
reference's own validation threshold.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core.hpcg as jhpcg
import repro.core.ops as jops
import repro.core.solvers as jsol
import repro_torch.core.hpcg as thpcg
import repro_torch.core.ops as tops
import repro_torch.core.solvers as tsol
from repro.core import Format as JFormat
from repro_torch.core.dynamic import DynamicMatrix
from repro_torch.core.formats import Format
from torch_parity import DEV, jconv, tconv

GRID = (16, 16, 16)
TOL, MAXITER = 1e-6, 300


def _systems(fmt):
    pj, pt = jhpcg.generate_problem(*GRID), thpcg.generate_problem(*GRID)
    Aj = jconv.convert(jhpcg.to_coo(pj), JFormat[fmt])
    At = tconv.convert(thpcg.to_coo(pt, device=DEV), Format[fmt])
    return (Aj, jnp.asarray(jhpcg.rhs_for_ones(pj)),
            At, torch.from_numpy(thpcg.rhs_for_ones(pt)))


def _jax_apply(Aj):
    return lambda v: jops.spmv(Aj, v, backend="ref")


def _check_history(res, maxiter):
    h = res.history.numpy()
    assert h.shape == (maxiter + 1,)
    assert np.isfinite(h[: res.iters + 1]).all()
    assert np.isnan(h[res.iters + 1:]).all()
    np.testing.assert_allclose(h[res.iters], float(res.resnorm), rtol=1e-6)


@pytest.mark.parametrize("fmt", ["DIA", "CSR"])
def test_cg_matches_jax(fmt):
    Aj, bj, At, bt = _systems(fmt)
    rj = jsol.cg(_jax_apply(Aj), bj, tol=TOL, maxiter=MAXITER)
    rt = tsol.cg(tsol.operator(DynamicMatrix(At)), bt, tol=TOL, maxiter=MAXITER)
    assert abs(rt.iters - int(rj.iters)) <= 1, (rt.iters, int(rj.iters))
    assert rt.iters < MAXITER
    np.testing.assert_allclose(rt.x.numpy(), 1.0, atol=1e-3)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-5)
    _check_history(rt, MAXITER)
    n = min(rt.iters, int(rj.iters)) + 1
    h0 = float(rt.history[0])  # late entries sit near the f32 floor: absolute slack
    np.testing.assert_allclose(rt.history.numpy()[:n], np.asarray(rj.history)[:n],
                               rtol=1e-3, atol=1e-6 * h0)


@pytest.mark.parametrize("fmt", ["DIA", "CSR"])
def test_cg_fixed_iters_matches_jax(fmt):
    Aj, bj, At, bt = _systems(fmt)
    rj = jsol.cg_fixed_iters(_jax_apply(Aj), bj, iters=12)
    rt = tsol.cg_fixed_iters(tsol.operator(At), bt, iters=12)
    assert rt.iters == 12 == int(rj.iters)
    assert np.isfinite(rt.history.numpy()).all() and rt.history.shape == (13,)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(rt.history.numpy(), np.asarray(rj.history), rtol=1e-3)


@pytest.mark.parametrize("precond", ["jacobi", "apply_m"])
@pytest.mark.parametrize("fmt", ["DIA", "CSR"])
def test_pcg_matches_jax(fmt, precond):
    Aj, bj, At, bt = _systems(fmt)
    dj, dt = jops.extract_diagonal(Aj), tops.extract_diagonal(At)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    if precond == "jacobi":
        rj = jsol.pcg(_jax_apply(Aj), bj, dj, tol=TOL, maxiter=MAXITER)
        rt = tsol.pcg(tsol.operator(At), bt, dt, tol=TOL, maxiter=MAXITER)
    else:  # any SPD map: a scaled identity
        rj = jsol.pcg(_jax_apply(Aj), bj, tol=TOL, maxiter=MAXITER,
                      apply_M=lambda r: r * 0.25)
        rt = tsol.pcg(tsol.operator(At), bt, tol=TOL, maxiter=MAXITER,
                      apply_M=lambda r: r * 0.25)
    assert abs(rt.iters - int(rj.iters)) <= 1, (rt.iters, int(rj.iters))
    np.testing.assert_allclose(rt.x.numpy(), 1.0, atol=1e-3)
    _check_history(rt, MAXITER)


def test_solver_edges():
    _, _, At, bt = _systems("DIA")
    res = tsol.cg(tsol.operator(At), bt, tol=1e-30, maxiter=5)
    assert res.iters == 5 and not math.isnan(float(res.history[5]))
    x0 = torch.ones_like(bt)
    assert tsol.cg(tsol.operator(At), bt, x0=x0, tol=TOL, maxiter=5).iters == 0
    with pytest.raises(ValueError, match="apply_M"):
        tsol.pcg(tsol.operator(At), bt)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tsol.operator(At, backend="cuda")(bt)
