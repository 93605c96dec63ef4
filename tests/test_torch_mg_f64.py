"""MG-PCG in float64, the port against the JAX package.

In float64 the rounding that sets MG-PCG's float32 tail (see
``test_torch_mg_tail.py``) is gone, so the two packages must give one
solve: the same iteration count at tol 1e-7 and the same residual curve.
26^3 coarsens once, to an odd 13^3 coarsest level, the coarse grid of the
104^3 hierarchy. Run alone, this prints the counts with ``-s``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.core.hpcg as jhpcg
import repro.core.ops as jops
import repro.core.solvers as jsol
import repro.mg as jmg
from repro_torch import mg
from repro_torch.core import hpcg
from repro_torch.core.convert import convert
from repro_torch.core.formats import Format
from repro_torch.core.solvers import operator, pcg
from torch_parity import DEV, jconv
from torch_parity import one_torch_thread  # noqa: F401  (autouse)


def test_mg_pcg_in_float64_is_the_jax_solve():
    """At 26^3 in float64 the port's MG-PCG (uniform CSR, plain SpMVs)
    takes JAX's iteration count, its residual curve is JAX's within 1e-9
    relative and its solution JAX's within 1e-12."""
    g = 26
    prob = hpcg.generate_problem(g, g, g)
    A = hpcg.to_coo(prob, dtype=torch.float64, device=DEV)
    b = torch.from_numpy(hpcg.rhs_for_ones(prob, np.float64))
    hier = mg.build_hierarchy(prob, backend="ref", A=A)
    res = pcg(operator(convert(A, Format.CSR), backend="ref"), b, tol=1e-7, maxiter=200,
              apply_M=hier.apply_M())
    with jax.enable_x64(True):
        jprob = jhpcg.generate_problem(g, g, g)
        Aj = jconv.convert(jhpcg.to_coo(jprob, dtype=jnp.float64), Format.CSR)
        hj = jmg.build_hierarchy(jprob, backend="ref", dtype=jnp.float64)
        rj = jax.jit(lambda bb: jsol.pcg(lambda v: jops.spmv(Aj, v, backend="ref"), bb,
                                         tol=1e-7, maxiter=200, apply_M=hj.apply_M()))(
            jnp.asarray(jhpcg.rhs_for_ones(jprob, np.float64)))
        hjx = np.asarray(rj.history, np.float64)[:int(rj.iters) + 1]
        xj = np.asarray(rj.x, np.float64)
        jiters = int(rj.iters)
    print(f"{g}^3 MG-PCG iterations at tol 1e-7 in float64: port {res.iters}, JAX {jiters}")
    assert res.x.dtype == torch.float64 and res.iters == jiters
    np.testing.assert_allclose(res.history.numpy()[:res.iters + 1], hjx, rtol=1e-9)
    np.testing.assert_allclose(res.x.numpy(), xj, rtol=0, atol=1e-12)
