"""MG-PCG's float32 tail, the port against the JAX package at 40^3.

Both solve HPCG 40^3 with the uniform-CSR V-cycle preconditioner to tol
1e-7 on the CPU (JAX through its jnp reference). Above the float32 floor
of the true residual the two residual curves are one curve; below it the
updated residual wanders with the rounding of the dots and SpMVs, so the
iteration count at 1e-7 may differ by a few. Run alone, this prints both
counts with ``-s``.
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


def test_mg_pcg_residual_curve_matches_jax_above_the_f32_floor():
    """At 40^3 the port's MG-PCG residual curve is JAX's (rtol 1e-2) down to
    1e-5 relative and crosses 1e-3 ... 1e-6 at the same iterations. Below
    the float32 floor of the true residual (~3e-6) the updated residual
    wanders with the rounding, so the count at tol 1e-7 may differ by a
    few: the port's solver and V-cycle are held above that floor."""
    g = 40
    prob = hpcg.generate_problem(g, g, g)
    A = convert(hpcg.to_coo(prob, device=DEV), Format.CSR)
    b = torch.from_numpy(hpcg.rhs_for_ones(prob))
    res = pcg(operator(A), b, tol=1e-7, maxiter=200,
              apply_M=mg.build_hierarchy(prob, device=DEV).apply_M())
    jprob = jhpcg.generate_problem(g, g, g)
    Aj = jconv.convert(jhpcg.to_coo(jprob), Format.CSR)
    hj = jmg.build_hierarchy(jprob, backend="ref")
    rj = jax.jit(lambda bb: jsol.pcg(lambda v: jops.spmv(Aj, v, backend="ref"), bb,
                                     tol=1e-7, maxiter=200, apply_M=hj.apply_M()))(
        jnp.asarray(jhpcg.rhs_for_ones(jprob)))
    ht = res.history.numpy()[:res.iters + 1]
    hjx = np.asarray(rj.history)[:int(rj.iters) + 1]
    ht, hjx = ht / ht[0], hjx / hjx[0]
    cross = [(int(np.argmax(ht < t)), int(np.argmax(hjx < t))) for t in (1e-3, 1e-4, 1e-5, 1e-6)]
    assert all(a == b_ > 0 for a, b_ in cross), cross
    k = cross[2][1]
    np.testing.assert_allclose(ht[:k + 1], hjx[:k + 1], rtol=1e-2)
    print(f"40^3 MG-PCG iterations at tol 1e-7: port {res.iters}, JAX {int(rj.iters)}; "
          f"crossings of 1e-3..1e-6 (port, JAX): {cross}")
    assert abs(res.iters - int(rj.iters)) <= 3 and float((res.x - 1).abs().max()) < 1e-3
