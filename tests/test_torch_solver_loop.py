"""The port's solver loop (blocks of masked iterations, ``repro_torch.core.solvers``)
against the JAX package's ``while_loop`` / ``scan`` solvers, on the CPU.

On the CPU every block runs eagerly through the plain versions of
``repro_torch.kernels.solver_vec`` (the ``ops.dot`` / ``axpy`` / ``waxpby``
sequence under the mask), so these tests hold the masking itself: where in
a block the solve converges, ``maxiter`` inside a block, ``b = 0``, and an
inactive iteration's state. JAX runs its jnp reference (``backend="ref"``)
on the CPU. Inputs are HPCG grids and numpy vectors from fixed seeds.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.core.hpcg as jhpcg
import repro.core.ops as jops
import repro.core.solvers as jsol
import repro.mg as jmg
from repro_torch.core import hpcg
from repro_torch.core import ops
from repro_torch.core import solvers
from repro_torch.core.formats import Format
from repro_torch.kernels import solver_vec as sv
from repro_torch.mg import build_hierarchy
from torch_parity import DEV, jconv, tconv
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

GRID = (16, 16, 16)
K = solvers.BLOCK_ITERS
# f32 history entries: within HIST_RTOL of JAX's, or HIST_FLOOR * ||r_0|| where
# the residual has fallen to f32 rounding (the two packages' updated
# residuals there follow their own sum orders)
HIST_RTOL, HIST_FLOOR = 1e-4, 1e-6
X_TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_kernels.py::_tol, float32


@pytest.fixture(scope="module")
def system():
    """The 16^3 problem in CSR for both packages, its right-hand side, JAX's
    ``cg`` jitted once per ``maxiter`` (b and tol traced) and its CG history
    at a tolerance that runs past 2 blocks."""
    pj, pt = jhpcg.generate_problem(*GRID), hpcg.generate_problem(*GRID)
    Aj = jconv.convert(jhpcg.to_coo(pj), Format.CSR)
    At = tconv.convert(hpcg.to_coo(pt, device=DEV), Format.CSR)
    b = hpcg.rhs_for_ones(pt)
    jax_A = lambda v: jops.spmv(Aj, v, backend="ref")  # noqa: E731

    @functools.lru_cache(maxsize=None)
    def jax_cg(maxiter):
        return jax.jit(lambda bb, tol: jsol.cg(jax_A, bb, tol=tol, maxiter=maxiter))

    hist = np.asarray(jax_cg(3 * K)(jnp.asarray(b), 1e-12).history)
    return {"jax_A": jax_A, "jax_cg": jax_cg, "A": solvers.operator(At), "b": b, "hist": hist,
            "pj": pj, "pt": pt, "At": At, "Aj": Aj}


def _same(rt, rj, maxiter):
    """iters equal, history within HIST_RTOL with NaN in the same places,
    x within the f32 kernel tolerance."""
    assert rt.iters == int(rj.iters)
    ht, hj = rt.history.numpy(), np.asarray(rj.history)
    assert ht.shape == hj.shape == (maxiter + 1,)
    np.testing.assert_array_equal(np.isnan(ht), np.isnan(hj))
    np.testing.assert_allclose(ht[~np.isnan(ht)], hj[~np.isnan(hj)], rtol=HIST_RTOL,
                               atol=HIST_FLOOR * hj[0])
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), **X_TOL)
    np.testing.assert_allclose(float(rt.resnorm), float(rj.resnorm), rtol=HIST_RTOL,
                               atol=HIST_FLOOR * hj[0])


def _tol_for(hist, k):
    """A tolerance whose test first passes at iteration k: the geometric
    mean of the residual ratios at k - 1 and k (far from either)."""
    return float(np.sqrt(hist[k - 1] * hist[k]) / hist[0])


@pytest.mark.parametrize("k_conv", [1, K + 1, K + K // 2, 2 * K],
                         ids=["first-of-block-1", "first-of-block-2", "middle", "last"])
def test_cg_converges_anywhere_in_a_block(system, k_conv):
    tol = _tol_for(system["hist"], k_conv)
    maxiter = 3 * K
    rj = system["jax_cg"](maxiter)(jnp.asarray(system["b"]), tol)
    rt = solvers.cg(system["A"], torch.from_numpy(system["b"]), tol=tol, maxiter=maxiter)
    assert int(rj.iters) == k_conv
    _same(rt, rj, maxiter)
    loop = solvers.last_loop
    assert loop.k_block == K and loop.iters == k_conv
    assert loop.eager == -(-k_conv // K) == loop.syncs  # one flag read a block


@pytest.mark.parametrize("maxiter", [K // 2 + 1, K + 3])
def test_cg_maxiter_inside_a_block(system, maxiter):
    rj = system["jax_cg"](maxiter)(jnp.asarray(system["b"]), 1e-30)
    rt = solvers.cg(system["A"], torch.from_numpy(system["b"]), tol=1e-30, maxiter=maxiter)
    assert rt.iters == maxiter and maxiter % K
    _same(rt, rj, maxiter)


def test_cg_with_b_zero_takes_no_iteration(system):
    b = np.zeros_like(system["b"])
    rj = system["jax_cg"](3 * K)(jnp.asarray(b), 1e-6)
    rt = solvers.cg(system["A"], torch.from_numpy(b), tol=1e-6, maxiter=3 * K)
    assert rt.iters == 0
    _same(rt, rj, 3 * K)
    assert not torch.any(rt.x != 0)


def test_cg_fixed_iters_runs_its_count(system):
    iters = K + 5
    rj = jsol.cg_fixed_iters(system["jax_A"], jnp.asarray(system["b"]), iters=iters)
    rt = solvers.cg_fixed_iters(system["A"], torch.from_numpy(system["b"]), iters=iters)
    _same(rt, rj, iters)
    assert solvers.last_loop.syncs == 0  # no flag read


def test_pcg_jacobi(system):
    dj, dt = jops.extract_diagonal(system["Aj"]), ops.extract_diagonal(system["At"])
    b = system["b"]
    rj = jsol.pcg(system["jax_A"], jnp.asarray(b), dj, tol=1e-6, maxiter=4 * K)
    rt = solvers.pcg(system["A"], torch.from_numpy(b), dt, tol=1e-6, maxiter=4 * K)
    _same(rt, rj, 4 * K)
    assert solvers.last_loop.k_block == K


def test_pcg_two_level_v_cycle(system):
    # a Jacobi-smoothed cycle: JAX compiles its loop in a fraction of the
    # colored SymGS cycle's time, and the loop under test is the same
    kw = dict(nlevels=2, smoother="jacobi", pre=2, post=2)
    hj = jmg.build_hierarchy(system["pj"], backend="ref", **kw)
    ht = build_hierarchy(system["pt"], device=DEV, **kw)
    assert ht.nlevels == hj.nlevels == 2
    b = system["b"]
    rj = jsol.pcg(system["jax_A"], jnp.asarray(b), tol=1e-6, maxiter=30,
                  apply_M=hj.apply_M())
    rt = solvers.pcg(system["A"], torch.from_numpy(b), tol=1e-6, maxiter=30,
                     apply_M=ht.apply_M())
    _same(rt, rj, 30)
    assert solvers.last_loop.k_block == solvers.BLOCK_ITERS_PRECOND


def _vectors(n=1000, seed=0):
    rng = np.random.default_rng(seed)
    x, r, p, noise, z = (torch.from_numpy(rng.standard_normal(n).astype(np.float32))
                         for _ in range(5))
    return x, r, p, 2 * p + 0.5 * noise, z


def _state(r, z, active=1):
    sc = torch.stack([ops.dot(r, r), ops.dot(r, z), torch.tensor(1e-9)])
    return sc, torch.tensor([3, active], dtype=torch.int64)


def test_plain_versions_are_the_ops_sequence_bitwise():
    x, r, p, ap, z = _vectors()
    sc, st = _state(r, z)
    pap = ops.dot(p, ap)
    assert torch.equal(sv.dot(p, ap), pap.reshape(1))  # the CPU wrapper runs the plain dot
    alpha = sc[1] / torch.clamp(pap, min=1e-30)
    want_x, want_r = ops.axpy(alpha, p, x), ops.axpy(-alpha, ap, r)
    xs, rs = x.clone(), r.clone()
    rr = sv.update(xs, rs, p, ap, sv.dot(p, ap), sc, st)
    assert torch.equal(xs, want_x) and torch.equal(rs, want_r)
    assert torch.equal(rr, ops.dot(want_r, want_r).reshape(1))
    rz = sv.dot(rs, z)
    beta = ops.dot(rs, z) / torch.clamp(sc[1], min=1e-30)
    ps = p.clone()
    sv.direction(ps, z, rz, sc, st)
    assert torch.equal(ps, ops.waxpby(1.0, z, beta, p))
    hist = torch.full((11,), float("nan"))
    sv.finish(rr, rz, sc, st, hist, 10)
    assert torch.equal(sc[:2], torch.stack([ops.dot(rs, rs), ops.dot(rs, z)]))
    assert st.tolist() == [4, 1] and torch.equal(hist[4], torch.sqrt(sc[0]))


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def test_an_inactive_iteration_leaves_every_state_bit(system):
    b = torch.from_numpy(system["b"])
    for apply_M in (None, lambda v: 0.25 * v):
        loop = solvers._Loop(system["A"], apply_M, b, None, 1e-6, 20, fixed=False)
        for _ in range(3):
            loop.iteration()
        loop.st[1] = 0
        state = [t.clone() for t in (loop.x, loop.r, loop.p, loop.sc, loop.st, loop.hist)]
        loop.iteration()
        after = (loop.x, loop.r, loop.p, loop.sc, loop.st, loop.hist)
        assert all(torch.equal(_bits(a), _bits(s)) for a, s in zip(after, state))


def test_replay_bookkeeping_adds_and_takes_back_every_kernel_count():
    """``_launch_counts`` reads every wrapper's count and ``_add_launches``
    adds a captured block's launches (at a replay) or takes them back (at
    the capture, which runs nothing)."""
    before = solvers._launch_counts()
    assert {k for m, k in before if m is None} == set(sv.launches)
    delta = dict.fromkeys(before, 3)
    solvers._add_launches(delta)
    assert solvers._launch_counts() == {k: v + 3 for k, v in before.items()}
    solvers._add_launches(delta, -1)
    assert solvers._launch_counts() == before


PHASES = ("preamble_ms", "eager_ms", "capture_ms", "replay_ms", "wait_ms")


def test_loops_hold_one_record_a_solve_in_order(system):
    """``solvers.loops`` gains one record a call of ``cg``, ``pcg`` and
    ``cg_fixed_iters``, oldest first; ``last_loop`` is its newest. On the
    CPU every block is eager: no capture, no replay, no allocator call."""
    A, b = system["A"], torch.from_numpy(system["b"])
    n0 = len(solvers.loops)
    r_cg = solvers.cg(A, b, tol=1e-6, maxiter=4 * K)
    r_pcg = solvers.pcg(A, b, ops.extract_diagonal(system["At"]), tol=1e-6, maxiter=4 * K)
    r_fixed = solvers.cg_fixed_iters(A, b, iters=K + 5)
    recs = list(solvers.loops)[-3:]
    assert len(solvers.loops) == min(n0 + 3, solvers.loops.maxlen)
    assert solvers.last_loop is solvers.loops[-1] is recs[-1]
    assert [r.iters for r in recs] == [r_cg.iters, r_pcg.iters, r_fixed.iters]
    assert [r.syncs for r in recs] == [recs[0].eager, recs[1].eager, 0]
    for rec in recs:
        assert all(getattr(rec, f) >= 0 for f in PHASES)
        assert rec.capture_ms == 0 and rec.device_allocs == 0
        assert not rec.captured and rec.replays == 0 and rec.eager >= 1
        assert rec.preamble_ms > 0 and rec.eager_ms > 0
    assert recs[2].wait_ms == 0  # no flag read


def test_loops_are_bounded_at_their_maxlen(system, monkeypatch):
    import collections

    assert solvers.loops.maxlen == 16384
    monkeypatch.setattr(solvers, "loops", collections.deque(maxlen=3))
    A, b = system["A"], torch.from_numpy(system["b"])
    for iters in range(1, 6):
        solvers.cg_fixed_iters(A, b, iters=iters)
    assert [r.iters for r in solvers.loops] == [3, 4, 5]
    assert solvers.last_loop is solvers.loops[-1]


def test_raising_solve_leaves_no_record(system):
    n0, last = len(solvers.loops), solvers.last_loop
    with pytest.raises(ValueError, match="apply_M"):
        solvers.pcg(system["A"], torch.from_numpy(system["b"]))
    assert len(solvers.loops) == n0 and solvers.last_loop is last
