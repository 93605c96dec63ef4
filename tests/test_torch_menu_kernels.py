"""The port's ELL, SELL, BSR and HYB SpMV on the CPU against the JAX package.

The plain versions (``repro_torch.kernels.ref``) and the HYB composition
(``repro_torch.kernels.ops.hyb_spmv``) are held against the JAX jnp
reference paths, a dense float64 oracle over ragged shapes (empty rows,
K = 0, ghost lanes, C in {8, 32}, bs in {2, 4, 8}, BSR K in {1, 3}, NaN in
padding that must never be read) and, for ELL and BSR, the JAX Pallas
kernels in interpret mode. The CUDA kernels themselves run only on a card:
``tests/test_torch_cuda.py`` holds them against these plain versions.

The slice as a whole: ``hpcg_solve.run`` in ELL, SELL, HYB and BSR takes
the JAX ``cg`` iteration count on the same grid and format.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core.formats as jf
import repro.core.hpcg as jhpcg
import repro.core.ops as jops
import repro.core.solvers as jsol
import repro.kernels.bsr_spmm as jbsr
import repro.kernels.ell_spmv as jell
import repro.kernels.ref as jref
import repro_torch.core.formats as tf
from repro.core import Format as JFormat
from repro_torch import hpcg_solve
from repro_torch.kernels import bsr_spmm as kb
from repro_torch.kernels import ell_spmv as ke
from repro_torch.kernels import ops as kops
from repro_torch.kernels import sell_spmv as ks
from repro_torch.kernels.ref import bsr_spmm_ref, ell_spmv_ref, sell_spmv_ref
from torch_parity import DEV, jax_fields, jconv, port_from_jax, static_of, tol
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
DTYPE_NAMES = sorted(TORCH_DTYPES)

# ELL (M, N, K): K = 0, short rows, rows longer than a 32-slot chunk.
ELL_CASES = [(40, 30, 0), (40, 30, 5), (37, 20, 35)]
# BSR (block rows, block columns, block size, rhs width K).
BSR_CASES = [(5, 4, 2, 1), (4, 3, 4, 3), (3, 5, 8, 1), (6, 2, 2, 3)]


@pytest.fixture(autouse=True)
def _private_selection_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "selections.json"))


def _t(a, dtype_name=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(TORCH_DTYPES[dtype_name]) if dtype_name else t


def _j(a, dtype_name=None):
    return jnp.asarray(a, JAX_DTYPES[dtype_name]) if dtype_name else jnp.asarray(a)


def _f(y):
    return y.float().numpy()


def _rounded(a, dtype_name):
    """What the oracle sees: the inputs after rounding to the working type."""
    return _f(_t(a, dtype_name)).astype(np.float64)


def _widened(Aj):
    """JAX container with its values widened to float32 (exactly)."""
    if isinstance(Aj, jf.HYB):
        return dataclasses.replace(Aj, ell=_widened(Aj.ell), coo=_widened(Aj.coo))
    return dataclasses.replace(Aj, data=Aj.data.astype(jnp.float32))


def _jax_ref_spmv_f32(Aj, xj):
    """JAX's jnp reference SpMV on the same (rounded) values, accumulated in
    float32 as the port's kernels specify (in bfloat16 the JAX reference
    path of SELL and HYB would accumulate in bfloat16)."""
    y = jops.spmv(_widened(Aj), xj.astype(jnp.float32), backend="ref")
    return np.asarray(y, np.float32)


def _ell_inputs(m, n, k, seed=0):
    """Columns past both edges (clamped, as ``take(mode="clip")``), every
    seventh row padding only (col -1, val 0): empty rows."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(-3, n + 3, (m, k)).astype(np.int32)
    vals = rng.standard_normal((m, k)).astype(np.float32)
    cols[::7], vals[::7] = -1, 0.0
    return cols, vals, rng.standard_normal(n).astype(np.float32)


@pytest.mark.parametrize("dtype_name", DTYPE_NAMES)
@pytest.mark.parametrize("case", range(len(ELL_CASES)))
def test_ell_plain_matches_jax_ref_pallas_and_oracle(case, dtype_name):
    m, n, k = ELL_CASES[case]
    cols, vals, x = _ell_inputs(m, n, k)
    y = ell_spmv_ref(_t(cols), _t(vals, dtype_name), _t(x, dtype_name))
    assert y.dtype == TORCH_DTYPES[dtype_name] and y.shape == (m,)
    jargs = (_j(cols), _j(vals, dtype_name), _j(x, dtype_name))
    np.testing.assert_allclose(_f(y), np.asarray(jref.ell_spmv_ref(*jargs), np.float32),
                               **tol(dtype_name))
    np.testing.assert_allclose(_f(y), np.asarray(jell.ell_spmv(*jargs, interpret=True),
                                                 np.float32), **tol(dtype_name))
    oracle = (_rounded(vals, dtype_name)
              * _rounded(x, dtype_name)[np.clip(cols, 0, n - 1)]).sum(axis=1)
    np.testing.assert_allclose(_f(y), oracle, **tol(dtype_name))


def _ragged_dense(m, n, seed):
    """Random rows of 0..3n/4 entries, every fifth row empty."""
    rng = np.random.default_rng(seed)
    a = np.zeros((m, n), np.float32)
    for i in range(m):
        if i % 5:
            ln = int(rng.integers(1, 3 * n // 4))
            a[i, rng.choice(n, ln, replace=False)] = rng.standard_normal(ln)
    return a


def _nan_in_ghost_lanes(fields, m, c):
    """NaN into every slot of the lanes past the last row (perm == m)."""
    data, ptrs, perm = fields["data"].copy(), fields["slice_ptrs"], fields["perm"]
    for lane in np.nonzero(perm >= m)[0]:
        s, r = divmod(int(lane), c)
        data[ptrs[s] + r:ptrs[s + 1]:c] = np.nan
    return dict(fields, data=data)


@pytest.mark.parametrize("dtype_name", DTYPE_NAMES)
@pytest.mark.parametrize("c,sigma", [(8, 16), (32, 64)])
def test_sell_plain_matches_jax_and_oracle(c, sigma, dtype_name):
    """61 rows: the last slice has ghost lanes, which hold NaN here."""
    m, n = 61, 40
    a = _ragged_dense(m, n, seed=c)
    Aj = jf.coo_from_dense_np(a, dtype=JAX_DTYPES[dtype_name])
    Sj = jconv.convert(Aj, JFormat.SELL, c=c, sigma=sigma)
    fields = _nan_in_ghost_lanes(jax_fields(Sj), m, c)
    assert (fields["perm"] == m).any()  # the case has ghost lanes
    St = tf.from_numpy(int(Sj.format), fields, Sj.shape, Sj.nnz, device=DEV, **static_of(Sj))
    x = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    y = sell_spmv_ref(St.slice_ptrs, St.cols, St.data, St.perm, _t(x, dtype_name), m, c)
    assert y.dtype == TORCH_DTYPES[dtype_name] and bool(torch.isfinite(y).all())
    Sj_nan = dataclasses.replace(Sj, data=jnp.asarray(fields["data"]))
    yj = _jax_ref_spmv_f32(Sj_nan, _j(x, dtype_name))
    np.testing.assert_allclose(_f(y), yj, **tol(dtype_name))
    oracle = _rounded(a, dtype_name) @ _rounded(x, dtype_name)
    np.testing.assert_allclose(_f(y), oracle, **tol(dtype_name))
    assert torch.equal(kops.sell_spmv(St, _t(x, dtype_name)), y)


def _bsr_inputs(mb, nbc, bs, k, empty_rows, seed=2):
    """Block-CSR arrays; with ``empty_rows`` the first and last block rows
    hold no block and 3 capacity blocks of NaN follow ``indptr[-1]``."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, nbc + 1, mb)
    if empty_rows:
        lens[0] = lens[-1] = 0
    nnz_b = int(lens.sum())
    pad = 3 if empty_rows else 0
    indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    bcol = np.concatenate([np.sort(rng.choice(nbc, ln, replace=False)) for ln in lens]
                          + [np.zeros(pad, np.int64)]).astype(np.int32)
    blocks = rng.standard_normal((nnz_b + pad, bs, bs)).astype(np.float32)
    blocks[nnz_b:] = np.nan
    B = rng.standard_normal((nbc * bs, k)).astype(np.float32)
    return indptr, bcol, blocks, B


def _bsr_oracle(indptr, bcol, blocks, B, bs):
    y = np.zeros((bs * (len(indptr) - 1), B.shape[1]))
    for r in range(len(indptr) - 1):
        for p in range(indptr[r], indptr[r + 1]):
            y[r * bs:(r + 1) * bs] += blocks[p] @ B[bcol[p] * bs:(bcol[p] + 1) * bs]
    return y


@pytest.mark.parametrize("dtype_name", DTYPE_NAMES)
@pytest.mark.parametrize("case", range(len(BSR_CASES)))
def test_bsr_plain_matches_jax_ref_pallas_and_oracle(case, dtype_name):
    """Every block row non-empty: the JAX Pallas kernel's own requirement."""
    mb, nbc, bs, k = BSR_CASES[case]
    indptr, bcol, blocks, B = _bsr_inputs(mb, nbc, bs, k, empty_rows=False)
    m = mb * bs
    y = bsr_spmm_ref(_t(indptr), _t(bcol), _t(blocks, dtype_name), _t(B, dtype_name), m)
    assert y.dtype == TORCH_DTYPES[dtype_name] and y.shape == (m, k)
    jargs = (_j(indptr), _j(bcol), _j(blocks, dtype_name), _j(B, dtype_name))
    yj = jref.bsr_spmm_ref(*jargs, m)
    np.testing.assert_allclose(_f(y), np.asarray(yj, np.float32), **tol(dtype_name))
    brow = np.repeat(np.arange(mb, dtype=np.int32), np.diff(indptr))
    yp = jbsr.bsr_spmm(jargs[0], _j(brow), *jargs[1:], m, interpret=True)
    np.testing.assert_allclose(_f(y), np.asarray(yp, np.float32), **tol(dtype_name))
    oracle = _bsr_oracle(indptr, bcol, _rounded(blocks, dtype_name), _rounded(B, dtype_name),
                         bs)
    np.testing.assert_allclose(_f(y), oracle, **tol(dtype_name))


@pytest.mark.parametrize("dtype_name", DTYPE_NAMES)
@pytest.mark.parametrize("case", range(len(BSR_CASES)))
def test_bsr_plain_empty_block_rows_and_nan_padding(case, dtype_name):
    """Empty block rows write zeros; the NaN blocks past indptr[-1] are never
    read (the JAX reference, which folds them into the last block row, is
    held on the same matrix without them)."""
    mb, nbc, bs, k = BSR_CASES[case]
    indptr, bcol, blocks, B = _bsr_inputs(mb, nbc, bs, k, empty_rows=True)
    m, live = mb * bs, int(indptr[-1])
    y = bsr_spmm_ref(_t(indptr), _t(bcol), _t(blocks, dtype_name), _t(B, dtype_name), m)
    assert bool(torch.isfinite(y).all()) and not bool(y[:bs].any()) and not bool(y[-bs:].any())
    yj = jref.bsr_spmm_ref(_j(indptr), _j(bcol[:live]), _j(blocks[:live], dtype_name),
                           _j(B, dtype_name), m)
    np.testing.assert_allclose(_f(y), np.asarray(yj, np.float32), **tol(dtype_name))
    oracle = _bsr_oracle(indptr, bcol, _rounded(blocks, dtype_name), _rounded(B, dtype_name),
                         bs)
    np.testing.assert_allclose(_f(y), oracle, **tol(dtype_name))
    Bt = tf.BSR(_t(indptr), _t(bcol), _t(blocks, dtype_name), (m, nbc * bs), live * bs * bs, bs)
    xv = _t(B[:, 0].copy(), dtype_name)
    assert torch.equal(kops.bsr_spmv(Bt, xv),
                       bsr_spmm_ref(Bt.indptr, Bt.indices, Bt.data, xv[:, None], m)[:, 0])


@pytest.mark.parametrize("dtype_name", DTYPE_NAMES)
@pytest.mark.parametrize("k", [2, 5])
def test_hyb_composition_matches_jax_and_oracle(k, dtype_name):
    """``kops.hyb_spmv`` (ELL plus the CSR kernel over the tail, whose CSR
    layout is built by a stable sort and searchsorted) against JAX's
    reference HYB SpMV; tail padding with row id M and NaN values is never
    read."""
    m, n = 64, 50
    a = _ragged_dense(m, n, seed=k)
    Aj = jf.coo_from_dense_np(a, dtype=JAX_DTYPES[dtype_name])
    Hj = jconv.convert(Aj, JFormat.HYB, k=k)
    Ht = port_from_jax(Hj)
    x = np.random.default_rng(3).standard_normal(n).astype(np.float32)
    y = kops.hyb_spmv(Ht, _t(x, dtype_name))
    yj = _jax_ref_spmv_f32(Hj, _j(x, dtype_name))
    np.testing.assert_allclose(_f(y), yj, **tol(dtype_name))
    oracle = _rounded(a, dtype_name) @ _rounded(x, dtype_name)
    np.testing.assert_allclose(_f(y), oracle, **tol(dtype_name))
    tail, pad = Ht.coo, 4
    coo = tf.COO(torch.cat([tail.row, torch.full((pad,), m, dtype=torch.int32)]),
                 torch.cat([tail.col, torch.zeros(pad, dtype=torch.int32)]),
                 torch.cat([tail.data, torch.full((pad,), float("nan"),
                                                  dtype=tail.data.dtype)]),
                 tail.shape, tail.nnz + pad)
    yp = kops.hyb_spmv(tf.HYB(Ht.ell, coo, Ht.shape, Ht.nnz), _t(x, dtype_name))
    assert bool(torch.isfinite(yp).all())
    np.testing.assert_allclose(_f(yp), oracle, **tol(dtype_name))


def test_tail_csr_matches_a_host_bincount():
    rng = np.random.default_rng(4)
    rows = rng.integers(0, 12, 40).astype(np.int32)
    rows[:3] = 12  # padding past the last row
    coo = tf.COO(_t(rows), _t(rng.integers(0, 9, 40).astype(np.int32)),
                 _t(rng.standard_normal(40).astype(np.float32)), (12, 9), 40)
    indptr, indices, data = kops.tail_csr(coo, 12)
    assert indptr.dtype == torch.int32
    expect = np.concatenate([[0], np.cumsum(np.bincount(rows[rows < 12], minlength=12))])
    np.testing.assert_array_equal(indptr.numpy(), expect)
    order = np.argsort(rows, kind="stable")
    np.testing.assert_array_equal(indices.numpy(), coo.col.numpy()[order])
    np.testing.assert_array_equal(data.numpy(), coo.data.numpy()[order])


def test_menu_wrappers_on_cpu_run_the_plain_version_uncounted():
    kops.reset_launches()
    cols, vals, x = _ell_inputs(40, 30, 5)
    assert torch.equal(ke.ell_spmv(_t(cols), _t(vals), _t(x)),
                       ell_spmv_ref(_t(cols), _t(vals), _t(x)))
    indptr, bcol, blocks, B = _bsr_inputs(4, 3, 4, 3, empty_rows=True)
    assert torch.equal(kb.bsr_spmm(_t(indptr), _t(bcol), _t(blocks), _t(B), 16),
                       bsr_spmm_ref(_t(indptr), _t(bcol), _t(blocks), _t(B), 16))
    S = tf.coo_from_dense_np(_ragged_dense(61, 40, 0), device=DEV)
    from repro_torch.core.convert import convert
    S = convert(S, tf.Format.SELL, c=8, sigma=16)
    xs = torch.ones(40)
    assert torch.equal(ks.sell_spmv(S.slice_ptrs, S.cols, S.data, S.perm, xs, 61, 8),
                       sell_spmv_ref(S.slice_ptrs, S.cols, S.data, S.perm, xs, 61, 8))
    assert set(kops.launch_counts().values()) == {0}
    for call in (lambda: ke.ell_spmv(_t(cols).to("meta"), _t(vals).to("meta"),
                                     _t(x).to("meta")),
                 lambda: kb.bsr_spmm(_t(indptr).to("meta"), _t(bcol).to("meta"),
                                     _t(blocks).to("meta"), _t(B).to("meta"), 16)):
        with pytest.raises(ValueError, match="cuda or cpu"):
            call()


def test_menu_wrapper_argument_checks():
    cols, vals, x = _t(np.zeros((4, 3), np.int32)), torch.ones(4, 3), torch.ones(5)
    ke._check(cols, vals, x)
    with pytest.raises(ValueError, match="int32"):
        ke._check(cols.long(), vals, x)
    with pytest.raises(ValueError, match="differ"):
        ke._check(cols, torch.ones(4, 2), x)
    with pytest.raises(ValueError, match="share dtype"):
        ke._check(cols, vals.double(), x.double())
    with pytest.raises(ValueError, match="contiguous"):
        ke._check(_t(np.zeros((3, 4), np.int32)).t(), vals, x)
    ptrs = torch.tensor([0, 8, 12], dtype=torch.int32)
    c_, d_ = torch.zeros(12, dtype=torch.int32), torch.ones(12)
    perm = torch.tensor([0, 1, 2, 3, 4, 5, 6, 6], dtype=torch.int32)
    ks._check(ptrs, c_, d_, perm, x, 6, 4)
    with pytest.raises(ValueError, match="nslices"):
        ks._check(ptrs, c_, d_, perm[:6], x, 6, 4)
    with pytest.raises(ValueError, match="whole planes"):
        ks._check(ptrs, c_[:10], d_[:10], perm, x, 6, 4)
    with pytest.raises(ValueError, match="positive"):
        ks._check(ptrs, c_, d_, perm, x, 6, 0)
    ip, bc = torch.tensor([0, 1, 1], dtype=torch.int32), torch.zeros(1, dtype=torch.int32)
    blk, Bm = torch.ones(1, 2, 2), torch.ones(4, 3)
    kb._check(ip, bc, blk, Bm, 4)
    with pytest.raises(ValueError, match="m/bs\\+1"):
        kb._check(ip, bc, blk, Bm, 6)
    with pytest.raises(ValueError, match="one block column"):
        kb._check(ip, torch.zeros(2, dtype=torch.int32), blk, Bm, 4)
    with pytest.raises(ValueError, match="bs, bs"):
        kb._check(ip, bc, torch.ones(1, 2, 3), Bm, 4)
    with pytest.raises(ValueError, match="multiple of bs"):
        kb._check(ip, bc, blk, torch.ones(5, 3), 4)


def test_default_config_of_the_menu():
    a = _ragged_dense(64, 50, 1)
    A = tf.coo_from_dense_np(a, device=DEV)
    from repro_torch.core.convert import convert
    H = convert(A, tf.Format.HYB, k=2)
    cfg = kops.default_config(H)
    assert cfg == {"ell": {}, "csr": {"vec": kops.default_config(
        tf.CSR(torch.zeros(65, dtype=torch.int32), H.coo.col, H.coo.data, H.shape,
               H.coo.nnz))["vec"]}}
    for fmt in (tf.Format.ELL, tf.Format.SELL):
        assert kops.default_config(convert(A, fmt)) == {}


# (grid, format, hints): the four new formats of the main path, cut to 8^3
# and 16^3; BSR's block edge divides the grid line.
SOLVES = [((8, 8, 8), "ELL", {}), ((8, 8, 8), "SELL", {}),
          ((8, 8, 8), "HYB", {"ell_k": 18}), ((8, 8, 8), "BSR", {"block_size": 4}),
          ((16, 16, 16), "ELL", {}), ((16, 16, 16), "SELL", {}),
          ((16, 16, 16), "HYB", {"ell_k": 18}), ((16, 16, 16), "BSR", {"block_size": 8})]


@pytest.mark.parametrize("grid,fmt,hints", SOLVES,
                         ids=[f"{g[0]}-{f}" for g, f, _ in SOLVES])
def test_slice_solves_like_jax_in_every_new_format(grid, fmt, hints):
    """Same CG iterations (within one: f32 sums in another order) as JAX's
    jnp-reference CG on the same grid and format, tol 1e-6 (above the f32
    floor), and max|x - 1| < 1e-3."""
    r = hpcg_solve.run(grid, fmt, device="cpu", tol=1e-6, **hints)
    assert r["format"] == fmt and r["passed"] and r["err"] < 1e-3
    prob = jhpcg.generate_problem(*grid)
    kw = {"k": hints["ell_k"]} if "ell_k" in hints else dict(hints)
    Aj = jconv.convert(jhpcg.to_coo(prob), JFormat[fmt], **kw)
    res = jsol.cg(lambda v: jops.spmv(Aj, v, backend="ref"),
                  jnp.asarray(jhpcg.rhs_for_ones(prob)), tol=1e-6, maxiter=500)
    assert abs(r["iters"] - int(res.iters)) <= 1


def test_bsr_plan_takes_a_block_grid_past_int32():
    """The port's block ids are int64: a 2^17-square matrix at bs = 2 has a
    grid of 2^32 blocks, which the JAX package's int32 ids refuse (HPCG
    104^3 at bs = 8 has 1.98e10)."""
    n = 1 << 17
    A = tf.coo_from_arrays([0, 5, n - 1], [n - 1, 7, 0], [1.0, 2.0, 3.0], (n, n), device=DEV)
    from repro_torch.core.convert import convert
    B = convert(A, tf.Format.BSR, block_size=2)
    assert B.nblocks == 3 and B.indices.tolist() == [n // 2 - 1, 3, 0]
    y = kops.bsr_spmv(B, torch.arange(n, dtype=torch.float32))
    assert (y[0].item(), y[5].item(), y[n - 1].item()) == (n - 1.0, 14.0, 0.0)
    with pytest.raises(ValueError, match="too large"):
        jconv.plan_switch(jf.coo_from_arrays([0], [0], [1.0], (n, n)), JFormat.BSR,
                          block_size=2)
