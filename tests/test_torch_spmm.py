"""The port's SpMM and SpMM_T on the CPU against the JAX package.

``repro_torch.core.ops.spmm``/``spmm_t`` (every ``_spmm_*`` reference, all
eight formats) against ``repro.core.ops.spmm``/``spmm_t(backend="ref")`` and
a dense float64 oracle, at rhs widths 1, 3 and 8; the plain versions of the
four SpMM kernels (``repro_torch.kernels.ref``) on ragged cases (empty rows,
NaN capacity padding and ghost lanes that must never be read, ELL K = 0,
clamped columns, C != 32) against the oracle, the JAX jnp references and,
for ELL, the JAX Pallas ``ell_spmm_t`` in interpret mode. The CUDA kernels
run only on a card: ``tests/test_torch_cuda.py`` holds them against these
plain versions. Tolerances: 1e-4 in float32, 2e-2 in bfloat16.
"""
import ctypes
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core.formats as jf
import repro.core.ops as jops
import repro.kernels.ell_spmv as jell
import repro_torch.core.formats as tf
import repro_torch.core.ops as tops
from repro_torch.core.dynamic import DynamicMatrix, SwitchDynamicMatrix
from repro_torch.kernels import _build
from repro_torch.kernels import csr_spmm as kcm
from repro_torch.kernels import ell_spmm as kem
from repro_torch.kernels import ops as kops
from repro_torch.kernels import sell_spmm as ksm
from repro_torch.kernels.ref import (csr_spmm_ref, csr_spmm_t_ref, ell_spmm_ref,
                                     ell_spmm_t_ref, sell_spmm_ref, sell_spmm_t_ref)
from torch_parity import PATTERNS, coo_pair, jconv, port_from_jax, tconv, tol

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
DTYPE_NAMES = sorted(TORCH_DTYPES)
WIDTHS = (1, 3, 8)
# Every format, with the plan hints that suit the 64-row parity patterns.
FORMATS = {"COO": {}, "CSR": {}, "DIA": {}, "ELL": {}, "BSR": {"block_size": 8},
           "DENSE": {}, "HYB": {}, "SELL": {"c": 8, "sigma": 16}}


def _t(a, dtype_name=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(TORCH_DTYPES[dtype_name]) if dtype_name else t


def _f(y):
    return y.float().numpy()


def _rounded(a, dtype_name):
    """What the oracle sees: the inputs after rounding to the working type."""
    return _f(_t(a, dtype_name)).astype(np.float64)


def _pair(pattern, fmt):
    a = PATTERNS[pattern]()
    Jc, _ = coo_pair(a)
    Jf = jconv.convert(Jc, jf.Format[fmt], **FORMATS[fmt])
    return a, Jf, port_from_jax(Jf)


@pytest.mark.parametrize("fmt", list(FORMATS))
@pytest.mark.parametrize("pattern", ["powerlaw", "random"])
def test_spmm_and_spmm_t_match_jax_and_oracle(pattern, fmt):
    a, Jf, P = _pair(pattern, fmt)
    m, n = a.shape
    rng = np.random.default_rng(20)
    for w in WIDTHS:
        B = rng.standard_normal((n, w)).astype(np.float32)
        X = rng.standard_normal((w, n)).astype(np.float32)
        y = tops.spmm(P, _t(B))
        assert y.shape == (m, w) and y.dtype == torch.float32
        np.testing.assert_allclose(y.numpy(), np.asarray(jops.spmm(Jf, jnp.asarray(B),
                                                                   backend="ref")),
                                   **tol("float32"))
        np.testing.assert_allclose(y.numpy(), a.astype(np.float64) @ B, **tol("float32"))
        assert torch.equal(y, tops._SPMM[type(P)](P, _t(B)))
        yt = tops.spmm_t(P, _t(X))
        assert yt.shape == (w, m)
        np.testing.assert_allclose(yt.numpy(), np.asarray(jops.spmm_t(Jf, jnp.asarray(X),
                                                                      backend="ref")),
                                   **tol("float32"))
        np.testing.assert_allclose(yt.numpy(), X.astype(np.float64) @ a.T, **tol("float32"))
        assert torch.equal(yt, tops.spmm_t(P, _t(X), backend="ref"))


def _widened(Aj):
    """JAX container with its values widened to float32 (exactly)."""
    if isinstance(Aj, jf.HYB):
        return dataclasses.replace(Aj, ell=_widened(Aj.ell), coo=_widened(Aj.coo))
    return dataclasses.replace(Aj, data=Aj.data.astype(jnp.float32))


@pytest.mark.parametrize("fmt", ["CSR", "ELL", "SELL", "HYB", "COO"])
def test_spmm_t_bf16_matches_jax_and_oracle(fmt):
    """bfloat16 weights and activations: the port's plain SpMM_T versions of
    the kernel formats sum in float32; JAX's jnp reference sums in bf16, so
    it runs on the same values widened to float32."""
    a = PATTERNS["powerlaw"]()
    Jc = jf.coo_from_dense_np(a, capacity=1032, dtype=jnp.bfloat16)
    Jf = jconv.convert(Jc, jf.Format[fmt], **FORMATS[fmt])
    P = port_from_jax(Jf)
    X = np.random.default_rng(21).standard_normal((3, a.shape[1])).astype(np.float32)
    Xb = _t(X, "bfloat16")
    y = kops.SPMM_T_CUDA[type(P)](P, Xb) if type(P) in kops.SPMM_T_CUDA else \
        tops.spmm_t(P, Xb)
    assert y.dtype == torch.bfloat16 and y.shape == (3, a.shape[0])
    yj = jops.spmm_t(_widened(Jf), jnp.asarray(_f(Xb)), backend="ref")
    np.testing.assert_allclose(_f(y), np.asarray(yj, np.float32), **tol("bfloat16"))
    oracle = _rounded(X, "bfloat16") @ _rounded(a, "bfloat16").T
    np.testing.assert_allclose(_f(y), oracle, **tol("bfloat16"))


@pytest.mark.parametrize("dtype_name", DTYPE_NAMES)
def test_coo_spmm_sums_rows_in_entry_order(dtype_name):
    """The plain COO SpMM reduces each row over its entries in entry order
    (one segment a row, no atomics): against JAX's ``_spmm_coo`` on entries
    in no row order, rows repeated, explicit zeros, an entry past the last
    row (dropped) and a column past the last (clamped). In float32 the sum
    is JAX's, in the same order: equal bitwise here. In bf16 a row is summed
    in float32 and rounded once, where JAX rounds at every add."""
    rng = np.random.default_rng(23)
    m, n, w = 12, 10, 5
    row = rng.integers(0, m, 60).astype(np.int32)
    col = rng.integers(0, n, 60).astype(np.int32)
    val = rng.standard_normal(60).astype(np.float32)
    row[:6] = 3  # one row of many entries, interleaved with the others
    val[10:16] = 0.0  # explicit zeros
    row[20], col[21] = m + 2, n + 3
    B = rng.standard_normal((n, w)).astype(np.float32)
    jd, td = JAX_DTYPES[dtype_name], TORCH_DTYPES[dtype_name]
    Jc = jf.COO(row=jnp.asarray(row), col=jnp.asarray(col), data=jnp.asarray(val, jd),
                shape=(m, n), nnz=60)
    Pc = tf.COO(row=_t(row), col=_t(col), data=_t(val, dtype_name), shape=(m, n), nnz=60)
    y = tops.spmm(Pc, _t(B, dtype_name))
    yj = np.asarray(jops._spmm_coo(Jc, jnp.asarray(B, jd)).astype(jnp.float32))
    assert y.dtype == td and y.shape == (m, w)
    if dtype_name == "float32":
        np.testing.assert_array_equal(y.numpy(), yj)
    else:
        np.testing.assert_allclose(_f(y), yj, **tol("bfloat16"))
    keep = row < m
    dense = np.zeros((m, n))
    np.add.at(dense, (row[keep], np.minimum(col[keep], n - 1)),
              _rounded(val, dtype_name)[keep])
    np.testing.assert_allclose(_f(y), dense @ _rounded(B, dtype_name), **tol(dtype_name))
    assert torch.equal(y, tops.spmm(Pc, _t(B, dtype_name)))


def _csr_ragged(n, seed):
    """CSR with empty first/middle/last rows, one long row, columns past both
    edges and 37 capacity slots of NaN past indptr[-1]."""
    rng = np.random.default_rng(seed)
    lens = [0, 3, 0, 0, 70, 1, 27, 0, 64, 0]
    nnz = sum(lens)
    indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    idx = rng.integers(-2, n + 2, nnz + 37).astype(np.int32)
    val = rng.standard_normal(nnz + 37).astype(np.float32)
    val[nnz:] = np.nan
    return indptr, idx, val, len(lens), nnz


def _csr_oracle(indptr, idx, val, n, dtype_name):
    """Dense (M, N) float64 matrix of the live entries, columns clamped."""
    m = len(indptr) - 1
    A = np.zeros((m, n))
    v = _rounded(val, dtype_name)
    for i in range(m):
        for p in range(indptr[i], indptr[i + 1]):
            A[i, min(max(idx[p], 0), n - 1)] += v[p]
    return A


@pytest.mark.parametrize("dtype_name", DTYPE_NAMES)
def test_csr_plain_spmm_versions_on_ragged_rows(dtype_name):
    n = 90
    indptr, idx, val, m, _ = _csr_ragged(n, 22)
    A = _csr_oracle(indptr, idx, val, n, dtype_name)
    rng = np.random.default_rng(23)
    args = (_t(indptr), _t(idx), _t(val, dtype_name))
    for w in WIDTHS:
        B = rng.standard_normal((n, w)).astype(np.float32)
        y = csr_spmm_ref(*args, _t(B, dtype_name), m)
        assert y.dtype == TORCH_DTYPES[dtype_name] and y.shape == (m, w)
        assert bool(torch.isfinite(y).all()) and not bool(y[0].any())
        np.testing.assert_allclose(_f(y), A @ _rounded(B, dtype_name), **tol(dtype_name))
        X = rng.standard_normal((w, n)).astype(np.float32)
        yt = csr_spmm_t_ref(*args, _t(X, dtype_name), m)
        assert yt.shape == (w, m) and bool(torch.isfinite(yt).all())
        np.testing.assert_allclose(_f(yt), _rounded(X, dtype_name) @ A.T, **tol(dtype_name))


# ELL (M, N, K): K = 0, short rows, rows longer than a warp's 32 lanes.
ELL_CASES = [(40, 30, 0), (40, 30, 5), (37, 20, 35)]


@pytest.mark.parametrize("dtype_name", DTYPE_NAMES)
@pytest.mark.parametrize("case", range(len(ELL_CASES)))
def test_ell_plain_spmm_t_matches_jax_ref_pallas_and_oracle(case, dtype_name):
    m, n, k = ELL_CASES[case]
    rng = np.random.default_rng(24)
    cols = rng.integers(-3, n + 3, (m, k)).astype(np.int32)
    vals = rng.standard_normal((m, k)).astype(np.float32)
    cols[::7], vals[::7] = -1, 0.0
    X = rng.standard_normal((3, n)).astype(np.float32)
    y = ell_spmm_t_ref(_t(cols), _t(vals, dtype_name), _t(X, dtype_name))
    assert y.dtype == TORCH_DTYPES[dtype_name] and y.shape == (3, m)
    oracle = np.einsum("ik,tik->ti", _rounded(vals, dtype_name),
                       _rounded(X, dtype_name)[:, np.clip(cols, 0, n - 1)])
    np.testing.assert_allclose(_f(y), oracle, **tol(dtype_name))
    jargs = (jnp.asarray(cols), jnp.asarray(_f(_t(vals, dtype_name))),
             jnp.asarray(_f(_t(X, dtype_name))))
    E = jf.ELL(jargs[0], jargs[1], (m, n), m * k)
    np.testing.assert_allclose(_f(y), np.asarray(jops.spmm_t(E, jargs[2], backend="ref")),
                               **tol(dtype_name))
    pallas = jell.ell_spmm_t(*jargs, tm=32, tn=8, interpret=True)
    np.testing.assert_allclose(_f(y), np.asarray(pallas, np.float32), **tol(dtype_name))


@pytest.mark.parametrize("dtype_name", DTYPE_NAMES)
@pytest.mark.parametrize("c,sigma", [(8, 16), (32, 64), (5, 5)])
def test_sell_plain_spmm_t_drops_nan_ghost_lanes(c, sigma, dtype_name):
    rng = np.random.default_rng(25)
    m, n = 61, 40
    a = np.zeros((m, n), np.float32)
    for i in range(m):
        if i % 5:
            ln = int(rng.integers(1, 3 * n // 4))
            a[i, rng.choice(n, ln, replace=False)] = rng.standard_normal(ln)
    S = tconv.convert(tf.coo_from_dense_np(a, device="cpu"), tf.Format.SELL, c=c, sigma=sigma)
    data = S.data.clone()
    ptrs, perm = S.slice_ptrs.tolist(), S.perm.tolist()
    for lane, row in enumerate(perm):
        if row >= m:
            s, r = divmod(lane, c)
            data[ptrs[s] + r:ptrs[s + 1]:c] = float("nan")
    assert max(perm) == m  # the case has ghost lanes
    args = (S.slice_ptrs, S.cols, data.to(TORCH_DTYPES[dtype_name]), S.perm)
    for w in WIDTHS:
        X = rng.standard_normal((w, n)).astype(np.float32)
        y = sell_spmm_t_ref(*args, _t(X, dtype_name), m, c)
        assert y.shape == (w, m) and bool(torch.isfinite(y).all())
        oracle = _rounded(X, dtype_name) @ _rounded(a, dtype_name).T
        np.testing.assert_allclose(_f(y), oracle, **tol(dtype_name))


@pytest.mark.parametrize("dtype_name", DTYPE_NAMES)
@pytest.mark.parametrize("case", range(len(ELL_CASES)))
def test_ell_plain_spmm_matches_jax_pallas_ref_and_oracle(case, dtype_name):
    """``ell_spmm_ref`` and ``spmm(ELL)`` on the CPU against JAX's Pallas
    ``ell_spmm`` in interpret mode (both layouts), its jnp reference and the
    dense oracle; clamped columns, padding rows, K = 0."""
    m, n, k = ELL_CASES[case]
    rng = np.random.default_rng(32)
    cols = rng.integers(-3, n + 3, (m, k)).astype(np.int32)
    vals = rng.standard_normal((m, k)).astype(np.float32)
    cols[::7], vals[::7] = -1, 0.0
    B = rng.standard_normal((n, 5)).astype(np.float32)
    y = ell_spmm_ref(_t(cols), _t(vals, dtype_name), _t(B, dtype_name))
    assert y.dtype == TORCH_DTYPES[dtype_name] and y.shape == (m, 5)
    oracle = np.einsum("ik,ikj->ij", _rounded(vals, dtype_name),
                       _rounded(B, dtype_name)[np.clip(cols, 0, n - 1)])
    np.testing.assert_allclose(_f(y), oracle, **tol(dtype_name))
    E = tf.ELL(_t(cols), _t(vals, dtype_name), (m, n), m * k)
    assert torch.equal(kops.ell_spmm(E, _t(B, dtype_name)), y)  # CPU: the plain version
    if dtype_name == "float32":  # the reference route sums bf16 in bf16, as JAX's does
        np.testing.assert_allclose(_f(tops.spmm(E, _t(B))), oracle, **tol(dtype_name))
    jargs = (jnp.asarray(cols), jnp.asarray(_f(_t(vals, dtype_name))),
             jnp.asarray(_f(_t(B, dtype_name))))
    Ej = jf.ELL(jargs[0], jargs[1], (m, n), m * k)
    np.testing.assert_allclose(_f(y), np.asarray(jops.spmm(Ej, jargs[2], backend="ref")),
                               **tol(dtype_name))
    for layout in ("row", "col"):
        pallas = jell.ell_spmm(*jargs, tm=32, tn=8, layout=layout, interpret=True)
        np.testing.assert_allclose(_f(y), np.asarray(pallas, np.float32), **tol(dtype_name))


@pytest.mark.parametrize("dtype_name", DTYPE_NAMES)
@pytest.mark.parametrize("c,sigma", [(8, 16), (32, 64), (5, 5)])
def test_sell_plain_spmm_matches_jax_ref_and_drops_nan_ghost_lanes(c, sigma, dtype_name):
    """``sell_spmm_ref`` and ``spmm(SELL)`` against JAX's jnp reference
    (``_spmm_sell``: the Pallas SELL kernel does not trace on this JAX) on
    the same container, with empty rows, C != 32, and ghost lanes holding
    NaN in the plain version's input (never written)."""
    rng = np.random.default_rng(33)
    m, n = 61, 40
    a = np.zeros((m, n), np.float32)
    for i in range(m):
        if i % 5:
            ln = int(rng.integers(1, 3 * n // 4))
            a[i, rng.choice(n, ln, replace=False)] = rng.standard_normal(ln)
    Jc, _ = coo_pair(a)
    Sj = jconv.convert(Jc, jf.Format.SELL, c=c, sigma=sigma)
    S = port_from_jax(Sj)
    data = S.data.clone()
    ptrs, perm = S.slice_ptrs.tolist(), S.perm.tolist()
    for lane, row in enumerate(perm):
        if row >= m:
            s, r = divmod(lane, c)
            data[ptrs[s] + r:ptrs[s + 1]:c] = float("nan")
    assert max(perm) == m  # the case has ghost lanes
    args = (S.slice_ptrs, S.cols, data.to(TORCH_DTYPES[dtype_name]), S.perm)
    oracle_a = _rounded(a, dtype_name)
    for w in WIDTHS + (20,):
        B = rng.standard_normal((n, w)).astype(np.float32)
        y = sell_spmm_ref(*args, _t(B, dtype_name), m, c)
        assert y.shape == (m, w) and bool(torch.isfinite(y).all())
        np.testing.assert_allclose(_f(y), oracle_a @ _rounded(B, dtype_name), **tol(dtype_name))
        Sw = jax_sell_widened(Sj, dtype_name)
        yj = jops._spmm_sell(Sw, jnp.asarray(_f(_t(B, dtype_name))))
        np.testing.assert_allclose(_f(y), np.asarray(yj, np.float32), **tol(dtype_name))
        if dtype_name == "float32":  # the wrapper on a CPU tensor: the plain version
            assert torch.equal(kops.sell_spmm(S, _t(B)), sell_spmm_ref(
                S.slice_ptrs, S.cols, S.data, S.perm, _t(B), m, c))
            np.testing.assert_allclose(_f(tops.spmm(S, _t(B))), oracle_a @ B, **tol(dtype_name))


def jax_sell_widened(Sj, dtype_name):
    """The JAX SELL container with its values rounded to the working type
    and widened to float32 (JAX's jnp reference would sum bf16 in bf16)."""
    vals = np.array(Sj.data, np.float32)  # a writable copy
    return dataclasses.replace(Sj, data=jnp.asarray(_f(_t(vals, dtype_name))))


@pytest.mark.parametrize("dtype_name", DTYPE_NAMES)
def test_hyb_spmm_matches_jax_and_oracle(dtype_name):
    """``hyb_spmm`` (on the CPU: the ELL plain version plus the CSR plain
    version over the sorted tail) and ``spmm(HYB)`` against JAX's
    ``_spmm_hyb`` and the dense float64 oracle."""
    a = PATTERNS["powerlaw"]()
    Jc = jf.coo_from_dense_np(a, capacity=1032)
    Hj = jconv.convert(Jc, jf.Format.HYB, k=2)
    H = port_from_jax(Hj)
    if dtype_name == "bfloat16":
        H = tf.HYB(tf.ELL(H.ell.cols, H.ell.data.bfloat16(), H.shape, H.ell.nnz),
                   tf.COO(H.coo.row, H.coo.col, H.coo.data.bfloat16(), H.shape, H.coo.nnz),
                   H.shape, H.nnz)
    assert H.coo.nnz > 0
    rng = np.random.default_rng(34)
    for w in WIDTHS:
        B = rng.standard_normal((a.shape[1], w)).astype(np.float32)
        Bt = _t(B, dtype_name)
        y = kops.hyb_spmm(H, Bt)
        assert y.dtype == TORCH_DTYPES[dtype_name] and y.shape == (a.shape[0], w)
        oracle = _rounded(a, dtype_name) @ _rounded(B, dtype_name)
        np.testing.assert_allclose(_f(y), oracle, **tol(dtype_name))
        if dtype_name == "float32":  # the reference route sums bf16 in bf16, as JAX's does
            np.testing.assert_allclose(_f(tops.spmm(H, Bt)), oracle, **tol(dtype_name))
        Hw = _widened(Hj) if dtype_name == "float32" else dataclasses.replace(
            Hj, ell=jax_sell_widened(Hj.ell, dtype_name), coo=jax_sell_widened(Hj.coo,
                                                                               dtype_name))
        yj = jops._spmm_hyb(Hw, jnp.asarray(_f(Bt)))
        np.testing.assert_allclose(_f(y), np.asarray(yj, np.float32), **tol(dtype_name))


def test_reference_spmm_walks_wide_rhs_in_column_chunks(monkeypatch):
    """A chunk budget below one column gives the same Y: each column of Y
    depends on that column of B alone (a sum over a strided chunk may round
    in another order, hence the float32 tolerance)."""
    a, _, P = _pair("powerlaw", "CSR")
    B = _t(np.random.default_rng(26).standard_normal((a.shape[1], 11)).astype(np.float32))
    whole = {fmt: tops.spmm(_pair("powerlaw", fmt)[2], B) for fmt in FORMATS}
    monkeypatch.setattr(tops, "REF_CHUNK_ELEMS", 7)
    calls = []
    real = tops.by_columns

    def counting(fn, B, per_col):
        calls.append(B.shape[1])
        return real(fn, B, per_col)
    monkeypatch.setattr(tops, "by_columns", counting)
    for fmt, y in whole.items():
        torch.testing.assert_close(tops.spmm(_pair("powerlaw", fmt)[2], B), y,
                                   **tol("float32"))
    assert calls  # the formats with a per-entry product went through the chunker
    indptr, idx, val, m, _ = _csr_ragged(90, 27)
    X = _t(np.random.default_rng(28).standard_normal((5, 90)).astype(np.float32))
    chunked = csr_spmm_t_ref(_t(indptr), _t(idx), _t(val), X, m)
    monkeypatch.setattr(tops, "REF_CHUNK_ELEMS", 1 << 27)
    torch.testing.assert_close(chunked, csr_spmm_t_ref(_t(indptr), _t(idx), _t(val), X, m),
                               **tol("float32"))


def test_dispatch_of_spmm_and_spmm_t():
    a, _, P = _pair("random", "ELL")
    X = torch.ones(2, a.shape[1])
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tops.spmm_t(P, X, backend="cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tops.spmm(P, X.T.contiguous(), backend="cuda")
    assert torch.equal(tops.spmm_t(P, X, backend="auto"), tops.spmm_t(P, X, backend="ref"))
    assert torch.equal(tops.spmm(P, X.T, backend="auto"), tops.spmm(P, X.T, backend="ref"))
    with pytest.raises(ValueError, match="unknown backend"):
        tops.spmm(P, X.T, backend="pallas")
    D = DynamicMatrix(P)
    assert torch.equal(D.spmm_t(X), tops.spmm_t(P, X))
    assert torch.equal(D.spmm(X.T), tops.spmm(P, X.T))
    coo = tconv.to_coo(P)
    S = SwitchDynamicMatrix.build(coo, active=tf.Format.ELL)
    assert torch.equal(S.spmm_t(X), tops.spmm_t(S.variants[S.active_id], X))
    assert torch.equal(S.activate(tf.Format.CSR).spmm(X.T), tops.spmm(tconv.convert(
        coo, tf.Format.CSR), X.T))


def test_pending_spmm_kernels_raise_only_on_the_card():
    """No SpMM kernel is pending any more: ELL, SELL and HYB SpMM have their
    kernels beside CSR and BSR (on a CPU tensor each wrapper runs its plain
    version); COO, DIA and Dense run the reference on the card, as the JAX
    package has no kernel for them either."""
    a = PATTERNS["random"]()
    C = tf.coo_from_dense_np(a, device="cpu")
    assert not hasattr(kops, "SPMM_PENDING")
    assert set(kops.SPMM_CUDA) == {tf.BSR, tf.CSR, tf.ELL, tf.SELL, tf.HYB}
    assert set(kops.SPMM_T_CUDA) == {tf.CSR, tf.ELL, tf.HYB, tf.SELL, tf.BSR}
    B = _t(np.random.default_rng(30).standard_normal((a.shape[1], 3)).astype(np.float32))
    for fmt in ("ELL", "SELL", "HYB"):
        A = tconv.convert(C, tf.Format[fmt])
        np.testing.assert_allclose(kops.SPMM_CUDA[type(A)](A, B).numpy(),
                                   a.astype(np.float64) @ B.double().numpy(), **tol("float32"))
    for fmt in ("COO", "DIA", "DENSE"):
        assert tconv.convert(C, tf.Format[fmt]).__class__ not in kops.SPMM_CUDA


def test_spmm_wrappers_on_cpu_run_the_plain_version_uncounted():
    kops.reset_launches()
    a = PATTERNS["powerlaw"]()
    C = tf.coo_from_dense_np(a, capacity=1032, device="cpu")
    X = _t(np.random.default_rng(29).standard_normal((4, a.shape[1])).astype(np.float32))
    oracle = X.double().numpy() @ a.T
    for fmt in ("CSR", "ELL", "SELL", "HYB", "BSR"):
        A = tconv.convert(C, tf.Format[fmt], **FORMATS[fmt])
        np.testing.assert_allclose(kops.SPMM_T_CUDA[type(A)](A, X).numpy(), oracle,
                                   **tol("float32"))
    Cr = tconv.convert(C, tf.Format.CSR)
    assert torch.equal(kops.csr_spmm(Cr, X.T.contiguous()),
                       csr_spmm_ref(Cr.indptr, Cr.indices, Cr.data, X.T.contiguous(), 64))
    assert torch.equal(kcm.csr_spmm(Cr.indptr, Cr.indices, Cr.data, X.T.contiguous(), 64,
                                    vec=4), kops.csr_spmm(Cr, X.T.contiguous()))
    assert torch.equal(kcm.csr_spmm_t(Cr.indptr, Cr.indices, Cr.data, X, 64, vec=8, tt=4),
                       csr_spmm_t_ref(Cr.indptr, Cr.indices, Cr.data, X, 64))
    assert all(v == 0 for v in kops.launch_counts().values())
    assert set(kops.launch_counts()) >= {"csr_spmm", "csr_spmm_t", "ell_spmm", "ell_spmm_t",
                                         "sell_spmm", "sell_spmm_t"}
    with pytest.raises(ValueError, match="cuda or cpu"):
        kem.ell_spmm_t(torch.zeros(2, 1, dtype=torch.int32, device="meta"),
                       torch.zeros(2, 1, device="meta"), torch.zeros(1, 3, device="meta"),
                       vec=2, tt=1)


def test_spmm_wrapper_argument_checks():
    ip = torch.tensor([0, 2, 3], dtype=torch.int32)
    ix = torch.tensor([0, 4, 1], dtype=torch.int32)
    v = torch.ones(3)
    X = torch.ones(4, 5)
    kcm._check(ip, ix, v, X, 2, "X", 1)
    with pytest.raises(ValueError, match="m\\+1"):
        kcm._check(ip, ix, v, X, 3, "X", 1)
    with pytest.raises(ValueError, match="2-D and contiguous"):
        kcm._check(ip, ix, v, X.t(), 2, "X", 1)
    with pytest.raises(ValueError, match="share dtype"):
        kcm._check(ip, ix, v, X.bfloat16(), 2, "X", 1)
    with pytest.raises(ValueError, match="int32"):
        kcm._check(ip.long(), ix, v, X, 2, "X", 1)
    cols = torch.zeros(3, 2, dtype=torch.int32)
    kem._check(cols, torch.ones(3, 2), X, 8, 4)
    with pytest.raises(ValueError, match="vec must be"):
        kem._check(cols, torch.ones(3, 2), X, 3, 4)
    with pytest.raises(ValueError, match="differ"):
        kem._check(cols, torch.ones(3, 3), X, 8, 4)
    with pytest.raises(ValueError, match="2-D \\(T, N\\)"):
        kem._check(cols, torch.ones(3, 2), torch.ones(5), 8, 4)
    ptrs = torch.tensor([0, 4], dtype=torch.int32)
    perm = torch.tensor([0, 1, 2, 2], dtype=torch.int32)
    ksm._check(ptrs, torch.zeros(4, dtype=torch.int32), torch.ones(4), perm, X, 3, 4, 8)
    with pytest.raises(ValueError, match="tt must be"):
        ksm._check(ptrs, torch.zeros(4, dtype=torch.int32), torch.ones(4), perm, X, 3, 4, 3)
    with pytest.raises(ValueError, match="slice height"):
        ksm._check(ptrs, torch.zeros(4, dtype=torch.int32), torch.ones(4), perm, X, 3, 2048, 8)
    with pytest.raises(ValueError, match="perm must have"):
        ksm._check(ptrs, torch.zeros(4, dtype=torch.int32), torch.ones(4), perm, X, 5, 4, 8)


def test_spmm_t_config_takes_up_to_eight_tokens_a_block():
    assert [kcm.token_tile(t) for t in (1, 2, 3, 5, 8, 9, 256)] == [1, 2, 4, 8, 8, 8, 8]
    assert kcm.MAX_TOKEN_TILE == max(kcm.TOKEN_TILES)
    C = tf.CSR(torch.zeros(101, dtype=torch.int32), torch.zeros(102400, dtype=torch.int32),
               torch.zeros(102400), (100, 4096), 102400)
    assert kops.default_config(C, op="spmm_t", ncols=256) == {"vec": 32, "tt": 8, "xt": 128}
    assert kops.default_config(C, op="spmm_t", ncols=3) == {"vec": 32, "tt": 4}
    assert kops.default_config(C, op="spmm", ncols=256) == {"vec": 32, "xt": 128}
    assert kops.default_config(C, op="spmm", ncols=8) == {"vec": 32}
    E = tf.ELL(torch.zeros(100, 20, dtype=torch.int32), torch.zeros(100, 20), (100, 64), 2000)
    assert kops.default_config(E, op="spmm_t", ncols=1) == {"vec": 4, "tt": 1}
    assert kops.default_config(E, op="spmm", ncols=1) == {"vec": 4}
    a = PATTERNS["powerlaw"]()
    A = tf.coo_from_dense_np(a, device="cpu")
    assert kops.default_config(tconv.convert(A, tf.Format.SELL), op="spmm_t", ncols=2) == \
        {"tt": 2}
    cfg = kops.default_config(tconv.convert(A, tf.Format.HYB), op="spmm_t", ncols=256)
    assert set(cfg) == {"ell", "csr"} and cfg["csr"]["vec"] in kcm.VEC_WIDTHS
    assert cfg["csr"]["tt"] == cfg["ell"]["tt"] == 8
    assert cfg["csr"]["xt"] == cfg["ell"]["xt"] == 128


@pytest.mark.parametrize("t,xt", [(1, 0), (8, 0), (31, 0), (32, 32), (63, 32), (64, 64),
                                  (127, 64), (128, 128), (256, 128), (257, 128)])
def test_spmm_t_config_picks_its_schedule_from_t(t, xt):
    """The row schedule below 32 tokens (no ``xt`` key), else the largest
    token-major tile <= T; CSR, ELL and both HYB parts alike, SELL from
    ``SELL_XT_FROM`` tokens (its slice kernel ran faster at T = 32). For
    Y = A @ B at Kb = t, ELL (and HYB's ELL part) the same; CSR and SELL
    the same (above ``AB_XT_MIN_DENSITY``) where they do not take the
    dense-tile schedule (``tc_tile``), HYB's CSR tail never."""
    assert kcm.xt_tile(t) == xt
    a = PATTERNS["powerlaw"]()
    A = tf.coo_from_dense_np(a, device="cpu")
    for fmt in ("CSR", "ELL", "SELL"):
        want = xt if fmt != "SELL" or t >= kops.SELL_XT_FROM else 0
        cfg = kops.default_config(tconv.convert(A, tf.Format[fmt]), op="spmm_t", ncols=t)
        assert cfg.get("xt", 0) == want and ("xt" in cfg) == bool(want)
        assert kops._xt(cfg) == want
    hyb = kops.default_config(tconv.convert(A, tf.Format.HYB), op="spmm_t", ncols=t)
    assert kops._xt(hyb["ell"]) == kops._xt(hyb["csr"]) == xt
    ell = kops.default_config(tconv.convert(A, tf.Format.ELL), op="spmm", ncols=t)
    assert ell.get("xt", 0) == xt and ("xt" in ell) == bool(xt)
    hyb = kops.default_config(tconv.convert(A, tf.Format.HYB), op="spmm", ncols=t)
    assert kops._xt(hyb["ell"]) == xt and "xt" not in hyb["csr"]
    assert "xt" not in kops.default_config(tconv.convert(A, tf.Format.CSR), op="spmv", ncols=t)
    for fmt in ("CSR", "SELL"):
        M = tconv.convert(A, tf.Format[fmt])
        cfg = kops.default_config(M, op="spmm", ncols=t)
        tc = kops.tc_tile(M, t)
        assert cfg.get("tc", 0) == tc and ("tc" in cfg) == bool(tc)
        assert kops._xt(cfg) == (0 if tc else xt)  # the pattern's density 0.14


@pytest.mark.parametrize("bad", [48, -1, 1, 256, True, 64.0, "64", None])
def test_spmm_t_wrappers_reject_a_bad_xt_before_any_launch(bad):
    """``check_xt`` is the wrappers' first step, whatever the device: a knob
    the kernels do not take raises before any check or launch, also on the
    CPU (where a valid knob runs the plain version, uncounted)."""
    with pytest.raises(ValueError, match="xt must be"):
        kcm.check_xt(bad)
    ip = torch.tensor([0, 2, 3], dtype=torch.int32)
    ix = torch.tensor([0, 4, 1], dtype=torch.int32)
    X = torch.ones(4, 5)
    kops.reset_launches()
    with pytest.raises(ValueError, match="xt must be"):
        kcm.csr_spmm_t(ip, ix, torch.ones(3), X, 2, vec=4, xt=bad)
    with pytest.raises(ValueError, match="xt must be"):
        kem.ell_spmm_t(torch.zeros(3, 2, dtype=torch.int32), torch.ones(3, 2), X, vec=4, xt=bad)
    with pytest.raises(ValueError, match="xt must be"):  # a meta tensor: no device at all
        kem.ell_spmm_t(torch.zeros(2, 1, dtype=torch.int32, device="meta"),
                       torch.zeros(2, 1, device="meta"), torch.zeros(1, 3, device="meta"),
                       vec=2, xt=bad)
    for xt in (0,) + kcm.XT_TILES:
        assert kcm.check_xt(xt) == xt
        assert torch.equal(kcm.csr_spmm_t(ip, ix, torch.ones(3), X, 2, vec=4, xt=xt),
                           csr_spmm_t_ref(ip, ix, torch.ones(3), X, 2))
    assert all(v == 0 for v in kops.launch_counts().values())
    assert kcm.launches_xt == kem.launches_xt == 0


@pytest.mark.parametrize("bad", [48, -1, 1, 256, True, 64.0, "64", None])
def test_sell_spmm_t_and_ell_spmm_reject_a_bad_xt_before_any_launch(bad):
    """The two wrappers that gained ``xt`` check it first too, on any
    device; a valid knob on the CPU runs the plain version, uncounted."""
    ptrs = torch.tensor([0, 4], dtype=torch.int32)
    cols = torch.tensor([0, 1, 2, -1], dtype=torch.int32)
    perm = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    X, B = torch.ones(4, 5), torch.ones(5, 4)
    ecols = torch.zeros(3, 2, dtype=torch.int32)
    kops.reset_launches()
    with pytest.raises(ValueError, match="xt must be"):
        ksm.sell_spmm_t(ptrs, cols, torch.ones(4), perm, X, 4, 4, xt=bad)
    with pytest.raises(ValueError, match="xt must be"):
        kem.ell_spmm(ecols, torch.ones(3, 2), B, vec=4, xt=bad)
    with pytest.raises(ValueError, match="xt must be"):  # a meta tensor: no device at all
        kem.ell_spmm(ecols.to("meta"), torch.zeros(3, 2, device="meta"),
                     torch.zeros(5, 4, device="meta"), vec=2, xt=bad)
    with pytest.raises(ValueError, match="xt must be"):
        ksm.sell_spmm_t(ptrs.to("meta"), cols.to("meta"), torch.zeros(4, device="meta"),
                        perm.to("meta"), torch.zeros(4, 5, device="meta"), 4, 4, xt=bad)
    for xt in (0,) + kcm.XT_TILES:
        assert torch.equal(ksm.sell_spmm_t(ptrs, cols, torch.ones(4), perm, X, 4, 4, xt=xt),
                           sell_spmm_t_ref(ptrs, cols, torch.ones(4), perm, X, 4, 4))
        assert torch.equal(kem.ell_spmm(ecols, torch.ones(3, 2), B, vec=4, xt=xt),
                           ell_spmm_ref(ecols, torch.ones(3, 2), B))
    assert all(v == 0 for v in kops.launch_counts().values())
    assert ksm.launches_xt == kem.launches_kxt == 0


def test_spmm_t_entry_points_pass_xt_and_read_a_missing_knob_as_the_row_schedule(
        monkeypatch, tmp_path):
    """``kernels.ops`` hands the wrappers the cfg's ``xt``; a cfg (or a
    record) without the knob means the row schedule, 0, in CSR, ELL and both
    parts of HYB; the default at T = 256 is the token-major one."""
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "empty.json"))
    seen = []

    def spy(real):
        def fn(*a, **kw):
            seen.append(kw["xt"])
            return real(*a, **kw)
        return fn
    monkeypatch.setattr(kcm, "csr_spmm_t", spy(kcm.csr_spmm_t))
    monkeypatch.setattr(kem, "ell_spmm_t", spy(kem.ell_spmm_t))
    a = PATTERNS["powerlaw"]()
    A = tf.coo_from_dense_np(a, device="cpu")
    X = _t(np.random.default_rng(31).standard_normal((256, a.shape[1])).astype(np.float32))
    oracle = X.double().numpy() @ a.T
    for fmt, old in (("CSR", {"vec": 8, "tt": 4}), ("ELL", {"vec": 8, "tt": 4}),
                     ("HYB", {"ell": {"vec": 8, "tt": 4}, "csr": {"vec": 4, "tt": 8}})):
        H = tconv.convert(A, tf.Format[fmt])
        fn = kops.SPMM_T_CUDA[type(H)]
        for cfg, want in ((old, 0), (None, 128), (kops.default_config(H, op="spmm_t", ncols=64),
                                                  64)):
            seen.clear()
            np.testing.assert_allclose(fn(H, X, cfg=cfg).numpy(), oracle, **tol("float32"))
            assert seen == [want] * (2 if fmt == "HYB" else 1), (fmt, cfg, seen)


def test_sell_spmm_t_and_ell_spmm_entry_points_pass_xt(monkeypatch, tmp_path):
    """``kernels.ops`` hands SELL SpMM_T and ELL SpMM (HYB's ELL part too)
    the cfg's ``xt``; a cfg or record without it means the old schedule, 0;
    the default at width 256 is the token-major tile 128. HYB's CSR tail
    takes no ``xt`` in Y = A @ B."""
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "empty.json"))
    seen = []

    def spy(real):
        def fn(*a, **kw):
            seen.append(kw["xt"])
            return real(*a, **kw)
        return fn
    monkeypatch.setattr(ksm, "sell_spmm_t", spy(ksm.sell_spmm_t))
    monkeypatch.setattr(kem, "ell_spmm", spy(kem.ell_spmm))
    a = PATTERNS["powerlaw"]()
    A = tf.coo_from_dense_np(a, device="cpu")
    rng = np.random.default_rng(34)
    X = _t(rng.standard_normal((256, a.shape[1])).astype(np.float32))
    B = _t(rng.standard_normal((a.shape[1], 256)).astype(np.float32))
    cases = (("SELL", "spmm_t", X, X.double().numpy() @ a.T, {"tt": 4}),
             ("ELL", "spmm", B, a @ B.double().numpy(), {"vec": 8}),
             ("HYB", "spmm", B, a @ B.double().numpy(), {"ell": {"vec": 8}, "csr": {"vec": 4}}))
    for fmt, op, rhs, oracle, old in cases:
        H = tconv.convert(A, tf.Format[fmt], **FORMATS[fmt])
        fn = kops.cuda_registry(op)[type(H)]
        for cfg, want in ((old, 0), (None, 128),
                          (kops.default_config(H, op=op, ncols=64), 64)):
            seen.clear()
            np.testing.assert_allclose(fn(H, rhs, cfg=cfg).numpy(), oracle, **tol("float32"))
            assert seen == [want], (fmt, cfg, seen)


@pytest.mark.parametrize("dtype_name", DTYPE_NAMES)
@pytest.mark.parametrize("xt", [0, 32, 128])
def test_sell_spmm_t_and_ell_spmm_plain_match_jax_with_and_without_xt(xt, dtype_name):
    """On the CPU the entry points run the plain versions whatever the cfg
    says: SELL SpMM_T against ``repro.core.ops.spmm_t(backend="ref")`` and
    ELL SpMM against ``repro.core.ops._spmm_ell`` on the same containers
    (bf16 JAX sums in bf16: it gets the values widened to f32), within
    ``tests/test_kernels.py::_tol``."""
    rng = np.random.default_rng(35)
    for pattern in ("powerlaw", "random"):
        a = PATTERNS[pattern]()
        m, n = a.shape
        Jc, _ = coo_pair(a)
        X = _t(rng.standard_normal((40, n)).astype(np.float32), dtype_name)
        B = _t(rng.standard_normal((n, 40)).astype(np.float32), dtype_name)
        for fmt, op in (("SELL", "spmm_t"), ("ELL", "spmm")):
            Jf = jconv.convert(Jc, jf.Format[fmt], **FORMATS[fmt])
            P = port_from_jax(Jf)
            P = dataclasses.replace(P, data=P.data.to(TORCH_DTYPES[dtype_name]))
            cfg = kops.default_config(P, op=op, ncols=40)
            cfg = {k: v for k, v in cfg.items() if k != "xt"}
            if xt:
                cfg["xt"] = xt
            y = kops.cuda_registry(op)[type(P)](P, X if op == "spmm_t" else B, cfg=cfg)
            assert y.dtype == TORCH_DTYPES[dtype_name]
            Jw = dataclasses.replace(Jf, data=jnp.asarray(_f(P.data)))
            if op == "spmm_t":
                yj = jops.spmm_t(Jw, jnp.asarray(_f(X)), backend="ref")
                oracle = _f(X).astype(np.float64) @ _rounded(a, dtype_name).T
            else:
                yj = jops._spmm_ell(Jw, jnp.asarray(_f(B)))
                oracle = _rounded(a, dtype_name) @ _f(B).astype(np.float64)
            np.testing.assert_allclose(_f(y), np.asarray(yj, np.float32), **tol(dtype_name))
            np.testing.assert_allclose(_f(y), oracle, **tol(dtype_name))


# Y = A @ B of CSR and SELL: three schedules, picked by ``xt`` (token-major)
# and ``tc`` (dense tiles on the tensor cores) from host ints only.
UP_WEIGHT = (16384, 4096)  # the minitron-8b up weight as stored (rows, cols)


def _shaped(fmt, m, n, nnz, dtype):
    """A CSR or SELL container holding only the host metadata that
    ``default_config`` reads (shape, nnz, dtype)."""
    i32 = torch.int32
    if fmt == "CSR":
        return tf.CSR(torch.zeros(m + 1, dtype=i32), torch.zeros(1, dtype=i32),
                      torch.zeros(1, dtype=dtype), (m, n), nnz)
    return tf.SELL(torch.zeros(1, dtype=i32), torch.zeros(1, dtype=dtype),
                   torch.zeros(32, dtype=i32), torch.zeros(2, dtype=i32), (m, n), nnz, 32, 256)


@pytest.mark.parametrize("fmt", ["CSR", "SELL"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kb", [1, 8, 32, 64, 256])
@pytest.mark.parametrize("density", [0.25, 0.05, 2.4e-5], ids=["d0.25", "d0.05", "hpcg"])
def test_ab_config_takes_its_schedule_from_width_and_density(fmt, dtype, kb, density):
    """The dense-tile schedule from ``TC_FROM`` columns at a density of at
    least ``TC_MIN_DENSITY`` of the dtype (never where that is None, at
    Kb <= 8 or at HPCG's 2.4e-5) on the up weight's 256 row tiles;
    otherwise the token-major tile from 32 columns at a density of at least
    ``AB_XT_MIN_DENSITY``, else the row schedule."""
    m, n = UP_WEIGHT
    A = _shaped(fmt, m, n, int(density * m * n), dtype)
    cfg = kops.default_config(A, op="spmm", ncols=kb)
    least = kops.TC_MIN_DENSITY[dtype]
    takes_tc = kb >= kops.TC_FROM and least is not None and density >= least
    assert cfg.get("tc", 0) == (128 if takes_tc else 0)
    takes_xt = not takes_tc and density >= kops.AB_XT_MIN_DENSITY
    assert cfg.get("xt", 0) == (kcm.xt_tile(kb) if takes_xt else 0)
    assert not ({"xt", "tc"} <= set(cfg))  # one schedule
    if kb <= 8 or density < 1e-3:
        assert "tc" not in cfg and "xt" not in cfg
    assert kops.tc_tile(A, kb) == cfg.get("tc", 0)
    for op in ("spmv", "spmm_t"):
        assert "tc" not in kops.default_config(A, op=op, ncols=kb)


def test_tc_tile_needs_enough_row_tiles_and_a_dtype_that_pays():
    """The up weight (256 row tiles) takes the dense-tile schedule in a dtype
    with a density threshold; the down weight (64 row tiles) and float32
    (None) never; HYB's CSR tail takes neither knob."""
    bf = torch.bfloat16
    assert kops.TC_MIN_DENSITY[torch.float32] is None
    up = _shaped("CSR", *UP_WEIGHT, 16777219, bf)
    down = _shaped("CSR", 4096, 16384, 16777217, bf)
    assert kops.tc_tile(up, 256) == 128 and kops.tc_tile(down, 256) == 0
    assert kops.tc_tile(_shaped("CSR", *UP_WEIGHT, 16777219, torch.float32), 256) == 0
    assert kops.tc_tile(up, kops.TC_FROM) == 128 and kops.tc_tile(up, kops.TC_FROM - 1) == 0
    A = tf.coo_from_dense_np(PATTERNS["stencil"](), device="cpu")
    hyb = kops.default_config(tconv.convert(A, tf.Format.HYB), op="spmm", ncols=256)
    assert set(hyb["csr"]) == {"vec"}


@pytest.mark.parametrize("bad", [{"tc": 32}, {"tc": 64}, {"tc": -1}, {"tc": 1}, {"tc": True},
                                 {"tc": 128.0}, {"tc": "128"}, {"tc": None},
                                 {"xt": 32, "tc": 128}, {"xt": 48}],
                         ids=lambda b: "-".join(f"{k}{v!r}" for k, v in b.items()))
def test_ab_wrappers_reject_a_bad_knob_before_any_launch(bad):
    """``check_ab_schedule`` is the first step of ``csr_spmm`` and
    ``sell_spmm`` on any device: a knob the kernels do not take, or two
    schedules at once, raises before any check or launch; a valid knob on
    the CPU runs the plain version, uncounted."""
    if "xt" not in bad:
        with pytest.raises(ValueError, match="tc must be"):
            kcm.check_tc(bad["tc"])
    ip = torch.tensor([0, 2, 3], dtype=torch.int32)
    ix = torch.tensor([0, 4, 1], dtype=torch.int32)
    ptrs = torch.tensor([0, 4], dtype=torch.int32)
    cols = torch.tensor([0, 1, 2, -1], dtype=torch.int32)
    perm = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    B = torch.ones(5, 4)
    kops.reset_launches()
    with pytest.raises(ValueError, match="must be|two schedules"):
        kcm.csr_spmm(ip, ix, torch.ones(3), B, 2, vec=4, **bad)
    with pytest.raises(ValueError, match="must be|two schedules"):
        ksm.sell_spmm(ptrs, cols, torch.ones(4), perm, B, 4, 4, **bad)
    with pytest.raises(ValueError, match="must be|two schedules"):  # a meta tensor: no device
        kcm.csr_spmm(ip.to("meta"), ix.to("meta"), torch.zeros(3, device="meta"),
                     torch.zeros(5, 4, device="meta"), 2, vec=4, **bad)
    for knob in [{}] + [{"xt": x} for x in kcm.XT_TILES] + [{"tc": t} for t in kcm.TC_TILES]:
        assert torch.equal(kcm.csr_spmm(ip, ix, torch.ones(3), B, 2, vec=4, **knob),
                           csr_spmm_ref(ip, ix, torch.ones(3), B, 2))
        assert torch.equal(ksm.sell_spmm(ptrs, cols, torch.ones(4), perm, B, 4, 4, **knob),
                           sell_spmm_ref(ptrs, cols, torch.ones(4), perm, B, 4, 4))
    assert all(v == 0 for v in kops.launch_counts().values())
    assert kcm.launches_kxt == kcm.launches_tc == ksm.launches_kxt == ksm.launches_tc == 0


def test_ab_entry_points_pass_xt_and_tc(monkeypatch, tmp_path):
    """``kernels.ops`` hands CSR and SELL SpMM the cfg's ``xt`` and ``tc``:
    a cfg or record without them means the row schedule; the default on this
    64-row pattern (too few row tiles for ``tc``) is the token-major tile of
    the width; HYB's CSR tail gets neither."""
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "empty.json"))
    seen = []

    def spy(real):
        def fn(*a, **kw):
            seen.append((kw.get("xt", 0), kw.get("tc", 0)))
            return real(*a, **kw)
        return fn
    monkeypatch.setattr(kcm, "csr_spmm", spy(kcm.csr_spmm))
    monkeypatch.setattr(ksm, "sell_spmm", spy(ksm.sell_spmm))
    a = PATTERNS["powerlaw"]()
    A = tf.coo_from_dense_np(a, device="cpu")
    rng = np.random.default_rng(36)
    for fmt, row in (("CSR", {"vec": 8}), ("SELL", {})):
        M = tconv.convert(A, tf.Format[fmt])
        for width, cfg, want in ((256, row, (0, 0)), (256, None, (128, 0)),
                                 (256, dict(row, xt=64), (64, 0)),
                                 (256, dict(row, tc=128), (0, 128)),
                                 (32, None, (32, 0))):
            B = _t(rng.standard_normal((a.shape[1], width)).astype(np.float32))
            seen.clear()
            y = kops.SPMM_CUDA[type(M)](M, B, cfg=cfg)
            np.testing.assert_allclose(y.numpy(), a @ B.double().numpy(), **tol("float32"))
            assert seen == [want], (fmt, width, cfg, seen)
    H = tconv.convert(A, tf.Format.HYB, **FORMATS["HYB"])
    seen.clear()
    kops.hyb_spmm(H, _t(rng.standard_normal((a.shape[1], 256)).astype(np.float32)))
    assert seen == [(0, 0)]  # the CSR tail keeps the row schedule


@pytest.mark.parametrize("dtype_name", DTYPE_NAMES)
@pytest.mark.parametrize("knob", [{}, {"xt": 32}, {"xt": 64}, {"xt": 128}, {"tc": 128}],
                         ids=["row", "xt32", "xt64", "xt128", "tc128"])
def test_csr_and_sell_spmm_plain_match_jax_with_every_schedule(knob, dtype_name):
    """On the CPU the entry points run the plain versions whatever the cfg
    says: CSR and SELL SpMM against ``repro.core.ops.spmm(backend="ref")``
    on the same containers (bf16 JAX sums in bf16: it gets the values
    widened to f32) and the float64 oracle, within
    ``tests/test_kernels.py::_tol``."""
    rng = np.random.default_rng(37)
    for pattern in ("powerlaw", "random"):
        a = PATTERNS[pattern]()
        Jc, _ = coo_pair(a)
        B = _t(rng.standard_normal((a.shape[1], 40)).astype(np.float32), dtype_name)
        for fmt in ("CSR", "SELL"):
            Jf = jconv.convert(Jc, jf.Format[fmt], **FORMATS[fmt])
            P = port_from_jax(Jf)
            P = dataclasses.replace(P, data=P.data.to(TORCH_DTYPES[dtype_name]))
            cfg = dict({"vec": 8} if fmt == "CSR" else {}, **knob)
            y = kops.SPMM_CUDA[type(P)](P, B, cfg=cfg)
            assert y.dtype == TORCH_DTYPES[dtype_name]
            Jw = dataclasses.replace(Jf, data=jnp.asarray(_f(P.data)))
            yj = jops.spmm(Jw, jnp.asarray(_f(B)), backend="ref")
            np.testing.assert_allclose(_f(y), np.asarray(yj, np.float32), **tol(dtype_name))
            np.testing.assert_allclose(_f(y), _rounded(a, dtype_name) @ _f(B).astype(np.float64),
                                       **tol(dtype_name))


# Stand-ins with the SpMM entry points' C signatures: each records its
# arguments so the test sees them arrive at full width (a pointer declared
# as a C int would be cut to 32 bits).
_STANDIN = """
#include <stdint.h>
static int64_t seen[16];
int64_t standin_seen(int i) {{ return seen[i]; }}
const char* {lib}_error_string(int code) {{ return code ? "stand-in error" : "ok"; }}
int {symbol}({params}) {{ {record} return 7; }}
"""
_SIGNATURES = {
    ("csr_spmm", "csr_spmm_f32", "_fn"): [
        "const void* indptr", "const void* indices", "const void* data", "const void* b",
        "void* y", "int64_t m", "int32_t n", "int64_t k", "int vec", "int device",
        "void* stream"],
    ("csr_spmm", "csr_spmm_t_f32", "_fn_t"): [
        "const void* indptr", "const void* indices", "const void* data", "const void* x",
        "void* y", "int64_t m", "int32_t n", "int64_t t", "int vec", "int tt", "int device",
        "void* stream"],
    ("ell_spmm", "ell_spmm_f32", "_fn"): [
        "const void* cols", "const void* data", "const void* b", "void* y", "int64_t m",
        "int32_t n", "int32_t k", "int64_t kb", "int vec", "int device", "void* stream"],
    ("ell_spmm", "ell_spmm_t_f32", "_fn_t"): [
        "const void* cols", "const void* data", "const void* x", "void* y", "int64_t m",
        "int32_t n", "int32_t k", "int64_t t", "int vec", "int tt", "int device",
        "void* stream"],
    ("csr_spmm", "csr_spmm_xt_f32", "_fn_xt"): [
        "const void* indptr", "const void* indices", "const void* data", "const void* x",
        "void* xt_scratch", "void* y", "int64_t m", "int32_t n", "int64_t t", "int xt",
        "int device", "void* stream"],
    ("ell_spmm", "ell_spmm_xt_f32", "_fn_xt"): [
        "const void* cols", "const void* data", "const void* x", "void* xt_scratch", "void* y",
        "int64_t m", "int32_t n", "int32_t k", "int64_t t", "int xt", "int device",
        "void* stream"],
    ("sell_spmm", "sell_spmm_f32", "_fn"): [
        "const void* ptrs", "const void* cols", "const void* data", "const void* perm",
        "const void* b", "void* y", "int64_t lanes", "int32_t c", "int64_t m", "int32_t n",
        "int64_t k", "int threads", "int stage", "int split", "int64_t per", "int device",
        "void* stream"],
    ("sell_spmm", "sell_spmm_t_f32", "_fn_t"): [
        "const void* ptrs", "const void* cols", "const void* data", "const void* perm",
        "const void* x", "void* y", "int64_t lanes", "int32_t c", "int64_t m", "int32_t n",
        "int64_t t", "int tt", "int threads", "int stage", "int split", "int64_t per",
        "int device", "void* stream"],
    ("sell_spmm", "sell_spmm_xt_f32", "_fn_xt"): [
        "const void* ptrs", "const void* cols", "const void* data", "const void* perm",
        "const void* x", "void* xt_scratch", "void* pcols", "void* pdata", "void* y",
        "int64_t capacity", "int64_t lanes", "int32_t c", "int64_t m", "int32_t n",
        "int64_t t", "int xt", "int device", "void* stream"],
    ("csr_spmm", "csr_spmm_kxt_f32", "_fn_kxt"): [
        "const void* indptr", "const void* indices", "const void* data", "const void* b",
        "void* b_scratch", "void* y", "int64_t m", "int32_t n", "int64_t kb", "int xt",
        "int device", "void* stream"],
    ("csr_spmm", "csr_spmm_tc_f32", "_fn_tc"): [
        "const void* indptr", "const void* indices", "const void* data", "const void* b",
        "void* b_scratch", "void* y", "int64_t m", "int32_t n", "int64_t kb", "int tc",
        "int device", "void* stream"],
    ("sell_spmm", "sell_spmm_kxt_f32", "_fn_kxt"): [
        "const void* ptrs", "const void* cols", "const void* data", "const void* perm",
        "const void* b", "void* b_scratch", "void* pcols", "void* pdata", "void* y",
        "int64_t capacity", "int64_t lanes", "int32_t c", "int64_t m", "int32_t n",
        "int64_t kb", "int xt", "int device", "void* stream"],
    ("sell_spmm", "sell_spmm_tc_f32", "_fn_tc"): [
        "const void* ptrs", "const void* cols", "const void* data", "const void* perm",
        "const void* b", "void* b_scratch", "void* pcols", "void* pdata", "void* y",
        "int64_t capacity", "int64_t lanes", "int32_t c", "int64_t m", "int32_t n",
        "int64_t kb", "int tc", "int device", "void* stream"],
    ("ell_spmm", "ell_spmm_kxt_f32", "_fn_kxt"): [
        "const void* cols", "const void* data", "const void* b", "void* b_scratch", "void* y",
        "int64_t m", "int32_t n", "int32_t k", "int64_t kb", "int xt", "int device",
        "void* stream"],
}


@pytest.mark.parametrize("key", sorted(_SIGNATURES), ids=lambda k: k[1])
def test_spmm_ctypes_bindings_pass_arguments_at_full_width(key, tmp_path, monkeypatch):
    import shutil
    import subprocess
    if shutil.which("gcc") is None:
        pytest.skip("needs a C compiler for the stand-in library")
    lib_name, symbol, getter = key
    monkeypatch.setenv(_build.BUILD_ENV, str(tmp_path / "out"))
    params = _SIGNATURES[key]
    record = " ".join(f"seen[{i}] = (int64_t){p.split()[-1]};" for i, p in enumerate(params))
    src = tmp_path / f"{lib_name}.c"
    src.write_text(_STANDIN.format(lib=lib_name, symbol=symbol, params=", ".join(params),
                                   record=record))
    lib = _build._lib_path(lib_name)
    lib.parent.mkdir(parents=True)
    subprocess.run(["gcc", "-shared", "-fPIC", "-o", str(lib), str(src)], check=True)
    monkeypatch.setattr(_build, "_LIBS", {})
    fn_of = getattr(kops.KERNELS[lib_name], getter)
    fn_of.cache_clear()
    try:
        fn, err_str = fn_of(torch.float32)
        args = [0x7FFF_1234_5678 + 16 * i for i in range(len(params))]
        for i, p in enumerate(params):
            if not p.startswith(("const void*", "void*")):
                args[i] = 2 ** 33 + 5 if p.startswith("int64_t") else 1000 + i
        assert fn(*args) == 7 and err_str(7) == b"stand-in error"
        seen = _build.load(lib_name).standin_seen
        seen.restype = ctypes.c_int64
        assert [seen(i) for i in range(len(params))] == args
    finally:
        fn_of.cache_clear()


def test_headers_are_part_of_the_build_key(tmp_path, monkeypatch):
    """An edited shared header changes every library's build directory."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a", "b"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    (csrc / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    keys = {n: _build._key([n]) for n in ("a", "b")}
    (csrc / "common.cuh").write_text("// v2\n")
    assert all(_build._key([n]) != k for n, k in keys.items())
    assert set(_build.headers()) == {"common.cuh"}
    assert set(_build.sources()) == {"a", "b"}


def test_each_source_names_its_kernels_and_int64_offsets():
    srcs = _build.sources()
    for name, kernels in (("csr_spmm", ("csr_spmm", "csr_spmm_t")),
                          ("ell_spmm", ("ell_spmm", "ell_spmm_t")),
                          ("sell_spmm", ("sell_spmm", "sell_spmm_t"))):
        text = srcs[name].read_text()
        for k in kernels:
            assert f"int {k}_f32(" in text and f"int {k}_bf16(" in text
        assert "What bounds it on an H100: bytes at T = 1" in text and "int64" in text
    # the SELL kernel copies its token tile into shared memory; CSR and ELL
    # stage XT chunks on the token-major schedule, in the shared header
    assert "stage_x" in srcs["sell_spmm"].read_text()
    common = _build.headers()["spmm_common.cuh"].read_text()
    assert "stage_xt" in common and "tokens_spmm_t" in common and "rows_spmm_t" in common
    for name in ("csr_spmm", "ell_spmm", "sell_spmm"):
        text = srcs[name].read_text()
        assert f"int {name}_xt_f32(" in text and f"int {name}_xt_bf16(" in text
    for name in ("ell_spmm", "csr_spmm", "sell_spmm"):
        text = srcs[name].read_text()
        assert f"int {name}_kxt_f32(" in text and f"int {name}_kxt_bf16(" in text
    for name in ("csr_spmm", "sell_spmm"):  # the dense-tile schedule
        text = srcs[name].read_text()
        assert f"int {name}_tc_f32(" in text and f"int {name}_tc_bf16(" in text
        assert "tiles_spmm_launch" in text and "tiles_spmm_ab" in text
    assert "tiles_spmm_ab" in common and "mma.sync" in common and "3xTF32" in common
    assert "bool AB" in common
    assert "SellRows" in srcs["sell_spmm"].read_text()
    assert "repack_slices" in srcs["sell_spmm"].read_text()
