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
    assert kops.default_config(C, op="spmm_t", ncols=256) == {"vec": 32, "tt": 8}
    assert kops.default_config(C, op="spmm_t", ncols=3) == {"vec": 32, "tt": 4}
    assert kops.default_config(C, op="spmm", ncols=256) == {"vec": 32}
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
    ("sell_spmm", "sell_spmm_f32", "_fn"): [
        "const void* ptrs", "const void* cols", "const void* data", "const void* perm",
        "const void* b", "void* y", "int64_t lanes", "int32_t c", "int64_t m", "int32_t n",
        "int64_t k", "int device", "void* stream"],
    ("sell_spmm", "sell_spmm_t_f32", "_fn_t"): [
        "const void* ptrs", "const void* cols", "const void* data", "const void* perm",
        "const void* x", "void* y", "int64_t lanes", "int32_t c", "int64_t m", "int32_t n",
        "int64_t t", "int tt", "int device", "void* stream"],
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
    # only the SELL kernel copies its token tile into shared memory
    assert "stage_x" in srcs["sell_spmm"].read_text()
    assert "stage" not in _build.headers()["spmm_common.cuh"].read_text()
