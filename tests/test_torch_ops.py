"""The PyTorch port's reference ops against the JAX package's jnp paths.

Every ``_spmv_*`` (reached through ``spmv(..., backend="ref")``) is held
against JAX's ``spmv(..., backend="ref")`` on the same container and
against a dense float64 oracle, at the tolerances of
``tests/test_kernels.py::_tol``. Diagonal extract/update, the row-id
helpers and the BLAS-1 ops are held against JAX too.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core.formats as jf
import repro.core.ops as jops
import repro_torch.core.formats as tf
import repro_torch.core.ops as tops
from repro_torch.kernels import ops as kops
from repro_torch.obs import metrics
from repro.core import Format as JFormat
from torch_parity import CAP, PATTERNS, jconv, port_from_jax, tol
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

SPMV_FORMATS = ["COO", "CSR", "DIA", "ELL", "BSR", "DENSE", "HYB", "SELL"]
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _containers(pattern, fmt, dtype_name="float32", capacity=CAP):
    """(dense f32 matrix, JAX container, the port's equal container)."""
    a = PATTERNS[pattern]()
    Aj = jf.coo_from_dense_np(a, capacity=capacity, dtype=JAX_DTYPES[dtype_name])
    kw = {"block_size": 4} if fmt == "BSR" else {}
    if fmt == "BSR" and (a.shape[0] % 4 or a.shape[1] % 4):
        kw = {"block_size": 1}
    Bj = jconv.convert(Aj, JFormat[fmt], **kw)
    return a, Bj, port_from_jax(Bj)


def _x(n, dtype_name, seed=7):
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    return (jnp.asarray(x, JAX_DTYPES[dtype_name]),
            torch.from_numpy(x).to(TORCH_DTYPES[dtype_name]))


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _check_spmv(pattern, fmt, dtype_name):
    a, Bj, Bt = _containers(pattern, fmt, dtype_name)
    xj, xt = _x(a.shape[1], dtype_name)
    yt = tops.spmv(Bt, xt, backend="ref")
    assert yt.dtype == TORCH_DTYPES[dtype_name] and yt.shape == (a.shape[0],)
    assert torch.equal(yt, tops.spmv(Bt, xt))  # None -> ref on a CPU tensor
    yj = np.asarray(jops.spmv(Bj, xj, backend="ref"), np.float32)
    oracle = jf.to_dense_np(Bj).astype(np.float64) @ np.asarray(xj, np.float64)
    np.testing.assert_allclose(_np(yt), yj, **tol(dtype_name))
    np.testing.assert_allclose(_np(yt), oracle, **tol(dtype_name))


@pytest.mark.parametrize("fmt", SPMV_FORMATS)
@pytest.mark.parametrize("pattern", ["stencil", "random", "powerlaw"])
def test_spmv_ref_f32_matches_jax_and_oracle(pattern, fmt):
    _check_spmv(pattern, fmt, "float32")


@pytest.mark.parametrize("fmt", SPMV_FORMATS)
def test_spmv_ref_bf16_matches_jax_and_oracle(fmt):
    """bf16 in, bf16 out; the stencil's values are exact in bf16."""
    _check_spmv("stencil", fmt, "bfloat16")


def test_spmv_rectangular_dia_offsets_outside():
    """DIA on a wide and a tall matrix, with offsets past either edge."""
    for shape, offs in (((30, 50), [-40, -2, 0, 7, 49, 60]), ((50, 30), [-49, -3, 0, 29])):
        Aj = jf.banded_coo(shape, [o for o in offs if -shape[0] < o < shape[1]])
        Bj = jconv.coo_to_dia(Aj, offsets=offs)
        Bt = port_from_jax(Bj)
        xj, xt = _x(shape[1], "float32")
        np.testing.assert_allclose(tops.spmv(Bt, xt).numpy(),
                                   np.asarray(jops.spmv(Bj, xj)), **tol("float32"))


def test_backend_resolution():
    """Every SpMV format but COO and Dense has a CUDA kernel now: on a CPU
    tensor ``backend="cuda"`` refuses (it never falls back to the
    reference), ``"ref"`` runs the reference, and ``"auto"`` routes: off
    the card always to the reference, counted as ``kernel.route.ref``."""
    _, _, Bt = _containers("stencil", "CSR")
    x = torch.ones(Bt.shape[1])
    assert tops.resolve_backend(None, x) == "ref"
    with pytest.raises(ValueError, match="CUDA tensors"):
        tops.spmv(Bt, x, backend="cuda")
    with metrics.scope() as s:
        assert torch.equal(tops.spmv(Bt, x, backend="auto"), tops.spmv(Bt, x, backend="ref"))
        assert tops.kernel_route(Bt) == ("ref", None)
        assert s.delta("kernel.route.ref") == 2 and s.delta("kernel.route.cuda") == 0
    with pytest.raises(ValueError, match="unknown backend"):
        tops.spmv(Bt, x, backend="pallas")
    assert set(kops.SPMV_CUDA) == {tf.CSR, tf.DIA, tf.ELL, tf.SELL, tf.HYB, tf.BSR}
    for fmt in ("ELL", "SELL", "HYB", "BSR"):
        _, _, Ct = _containers("stencil", fmt)
        with pytest.raises(ValueError, match="CUDA tensors"):
            tops.spmv(Ct, x, backend="cuda")
        assert tops.spmv(Ct, x, backend="ref").shape == (Bt.shape[0],)


def test_csr_row_ids_and_sell_ids_match_jax():
    a = PATTERNS["powerlaw"]()
    Aj = jf.coo_from_dense_np(a, capacity=CAP)
    Cj = jconv.convert(Aj, JFormat.CSR)
    Ct = port_from_jax(Cj)
    np.testing.assert_array_equal(
        tops.csr_row_ids(Ct.indptr, Ct.capacity, Ct.shape[0]).numpy(),
        np.asarray(jops.csr_row_ids(Cj.indptr, Cj.capacity, Cj.shape[0])))
    Sj = jconv.convert(Aj, JFormat.SELL, c=8, sigma=16)
    St = port_from_jax(Sj)
    np.testing.assert_array_equal(
        tops.sell_sorted_ids(St.slice_ptrs, St.c, St.capacity, St.nslices).numpy(),
        np.asarray(jops.sell_sorted_ids(Sj.slice_ptrs, Sj.c, Sj.capacity, Sj.nslices)))


@pytest.mark.parametrize("fmt", SPMV_FORMATS)
def test_extract_diagonal_matches_jax(fmt):
    for pattern in ("stencil", "random"):
        _, Bj, Bt = _containers(pattern, fmt)
        np.testing.assert_array_equal(tops.extract_diagonal(Bt).numpy(),
                                      np.asarray(jops.extract_diagonal(Bj)))


@pytest.mark.parametrize("fmt", ["COO", "CSR", "DIA", "ELL", "SELL", "DENSE"])
def test_update_diagonal_matches_jax(fmt):
    """Padded and unpadded inputs. With padding, both packages also write
    the new value into the inert (0, 0) padding entries of COO and CSR,
    which then count on the diagonal: the port keeps that behaviour."""
    d = np.random.default_rng(5).uniform(20, 30, 64).astype(np.float32)
    for capacity in (CAP, None):
        a, Bj, Bt = _containers("stencil", fmt, capacity=capacity)
        Uj = jops.update_diagonal(Bj, jnp.asarray(d))
        Ut = tops.update_diagonal(Bt, torch.from_numpy(d))
        np.testing.assert_array_equal(tf.to_dense_np(Ut), jf.to_dense_np(Uj))
        np.testing.assert_array_equal(tf.to_dense_np(Bt), a)  # the input is untouched
    np.testing.assert_array_equal(tops.extract_diagonal(Ut).numpy(), d)


def test_blas1_match_jax():
    rng = np.random.default_rng(6)
    x, y = rng.standard_normal((2, 257)).astype(np.float32)
    xj, yj, xt, yt = jnp.asarray(x), jnp.asarray(y), torch.from_numpy(x), torch.from_numpy(y)
    np.testing.assert_allclose(float(tops.dot(xt, yt)), float(jops.dot(xj, yj)), rtol=1e-5)
    np.testing.assert_allclose(float(tops.norm2(xt)), float(jops.norm2(xj)), rtol=1e-6)
    np.testing.assert_allclose(tops.waxpby(0.5, xt, -2.0, yt).numpy(),
                               np.asarray(jops.waxpby(0.5, xj, -2.0, yj)), rtol=1e-6)
    np.testing.assert_allclose(tops.axpy(3.0, xt, yt).numpy(),
                               np.asarray(jops.axpy(3.0, xj, yj)), rtol=1e-6)


def test_assign_reduction_scan_match_jax():
    x = np.random.default_rng(7).standard_normal(33).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    for value in (0.0, 2.5):
        z = tops.assign(xt, value)
        assert z.dtype == xt.dtype and z.data_ptr() != xt.data_ptr()
        np.testing.assert_array_equal(z.numpy(), np.asarray(jops.assign(xj, value)))
    np.testing.assert_allclose(float(tops.reduction(xt)), float(jops.reduction(xj)), rtol=1e-5)
    np.testing.assert_allclose(tops.scan(xt).numpy(), np.asarray(jops.scan(xj)),
                               rtol=1e-5, atol=1e-5)


def test_segment_sum_and_take_clip_follow_jax_semantics():
    """Out-of-range ids are dropped and out-of-range gathers clamp, as in
    ``jax.ops.segment_sum`` and ``jnp.take(mode="clip")``."""
    vals = torch.tensor([1.0, 2.0, 4.0, 8.0])
    ids = torch.tensor([0, 3, -1, 1], dtype=torch.int32)
    assert tops.segment_sum(vals, ids, 3).tolist() == [1.0, 8.0, 0.0]
    x = torch.tensor([10.0, 20.0, 30.0])
    assert tops.take_clip(x, torch.tensor([-5, 1, 9])).tolist() == [10.0, 20.0, 30.0]


def test_coo_spmv_keeps_its_row_order_per_container():
    """The plain COO SpMV sorts a container's entries by row once and keeps
    that order for the container: rows out of order, repeats, out-of-range
    rows and capacity padding (row 0, value 0) give JAX's y, a rerun is
    bitwise, and a container with other values gets its own order."""
    import dataclasses
    rng = np.random.default_rng(3)
    m, n, live, cap = 37, 29, 150, 200
    row = np.zeros(cap, np.int32)
    col = np.zeros(cap, np.int32)
    val = np.zeros(cap, np.float32)
    row[:live] = rng.integers(0, m, live)
    col[:live] = rng.integers(0, n, live)
    val[:live] = rng.standard_normal(live)
    row[live:live + 5] = m + 3  # out of range: dropped, as segment_sum drops it
    val[live:live + 5] = 1.0
    At = tf.COO(torch.from_numpy(row), torch.from_numpy(col), torch.from_numpy(val),
                (m, n), live)
    Aj = jf.COO(jnp.asarray(row), jnp.asarray(col), jnp.asarray(val), (m, n), live)
    xj, xt = _x(n, "float32")
    y = tops.spmv(At, xt, backend="ref")
    assert At in tops._COO_ORDER
    np.testing.assert_allclose(y.numpy(), np.asarray(jops.spmv(Aj, xj, backend="ref")),
                               **tol("float32"))
    assert torch.equal(y, tops.spmv(At, xt, backend="ref"))
    Bt = dataclasses.replace(At, data=At.data * 2)
    np.testing.assert_allclose(tops.spmv(Bt, xt, backend="ref").numpy(), 2 * y.numpy(),
                               rtol=1e-6, atol=1e-6)
