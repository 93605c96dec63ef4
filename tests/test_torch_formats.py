"""The PyTorch port's containers and HPCG problem against the JAX package.

Containers built from the same numpy input must be bit-identical field by
field; ``from_numpy``/``to_numpy`` carry a JAX container across and back;
the HPCG triplets, right-hand side and exact solution are bit-identical.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core.formats as jf
import repro.core.hpcg as jhpcg
import repro_torch
import repro_torch.core.formats as tf
import repro_torch.core.hpcg as thpcg
from repro.core import Format as JFormat
from repro_torch.device import resolve_device
from torch_parity import (DEV, PATTERNS, assert_same_container, coo_pair,
                          jax_fields, jconv, port_from_jax)

ALL_FORMATS = ["COO", "CSR", "DIA", "ELL", "HYB", "SELL", "DENSE", "BSR"]


def test_format_enum_values_match_jax():
    assert {f.name: int(f) for f in tf.Format} == {f.name: int(f) for f in JFormat}
    for fmt, cls in tf.FORMAT_TO_CLS.items():
        assert cls.format == fmt


def test_entry_points_default_to_cuda_and_never_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tf.coo_from_arrays([0], [0], [1.0], (1, 1))
    with pytest.raises(RuntimeError):
        repro_torch.resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_coo_from_dense_matches_jax(pattern):
    Aj, At = coo_pair(PATTERNS[pattern]())
    assert_same_container(Aj, At)
    assert At.capacity == Aj.capacity and At.device.type == "cpu"


def test_coo_from_arrays_and_banded_match_jax():
    rng = np.random.default_rng(4)
    row = rng.integers(0, 30, 50)
    col = rng.integers(0, 20, 50)
    val = rng.standard_normal(50).astype(np.float32)
    assert_same_container(jf.coo_from_arrays(row, col, val, (30, 20), capacity=64),
                          tf.coo_from_arrays(row, col, val, (30, 20), capacity=64,
                                             device=DEV))
    assert_same_container(jf.banded_coo((40, 33), [-3, 0, 5, 40]),
                          tf.banded_coo((40, 33), [-3, 0, 5, 40], device=DEV))
    fill = [0.5, -2.0, 3.0]
    assert_same_container(jf.banded_coo((25, 25), [-1, 0, 1], fill=fill, capacity=80),
                          tf.banded_coo((25, 25), [-1, 0, 1], fill=fill, capacity=80,
                                        device=DEV))
    with pytest.raises(ValueError, match="capacity"):
        tf.coo_from_arrays(row, col, val, (30, 20), capacity=10, device=DEV)


@pytest.mark.parametrize("fmt", ALL_FORMATS)
def test_from_numpy_round_trips_jax_containers(fmt):
    """A JAX container crosses into the port (``from_numpy``) with every
    field and static value intact, densifies to the same matrix, and comes
    back (``to_numpy``) bit for bit."""
    a = PATTERNS["powerlaw"]()
    kw = {"block_size": 8} if fmt == "BSR" else {}
    Bj = jconv.convert(coo_pair(a)[0], JFormat[fmt], **kw)
    Bt = port_from_jax(Bj)
    assert isinstance(Bt, tf.FORMAT_TO_CLS[tf.Format[fmt]])
    assert_same_container(Bj, Bt)
    np.testing.assert_array_equal(tf.to_dense_np(Bt), a)
    again = tf.from_numpy(fmt, tf.to_numpy(Bt), Bt.shape, Bt.nnz, device=DEV,
                          **{k: getattr(Bt, k) for k in ("block_size", "c", "sigma")
                             if hasattr(Bt, k)})
    assert_same_container(Bj, again)


def test_from_numpy_keeps_bfloat16_bits():
    a = PATTERNS["banded"]()
    Bj = jconv.convert(jf.coo_from_dense_np(a, dtype=jnp.bfloat16), JFormat.DIA)
    Bt = port_from_jax(Bj)
    assert Bt.dtype == torch.bfloat16
    np.testing.assert_array_equal(np.asarray(Bj.data).astype(np.float32),
                                  Bt.data.float().numpy())
    assert_same_container(Bj, Bt)


def test_container_metadata_accessors():
    a = PATTERNS["powerlaw"]()
    Bj = jconv.convert(coo_pair(a)[0], JFormat.SELL, c=8, sigma=32)
    Bt = port_from_jax(Bj)
    assert (Bt.c, Bt.sigma, Bt.nslices, Bt.capacity) == (Bj.c, Bj.sigma, Bj.nslices,
                                                         Bj.capacity)
    assert set(Bt.tensors()) == set(jax_fields(Bj))
    H = port_from_jax(jconv.convert(coo_pair(a)[0], JFormat.HYB))
    assert H.dtype == torch.float32 and H.device.type == "cpu" and H.k == H.ell.k


@pytest.mark.parametrize("grid", [(16, 16, 16), (5, 7, 3), (1, 1, 1)])
def test_hpcg_problem_bit_identical(grid):
    pj, pt = jhpcg.generate_problem(*grid), thpcg.generate_problem(*grid)
    for name in ("row", "col", "val"):
        a, b = getattr(pj, name), getattr(pt, name)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert pj.shape == pt.shape and pj.nrows == pt.nrows
    for fn in ("rhs_for_ones", "exact_solution"):
        a, b = getattr(jhpcg, fn)(pj), getattr(thpcg, fn)(pt)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_hpcg_to_coo_matches_jax():
    pj, pt = jhpcg.generate_problem(6, 5, 4), thpcg.generate_problem(6, 5, 4)
    cap = len(pj.val) + 11
    assert_same_container(jhpcg.to_coo(pj, capacity=cap),
                          thpcg.to_coo(pt, capacity=cap, device=DEV))
    At = thpcg.to_coo(pt, dtype=torch.bfloat16, device=DEV)
    assert At.dtype == torch.bfloat16 and At.nnz == len(pt.val)
