"""Shared inputs and comparisons for the PyTorch port's parity tests
(``tests/test_torch_*.py``).

Every input is made with numpy from a fixed seed and handed to both the
JAX package (the reference) and ``repro_torch``; containers cross between
them as numpy arrays. JAX runs on the CPU and only through its jnp
reference paths (``backend="ref"``), never through a Pallas kernel.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

import numpy as np

import repro.core.formats as jf
import repro.core.hpcg as jhpcg
import repro_torch.core.formats as tf

# ``repro.core`` and ``repro_torch.core`` re-export a ``convert`` function
# under the module's own name, so the modules are fetched by path.
jconv = importlib.import_module("repro.core.convert")
tconv = importlib.import_module("repro_torch.core.convert")

DEV = "cpu"  # the tests run the port's CPU path; entry points default to cuda


def tol(dtype_name: str) -> dict:
    """Tolerances of ``tests/test_kernels.py::_tol``: f32 1e-4, bf16 2e-2."""
    return dict(rtol=2e-2, atol=2e-2) if dtype_name == "bfloat16" else dict(rtol=1e-4, atol=1e-4)


def stencil(nx: int = 4, ny: int = 4, nz: int = 4) -> np.ndarray:
    """Dense HPCG 27-point stencil (26 on the diagonal, -1 off it)."""
    prob = jhpcg.generate_problem(nx, ny, nz)
    a = np.zeros(prob.shape, np.float32)
    a[prob.row, prob.col] = prob.val
    return a


def banded(m: int = 64, n: int = 64, offsets=(-7, -1, 0, 2, 9), seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    a = np.zeros((m, n), np.float32)
    for off in offsets:
        i = np.arange(max(0, -off), min(m, n - off))
        a[i, i + off] = rng.standard_normal(len(i)).astype(np.float32)
    return a


def random_sparse(m: int = 64, n: int = 48, density: float = 0.08, seed: int = 2) -> np.ndarray:
    """Uniform random pattern with an empty row and an empty column."""
    rng = np.random.default_rng(seed)
    a = np.where(rng.random((m, n)) < density, rng.standard_normal((m, n)), 0)
    a = a.astype(np.float32)
    a[5] = 0
    a[:, 3] = 0
    return a


def powerlaw(m: int = 64, n: int = 64, seed: int = 3) -> np.ndarray:
    """Pareto row lengths: a few long rows, many short, one empty."""
    rng = np.random.default_rng(seed)
    lens = np.minimum(n, (rng.pareto(1.2, m) * 3).astype(int) + 1)
    lens[10] = 0
    a = np.zeros((m, n), np.float32)
    for i, ln in enumerate(lens):
        cols = rng.choice(n, ln, replace=False)
        a[i, cols] = rng.standard_normal(ln).astype(np.float32)
    return a


# Every pattern has 64 rows and at most CAP entries: one capacity for all
# keeps the shapes JAX compiles for few (its eager ops compile per shape).
PATTERNS = {
    "stencil": stencil,
    "banded": banded,
    "random": random_sparse,
    "powerlaw": powerlaw,
}
CAP = 1032


def coo_pair(a: np.ndarray, capacity: Optional[int] = CAP):
    """The same dense matrix as a JAX COO and a port COO (CPU), padded with
    inert entries to ``capacity`` (None: no padding)."""
    return (jf.coo_from_dense_np(a, capacity=capacity),
            tf.coo_from_dense_np(a, capacity=capacity, device=DEV))


def jax_fields(A) -> dict:
    """The array fields of a JAX container as numpy, nested for HYB (the
    layout ``repro_torch.core.formats.to_numpy`` returns)."""
    out = {}
    for f in dataclasses.fields(A):
        if not f.metadata.get("pytree_node", True):
            continue
        v = getattr(A, f.name)
        out[f.name] = jax_fields(v) if dataclasses.is_dataclass(v) else np.asarray(v)
    return out


def static_of(A) -> dict:
    """Static metadata beyond shape/nnz (``block_size``, ``c``, ``sigma``)."""
    names = {f.name for f in dataclasses.fields(A)}
    return {k: getattr(A, k) for k in ("block_size", "c", "sigma") if k in names}


def port_from_jax(A):
    """The port's container equal to JAX container ``A`` (via numpy)."""
    return tf.from_numpy(int(A.format), jax_fields(A), A.shape, A.nnz, device=DEV,
                         **static_of(A))


def _widen(v: np.ndarray) -> np.ndarray:
    return v.astype(np.float32) if v.dtype.name == "bfloat16" else v


def assert_same_container(Aj, At) -> None:
    """Same format, metadata, and bit-identical fields (bf16 compared after
    the exact widening to f32)."""
    assert int(Aj.format) == int(At.format)
    assert tuple(Aj.shape) == tuple(At.shape) and int(Aj.nnz) == int(At.nnz)
    assert static_of(Aj) == static_of(At)
    _assert_same_fields(jax_fields(Aj), tf.to_numpy(At))


def _assert_same_fields(fj: dict, ft: dict) -> None:
    assert fj.keys() == ft.keys()
    for k in fj:
        if isinstance(fj[k], dict):
            _assert_same_fields(fj[k], ft[k])
            continue
        a, b = _widen(fj[k]), ft[k]
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        assert a.shape == b.shape, (k, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=k)
