"""The port's CSR and DIA SpMV: plain versions, wrappers, build and kernels
(the ELL, SELL, BSR and HYB menu is in tests/test_torch_menu_kernels.py).

On the CPU the plain torch versions (``repro_torch.kernels.ref``) are held
against the JAX package's ``repro.kernels.ref`` and a dense float64 oracle
over ragged shapes: empty rows, rectangular DIA, offsets outside the
matrix, CSR capacity padding. The CUDA kernels themselves run only on a
card: ``tests/test_torch_cuda.py`` holds them against these plain versions.
"""
import ctypes
import itertools
import os
import stat

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.kernels.ref as jref
import repro_torch.core.formats as tf
from repro_torch.kernels import _build
from repro_torch.kernels import csr_spmv as kc
from repro_torch.kernels import dia_spmv as kd
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import csr_spmv_ref, dia_spmv_ref
from torch_parity import CAP, DEV, PATTERNS, tconv, tol
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

# (M, N, offsets): square, wide, tall, offsets past both edges, one row.
DIA_CASES = [
    (64, 64, [-7, -1, 0, 2, 9]),
    (120, 70, [-130, -5, 0, 3, 69, 80]),
    (30, 110, [-29, -1, 0, 1, 50, 109, 110]),
    (1, 1, [0]),
]
ALL_KERNELS = ("dia_spmv", "csr_spmv", "ell_spmv", "sell_spmv", "bsr_spmm", "csr_spmm",
               "csr_spmm_t", "ell_spmm", "ell_spmm_t", "sell_spmm", "sell_spmm_t")
# Source (library) -> the Pallas functions its kernels replace.
REPLACES = {"dia_spmv": ("dia_spmv.py::dia_spmv",), "csr_spmv": ("csr_spmv.py::csr_spmv",),
            "ell_spmv": ("ell_spmv.py::ell_spmv",), "sell_spmv": ("sell_spmv.py::sell_spmv",),
            "bsr_spmm": ("bsr_spmm.py::bsr_spmm",),
            "csr_spmm": ("csr_spmm.py::csr_spmm", "csr_spmm.py::csr_spmm_t"),
            "ell_spmm": ("ell_spmv.py::ell_spmm", "ell_spmv.py::ell_spmm_t"),
            "sell_spmm": ("sell_spmv.py::sell_spmm", "sell_spmv.py::sell_spmm_t")}
# Sources of the port's own kernels (no Pallas kernel) -> the JAX code they
# stand for: the CG loop's vector algebra, fused by XLA inside the solvers'
# while_loop.
PORT_OWN = {"solver_vec": "repro/core/solvers.py"}
# CSR row lengths: empty first/middle/last rows, one long row.
CSR_LENS = [[0, 3, 0, 0, 70, 1, 27, 0, 64, 0], [5], [0, 0, 2]]


def _dia_inputs(m, n, offs, dtype_name, seed=0):
    """Diagonal table entries outside the matrix are left non-zero: every
    version must mask them."""
    rng = np.random.default_rng(seed)
    return (np.asarray(offs, np.int32),
            rng.standard_normal((len(offs), m)).astype(np.float32),
            rng.standard_normal(n).astype(np.float32))


def _dia_oracle(offs, data, x, n):
    m = data.shape[1]
    y = np.zeros(m)
    for d, off in enumerate(offs):
        i = np.arange(m)
        ok = (i + off >= 0) & (i + off < n)
        y[ok] += data[d, ok].astype(np.float64) * x[i[ok] + off]
    return y


def _csr_inputs(lens, n=90, pad=13, seed=1):
    """CSR arrays with ``pad`` slots of NaN capacity padding past
    ``indptr[-1]``: they must never be read."""
    rng = np.random.default_rng(seed)
    nnz = sum(lens)
    indptr = np.asarray([0] + list(itertools.accumulate(lens)), np.int32)
    idx = rng.integers(0, n, nnz + pad).astype(np.int32)
    val = rng.standard_normal(nnz + pad).astype(np.float32)
    val[nnz:] = np.nan
    x = rng.standard_normal(n).astype(np.float32)
    return indptr, idx, val, x


def _csr_oracle(indptr, idx, val, x):
    m = len(indptr) - 1
    return np.array([np.dot(val[indptr[i]:indptr[i + 1]].astype(np.float64),
                            x[idx[indptr[i]:indptr[i + 1]]]) for i in range(m)])


def _t(a, dtype_name=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(TORCH_DTYPES[dtype_name]) if dtype_name else t


def _j(a, dtype_name=None):
    return jnp.asarray(a, JAX_DTYPES[dtype_name]) if dtype_name else jnp.asarray(a)


def _f(y):
    return y.float().numpy()


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(DIA_CASES)))
def test_dia_plain_matches_jax_ref_and_oracle(case, dtype_name):
    m, n, offs = DIA_CASES[case]
    o, d, x = _dia_inputs(m, n, offs, dtype_name)
    y = dia_spmv_ref(_t(o), _t(d, dtype_name), _t(x, dtype_name), n)
    assert y.dtype == TORCH_DTYPES[dtype_name] and y.shape == (m,)
    yj = jref.dia_spmv_ref(_j(o), _j(d, dtype_name), _j(x, dtype_name), n)
    np.testing.assert_allclose(_f(y), np.asarray(yj, np.float32), **tol(dtype_name))
    d_r = _f(_t(d, dtype_name))  # the oracle sees the rounded inputs
    x_r = _f(_t(x, dtype_name))
    np.testing.assert_allclose(_f(y), _dia_oracle(o, d_r, x_r, n), **tol(dtype_name))


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(CSR_LENS)))
def test_csr_plain_matches_jax_ref_and_oracle(case, dtype_name):
    lens = CSR_LENS[case]
    indptr, idx, val, x = _csr_inputs(lens)
    m = len(lens)
    y = csr_spmv_ref(_t(indptr), _t(idx), _t(val, dtype_name), _t(x, dtype_name), m)
    assert y.dtype == TORCH_DTYPES[dtype_name] and y.shape == (m,)
    assert bool(torch.isfinite(y).all())  # the NaN padding was never read
    yj = jref.csr_spmv_ref(_j(indptr), _j(idx), _j(val, dtype_name), _j(x, dtype_name), m)
    np.testing.assert_allclose(_f(y), np.asarray(yj, np.float32), **tol(dtype_name))
    oracle = _csr_oracle(indptr, idx, _f(_t(val, dtype_name)), _f(_t(x, dtype_name)))
    np.testing.assert_allclose(_f(y), oracle, **tol(dtype_name))


def test_wrappers_on_cpu_run_the_plain_version_uncounted():
    kops.reset_launches()
    a = PATTERNS["powerlaw"]()
    A = tf.coo_from_dense_np(a, capacity=CAP, device=DEV)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(a.shape[1]).astype(np.float32))
    D, C = tconv.convert(A, tf.Format.DIA), tconv.convert(A, tf.Format.CSR)
    assert torch.equal(kops.dia_spmv(D, x), dia_spmv_ref(D.offsets, D.data, x, D.shape[1]))
    assert torch.equal(kops.csr_spmv(C, x), csr_spmv_ref(C.indptr, C.indices, C.data, x,
                                                         C.shape[0]))
    assert torch.equal(kd.dia_spmv(D.offsets, D.data, x, D.shape[1]),
                       dia_spmv_ref(D.offsets, D.data, x, D.shape[1]))
    np.testing.assert_allclose(kops.SPMV_CUDA[tf.CSR](C, x).numpy(), a @ x.numpy(),
                               **tol("float32"))
    assert kops.launch_counts() == dict.fromkeys(ALL_KERNELS, 0)
    with pytest.raises(ValueError, match="cuda or cpu"):
        kd.dia_spmv(D.offsets.to("meta"), D.data.to("meta"), x.to("meta"), D.shape[1])


def test_wrapper_argument_checks():
    o = torch.tensor([0, 1], dtype=torch.int32)
    d = torch.ones(2, 5)
    x = torch.ones(5)
    kd._check(o, d, x, 5, 256)
    with pytest.raises(ValueError, match="int32"):
        kd._check(o.long(), d, x, 5, 256)
    with pytest.raises(ValueError, match="ndiag"):
        kd._check(o, torch.ones(3, 5), x, 5, 256)
    with pytest.raises(ValueError, match="share dtype"):
        kd._check(o, d.double(), x.double(), 5, 256)
    with pytest.raises(ValueError, match="contiguous"):
        kd._check(o, torch.ones(5, 2).t(), x, 5, 256)
    with pytest.raises(ValueError, match="multiple of 32"):
        kd._check(o, d, x, 5, 100)
    ip = torch.tensor([0, 2, 3], dtype=torch.int32)
    ix = torch.tensor([0, 4, 1], dtype=torch.int32)
    v = torch.ones(3)
    kc._check(ip, ix, v, x, 2, 8)
    with pytest.raises(ValueError, match="m\\+1"):
        kc._check(ip, ix, v, x, 3, 8)
    with pytest.raises(ValueError, match="differ"):
        kc._check(ip, ix, torch.ones(4), x, 2, 8)
    with pytest.raises(ValueError, match="vec"):
        kc._check(ip, ix, v, x, 2, 3)
    with pytest.raises(ValueError, match="share dtype"):
        kc._check(ip, ix, v.bfloat16(), x, 2, 8)


def test_default_config_follows_row_length():
    def csr(m, nnz):
        return tf.CSR(torch.zeros(m + 1, dtype=torch.int32), torch.zeros(nnz, dtype=torch.int32),
                      torch.zeros(nnz), (m, m), nnz)
    assert kops.default_config(csr(100, 2750))["vec"] == 4  # HPCG: ~27.5 per row
    assert kops.default_config(csr(100, 5000))["vec"] == 8
    assert kops.default_config(csr(100, 10))["vec"] == 2
    assert kops.default_config(csr(10, 10 ** 5))["vec"] == 32
    dia = tf.DIA(torch.zeros(1, dtype=torch.int32), torch.zeros(1, 4), (4, 4), 4)
    assert kops.default_config(dia) == {"block": 256}


def test_sources_name_the_tpu_kernel_they_replace():
    srcs = _build.sources()
    assert set(srcs) == set(REPLACES) | set(PORT_OWN)
    assert set(REPLACES) == set(kops.KERNELS)
    assert set(kops.LAUNCH_COUNTERS) == set(ALL_KERNELS)
    for name, path in srcs.items():
        text = path.read_text()
        for pallas in REPLACES.get(name, ()):
            assert f"repro/kernels/{pallas}" in text
        if name in PORT_OWN:
            assert "Replaces no Pallas kernel" in text and PORT_OWN[name] in text
        assert "What bounds it on an H100: bytes" in text
        # no sum uses atomics; the one atomic is csr_spmv's per-row arrival
        # counter, which orders its long-row chunks and adds no value
        text = text.replace("no atomics", "").replace("atomicAdd(plan.arrive + row, 1)", "")
        assert "atomic" not in text


def _fake_nvcc(tmp_path, body):
    path = tmp_path / "bin" / "nvcc"
    path.parent.mkdir()
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return path


def test_build_runs_one_compiler_per_source(tmp_path, monkeypatch):
    """The build orchestration with a stand-in compiler that writes its
    ``-o`` target: one library per source, keyed by the source hash,
    built once and reused."""
    nvcc = _fake_nvcc(tmp_path, 'while [ "$1" != "-o" ]; do shift; done\n'
                                'echo "ptxas info: Used 32 registers" ; touch "$2"\n')
    monkeypatch.setenv("CUDA_HOME", str(nvcc.parent.parent))
    monkeypatch.setenv(_build.BUILD_ENV, str(tmp_path / "out"))
    assert _build.nvcc_path() == str(nvcc)
    logs = _build.build_all()
    assert set(logs) == set(REPLACES) | set(PORT_OWN)
    assert all("Used 32 registers" in log for log in logs.values())
    for name in logs:
        lib = _build._lib_path(name)
        assert lib.exists() and lib.parent.parent == tmp_path / "out"
    nvcc.write_text("#!/bin/sh\nexit 9\n")  # a rebuild would now fail: none happens
    assert _build.build_all(["dia_spmv"])["dia_spmv"] == logs["dia_spmv"]


def test_build_failure_names_the_source(tmp_path, monkeypatch):
    nvcc = _fake_nvcc(tmp_path, 'echo "error: bad kernel" ; exit 2\n')
    monkeypatch.setenv("CUDA_HOME", str(nvcc.parent.parent))
    monkeypatch.setenv(_build.BUILD_ENV, str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="(?s)nvcc failed for dia_spmv .*bad kernel"):
        _build.build_all(["dia_spmv"])
    assert not _build._lib_path("dia_spmv").exists()


# Stand-ins with the kernels' C signatures: each records its arguments so
# the test can see them arrive at full width (a pointer declared as a C int
# would be cut to 32 bits).
_STANDIN = """
#include <stdint.h>
static int64_t seen[16];
int64_t {name}_seen(int i) {{ return seen[i]; }}
const char* {name}_error_string(int code) {{ return code ? "stand-in error" : "ok"; }}
int {name}_f32({params}) {{ {record} return 7; }}
"""
_SIGNATURES = {
    "dia_spmv": ["const void* offsets", "const void* data", "const void* x", "void* y",
                 "int ndiag", "int64_t m", "int64_t n", "int block", "int device",
                 "void* stream"],
    "csr_spmv": ["const void* indptr", "const void* indices", "const void* data",
                 "const void* x", "void* y", "int64_t m", "int32_t n", "int vec",
                 "const void* chunk_end", "const void* chunk_row", "void* arrive",
                 "void* partials", "int long_len", "int long_ctas", "int device",
                 "void* stream"],
    "ell_spmv": ["const void* cols", "const void* data", "const void* x", "void* y",
                 "int64_t m", "int32_t n", "int32_t k", "int device", "void* stream"],
    "sell_spmv": ["const void* ptrs", "const void* cols", "const void* data",
                  "const void* perm", "const void* x", "void* y", "int64_t lanes",
                  "int32_t c", "int64_t m", "int32_t n", "int device", "void* stream"],
    "bsr_spmm": ["const void* indptr", "const void* bcol", "const void* blocks",
                 "const void* b", "void* y", "int64_t m", "int64_t ncols", "int32_t bs",
                 "int64_t nbcols", "int device", "void* stream"],
}


@pytest.mark.parametrize("name", sorted(_SIGNATURES))
def test_ctypes_bindings_pass_arguments_at_full_width(name, tmp_path, monkeypatch):
    import shutil
    import subprocess
    if shutil.which("gcc") is None:
        pytest.skip("needs a C compiler for the stand-in library")
    monkeypatch.setenv(_build.BUILD_ENV, str(tmp_path / "out"))
    params = _SIGNATURES[name]
    record = " ".join(f"seen[{i}] = (int64_t){p.split()[-1]};" for i, p in enumerate(params))
    src = tmp_path / f"{name}.c"
    src.write_text(_STANDIN.format(name=name, params=", ".join(params), record=record))
    lib = _build._lib_path(name)
    lib.parent.mkdir(parents=True)
    subprocess.run(["gcc", "-shared", "-fPIC", "-o", str(lib), str(src)], check=True)
    monkeypatch.setattr(_build, "_LIBS", {})
    module = kops.KERNELS[name]
    module._fn.cache_clear()
    try:
        fn, err_str = module._fn(torch.float32)
        args = [0x7FFF_1234_5678 + 16 * i for i in range(len(params))]
        for i, p in enumerate(params):
            if not p.startswith(("const void*", "void*")):
                args[i] = 2 ** 33 + 5 if p.startswith("int64_t") else 1000 + i
        assert fn(*args) == 7 and err_str(7) == b"stand-in error"
        seen = getattr(_build.load(name), f"{name}_seen")
        seen.restype = ctypes.c_int64
        assert [seen(i) for i in range(len(params))] == args
    finally:
        module._fn.cache_clear()


def test_nvcc_missing_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
