"""The port on the card: each CUDA kernel against its plain version, and the
main path's CUDA route against the CPU route.

Every test here needs an NVIDIA GPU and ``nvcc``; each carries the ``cuda``
marker and skips where ``torch.cuda.is_available()`` is false. This file
imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import itertools

import numpy as np
import pytest
import torch

from repro_torch import hpcg_solve
from repro_torch.core import hpcg
from repro_torch.core.convert import convert
from repro_torch.core.dynamic import DynamicMatrix
from repro_torch.core.formats import Format, to_numpy
from repro_torch.core.ops import spmv
from repro_torch.kernels import csr_spmv as kc
from repro_torch.kernels import dia_spmv as kd
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import csr_spmv_ref, dia_spmv_ref
from repro_torch.tuning import PatternFeatures

pytestmark = pytest.mark.cuda

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# (M, N, offsets): square, tall, wide, offsets past both edges, one row.
DIA_CASES = [(64, 64, [-7, -1, 0, 2, 9]), (1000, 700, [-1200, -5, 0, 3, 699, 800]),
             (300, 1100, [-299, -1, 0, 1, 500, 1099, 1100]), (1, 1, [0])]
# CSR row lengths: empty first/middle/last rows, one row longer than a warp.
CSR_LENS = [[0, 3, 0, 0, 700, 1, 27, 0, 64, 0], [5], [0, 0, 2]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


def _rand(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_dia_kernel_matches_plain(card, dtype_name):
    """Table entries outside the matrix are left non-zero: the kernel masks."""
    rng = np.random.default_rng(0)
    dt = DTYPES[dtype_name]
    for m, n, offs in DIA_CASES:
        o = torch.tensor(offs, dtype=torch.int32, device=card)
        d, x = _rand(rng, (len(offs), m), dt, card), _rand(rng, n, dt, card)
        before = kd.launches
        y1, y2 = kd.dia_spmv(o, d, x, n), kd.dia_spmv(o, d, x, n)
        torch.cuda.synchronize()
        assert kd.launches == before + 2 and y1.dtype == dt and y1.shape == (m,)
        torch.testing.assert_close(y1.float(), dia_spmv_ref(o, d, x, n).float(),
                                   **TOL[dtype_name])
        assert torch.equal(y1, y2)  # one summation order: bitwise stable


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_csr_kernel_matches_plain_at_every_width(card, dtype_name):
    """NaN capacity padding past indptr[-1] must never be read."""
    rng = np.random.default_rng(1)
    dt = DTYPES[dtype_name]
    n = 900
    for lens in CSR_LENS:
        m, nnz = len(lens), sum(lens)
        ip = torch.tensor([0] + list(itertools.accumulate(lens)), dtype=torch.int32,
                          device=card)
        ix = torch.from_numpy(rng.integers(0, n, nnz + 37).astype(np.int32)).to(card)
        v = _rand(rng, nnz + 37, dt, card)
        v[nnz:] = float("nan")
        x = _rand(rng, n, dt, card)
        y_p = csr_spmv_ref(ip, ix, v, x, m)
        for vec in kc.VEC_WIDTHS:
            y1 = kc.csr_spmv(ip, ix, v, x, m, vec=vec)
            y2 = kc.csr_spmv(ip, ix, v, x, m, vec=vec)
            torch.cuda.synchronize()
            assert bool(torch.isfinite(y1).all())
            torch.testing.assert_close(y1.float(), y_p.float(), **TOL[dtype_name])
            assert torch.equal(y1, y2)


def test_wrappers_check_their_inputs(card):
    o = torch.tensor([0], dtype=torch.int64, device=card)
    with pytest.raises(ValueError, match="int32"):
        kd.dia_spmv(o, torch.ones(1, 4, device=card), torch.ones(4, device=card), 4)
    with pytest.raises(ValueError, match="x on cuda"):
        kd.dia_spmv(o.int().cpu(), torch.ones(1, 4, device=card), torch.ones(4, device=card), 4)
    ip = torch.tensor([0, 1], dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="share dtype"):
        kc.csr_spmv(ip, ip[:1], torch.ones(1, device=card, dtype=torch.float64),
                    torch.ones(3, device=card, dtype=torch.float64), 1, vec=4)


def test_main_path_formats_run_their_kernels(card):
    """spmv(backend=None) on a CUDA tensor launches the format's kernel, once
    per call, and agrees with backend='ref' on the card; ELL has no kernel
    yet and raises instead of falling back."""
    prob = hpcg.generate_problem(8, 8, 8)
    A = hpcg.to_coo(prob, device=card)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(A.shape[1])
                         .astype(np.float32)).to(card)
    for fmt, kernel in ((Format.DIA, "dia_spmv"), (Format.CSR, "csr_spmv")):
        M = DynamicMatrix(A).activate(fmt)
        before = kops.launch_counts()[kernel]
        y = spmv(M, x)
        torch.cuda.synchronize()
        assert kops.launch_counts()[kernel] == before + 1
        torch.testing.assert_close(y, spmv(M, x, backend="ref"), **TOL["float32"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        spmv(DynamicMatrix(A).activate(Format.ELL), x)


def _flat(fields, prefix=""):
    """Nested ``to_numpy`` fields (HYB) as one flat dict."""
    out = {}
    for k, v in fields.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: v})
    return out


def test_conversions_and_features_on_card_match_cpu(card):
    prob = hpcg.generate_problem(6, 5, 4)
    Ag, Ac = hpcg.to_coo(prob, device=card), hpcg.to_coo(prob, device="cpu")
    for fmt in (Format.CSR, Format.DIA, Format.ELL, Format.SELL, Format.HYB):
        fg, fc = _flat(to_numpy(convert(Ag, fmt))), _flat(to_numpy(convert(Ac, fmt)))
        assert fg.keys() == fc.keys()
        for k in fc:
            np.testing.assert_array_equal(fg[k], fc[k], err_msg=f"{fmt.name}.{k}")
    np.testing.assert_allclose(PatternFeatures.from_coo(Ag).vector(),
                               PatternFeatures.from_coo(Ac).vector(), rtol=1e-9)


@pytest.mark.parametrize("fmt", ["auto", "CSR"])
def test_solve_on_card_matches_cpu(card, fmt):
    g = hpcg_solve.run((16, 16, 16), fmt, device="cuda", tol=1e-6)
    c = hpcg_solve.run((16, 16, 16), fmt, device="cpu", tol=1e-6)
    assert g["format"] == c["format"] == ("DIA" if fmt == "auto" else "CSR")
    assert abs(g["iters"] - c["iters"]) <= 1  # f32 reductions in another order
    assert g["passed"] and c["passed"]
