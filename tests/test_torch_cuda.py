"""The port on the card: each CUDA kernel against its plain version, the
main path's CUDA route against the CPU route, and the sparse-weight layer
(``LinearSparse``) on the card against the same layer on the CPU.

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
from repro_torch.core.formats import COO, HYB, Format, coo_from_dense_np, to_numpy
from repro_torch.core.ops import spmm, spmm_t, spmv
from repro_torch.kernels import bsr_spmm as kb
from repro_torch.kernels import csr_spmm as kcm
from repro_torch.kernels import csr_spmv as kc
from repro_torch.kernels import dia_spmv as kd
from repro_torch.kernels import ell_spmm as kem
from repro_torch.kernels import ell_spmv as ke
from repro_torch.kernels import ops as kops
from repro_torch.kernels import sell_spmm as ksm
from repro_torch.kernels import sell_spmv as ks
from repro_torch.kernels.ref import (bsr_spmm_ref, csr_spmm_ref, csr_spmm_t_ref,
                                     csr_spmv_ref, dia_spmv_ref, ell_spmm_ref, ell_spmm_t_ref,
                                     ell_spmv_ref, sell_spmm_ref, sell_spmm_t_ref, sell_spmv_ref)
from repro_torch.models import LinearSparse, prune_magnitude
from repro_torch.tuning import FormatPolicy, PatternFeatures

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
    """spmv(backend=None) on a CUDA tensor launches the format's kernel once
    per call (HYB: the ELL kernel once and the CSR kernel once) and agrees
    with backend='ref' on the card; COO keeps the reference path."""
    prob = hpcg.generate_problem(8, 8, 8)
    A = hpcg.to_coo(prob, device=card)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(A.shape[1])
                         .astype(np.float32)).to(card)
    cases = ((Format.DIA, {}, ["dia_spmv"]), (Format.CSR, {}, ["csr_spmv"]),
             (Format.ELL, {}, ["ell_spmv"]), (Format.SELL, {}, ["sell_spmv"]),
             (Format.HYB, {"k": 18}, ["ell_spmv", "csr_spmv"]),
             (Format.BSR, {"block_size": 8}, ["bsr_spmm"]), (Format.COO, {}, []))
    for fmt, hints, kernels in cases:
        M = DynamicMatrix(A).activate(fmt, **hints)
        before = kops.launch_counts()
        y = spmv(M, x)
        torch.cuda.synchronize()
        after = kops.launch_counts()
        assert {k: after[k] - before[k] for k in after} == \
            {k: int(k in kernels) for k in after}, fmt.name
        torch.testing.assert_close(y, spmv(M, x, backend="ref"), **TOL["float32"])


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


# ELL (M, N, K): K = 0, one chunk, several chunks of the shared-memory tile,
# a tile boundary that is not a multiple of the 128-row tile.
ELL_CASES = [(300, 250, 0), (300, 250, 27), (257, 90, 70), (1, 1, 1)]


def _ell_inputs(rng, m, n, k, dt, dev):
    """Columns past both edges (clamped), rows of padding only (col -1,
    val 0: empty rows)."""
    cols = rng.integers(-3, n + 3, (m, k)).astype(np.int32)
    vals = rng.standard_normal((m, k)).astype(np.float32)
    cols[::7], vals[::7] = -1, 0.0
    return (torch.from_numpy(cols).to(dev),
            torch.from_numpy(vals).to(dev, dt), _rand(rng, n, dt, dev))


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_ell_kernel_matches_plain(card, dtype_name):
    rng = np.random.default_rng(3)
    dt = DTYPES[dtype_name]
    for m, n, k in ELL_CASES:
        cols, vals, x = _ell_inputs(rng, m, n, k, dt, card)
        before = ke.launches
        y1, y2 = ke.ell_spmv(cols, vals, x), ke.ell_spmv(cols, vals, x)
        torch.cuda.synchronize()
        assert ke.launches == before + (2 if k else 0)  # K = 0 launches nothing
        assert y1.dtype == dt and y1.shape == (m,)
        torch.testing.assert_close(y1.float(), ell_spmv_ref(cols, vals, x).float(),
                                   **TOL[dtype_name])
        assert torch.equal(y1, y2)


def _ragged_dense(rng, m, n):
    """Random rows of 0..3n/4 entries, every fifth row empty."""
    a = np.zeros((m, n), np.float32)
    for i in range(m):
        if i % 5:
            ln = int(rng.integers(1, 3 * n // 4))
            a[i, rng.choice(n, ln, replace=False)] = rng.standard_normal(ln)
    return a


def _sell_with_nan_ghosts(a, c, sigma, dt, dev):
    """A SELL container whose ghost lanes (perm == M) hold NaN values."""
    S = convert(coo_from_dense_np(a, device="cpu"), Format.SELL, c=c, sigma=sigma)
    data = S.data.clone()
    ptrs, perm = S.slice_ptrs.tolist(), S.perm.tolist()
    for lane, row in enumerate(perm):
        if row >= a.shape[0]:
            s, r = divmod(lane, c)
            data[ptrs[s] + r:ptrs[s + 1]:c] = float("nan")
    return [t.to(dev) for t in (S.slice_ptrs, S.cols, data.to(dt), S.perm)]


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("c,sigma", [(32, 256), (8, 16), (5, 5)])
def test_sell_kernel_matches_plain(card, dtype_name, c, sigma):
    """Empty rows, ghost lanes holding NaN (must be dropped), C != 32."""
    rng = np.random.default_rng(4)
    dt = DTYPES[dtype_name]
    m, n = 301, 120
    ptrs, cols, data, perm = _sell_with_nan_ghosts(_ragged_dense(rng, m, n), c, sigma,
                                                   dt, card)
    assert int(perm.max()) == m  # the case has ghost lanes
    x = _rand(rng, n, dt, card)
    before = ks.launches
    y1 = ks.sell_spmv(ptrs, cols, data, perm, x, m, c)
    y2 = ks.sell_spmv(ptrs, cols, data, perm, x, m, c)
    torch.cuda.synchronize()
    assert ks.launches == before + 2 and bool(torch.isfinite(y1).all())
    torch.testing.assert_close(y1.float(), sell_spmv_ref(ptrs, cols, data, perm, x, m,
                                                         c).float(), **TOL[dtype_name])
    assert torch.equal(y1, y2)


def _bsr_inputs(rng, bs, ncols, dt, dev):
    """Block rows of 0..4 blocks (first and last empty), one block column
    past the edge (clamped), 3 capacity blocks of NaN past indptr[-1]."""
    mb, nbc = 9, 6
    lens = [0] + [int(v) for v in rng.integers(0, 5, mb - 2)] + [0]
    nblk = sum(lens)
    indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    bcol = rng.integers(0, nbc, nblk + 3).astype(np.int32)
    if nblk:
        bcol[0] = nbc + 2
    blocks = rng.standard_normal((nblk + 3, bs, bs)).astype(np.float32)
    blocks[nblk:] = np.nan
    B = rng.standard_normal((nbc * bs, ncols)).astype(np.float32)
    return (torch.from_numpy(indptr).to(dev), torch.from_numpy(bcol).to(dev),
            torch.from_numpy(blocks).to(dev, dt), torch.from_numpy(B).to(dev, dt),
            mb * bs)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("bs", [2, 8, 16])
@pytest.mark.parametrize("ncols", [1, 8])
def test_bsr_kernel_matches_plain(card, dtype_name, bs, ncols):
    rng = np.random.default_rng(5)
    dt = DTYPES[dtype_name]
    indptr, bcol, blocks, B, m = _bsr_inputs(rng, bs, ncols, dt, card)
    before = kb.launches
    y1 = kb.bsr_spmm(indptr, bcol, blocks, B, m)
    y2 = kb.bsr_spmm(indptr, bcol, blocks, B, m)
    torch.cuda.synchronize()
    assert kb.launches == before + 2 and y1.shape == (m, ncols)
    assert bool(torch.isfinite(y1).all()) and not bool(y1[:bs].any())  # empty row 0
    torch.testing.assert_close(y1.float(), bsr_spmm_ref(indptr, bcol, blocks, B, m).float(),
                               **TOL[dtype_name])
    assert torch.equal(y1, y2)


def test_bsr_with_an_empty_block_row_still_launches(card):
    """No host look at indptr and no fallback: the kernel runs and writes
    zeros for the empty block row."""
    a = np.zeros((16, 16), np.float32)
    a[:4, :4] = 1.0
    a[12:, 8:] = 2.0  # block rows 1 and 2 (bs = 4) are empty
    Bm = convert(coo_from_dense_np(a, device=card), Format.BSR, block_size=4)
    x = torch.ones(16, device=card)
    before = kb.launches
    y = spmv(Bm, x)
    torch.cuda.synchronize()
    assert kb.launches == before + 1
    torch.testing.assert_close(y, torch.from_numpy(a.sum(axis=1)).to(card))


def test_hyb_tail_padding_is_never_read(card):
    """Tail padding with row id M and NaN values sorts past indptr[M]."""
    a = _ragged_dense(np.random.default_rng(6), 64, 40)
    H = convert(coo_from_dense_np(a, device=card), Format.HYB, k=3)
    pad = 5
    tail = H.coo
    coo = COO(torch.cat([tail.row, torch.full((pad,), 64, dtype=torch.int32, device=card)]),
              torch.cat([tail.col, torch.zeros(pad, dtype=torch.int32, device=card)]),
              torch.cat([tail.data, torch.full((pad,), float("nan"), device=card)]),
              tail.shape, tail.nnz + pad)
    Hp = HYB(H.ell, coo, H.shape, H.nnz)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(40).astype(np.float32))
    y = spmv(Hp, x.to(card))
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all())
    np.testing.assert_allclose(y.cpu().numpy(), a @ x.numpy(), rtol=1e-4, atol=1e-4)


def test_menu_spmv_makes_no_host_sync(card):
    """SELL, HYB (tail sort and row pointers) and BSR SpMV under
    ``set_sync_debug_mode("error")``: any device->host sync raises."""
    prob = hpcg.generate_problem(8, 8, 8)
    A = hpcg.to_coo(prob, device=card)
    x = torch.ones(A.shape[1], device=card)
    mats = [convert(A, Format.SELL), convert(A, Format.HYB, k=18),
            convert(A, Format.BSR, block_size=8)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ys = [spmv(M, x) for M in mats]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for y in ys:
        torch.testing.assert_close(y, torch.from_numpy(hpcg.rhs_for_ones(prob)).to(card),
                                   rtol=1e-4, atol=1e-4)


def test_profile_policy_picks_from_the_menu_on_card(card):
    """The profile tuner times every candidate through its kernel."""
    A = hpcg.to_coo(hpcg.generate_problem(16, 16, 16), device=card)
    kops.reset_launches()
    rep = FormatPolicy("profile", profile_iters=2).select(A)
    assert rep.best in rep.times and set(rep.times) == set(FormatPolicy().candidates)
    counts = kops.launch_counts()
    assert all(counts[k] > 0 for k in ("csr_spmv", "dia_spmv", "ell_spmv", "sell_spmv"))


# ---------------------------------------------------------------------------
# SpMM and SpMM_T kernels, and the sparse-weight layer
# ---------------------------------------------------------------------------

# Token counts: one (decode), a ragged tile, several tiles.
TOKENS = (1, 3, 20)
# CSR row lengths for SpMM: empty first/middle/last rows, one row longer
# than a warp's stride.
SPMM_LENS = [0, 3, 0, 0, 300, 1, 27, 0, 64, 0, 33]


def _csr_ragged(rng, lens, n, dt, dev):
    """CSR with capacity padding past indptr[-1] holding NaN (never read)
    and columns past both edges (clamped)."""
    m, nnz = len(lens), sum(lens)
    ip = torch.tensor([0] + list(itertools.accumulate(lens)), dtype=torch.int32, device=dev)
    ix = torch.from_numpy(rng.integers(-2, n + 2, nnz + 37).astype(np.int32)).to(dev)
    v = _rand(rng, nnz + 37, dt, dev)
    v[nnz:] = float("nan")
    return ip, ix, v, m


def _same(y1, y2, y_p, dtype_name):
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y1).all()) and y1.shape == y_p.shape
    torch.testing.assert_close(y1.float(), y_p.float(), **TOL[dtype_name])
    assert torch.equal(y1, y2)  # one summation order: bitwise stable


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_csr_spmm_kernel_matches_plain(card, dtype_name):
    rng = np.random.default_rng(10)
    dt = DTYPES[dtype_name]
    n = 500
    ip, ix, v, m = _csr_ragged(rng, SPMM_LENS, n, dt, card)
    for k in (1, 3, 8, 9, 40, 256, 300):
        B = _rand(rng, (n, k), dt, card)
        y_p = csr_spmm_ref(ip, ix, v, B, m)
        for vec in (kcm.VEC_WIDTHS if k <= 8 else (4,)):  # vec reads K <= 8 only
            before = kcm.launches
            y1 = kcm.csr_spmm(ip, ix, v, B, m, vec=vec)
            y2 = kcm.csr_spmm(ip, ix, v, B, m, vec=vec)
            assert kcm.launches == before + 2
            _same(y1, y2, y_p, dtype_name)
            assert not bool(y1[0].any())  # an empty row writes zeros


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("n", [500, 70000])
def test_csr_spmm_t_kernel_matches_plain(card, dtype_name, n):
    rng = np.random.default_rng(11)
    dt = DTYPES[dtype_name]
    ip, ix, v, m = _csr_ragged(rng, SPMM_LENS, n, dt, card)
    for t in TOKENS:
        X = _rand(rng, (t, n), dt, card)
        y_p = csr_spmm_t_ref(ip, ix, v, X, m)
        for vec, tt in itertools.product(kcm.VEC_WIDTHS, kcm.TOKEN_TILES):
            before = kcm.launches_t
            y1 = kcm.csr_spmm_t(ip, ix, v, X, m, vec=vec, tt=tt)
            y2 = kcm.csr_spmm_t(ip, ix, v, X, m, vec=vec, tt=tt)
            assert kcm.launches_t == before + 2
            _same(y1, y2, y_p, dtype_name)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_ell_spmm_t_kernel_matches_plain(card, dtype_name):
    rng = np.random.default_rng(12)
    dt = DTYPES[dtype_name]
    for m, n, k in ELL_CASES:
        cols, vals, _ = _ell_inputs(rng, m, n, k, dt, card)
        for t in TOKENS:
            X = _rand(rng, (t, n), dt, card)
            y_p = ell_spmm_t_ref(cols, vals, X)
            for vec, tt in ((2, 1), (8, 4), (32, 8), (4, 2), (16, None)):
                before = kem.launches_t
                y1 = kem.ell_spmm_t(cols, vals, X, vec=vec, tt=tt)
                y2 = kem.ell_spmm_t(cols, vals, X, vec=vec, tt=tt)
                assert kem.launches_t == before + (2 if k else 0)  # K = 0 launches nothing
                _same(y1, y2, y_p, dtype_name)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("c,sigma", [(32, 256), (8, 16), (5, 5)])
def test_sell_spmm_t_kernel_matches_plain(card, dtype_name, c, sigma):
    """Ghost lanes hold NaN (never written to Y), empty rows, C != 32."""
    rng = np.random.default_rng(13)
    dt = DTYPES[dtype_name]
    m, n = 301, 120
    args = _sell_with_nan_ghosts(_ragged_dense(rng, m, n), c, sigma, dt, card)
    for t in TOKENS:
        X = _rand(rng, (t, n), dt, card)
        y_p = sell_spmm_t_ref(*args, X, m, c)
        for tt in kcm.TOKEN_TILES + (None,):
            before = ksm.launches_t
            y1 = ksm.sell_spmm_t(*args, X, m, c, tt=tt)
            y2 = ksm.sell_spmm_t(*args, X, m, c, tt=tt)
            assert ksm.launches_t == before + 2
            _same(y1, y2, y_p, dtype_name)


def test_spmm_on_formats_without_a_ported_kernel_raises(card):
    """Every SpMM kernel is ported now: on the card ELL, SELL and HYB SpMM
    launch their kernels (HYB: ell_spmm and csr_spmm over the tail), as do
    CSR and BSR, with ``backend=None`` and ``"cuda"``; COO runs the
    reference, as in the JAX package."""
    a = _ragged_dense(np.random.default_rng(14), 64, 48)
    A = coo_from_dense_np(a, device=card)
    B = torch.ones(48, 5, device=card)
    for fmt, kernels in ((Format.ELL, ("ell_spmm",)), (Format.SELL, ("sell_spmm",)),
                         (Format.HYB, ("ell_spmm", "csr_spmm")), (Format.CSR, ("csr_spmm",)),
                         (Format.BSR, ("bsr_spmm",)), (Format.COO, ())):
        M = convert(A, fmt, **({"block_size": 16} if fmt == Format.BSR else {}))
        for backend in (None, "cuda"):
            before = kops.launch_counts()
            y = spmm(M, B, backend=backend)
            torch.cuda.synchronize()
            after = kops.launch_counts()
            assert {k: after[k] - before[k] for k in after} == \
                {k: int(k in kernels) for k in after}
            np.testing.assert_allclose(y.cpu().numpy(), a @ np.ones((48, 5), np.float32),
                                       rtol=1e-4, atol=1e-4)


# Rhs widths of Y = A @ B: the sub-warp schedule (K <= 8), one lane group
# (9), a group with several columns a lane (256), a second grid row (300).
SPMM_WIDTHS = (1, 3, 9, 256, 300)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_ell_spmm_kernel_matches_plain(card, dtype_name):
    """Clamped columns and rows of padding only; K = 0 launches nothing."""
    rng = np.random.default_rng(18)
    dt = DTYPES[dtype_name]
    for m, n, k in ELL_CASES:
        cols, vals, _ = _ell_inputs(rng, m, n, k, dt, card)
        for kb in SPMM_WIDTHS:
            B = _rand(rng, (n, kb), dt, card)
            y_p = ell_spmm_ref(cols, vals, B)
            for vec in (kcm.VEC_WIDTHS if kb <= 8 else (8,)):  # vec reads Kb <= 8 only
                before = kem.launches
                y1 = kem.ell_spmm(cols, vals, B, vec=vec)
                y2 = kem.ell_spmm(cols, vals, B, vec=vec)
                assert kem.launches == before + (2 if k else 0)
                _same(y1, y2, y_p, dtype_name)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("c,sigma", [(32, 256), (8, 16), (5, 5)])
def test_sell_spmm_kernel_matches_plain(card, dtype_name, c, sigma):
    """Ghost lanes hold NaN (never written to Y), empty rows, C != 32."""
    rng = np.random.default_rng(19)
    dt = DTYPES[dtype_name]
    m, n = 301, 120
    args = _sell_with_nan_ghosts(_ragged_dense(rng, m, n), c, sigma, dt, card)
    for kb in SPMM_WIDTHS:
        B = _rand(rng, (n, kb), dt, card)
        before = ksm.launches
        y1 = ksm.sell_spmm(*args, B, m, c)
        y2 = ksm.sell_spmm(*args, B, m, c)
        assert ksm.launches == before + 2
        _same(y1, y2, sell_spmm_ref(*args, B, m, c), dtype_name)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_hyb_spmm_kernel_matches_plain(card, dtype_name):
    """ELL planes plus the CSR tail, each kernel once a call."""
    rng = np.random.default_rng(20)
    dt = DTYPES[dtype_name]
    a = _ragged_dense(rng, 96, 70)
    H = convert(coo_from_dense_np(a, device=card, dtype=dt), Format.HYB, k=3)
    assert H.coo.nnz > 0
    for kb in SPMM_WIDTHS:
        B = _rand(rng, (70, kb), dt, card)
        before = kops.launch_counts()
        y1, y2 = kops.hyb_spmm(H, B), kops.hyb_spmm(H, B)
        after = kops.launch_counts()
        assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == \
            {"ell_spmm": 2, "csr_spmm": 2}
        y_p = ell_spmm_ref(H.ell.cols, H.ell.data, B) + csr_spmm_ref(
            *kops.tail_csr(H.coo, 96), B, 96)
        _same(y1, y2, y_p, dtype_name)


def test_tune_kernel_then_auto_launches_the_kernel(card, tmp_path, monkeypatch):
    """A record that beat the reference routes ``auto`` to the kernel with
    its knobs (bitwise what ``backend="cuda", cfg=`` gives), one launch a
    call; a record that lost routes to the reference, counted as a veto."""
    from repro_torch.obs import metrics
    from repro_torch.tuning import CACHE_PATH_ENV, KernelRecord, SelectionCache, kernel_tune
    path = str(tmp_path / "sel.json")
    monkeypatch.setenv(CACHE_PATH_ENV, path)
    rng = np.random.default_rng(21)
    A = convert(coo_from_dense_np(_ragged_dense(rng, 400, 300), device=card), Format.ELL)
    B = _rand(rng, (300, 16), torch.float32, card)
    rec = kernel_tune.tune_kernel(A, B, op="spmm", cache=SelectionCache(path), iters=2, inner=1)
    rec = KernelRecord(rec.fmt, rec.op, rec.cfg, kernel_us=1.0, ref_us=2.0)  # a winner
    key = kernel_tune.kernel_key(A.format, 400, 300, A.nnz, op="spmm", ncols=16, device=card)
    SelectionCache(path).put_raw(key, rec.to_json())
    assert kernel_tune.best_config(A, op="spmm", ncols=256) is None  # b16 only
    with metrics.scope() as s:
        before = kem.launches
        y = spmm(A, B, backend="auto")
        torch.cuda.synchronize()
        assert kem.launches == before + 1 and s.delta("kernel.route.cuda") == 1
    assert torch.equal(y, spmm(A, B, backend="cuda", cfg=rec.cfg))
    SelectionCache(path).put_raw(key, KernelRecord(rec.fmt, rec.op, rec.cfg, 2.0, 1.0).to_json())
    with metrics.scope() as s:
        before = kem.launches
        y_ref = spmm(A, B, backend="auto")
        assert kem.launches == before and s.delta("kernel.route.veto") == 1
    torch.testing.assert_close(y_ref, y, rtol=1e-4, atol=1e-4)


def test_cached_policy_round_trip_on_card(card, tmp_path):
    """FormatPolicy("cached") per width bucket: a miss takes the ml pick
    and pins ("cuda", cfg) from a winning record of its own cache; the
    next call hits and returns the same (format, backend, cfg)."""
    from repro_torch.models import WEIGHT_CANDIDATES
    from repro_torch.tuning import KernelRecord, SelectionCache, kernel_tune
    rng = np.random.default_rng(22)
    w = prune_magnitude(rng.standard_normal((128, 96)).astype(np.float32), 0.25)
    A = coo_from_dense_np(w.T, device=card)
    cache = SelectionCache(str(tmp_path / "sel.json"))
    fmt = FormatPolicy("ml", candidates=WEIGHT_CANDIDATES).select(A).best
    cache.put_raw(kernel_tune.kernel_key(fmt, 96, 128, A.nnz, op="spmm_t", ncols=256,
                                         device=card),
                  KernelRecord(fmt.name, "spmm_t", {"tt": 4}, 1.0, 9.0).to_json())
    for ncols, pin in ((1, (None, None)), (256, ("cuda", {"tt": 4}))):
        pol = FormatPolicy("cached", candidates=WEIGHT_CANDIDATES, cache=cache)
        cold = pol.select(A, op="spmm_t", ncols=ncols)
        warm = pol.select(A, op="spmm_t", ncols=ncols)
        assert cold.mode == "cached-miss:ml" and warm.mode == "cached"
        assert (cold.best, cold.backend, cold.cfg) == (warm.best, warm.backend, warm.cfg) == \
            (fmt,) + pin


# Kernels each weight format's SpMM_T launches once per call.
LAYER_KERNELS = {Format.CSR: ["csr_spmm_t"], Format.ELL: ["ell_spmm_t"],
                 Format.SELL: ["sell_spmm_t"], Format.HYB: ["ell_spmm_t", "csr_spmm_t"],
                 Format.COO: []}


@pytest.mark.parametrize("fmt", list(LAYER_KERNELS), ids=lambda f: f.name)
def test_linear_sparse_on_card_matches_cpu(card, fmt):
    rng = np.random.default_rng(15)
    w = prune_magnitude(rng.standard_normal((96, 160)).astype(np.float32), 0.25)
    b = rng.standard_normal(160).astype(np.float32)
    gpu = LinearSparse.from_dense(w, fmt=fmt, bias=b)
    cpu = LinearSparse.from_dense(w, fmt=fmt, bias=b, device="cpu")
    assert gpu.weight.concrete.device.type == "cuda"
    for t in (1, 3, 20):
        x = rng.standard_normal((t, 96)).astype(np.float32)
        before = kops.launch_counts()
        y = gpu(torch.from_numpy(x).to(card))
        torch.cuda.synchronize()
        after = kops.launch_counts()
        assert {k: after[k] - before[k] for k in after} == \
            {k: int(k in LAYER_KERNELS[fmt]) for k in after}
        torch.testing.assert_close(y.cpu(), cpu(torch.from_numpy(x)), **TOL["float32"])
        np.testing.assert_allclose(y.cpu().numpy(), x.astype(np.float64) @ w + b,
                                   rtol=1e-4, atol=1e-4)


def test_linear_sparse_call_makes_no_host_sync(card):
    rng = np.random.default_rng(16)
    w = prune_magnitude(rng.standard_normal((64, 96)).astype(np.float32), 0.3)
    layers = [LinearSparse.from_dense(w, fmt=f) for f in (Format.CSR, Format.ELL,
                                                           Format.SELL, Format.HYB)]
    x = torch.ones(8, 64, device=card)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ys = [layer(x) for layer in layers]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for y in ys:
        np.testing.assert_allclose(y.cpu().numpy(), np.ones((8, 64), np.float32) @ w,
                                   rtol=1e-4, atol=1e-4)


def test_profile_spmm_t_on_card_skips_nothing_and_launches_kernels(card):
    """FormatPolicy('profile') at op='spmm_t' times every weight candidate
    on the card, each kernel format through its kernel."""
    rng = np.random.default_rng(17)
    w = prune_magnitude(rng.standard_normal((128, 96)).astype(np.float32), 0.25)
    A = coo_from_dense_np(w.T, device=card)
    kops.reset_launches()
    candidates = list(LAYER_KERNELS)
    rep = FormatPolicy("profile", candidates=candidates, profile_iters=2).select(
        A, op="spmm_t", ncols=16)
    assert set(rep.times) == set(candidates)
    counts = kops.launch_counts()
    assert all(counts[k] > 0 for k in ("csr_spmm_t", "ell_spmm_t", "sell_spmm_t"))
    kops.reset_launches()
    rep = FormatPolicy("profile", candidates=candidates, profile_iters=2).select(
        A, op="spmm", ncols=16)
    assert set(rep.times) == set(candidates)
    counts = kops.launch_counts()
    assert all(counts[k] > 0 for k in ("csr_spmm", "ell_spmm", "sell_spmm"))
