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
from repro_torch.core.formats import COO, CSR, HYB, Format, coo_from_dense_np, to_numpy
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
from torch_long_rows import csr_arrays, powerlaw_csr, ragged_lens, with_filler

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


def _close_to_plain(y, ip, ix, v, x, m, dtype_name):
    """``y`` within TOL's rtol of each row's sum of |products| (plus its
    atol) of the plain version: a long row's f32 sum taken in another order
    moves by about its length times 2^-24 of that scale, which for a row
    of 2^20 random terms is more than 1e-4 of a total that cancels; the
    plain version's own order (``index_add_``) changes from run to run."""
    tol = TOL[dtype_name]
    y_p = csr_spmv_ref(ip, ix, v, x, m).float()
    scale = csr_spmv_ref(ip, ix, v.abs(), x.abs(), m).float()
    err = (y.float() - y_p).abs()
    assert bool((err <= tol["atol"] + tol["rtol"] * scale).all()), float(err.max())


def _csr(ip, ix, v, shape):
    return CSR(ip, ix, v, shape=shape, nnz=int(v.shape[0]))


def _on(card, dt, *arrays):
    ip, ix, v = arrays[:3]
    out = [torch.from_numpy(ip).to(card), torch.from_numpy(ix).to(card),
           torch.from_numpy(v).to(card, dt)]
    return out + [torch.from_numpy(a).to(card, dt) for a in arrays[3:]]


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_csr_long_rows_match_plain_at_every_width(card, dtype_name):
    """Rows of exactly L and L + 1 entries (L = 32 * vec), k * CHUNK +- 1,
    one row holding every entry, a row of 2^20 entries; NaN capacity past
    indptr[-1] (|NaN| is NaN: never read either). Each call is one launch;
    reruns are bitwise (the second call builds its plan anew)."""
    rng = np.random.default_rng(11)
    dt = DTYPES[dtype_name]
    n = 5000
    for vec in kc.VEC_WIDTHS:
        for name, lens in ragged_lens(vec).items():
            ip, ix, v, x = _on(card, dt, *csr_arrays(rng, lens, n),
                               rng.standard_normal(n).astype(np.float32))
            m = len(lens)
            before = kc.launches
            y1 = kc.csr_spmv(ip, ix, v, x, m, vec=vec)
            y2 = kc.csr_spmv(ip, ix, v, x, m, vec=vec)
            torch.cuda.synchronize()
            assert kc.launches == before + 2, (vec, name)
            assert bool(torch.isfinite(y1).all()), (vec, name)
            _close_to_plain(y1, ip, ix, v, x, m, dtype_name)
            assert torch.equal(y1, y2), (vec, name)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_csr_power_law_matches_plain(card, dtype_name):
    """M = N = 2^20, rows of 1 + floor(pareto(1.5) * 4) entries up to
    65,536 (~8.9 M entries): through the container route, with its cached
    plan, and through the wrapper with a plan built for the call."""
    dt = DTYPES[dtype_name]
    indptr, idx, val = powerlaw_csr(0, 1 << 20)
    ip, ix, v, x = _on(card, dt, indptr, idx, val,
                       np.random.default_rng(1).standard_normal(1 << 20).astype(np.float32))
    A = _csr(ip, ix, v, (1 << 20, 1 << 20))
    vec = kops.default_config(A)["vec"]
    y1, y2 = kops.csr_spmv(A, x), kc.csr_spmv(ip, ix, v, x, A.shape[0], vec=vec)
    torch.cuda.synchronize()
    _close_to_plain(y1, ip, ix, v, x, A.shape[0], dtype_name)
    assert torch.equal(y1, y2)


def test_csr_long_rows_make_no_host_sync_from_the_first_call(card):
    """The plan is built on the device inside the checked region: on a new
    container's first call, and by the wrapper when it is given none."""
    rng = np.random.default_rng(12)
    ip, ix, v, x = _on(card, torch.float32, *csr_arrays(rng, ragged_lens(2)["edges"], 900),
                       rng.standard_normal(900).astype(np.float32))
    A = _csr(ip, ix, v, (ip.shape[0] - 1, 900))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y1 = kops.csr_spmv(A, x, cfg={"vec": 2})
        y2 = kc.csr_spmv(ip, ix, v, x, A.shape[0], vec=2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(y1, y2)
    _close_to_plain(y1, ip, ix, v, x, A.shape[0], "float32")


def test_csr_long_rows_100_back_to_back_calls_give_the_same_bits(card):
    """The arrival counters go back to 0 at the end of every call, so the
    plan serves the next call on the stream: 100 calls, one launch each, no
    synchronisation between them."""
    rng = np.random.default_rng(13)
    lens = with_filler([0, 40 * 256 + 3, 5, 3 * 256, 700, 0, 2 * 256 + 1], 2)
    ip, ix, v, x = _on(card, torch.float32, *csr_arrays(rng, lens, 900),
                       rng.standard_normal(900).astype(np.float32))
    plan = kc.long_row_plan(ip, v.shape[0], 2)
    before = kc.launches
    ys = [kc.csr_spmv(ip, ix, v, x, len(lens), vec=2, plan=plan) for _ in range(100)]
    torch.cuda.synchronize()
    assert kc.launches == before + 100
    assert all(torch.equal(ys[0], y) for y in ys[1:])
    assert not plan.arrive.any()
    _close_to_plain(ys[0], ip, ix, v, x, len(lens), "float32")


def test_csr_wrapper_refuses_a_plan_of_another_width(card):
    ip = torch.tensor([0, 3, 600], dtype=torch.int32, device=card)
    ix = torch.zeros(600, dtype=torch.int32, device=card)
    v = torch.ones(600, device=card)
    plan = kc.long_row_plan(ip, 600, 2)
    with pytest.raises(ValueError, match="built for vec=2, not vec=4"):
        kc.csr_spmv(ip, ix, v, torch.ones(4, device=card), 2, vec=4, plan=plan)
    y = kc.csr_spmv(ip, ix, v, torch.ones(4, device=card), 2, vec=2, plan=plan)
    assert y.tolist() == [3.0, 597.0]


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


# The token-major SpMM_T schedule (xt): token counts around its tiles, rhs
# widths of one chunk and of several (neither a multiple of a chunk), and
# rows in three column orders: sorted (one run), two sorted runs (ELL's
# trailing padding is one), and no order at all (filtered rows); every
# layout holds empty rows and columns past both edges.
XT_TOKENS = (9, 16, 31, 33, 256, 257)
XT_WIDTHS = (700, 9001)
XT_LAYOUTS = ("sorted", "two_runs", "unsorted")
# |y_k - y_p| <= atol + sum_rtol * sum|a||b| + out_rtol * |y_p| (chip_smoke.py's
# SpMM rule: other summation orders in f32, one rounding to bf16).
SPMM_TOL = {"float32": (1e-4, 1e-4, 0.0), "bfloat16": (0.0, 1e-4, 2.0 ** -7)}


def _spmm_reading(y, y_p, scale, dtype_name):
    atol, sum_rtol, out_rtol = SPMM_TOL[dtype_name]
    limit = atol + sum_rtol * scale.float() + out_rtol * y_p.float().abs()
    diff = (y.float() - y_p.float()).abs()
    return float((diff / limit.clamp_min(1e-30)).max()) if y.numel() else 0.0


def _row_cols(rng, layout, ln, n):
    """Column indices of one row of ``ln`` entries in ``layout`` order."""
    if layout == "unsorted":
        return rng.integers(-2, n + 2, ln)
    if layout == "two_runs" and ln > 1:
        cut = int(rng.integers(1, ln))
        return np.concatenate([np.sort(rng.integers(n // 2, n + 2, cut)),
                               np.sort(rng.integers(-2, n // 2, ln - cut))])
    return np.sort(rng.integers(-2, n + 2, ln))


def _xt_csr(rng, layout, n, dt, dev, m=300):
    """CSR in ``layout`` order: empty rows, rows longer than a chunk, and
    capacity padding of NaN past indptr[-1] (never read)."""
    lens = rng.integers(0, 80, m)
    lens[::7] = 0
    lens[5], lens[11] = 2 * n + 3, 33
    ix = np.concatenate([_row_cols(rng, layout, int(ln), n) for ln in lens] +
                        [rng.integers(0, n, 37)]).astype(np.int32)
    nnz = int(lens.sum())
    ip = torch.tensor(np.concatenate([[0], np.cumsum(lens)]), dtype=torch.int32, device=dev)
    v = _rand(rng, nnz + 37, dt, dev)
    v[nnz:] = float("nan")
    return ip, torch.from_numpy(ix).to(dev), v, m


def _xt_ell(rng, layout, n, k, dt, dev, m=300):
    """ELL in ``layout`` order: each row's live slots, then padding (col -1,
    val 0) to K; every seventh row is padding only."""
    cols = np.full((m, k), -1, np.int32)
    vals = np.zeros((m, k), np.float32)
    for i in range(m):
        ln = 0 if i % 7 == 0 or k == 0 else int(rng.integers(1, k + 1))
        cols[i, :ln] = _row_cols(rng, layout, ln, n)
        vals[i, :ln] = rng.standard_normal(ln)
    return torch.from_numpy(cols).to(dev), torch.from_numpy(vals).to(dev, dt)


def _check_xt(run, plain, X, row_cfg, dtype_name, counters, expect_launch=True):
    """Every tile against the plain version (and the row schedule ``row_cfg``)
    within SPMM_TOL, bitwise reruns, two counted token-major launches."""
    y_p = plain(X, False)
    scale = plain(X, True)
    y_row = run(X, **row_cfg)
    torch.cuda.synchronize()
    assert _spmm_reading(y_row, y_p, scale, dtype_name) <= 1.0
    for xt in kcm.XT_TILES:
        before = [getattr(mod, attr) for mod, attr in counters]
        y1, y2 = run(X, vec=8, xt=xt), run(X, vec=8, xt=xt)
        torch.cuda.synchronize()
        launched = [getattr(mod, attr) - b for (mod, attr), b in zip(counters, before)]
        assert launched == [2 if expect_launch else 0] * len(counters), (xt, launched)
        assert y1.shape == y_p.shape and y1.dtype == X.dtype
        assert bool(torch.isfinite(y1).all())
        assert _spmm_reading(y1, y_p, scale, dtype_name) <= 1.0, xt
        assert _spmm_reading(y1, y_row, scale, dtype_name) <= 1.0, xt  # new against old
        assert torch.equal(y1, y2)  # one summation order: bitwise stable


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("layout", XT_LAYOUTS)
@pytest.mark.parametrize("n", XT_WIDTHS)
def test_token_major_csr_spmm_t_matches_plain(card, dtype_name, layout, n):
    rng = np.random.default_rng(40)
    dt = DTYPES[dtype_name]
    ip, ix, v, m = _xt_csr(rng, layout, n, dt, card)
    empty = (ip[1:] == ip[:-1]).nonzero().flatten()

    def run(X, **kw):
        return kcm.csr_spmm_t(ip, ix, v, X, m, **kw)

    def plain(X, absolute):
        return csr_spmm_t_ref(ip, ix, v.abs() if absolute else v, X.abs() if absolute else X, m)
    for t in XT_TOKENS:
        X = _rand(rng, (t, n), dt, card)
        _check_xt(run, plain, X, {"vec": 8, "tt": 8}, dtype_name,
                  [(kcm, "launches_t"), (kcm, "launches_xt")])
        assert not bool(run(X, vec=8, xt=32)[:, empty].any())  # empty rows write zeros


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("layout", XT_LAYOUTS)
@pytest.mark.parametrize("n", XT_WIDTHS)
def test_token_major_ell_spmm_t_matches_plain(card, dtype_name, layout, n):
    rng = np.random.default_rng(41)
    dt = DTYPES[dtype_name]
    for k in (0, 70):
        cols, vals = _xt_ell(rng, layout, n, k, dt, card)

        def run(X, **kw):
            return kem.ell_spmm_t(cols, vals, X, **kw)

        def plain(X, absolute):
            return ell_spmm_t_ref(cols, vals.abs() if absolute else vals,
                                  X.abs() if absolute else X)
        for t in XT_TOKENS:
            X = _rand(rng, (t, n), dt, card)
            _check_xt(run, plain, X, {"vec": 8, "tt": 8}, dtype_name,
                      [(kem, "launches_t"), (kem, "launches_xt")], expect_launch=k > 0)
            if k:
                assert not bool(run(X, vec=8, xt=64)[:, ::7].any())  # padding-only rows


def test_token_major_with_full_blocks_and_the_layer_route(card):
    """A matrix of enough rows for blocks of 8 rows a warp (the serving
    weights' case), through ``kernels.ops`` with the default cfg at T = 256
    and a record-free cfg without ``xt`` (the row schedule): both launch,
    only the first on the token-major schedule."""
    rng = np.random.default_rng(42)
    a = np.where(rng.random((9000, 700)) < 0.05, rng.standard_normal((9000, 700)), 0)
    A = coo_from_dense_np(a.astype(np.float32), device=card)
    X = _rand(rng, (256, 700), torch.float32, card)
    oracle = X.double() @ torch.from_numpy(a.T).to(card)
    for fmt, mod in ((Format.CSR, kcm), (Format.ELL, kem)):
        M = convert(A, fmt)
        for cfg, xt_launches in ((None, 1), ({"vec": 8, "tt": 8}, 0)):
            before = (mod.launches_t, mod.launches_xt)
            y = spmm_t(M, X, backend="cuda", cfg=cfg)
            torch.cuda.synchronize()
            assert (mod.launches_t - before[0], mod.launches_xt - before[1]) == (1, xt_launches)
            err = float((y.double() - oracle).abs().max() / oracle.abs().max())
            assert err <= 1e-5, (fmt, cfg, err)


# SELL-C-sigma on the token-major schedule: containers built from rows in
# the three column orders (convert builds sorted rows only), sigma-sorted
# slices, ghost lanes (M % C != 0) holding NaN, empty rows and short rows
# with trailing padding (col -1, val 0).
SELL_XT_TOKENS = (31, 32, 33, 256, 257)


def _xt_sell(rng, layout, n, c, sigma, dt, dev, m=301):
    """SELL-C-sigma of ``m`` rows in ``layout`` column order: rows sorted by
    length (descending) within windows of ``sigma``, each slice as wide as
    its longest row, padding trailing each shorter row, ghost lanes past M
    holding NaN values."""
    lens = rng.integers(0, 80, m)
    lens[::7] = 0
    lens[5], lens[11] = 2 * n + 3, 33
    return _sell_of_lens(rng, lens, layout, n, c, sigma, dt, dev), m


def _sell_of_lens(rng, lens, layout, n, c, sigma, dt, dev):
    """SELL-C-sigma of rows of ``lens`` entries each in ``layout`` column
    order, as ``_xt_sell`` describes; returns (ptrs, cols, data, perm)."""
    m = len(lens)
    rows = [(_row_cols(rng, layout, int(ln), n).astype(np.int32),
             rng.standard_normal(int(ln)).astype(np.float32)) for ln in lens]
    nslices = -(-m // c)
    perm = np.full(nslices * c, m, np.int32)
    order = np.concatenate([w0 + np.argsort(-lens[w0:w0 + sigma], kind="stable")
                            for w0 in range(0, m, sigma)])
    perm[:m] = order
    widths = [max([int(lens[r]) for r in perm[s * c:(s + 1) * c] if r < m] + [0])
              for s in range(nslices)]
    ptrs = np.concatenate([[0], np.cumsum(np.array(widths) * c)]).astype(np.int32)
    cols = np.full(int(ptrs[-1]), -1, np.int32)
    vals = np.zeros(int(ptrs[-1]), np.float32)
    for q, r in enumerate(perm):
        s, lane = divmod(q, c)
        if r < m:
            at = ptrs[s] + lane + c * np.arange(lens[r])
            cols[at], vals[at] = rows[r]
        else:
            vals[ptrs[s] + lane:ptrs[s + 1]:c] = np.nan
    return [torch.from_numpy(ptrs).to(dev), torch.from_numpy(cols).to(dev),
            torch.from_numpy(vals).to(dev, dt), torch.from_numpy(perm).to(dev)]


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("layout", XT_LAYOUTS)
@pytest.mark.parametrize("n", XT_WIDTHS)
@pytest.mark.parametrize("c,sigma", [(32, 256), (64, 64)])
def test_token_major_sell_spmm_t_matches_plain(card, dtype_name, layout, n, c, sigma):
    rng = np.random.default_rng(43)
    dt = DTYPES[dtype_name]
    args, m = _xt_sell(rng, layout, n, c, sigma, dt, card)
    assert int(args[3].max()) == m  # the case has ghost lanes
    empty = [i for i in range(m) if i % 7 == 0]

    def run(X, vec=None, **kw):  # vec: the CSR/ELL knob, not SELL's
        return ksm.sell_spmm_t(*args, X, m, c, **kw)

    def plain(X, absolute):
        return sell_spmm_t_ref(args[0], args[1], args[2].abs() if absolute else args[2],
                               args[3], X.abs() if absolute else X, m, c)
    for t in SELL_XT_TOKENS:
        X = _rand(rng, (t, n), dt, card)
        _check_xt(run, plain, X, {"tt": 8}, dtype_name,
                  [(ksm, "launches_t"), (ksm, "launches_xt")])
        assert not bool(run(X, xt=32)[:, empty].any())  # empty rows write zeros


# Y = A @ B widths of the token-major ELL SpMM: one tile, one column past
# it, ragged, several tiles, one past; B also one element off its
# allocation's 16-byte alignment (staged through the padded scratch).
ELL_XT_WIDTHS = (32, 33, 100, 256, 257)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("layout", XT_LAYOUTS)
@pytest.mark.parametrize("n", XT_WIDTHS)
def test_token_major_ell_spmm_matches_plain(card, dtype_name, layout, n):
    rng = np.random.default_rng(44)
    dt = DTYPES[dtype_name]
    for k in (0, 70):
        cols, vals = _xt_ell(rng, layout, n, k, dt, card)

        def run(B, **kw):
            return kem.ell_spmm(cols, vals, B, **kw)

        def plain(B, absolute):
            return ell_spmm_ref(cols, vals.abs() if absolute else vals,
                                B.abs() if absolute else B)
        for kb in ELL_XT_WIDTHS:
            B = _rand(rng, (n, kb), dt, card)
            off = torch.empty(n * kb + 1, dtype=dt, device=card)[1:].view(n, kb)
            off.copy_(B)
            assert off.data_ptr() % 16 and off.is_contiguous()
            for Bv in (B, off):
                _check_xt(run, plain, Bv, {"vec": 8}, dtype_name,
                          [(kem, "launches"), (kem, "launches_kxt")], expect_launch=k > 0)
            if k:
                assert not bool(run(B, vec=8, xt=64)[::7].any())  # padding-only rows


def test_token_major_sell_spmm_t_and_ell_spmm_with_full_blocks_and_the_route(card):
    """A matrix of enough rows for blocks of 8 rows a warp, through the
    entry points: the default cfg at width 256 runs the token-major
    schedule, a cfg without ``xt`` the old one (SELL's slice kernel, ELL's
    rows), HYB's ELL part the token-major one beside its CSR tail; and the
    check catches a planted fault (every 64th stored entry dropped)."""
    rng = np.random.default_rng(45)
    a = np.where(rng.random((9000, 700)) < 0.05, rng.standard_normal((9000, 700)), 0)
    A = coo_from_dense_np(a.astype(np.float32), device=card)
    X = _rand(rng, (256, 700), torch.float32, card)
    B = X.T.contiguous()
    oracle = torch.from_numpy(a).to(card) @ B.double()
    for fmt, op, rhs, want, old, counters in (
            (Format.SELL, spmm_t, X, oracle.T, {"tt": 8}, (ksm, "launches_t", "launches_xt")),
            (Format.ELL, spmm, B, oracle, {"vec": 8}, (kem, "launches", "launches_kxt")),
            (Format.HYB, spmm, B, oracle, {"ell": {"vec": 8}, "csr": {"vec": 8}},
             (kem, "launches", "launches_kxt"))):
        M = convert(A, fmt)
        mod, total, xt = counters
        for cfg, xt_launches in ((None, 1), (old, 0)):
            before = (getattr(mod, total), getattr(mod, xt), kcm.launches)
            y = op(M, rhs, backend="cuda", cfg=cfg)
            torch.cuda.synchronize()
            assert (getattr(mod, total) - before[0], getattr(mod, xt) - before[1]) == \
                (1, xt_launches), (fmt, cfg)
            assert kcm.launches - before[2] == int(fmt == Format.HYB)  # the CSR tail
            err = float((y.double() - want).abs().max() / want.abs().max())
            assert err <= 1e-5, (fmt, cfg, err)
    # the planted fault reads above the SpMM limit for both kernels
    S, E = convert(A, Format.SELL), convert(A, Format.ELL)
    sargs = (S.slice_ptrs, S.cols, S.data, S.perm)
    for y, plain_of, vals, absolute in (
            (ksm.sell_spmm_t(*sargs, X, 9000, S.c, xt=128),
             lambda d: sell_spmm_t_ref(S.slice_ptrs, S.cols, d, S.perm, X, 9000, S.c), S.data,
             sell_spmm_t_ref(S.slice_ptrs, S.cols, S.data.abs(), S.perm, X.abs(), 9000, S.c)),
            (kem.ell_spmm(E.cols, E.data, B, vec=8, xt=128),
             lambda d: ell_spmm_ref(E.cols, d, B), E.data,
             ell_spmm_ref(E.cols, E.data.abs(), B.abs()))):
        torch.cuda.synchronize()
        assert _spmm_reading(y, plain_of(vals), absolute, "float32") <= 1.0
        dropped = vals.clone()
        dropped.view(-1)[::64] = 0
        assert _spmm_reading(y, plain_of(dropped), absolute, "float32") > 1.0


# Y = A @ B of CSR and SELL on the token-major (xt) and dense-tile (tc)
# schedules, on the rows of the xt cases (empty rows, sorted runs, two runs,
# filtered rows, clamped and duplicate columns, NaN capacity padding and
# ghost lanes, M not a multiple of the 64-row tile): widths of one tile, one
# column past it, two tiles, one past a pair of 128-column strips; B also
# one element off its allocation's 16-byte alignment (padded once).
AB_WIDTHS = (32, 33, 64, 257)
AB_SCHEDULES = [{"xt": x} for x in kcm.XT_TILES] + [{"tc": t} for t in kcm.TC_TILES]


def _check_ab(run, plain, B, dtype_name, mod):
    """Every xt and tc schedule against the plain version and the row
    schedule within SPMM_TOL, bitwise reruns, each launch counted in
    ``launches`` and in its schedule's count."""
    y_p, scale = plain(B, False), plain(B, True)
    y_row = run(B)
    torch.cuda.synchronize()
    assert _spmm_reading(y_row, y_p, scale, dtype_name) <= 1.0
    for knob in AB_SCHEDULES:
        count = "launches_kxt" if "xt" in knob else "launches_tc"
        before = (mod.launches, getattr(mod, count))
        y1, y2 = run(B, **knob), run(B, **knob)
        torch.cuda.synchronize()
        assert (mod.launches - before[0], getattr(mod, count) - before[1]) == (2, 2), knob
        assert y1.shape == y_p.shape and y1.dtype == B.dtype
        assert bool(torch.isfinite(y1).all()), knob
        assert _spmm_reading(y1, y_p, scale, dtype_name) <= 1.0, knob
        assert _spmm_reading(y1, y_row, scale, dtype_name) <= 1.0, knob  # new against old
        assert torch.equal(y1, y2), knob  # one summation order: bitwise stable


def _offset_copy(B):
    """B one element past a 16-byte boundary: read through the padded copy."""
    off = torch.empty(B.numel() + 1, dtype=B.dtype, device=B.device)[1:].view(B.shape)
    off.copy_(B)
    assert off.data_ptr() % 16 and off.is_contiguous()
    return off


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("layout", XT_LAYOUTS)
@pytest.mark.parametrize("n", XT_WIDTHS)
def test_ab_schedules_csr_spmm_match_plain(card, dtype_name, layout, n):
    rng = np.random.default_rng(46)
    dt = DTYPES[dtype_name]
    ip, ix, v, m = _xt_csr(rng, layout, n, dt, card)
    empty = (ip[1:] == ip[:-1]).nonzero().flatten()

    def run(B, **kw):
        return kcm.csr_spmm(ip, ix, v, B, m, vec=8, **kw)

    def plain(B, absolute):
        return csr_spmm_ref(ip, ix, v.abs() if absolute else v, B.abs() if absolute else B, m)
    for kb in AB_WIDTHS:
        B = _rand(rng, (n, kb), dt, card)
        for Bv in (B, _offset_copy(B)):
            _check_ab(run, plain, Bv, dtype_name, kcm)
        for knob in ({"xt": 32}, {"tc": 128}):
            assert not bool(run(B, **knob)[empty].any())  # empty rows write zeros


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("layout", XT_LAYOUTS)
@pytest.mark.parametrize("c,sigma", [(32, 256), (64, 64)])
def test_ab_schedules_sell_spmm_match_plain(card, dtype_name, layout, c, sigma):
    rng = np.random.default_rng(47)
    dt = DTYPES[dtype_name]
    n = 700
    args, m = _xt_sell(rng, layout, n, c, sigma, dt, card)
    assert int(args[3].max()) == m  # the case has ghost lanes
    empty = [i for i in range(m) if i % 7 == 0]

    def run(B, **kw):
        return ksm.sell_spmm(*args, B, m, c, **kw)

    def plain(B, absolute):
        return sell_spmm_ref(args[0], args[1], args[2].abs() if absolute else args[2],
                             args[3], B.abs() if absolute else B, m, c)
    for kb in AB_WIDTHS:
        B = _rand(rng, (n, kb), dt, card)
        for Bv in (B, _offset_copy(B)):
            _check_ab(run, plain, Bv, dtype_name, ksm)
        for knob in ({"xt": 32}, {"tc": 128}):
            assert not bool(run(B, **knob)[empty].any())  # empty rows write zeros


def test_ab_default_schedule_follows_the_density(card):
    """Through the entry points at width 256 on a matrix of enough 64-row
    tiles for ``tc``, in bfloat16: above ``TC_MIN_DENSITY`` the default cfg
    of CSR and SELL runs the dense-tile schedule, below it the token-major
    one, both within the SpMM rule of the plain version; float32 always the
    token-major one; a cfg without either knob runs the row schedule."""
    rng = np.random.default_rng(48)
    m, n = 64 * kops.TC_MIN_ROW_TILES + 5, 700
    least = kops.TC_MIN_DENSITY[torch.bfloat16]
    for density in (min(0.5, 2 * least), least / 4):
        a = np.where(rng.random((m, n)) < density, rng.standard_normal((m, n)), 0)
        for dt, dtype_name in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32")):
            A = coo_from_dense_np(a.astype(np.float32), device=card, dtype=dt)
            B = _rand(rng, (n, 256), dt, card)
            least_dt = kops.TC_MIN_DENSITY[dt]
            takes_tc = least_dt is not None and density >= least_dt
            for fmt, mod, ref in ((Format.CSR, kcm, csr_spmm_ref), (Format.SELL, ksm, sell_spmm_ref)):
                M = convert(A, fmt)
                cfg = kops.default_config(M, op="spmm", ncols=256)
                assert ("tc" in cfg) == takes_tc and ("xt" in cfg) != takes_tc, (density, cfg)
                if fmt == Format.CSR:
                    args = (M.indptr, M.indices)
                    plain = lambda d, b: ref(*args, d, b, m)
                else:
                    plain = lambda d, b: ref(M.slice_ptrs, M.cols, d, M.perm, b, m, M.c)
                y_p, scale = plain(M.data, B), plain(M.data.abs(), B.abs())
                for run_cfg, want in ((None, (1, int(not takes_tc), int(takes_tc))),
                                      ({"vec": 8}, (1, 0, 0))):
                    before = (mod.launches, mod.launches_kxt, mod.launches_tc)
                    y = spmm(M, B, backend="cuda", cfg=run_cfg)
                    torch.cuda.synchronize()
                    assert (mod.launches - before[0], mod.launches_kxt - before[1],
                            mod.launches_tc - before[2]) == want, (fmt, density, run_cfg)
                    assert _spmm_reading(y, y_p, scale, dtype_name) <= 1.0, (fmt, run_cfg)


def test_ab_wrappers_raise_on_a_bad_knob(card):
    """On the card a knob the kernels do not take raises before any launch:
    no schedule gives way to another."""
    rng = np.random.default_rng(49)
    a = _ragged_dense(rng, 64, 48)
    C = convert(coo_from_dense_np(a, device=card), Format.CSR)
    S = convert(coo_from_dense_np(a, device=card), Format.SELL)
    B = torch.ones(48, 64, device=card)
    before = kops.launch_counts()
    for bad in ({"xt": 32, "tc": 128}, {"tc": 64}, {"tc": True}, {"xt": 48}, {"tc": 128.0}):
        with pytest.raises(ValueError):
            kcm.csr_spmm(C.indptr, C.indices, C.data, B, 64, vec=8, **bad)
        with pytest.raises(ValueError):
            ksm.sell_spmm(S.slice_ptrs, S.cols, S.data, S.perm, B, 64, S.c, **bad)
    for bad in ({"xt": 32, "tc": 128}, {"tc": 64}, {"xt": 48}):  # through the entry point
        with pytest.raises(ValueError):
            spmm(C, B, backend="cuda", cfg=dict({"vec": 8}, **bad))
        with pytest.raises(ValueError):
            spmm(S, B, backend="cuda", cfg=bad)
    assert kops.launch_counts() == before


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


# The slice schedule (sell_spmm for Kb <= 8, sell_spmm_t at xt = 0) on each
# kind of plan (kernels/sell_spmm.py::slice_plan): a slice-starved matrix of
# long rows (3 slices: split over a cluster of 4), a rhs too wide to stage
# at any width (gathered through L1), and ragged slices of C in {32, 8, 5}
# (staged). Columns run past both edges (clamped), ghost lanes hold NaN,
# every seventh row is empty.
SLICE_WIDTHS = (1, 2, 3, 8, 20)
# name: (m, n, row lengths [lo, hi), c, sigma, (the plan's stage at width 1,
# its split at every width)); wider tiles of the small cases are not staged
# where the blocks' copies would outweigh the weight.
SLICE_CASES = {
    "starved": (90, 6000, (2000, 5000), 32, 96, (True, 4)),
    "wide": (301, 131072, (0, 200), 32, 256, (False, None)),
    "c32": (301, 900, (0, 600), 32, 256, (True, None)),
    "c8": (301, 900, (0, 600), 8, 16, (True, None)),
    "c5": (301, 900, (0, 600), 5, 5, (True, None)),
}


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(SLICE_CASES))
def test_slice_schedule_matches_plain_on_every_plan(card, dtype_name, case):
    m, n, (lo, hi), c, sigma, (stage, split) = SLICE_CASES[case]
    rng = np.random.default_rng(61)
    dt = DTYPES[dtype_name]
    lens = rng.integers(lo, hi, m)
    lens[::7] = 0
    args = _sell_of_lens(rng, lens, "unsorted", n, c, sigma, dt, card)
    assert int(args[3].max()) == m  # the case has ghost lanes
    absargs = (args[0], args[1], args[2].abs(), args[3])
    for w in SLICE_WIDTHS:
        X = _rand(rng, (w, n), dt, card)
        B = X.T.contiguous()
        for fn, ref, rhs, count in ((ksm.sell_spmm_t, sell_spmm_t_ref, X, "launches_t"),
                                    (ksm.sell_spmm, sell_spmm_ref, B, "launches")):
            slice_kernel = fn is ksm.sell_spmm_t or w <= ksm.SLICE_MAX_TOKENS
            ksm.last_plan = None
            before = getattr(ksm, count)
            y1, y2 = fn(*args, rhs, m, c), fn(*args, rhs, m, c)
            torch.cuda.synchronize()
            assert getattr(ksm, count) == before + 2
            plan = ksm.last_plan
            assert (plan is not None) == slice_kernel, (w, fn)
            if slice_kernel:
                assert w > 1 or plan.stage == stage, plan
                assert split is None or plan.split == split, (w, plan)
            y_p = ref(*args, rhs, m, c)
            scale = ref(*absargs, rhs.abs(), m, c)
            assert y1.shape == y_p.shape and y1.dtype == dt and bool(torch.isfinite(y1).all())
            assert _spmm_reading(y1, y_p, scale, dtype_name) <= 1.0, (w, fn)
            assert torch.equal(y1, y2)  # one summation order: bitwise stable
            rows = y1[::7] if fn is ksm.sell_spmm else y1[:, ::7]
            assert not bool(rows.any())  # empty rows write zeros


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


# ---------------------------------------------------------------------------
# Multigrid: the SpMV kernels on color blocks, the V-cycle on the card
# ---------------------------------------------------------------------------

SPMV_KERNEL_OF = {Format.CSR: kc, Format.ELL: ke, Format.SELL: ks, Format.DIA: kd}
# each kernel's plain version (f32 accumulation, as the kernel) on a container
SPMV_PLAIN_OF = {
    Format.CSR: lambda A, x: csr_spmv_ref(A.indptr, A.indices, A.data, x, A.shape[0]),
    Format.ELL: lambda A, x: ell_spmv_ref(A.cols, A.data, x),
    Format.SELL: lambda A, x: sell_spmv_ref(A.slice_ptrs, A.cols, A.data, A.perm, x,
                                            A.shape[0], A.c),
    Format.DIA: lambda A, x: dia_spmv_ref(A.offsets, A.data, x, A.shape[1]),
}
# (grid, formats): the 104^3 level-0 blocks (140608 x 1124864; DIA would
# store ~52^3 diagonals of a block, so it runs on the small grids), 13^3
# blocks (343 rows, colors of 216-294 rows padded), 2^3 one-row blocks.
COLOR_BLOCK_CASES = [(104, (Format.CSR, Format.ELL, Format.SELL)),
                     (13, tuple(SPMV_KERNEL_OF)), (2, tuple(SPMV_KERNEL_OF))]


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("grid,fmts", COLOR_BLOCK_CASES, ids=lambda v: str(v))
def test_spmv_kernels_on_color_blocks_match_plain(card, grid, fmts, dtype_name):
    """Rectangular (rmax, n) row blocks with padding rows and x longer than
    the block's row count: each kernel against its plain version."""
    from repro_torch.mg import build_colored
    dt = DTYPES[dtype_name]
    dims = (grid,) * 3
    C = hpcg.to_coo(hpcg.generate_problem(*dims), dtype=dt, device=card)
    rng = np.random.default_rng(20)
    x = _rand(rng, C.shape[0], dt, card)
    for fmt in fmts:
        cs = build_colored(C, dims=dims, fmt=fmt)
        for c in (0, 3, 7):  # the largest color, a middle one, the smallest
            blk = cs.blocks[c]
            assert blk.shape == (max(cs.counts), C.shape[0]) and blk.format == fmt
            mod = SPMV_KERNEL_OF[fmt]
            before = mod.launches
            y1, y2 = spmv(blk, x), spmv(blk, x)
            torch.cuda.synchronize()
            assert mod.launches == before + 2
            y_p = SPMV_PLAIN_OF[fmt](blk, x)
            torch.testing.assert_close(y1.float(), y_p.float(), **TOL[dtype_name])
            assert torch.equal(y1, y2)
            assert not y1[cs.counts[c]:].any()  # padding rows sum nothing


def _hier(device, grid, policy=None):
    from repro_torch.mg import build_hierarchy
    return build_hierarchy(hpcg.generate_problem(grid, grid, grid), device=device,
                           policy=FormatPolicy(policy) if policy else None)


@pytest.mark.parametrize("policy", [None, "ml"])
@pytest.mark.parametrize("grid", [8, 16])
def test_v_cycle_on_card_matches_cpu(card, grid, policy):
    gpu, cpu = _hier(card, grid, policy), _hier("cpu", grid, policy)
    assert gpu.formats() == cpu.formats()
    r = np.random.default_rng(21).standard_normal(grid ** 3).astype(np.float32)
    z = gpu.apply_M()(torch.from_numpy(r).to(card)).cpu().numpy()
    want = cpu.apply_M()(torch.from_numpy(r)).numpy()
    assert np.abs(z - want).max() / np.abs(want).max() < 1e-5


def test_v_cycle_launch_count_and_no_host_sync(card):
    """16^3 has four levels: 3 x (16 pre + 1 residual + 16 post) + 16 x 4
    coarse sweeps = 163 csr_spmv launches a V-cycle, and none syncs."""
    hier = _hier(card, 16)
    r = torch.ones(16 ** 3, device=card)
    hier.apply_M()(r)  # warm: first-use lookups and builds happen here
    torch.cuda.synchronize()
    kops.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        z = hier.apply_M()(r)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    counts = kops.launch_counts()
    assert counts["csr_spmv"] == 163 and sum(counts.values()) == 163
    assert bool(torch.isfinite(z).all())


def test_v_cycle_reruns_bitwise(card):
    """CSR blocks and injection transfers: every scatter index is unique."""
    hier = _hier(card, 16)
    r = torch.from_numpy(np.random.default_rng(22).standard_normal(4096)
                         .astype(np.float32)).to(card)
    assert torch.equal(hier.apply_M()(r), hier.apply_M()(r))


def test_mg_pcg_on_card_matches_cpu(card):
    a = hpcg_solve.run((16, 16, 16), "CSR", device="cuda", precond="mg")
    b = hpcg_solve.run((16, 16, 16), "CSR", device="cpu", precond="mg")
    assert a["passed"] and b["passed"] and abs(a["iters"] - b["iters"]) <= 1
    assert a["levels"] == b["levels"]


def test_build_hierarchy_raises_on_bad_options(card):
    from repro_torch.mg import build_hierarchy
    prob = hpcg.generate_problem(8, 8, 8)
    with pytest.raises(ValueError, match="unknown smoother"):
        build_hierarchy(prob, smoother="chebyshev")
    with pytest.raises(ValueError, match="prolong"):
        build_hierarchy(prob, prolong="cubic")


# ---------------------------------------------------------------------------
# The distributed layer: P shards on the card
# ---------------------------------------------------------------------------

DIST_KERNELS_OF = {"CSR": ("csr_spmv",), "DIA": ("dia_spmv",), "ELL": ("ell_spmv",),
                   "SELL": ("sell_spmv",), "COO": ()}


def _dist(device, grid, nshards, mode="uniform", **kw):
    from repro_torch.core.distributed import build_dist_matrix
    prob = hpcg.generate_problem(*grid)
    return build_dist_matrix(prob.row, prob.col, prob.val, prob.shape, nshards,
                             device=device, mode=mode, plan=hpcg.slab_plan(prob, nshards),
                             check_plan=False, **kw)


def _dist_launches(A) -> dict:
    """Kernel launches one dist_spmv issues: one per shard and part, by the
    part's active format (COO has no kernel)."""
    out = {}
    for part in A.shard_parts:
        for name in A.formats(part):
            for k in DIST_KERNELS_OF[name]:
                out[k] = out.get(k, 0) + 1
    return out


@pytest.mark.parametrize("fmt", [Format.CSR, Format.DIA, Format.ELL, Format.SELL],
                         ids=lambda f: f.name)
@pytest.mark.parametrize("nshards", [4, 8])
def test_dist_part_kernels_match_plain(card, nshards, fmt):
    """Interior, boundary (most rows empty) and remote (rectangular, halo
    columns) parts of every shard: each kernel against its plain version,
    and a bitwise rerun."""
    A = _dist(card, (32, 32, 64), nshards, local_format=fmt, remote_format=fmt)
    rng = np.random.default_rng(30)
    mod = SPMV_KERNEL_OF[fmt]
    for part in ("local", "boundary", "remote"):
        for p, C in enumerate(A.shard_parts[part]):
            assert C.format == fmt
            x = _rand(rng, C.shape[1], torch.float32, card)
            before = mod.launches
            y1, y2 = spmv(C, x), spmv(C, x)
            torch.cuda.synchronize()
            assert mod.launches == before + 2
            torch.testing.assert_close(y1, SPMV_PLAIN_OF[fmt](C, x), **TOL["float32"])
            assert torch.equal(y1, y2), (part, p)


@pytest.mark.parametrize("fmt", [Format.CSR, Format.DIA, Format.ELL, Format.SELL],
                         ids=lambda f: f.name)
def test_dist_color_block_kernels_match_plain(card, fmt):
    """The distributed smoother's stacked (rmax, mp) color blocks, whose
    capacity padding sits in row 0: on every level, color and shard each
    kernel against its plain version, and a bitwise rerun."""
    from repro_torch.mg import build_dist_hierarchy
    h = build_dist_hierarchy(hpcg.generate_problem(16, 16, 32), 4, device=card,
                             smoother_format=fmt)
    rng = np.random.default_rng(33)
    mod = SPMV_KERNEL_OF[fmt]
    for lev in h.levels:
        x = _rand(rng, lev.A.mp, torch.float32, card)
        for c, blocks in enumerate(lev.colored.shard_blocks):
            for p, blk in enumerate(blocks):
                assert blk.format == fmt
                before = mod.launches
                y1, y2 = spmv(blk, x), spmv(blk, x)
                torch.cuda.synchronize()
                assert mod.launches == before + 2
                torch.testing.assert_close(y1, SPMV_PLAIN_OF[fmt](blk, x), **TOL["float32"])
                assert torch.equal(y1, y2), (lev.dims, c, p)


@pytest.mark.parametrize("mode", ["uniform", "multiformat"])
def test_dist_spmv_on_card_matches_cpu_and_counts_launches(card, mode):
    kw = (dict(local_format=Format.DIA, remote_format=Format.COO) if mode == "uniform"
          else dict(tune="ml"))
    gpu, cpu = _dist(card, (16, 16, 32), 4, mode, **kw), _dist("cpu", (16, 16, 32), 4, mode, **kw)
    assert all(gpu.formats(p) == cpu.formats(p) for p in cpu.shard_parts)
    from repro_torch.core.distributed import dist_spmv
    x = np.random.default_rng(31).standard_normal(gpu.shape[0]).astype(np.float32)
    xg = torch.from_numpy(x).to(card)
    dist_spmv(gpu, xg)
    torch.cuda.synchronize()
    kops.reset_launches()
    y = dist_spmv(gpu, xg)
    torch.cuda.synchronize()
    counts = {k: v for k, v in kops.launch_counts().items() if v}
    assert counts == _dist_launches(gpu)
    want = dist_spmv(cpu, torch.from_numpy(x)).numpy()
    assert np.abs(y.cpu().numpy() - want).max() / np.abs(want).max() < 1e-5
    assert torch.equal(y, dist_spmv(gpu, xg))


def test_dist_spmv_and_v_cycle_make_no_host_sync(card):
    from repro_torch.core.distributed import dist_spmv
    from repro_torch.mg import build_dist_hierarchy
    h = build_dist_hierarchy(hpcg.generate_problem(16, 16, 32), 4, device=card,
                             mode="multiformat", tune="ml")
    A = h.levels[0].A
    r = torch.ones(A.shape[0], device=card)
    z0, y0 = h.apply_M()(r), dist_spmv(A, r)  # warm: first-use lookups happen here
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, z = dist_spmv(A, r), h.apply_M()(r)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(y, y0) and torch.equal(z, z0)


def test_dist_v_cycle_on_card_matches_cpu(card):
    from repro_torch.mg import build_dist_hierarchy
    prob = hpcg.generate_problem(16, 16, 32)
    gpu = build_dist_hierarchy(prob, 4, device=card, mode="multiformat", tune="ml")
    cpu = build_dist_hierarchy(prob, 4, device="cpu", mode="multiformat", tune="ml")
    assert gpu.formats() == cpu.formats()
    r = np.random.default_rng(32).standard_normal(prob.shape[0]).astype(np.float32)
    z = gpu.apply_M()(torch.from_numpy(r).to(card)).cpu().numpy()
    want = cpu.apply_M()(torch.from_numpy(r)).numpy()
    assert np.abs(z - want).max() / np.abs(want).max() < 1e-5


@pytest.mark.parametrize("precond", ["none", "mg"])
def test_dist_hpcg_solve_on_card_matches_cpu(card, precond):
    kw = dict(shards=4, mode="multiformat", precond=precond)
    a = hpcg_solve.run((16, 16, 16), device="cuda", **kw)
    b = hpcg_solve.run((16, 16, 16), device="cpu", **kw)
    assert a["passed"] and b["passed"] and abs(a["iters"] - b["iters"]) <= 1
    assert a["formats"] == b["formats"] and a["plan"] == b["plan"]


# ---------------------------------------------------------------------------
# Observability on the card (repro_torch.obs)
# ---------------------------------------------------------------------------


def test_span_sync_waits_for_card_tensors_once_at_close(card, monkeypatch):
    from repro_torch.obs import trace
    real, calls = torch.cuda.synchronize, []

    def counted(*a):
        calls.append(a)
        real(*a)
    monkeypatch.setattr(torch.cuda, "synchronize", counted)
    A = convert(coo_from_dense_np(np.eye(512, dtype=np.float32), device=card), Format.CSR)
    x = torch.ones(512, device=card)
    with trace.tracing("full"):
        trace.clear()
        with trace.span("solver.solve") as sp:
            y = spmv(A, x)
            sp.sync(y, torch.ones(2))
            assert calls == []
        assert calls == [(y.device,)]
        with trace.span("solver.none"):
            spmv(A, x)
        assert len(calls) == 1
        ev = next(e for e in trace.events() if e["name"] == "solver.solve")
    assert ev["dur"] > 0 and torch.equal(y, x)
    trace.clear()


@pytest.mark.parametrize("mode", ["off", "summary"])
def test_traced_hot_paths_make_no_host_sync(card, mode, monkeypatch, tmp_path):
    """spmv (routed ``auto``), dist_spmv and a V-cycle with tracing off or
    in summary mode and the ledger on: no implicit device->host sync, no
    synchronize."""
    from repro_torch.core.distributed import dist_spmv
    from repro_torch.mg import build_dist_hierarchy
    from repro_torch.obs import ledger, trace
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "empty.json"))
    h = build_dist_hierarchy(hpcg.generate_problem(16, 16, 32), 4, device=card,
                             mode="multiformat", tune="ml")
    hier = _hier(card, 16)
    A = h.levels[0].A
    r, r16 = torch.ones(A.shape[0], device=card), torch.ones(16 ** 3, device=card)
    M = hier.levels[0].A
    outs0 = (spmv(M, r16, backend="auto"), dist_spmv(A, r), h.apply_M()(r),
             hier.apply_M()(r16))  # warm
    torch.cuda.synchronize()
    ledger.set_enabled(True)
    real_sync = torch.cuda.synchronize

    def boom(*a):
        raise AssertionError("torch.cuda.synchronize on a hot path")
    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    with trace.tracing(mode):
        trace.clear()
        torch.cuda.set_sync_debug_mode("error")
        try:
            outs = (spmv(M, r16, backend="auto"), dist_spmv(A, r), h.apply_M()(r),
                    hier.apply_M()(r16))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        names = set(trace.aggregate())
    monkeypatch.setattr(torch.cuda, "synchronize", real_sync)
    # the auto route has no record here: the reference, which sums with
    # atomics, reruns within rounding; the rest reruns bitwise
    assert torch.allclose(outs[0], outs0[0], rtol=1e-5, atol=1e-5)
    for got, want in zip(outs[1:], outs0[1:]):
        assert torch.equal(got, want)
    assert names == (set() if mode == "off" else
                     {"kernel.route", "exchange.issue", "exchange.dist_spmv", "mg.vcycle",
                      "mg.vcycle_dist"})
    trace.clear()


# ---------------------------------------------------------------------------
# the dense decoder and the serving engine (smoke size): the card vs the CPU
# ---------------------------------------------------------------------------


def _dense_smoke(arch="minitron_8b", dtype="float32"):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    model = build_model(cfg)
    cpu = model.init(0, device="cpu")
    return cfg, model, cpu


def _to(tree, dev):
    from repro_torch.models.spec import tree_map
    return tree_map(lambda t: t.to(dev), tree)


def test_model_init_on_the_card_by_default(card):
    from repro_torch.models.spec import tree_leaves
    cfg, model, _ = _dense_smoke()
    params = model.init(0)
    assert all(t.device.type == "cuda" for t in tree_leaves(params))
    again = model.init(0, device=card)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params), tree_leaves(again)))
    cache = model.init_cache(2, 8)
    assert cache["k"].device.type == "cuda" and cache["k"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["minitron_8b", "qwen1_5_32b"])
def test_forward_on_card_matches_cpu(card, arch):
    cfg, model, cpu = _dense_smoke(arch)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 16)))
    out_c, _, (k_c, v_c) = model.forward(cpu, {"tokens": tokens}, q_chunk=8, kv_chunk=4,
                                         collect_kv=True)
    out_g, _, (k_g, v_g) = model.forward(_to(cpu, card), {"tokens": tokens.to(card)},
                                         q_chunk=8, kv_chunk=4, collect_kv=True)
    for g, c in ((out_g, out_c), (k_g, k_c), (v_g, v_c)):
        assert torch.allclose(g.cpu(), c, **TOL["float32"])


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_flash_attention_on_card_matches_cpu(card, dtype_name):
    from repro_torch.models.flash import flash_attention
    rng = np.random.default_rng(1)
    q, k, v = (_rand(rng, (2, 128, h, 32), DTYPES[dtype_name], "cpu") for h in (8, 4, 4))
    for causal, qc, kc in ((True, 32, 64), (False, 64, 32)):
        c = flash_attention(q, k, v, causal, qc, kc)
        g = flash_attention(q.to(card), k.to(card), v.to(card), causal, qc, kc)
        assert torch.allclose(g.cpu().float(), c.float(), **TOL[dtype_name])


@pytest.mark.parametrize("quant", [False, True])
def test_decode_steps_on_card_match_cpu(card, quant):
    cfg, model, cpu = _dense_smoke()
    gpu = _to(cpu, card)
    cache_dt = torch.bfloat16 if quant else torch.float32
    cc = model.init_cache(2, 12, cache_dt, kv_quant=quant, device="cpu")
    cg = model.init_cache(2, 12, cache_dt, kv_quant=quant, device=card)
    rng = np.random.default_rng(2)
    pos = torch.tensor([0, 3])
    for _ in range(4):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab, (2,)))
        lc, _ = model.decode_step(cpu, cc, tok, pos)
        lg, _ = model.decode_step(gpu, cg, tok.to(card), pos.to(card))
        assert torch.allclose(lg.cpu(), lc, **TOL["bfloat16" if quant else "float32"])
        pos = pos + 1


def test_engine_on_card_serves_the_cpu_tokens(card):
    from repro_torch.launch.serve import DecodeEngine, serve
    cfg, model, cpu = _dense_smoke("stablelm_1_6b")
    rng = np.random.default_rng(3)
    reqs = [(i, rng.integers(0, cfg.vocab, (n,)).astype(np.int32))
            for i, n in enumerate((3, 11, 5, 7, 4))]
    engine_c = DecodeEngine(model, cpu, 3, 32, device="cpu")
    engine_c.cache = model.init_cache(3, 32, torch.float32, device="cpu")
    done_c, _ = serve(engine_c, reqs, 6)
    engine = DecodeEngine(model, _to(cpu, card), 3, 32)
    engine.cache = model.init_cache(3, 32, torch.float32)
    done_g, _ = serve(engine, reqs, 6)
    assert dict(done_g) == dict(done_c)
    assert engine.cache["k"].device.type == "cuda" and engine.prefill_calls >= 2


def test_serve_cli_on_card(card, capsys):
    from repro_torch.launch.serve import main
    assert main(["--arch", "minitron_8b", "--smoke", "--requests", "4", "--slots", "2"]) == 0
    out = capsys.readouterr().out
    assert "served 4 requests, 64 tokens" in out and "on cuda" in out


# ---------------------------------------------------------------------------
# the moe, ssm and hybrid families (smoke size): the card vs the CPU
# ---------------------------------------------------------------------------


def test_coo_spmm_on_card_reruns_bitwise(card):
    """The plain COO SpMM (the moe ``coo`` dispatch's combine) reduces each
    row in entry order without atomics: two runs on the card are equal
    bitwise, and agree with the CPU."""
    rng = np.random.default_rng(30)
    m, n, nnz = 300, 200, 20000  # ~67 entries a row, rows repeated
    row = torch.from_numpy(rng.integers(0, m, nnz).astype(np.int32))
    col = torch.from_numpy(rng.integers(0, n, nnz).astype(np.int32))
    for dtype_name, dt in DTYPES.items():
        val = _rand(rng, (nnz,), dt, "cpu")
        B = _rand(rng, (n, 64), dt, "cpu")
        A = COO(row=row, col=col, data=val, shape=(m, n), nnz=nnz)
        Ag = COO(row=row.to(card), col=col.to(card), data=val.to(card), shape=(m, n), nnz=nnz)
        y1, y2 = spmm(Ag, B.to(card)), spmm(Ag, B.to(card))
        assert torch.equal(y1, y2), dtype_name
        assert torch.allclose(y1.cpu().float(), spmm(A, B).float(), **TOL[dtype_name])


@pytest.mark.parametrize("dispatch", ["dense", "sort", "coo"])
def test_moe_dispatch_on_card_matches_cpu(card, dispatch):
    from repro_torch.models import moe
    from repro_torch.models.spec import tree_map
    cfg, model, cpu = _dense_smoke("deepseek_moe_16b")
    layer = tree_map(lambda t: t[0], cpu["blocks"]["moe"])  # layer 0
    layer["router"] = layer["router"] * 30  # routing decided by the input
    x = _rand(np.random.default_rng(31), (4, 64, cfg.d_model), torch.float32, "cpu")
    yc, auxc = moe.moe_apply(layer, x, cfg, dispatch=dispatch)
    lg = _to(layer, card)
    yg, auxg = moe.moe_apply(lg, x.to(card), cfg, dispatch=dispatch)
    assert torch.allclose(yg.cpu(), yc, **TOL["float32"])
    assert abs(float(auxg) - float(auxc)) < 1e-5
    if dispatch != "dense":  # no atomics: reruns bitwise (bf16 too)
        xb = x.to(card, torch.bfloat16)
        assert torch.equal(moe.moe_apply(lg, xb, cfg, dispatch=dispatch)[0],
                           moe.moe_apply(lg, xb, cfg, dispatch=dispatch)[0])


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "mamba2_2_7b", "zamba2_2_7b"])
def test_family_forward_and_decode_on_card_match_cpu(card, arch):
    cfg, model, cpu = _dense_smoke(arch)
    gpu = _to(cpu, card)
    tokens = torch.from_numpy(np.random.default_rng(32).integers(0, cfg.vocab, (2, 32)))
    out_c, aux_c = model.forward(cpu, {"tokens": tokens})
    out_g, aux_g = model.forward(gpu, {"tokens": tokens.to(card)})
    assert torch.allclose(out_g.cpu(), out_c, **TOL["float32"])
    assert abs(float(aux_g) - float(aux_c)) < 1e-5
    cc = model.init_cache(2, 16, torch.float32, device="cpu")
    cg = model.init_cache(2, 16, torch.float32, device=card)
    assert all(t.device.type == "cuda" for t in cg.values())
    pos = torch.tensor([0, 3])
    for i in range(6):
        lc, _ = model.decode_step(cpu, cc, tokens[:, i], pos + i)
        lgg, _ = model.decode_step(gpu, cg, tokens[:, i].to(card), (pos + i).to(card))
        assert torch.allclose(lgg.cpu(), lc, **TOL["float32"]), i
    for name in cc:
        assert torch.allclose(cg[name].cpu(), cc[name], **TOL["float32"]), name


@pytest.mark.parametrize("arch", ["mamba2_2_7b", "zamba2_2_7b"])
def test_recurrent_engine_on_card_matches_the_cpu_chain(card, arch):
    """2 slots, 5 requests (slot reuse): every logit the engine computes on
    the card equals the CPU's single-request decode chain fed the same
    tokens, within 1e-4 * max|logit|."""
    from repro_torch.launch.serve import DecodeEngine, serve
    cfg, model, cpu = _dense_smoke(arch)
    rng = np.random.default_rng(33)
    reqs = [(i, rng.integers(0, cfg.vocab, (n,)).astype(np.int32))
            for i, n in enumerate((5, 9, 3, 7, 4))]
    engine = DecodeEngine(model, _to(cpu, card), 2, 14, device=card, record_logits=True)
    engine.cache = model.init_cache(2, 14, torch.float32, device=card)
    done, _ = serve(engine, reqs, 6)
    assert engine.prefill_calls == len(reqs)
    for rid, prompt in reqs:
        fed = list(prompt) + dict(done)[rid][:-1]
        cache = model.init_cache(1, 14, torch.float32, device="cpu")
        ref = torch.stack([model.decode_step(cpu, cache, torch.tensor([int(t)]),
                                             torch.tensor([i]))[0][0]
                           for i, t in enumerate(fed)])
        got = torch.stack(engine.logits_log[rid]).cpu()
        assert got.shape == ref.shape
        assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max()), rid


@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_on_card_matches_float64(card, causal):
    """dq/dk/dv of the chunked backward in float32 on the card against
    autograd of the unchunked float64 softmax attention, within 1e-5 *
    max|g| (GQA, 8 heads over 4 kv heads)."""
    from repro_torch.models.flash import flash_attention
    rng = np.random.default_rng(40)
    q, k, v, w = (rng.standard_normal(s).astype(np.float32)
                  for s in ((2, 256, 8, 64), (2, 256, 4, 64), (2, 256, 4, 64), (2, 256, 8, 64)))

    def grads(dtype, fn):
        ts = [torch.tensor(a, dtype=dtype, device=card, requires_grad=True) for a in (q, k, v)]
        (fn(*ts) * torch.tensor(w, dtype=dtype, device=card)).sum().backward()
        return [t.grad.double().cpu() for t in ts]

    def oracle(a, b, c):
        b, c = b.repeat_interleave(2, dim=2), c.repeat_interleave(2, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", a, b) * a.shape[-1] ** -0.5
        if causal:
            s = s.masked_fill(~torch.tril(torch.ones(256, 256, dtype=torch.bool, device=card)),
                              float("-inf"))
        return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), c)

    got = grads(torch.float32, lambda a, b, c: flash_attention(a, b, c, causal, 64, 128))
    want = grads(torch.float64, oracle)
    for g, o in zip(got, want):
        assert float((g - o).abs().max()) <= 1e-5 * float(o.abs().max())


@pytest.mark.parametrize("arch", ["stablelm_1_6b", "deepseek_moe_16b", "mamba2_2_7b",
                                  "zamba2_2_7b", "internvl2_26b", "hubert_xlarge"])
def test_train_step_on_card_has_finite_grads(card, arch):
    """One full train step of each family's smoke model on the card (bf16
    compute, f32 params and AdamW state): finite loss and gradients, params
    moved and finite; the loss is the CPU's within bf16's tolerance."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_source, to_device
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.models.spec import tree_leaves, tree_map
    from repro_torch.optim.adamw import AdamW
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    batch = make_source(cfg, 64, 2, seed=1).batch_at(0)
    if cfg.frontend == "vision":
        batch["tokens"] = batch["tokens"][:, :64 - cfg.n_patches]
        batch["patches"] = np.random.default_rng(41).standard_normal(
            (2, cfg.n_patches, cfg.frontend_dim)).astype(np.float32)
    losses = {}
    cpu = model.init(0, device="cpu")  # the CPU's and the card's generators draw apart
    for dev in (torch.device("cpu"), card):
        params = train.trainable(tree_map(lambda t: t.to(dev, copy=True), cpu))
        before = [t.detach().clone() for t in tree_leaves(params)]
        loss = model.loss(params, to_device(batch, dev), q_chunk=32, kv_chunk=32)
        loss.backward()
        assert torch.isfinite(loss)
        grads = tree_map(lambda t: t.grad, params)
        assert all(g is not None and bool(torch.isfinite(g).all()) for g in tree_leaves(grads))
        opt = AdamW(lr=1e-3)
        opt.update(grads, opt.init(params), params)
        after = tree_leaves(params)
        assert all(bool(torch.isfinite(a).all()) for a in after)
        assert any(not torch.equal(a.detach(), b) for a, b in zip(after, before))
        losses[dev.type] = float(loss.detach())
    assert abs(losses["cpu"] - losses["cuda"]) <= 2e-2 * abs(losses["cpu"])


@pytest.mark.parametrize("stages,micro", [(2, 4), (4, 3)])
def test_pipeline_on_card_matches_the_serial_stack(card, stages, micro):
    """stablelm-1.6b's width cut to 4 layers, f32: the GPipe schedule on the
    card against the serial 4-layer stack on the same inputs (forward
    within 1e-5 x max|y|, every gradient within 1e-4 x max|g|)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.pipeline import pipeline_apply, stage_params
    from repro_torch.models import build_model
    from repro_torch.models import transformer as tfm
    from repro_torch.models.spec import tree_leaves, tree_map
    cfg = dataclasses.replace(get_config("stablelm_1_6b"), n_layers=4, dtype="float32")
    blocks = build_model(cfg).init(0, device=card)["blocks"]
    staged = stage_params(tree_map(lambda t: t.clone(), blocks), stages)
    seq = 128
    x = torch.randn(micro, 1, seq, cfg.d_model, device=card,
                    generator=torch.Generator(device=card).manual_seed(1))
    pos = torch.arange(seq, dtype=torch.int32, device=card)[None]

    def stack(slab, h):
        for p in tfm.layer_views(slab, tree_leaves(slab)[0].shape[0]):
            h, _ = tfm._attn_block(p, h, cfg, causal=True, positions=pos, q_chunk=64,
                                   kv_chunk=128)
        return h

    def grads(fn, params):
        for p in tree_leaves(params):
            p.requires_grad_(True)
        y = fn(params)
        y.square().sum().backward()
        return y.detach(), [p.grad for p in tree_leaves(params)]

    y_ser, g_ser = grads(lambda p: stack(p, x.reshape(micro, seq, -1)), blocks)
    y_pipe, g_pipe = grads(
        lambda p: pipeline_apply(stack, p, x, make_mesh((stages,), ("stage",))), staged)
    assert float((y_pipe.reshape(y_ser.shape) - y_ser).abs().max()) <= \
        1e-5 * float(y_ser.abs().max())
    for a, b in zip(g_pipe, g_ser):
        assert float((a.reshape(b.shape) - b).abs().max()) <= 1e-4 * float(b.abs().max())


def test_env_apply_turns_tf32_off_on_the_card(card, monkeypatch):
    from repro_torch import env
    monkeypatch.setattr(env, "_applied", None)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    torch.zeros(1, device=card)  # CUDA initialised: apply warns that cuBLAS may have read it
    with pytest.warns(RuntimeWarning, match="after CUDA was initialised"):
        got = env.apply("cuda")
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    assert got["tf32"] == {"matmul": False, "cudnn": False}
    assert got["backend"] == "cuda" and got["cuda_initialized_before"]
    assert env.describe() == got


# ---------------------------------------------------------------------------
# The solvers' loop on the card: captured blocks and solver_vec's kernels
# ---------------------------------------------------------------------------


def _bits(t):
    if not t.is_floating_point():
        return t
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16", "float64"])
@pytest.mark.parametrize("n,offset", [(1, 0), (1000, 0), (1000, 1), (600_001, 0)])
def test_solver_vec_kernels_match_plain(card, dtype_name, n, offset):
    """dot, update, direction and finish at a length of one, a ragged one,
    one on an unaligned view (scalar loads) and one above MAX_PARTS blocks.
    f32 and f64: each output within REL * sum|terms| of the plain version's
    (chip_smoke.py's SV_REL). bf16: against an f64 evaluation of the same
    formula (alpha and beta as f32 scalars), a vector output within 2^-8 *
    sum|terms| beyond the one rounding to bf16 the formula allows, an f32
    sum within 1e-5 * sum|terms| (chip_smoke.py's SV_BF16_REL). The flag
    and k equal the plain version's; reruns bitwise."""
    from repro_torch.kernels import solver_vec as sv
    dt = getattr(torch, dtype_name)
    rel = {"float32": 1e-5, "float64": 1e-12}.get(dtype_name)
    rng = np.random.default_rng(n + offset)
    x, r, p, noise, z = (torch.from_numpy(rng.standard_normal(n + offset))[offset:].to(card, dt)
                         for _ in range(5))
    ap = (p.double() * (2 + 0.1 * noise.double())).to(dt)  # p . Ap > 0
    z = (0.5 * r.double() + 0.1 * z.double()).to(dt)  # r . z > 0, as an SPD M^-1 gives
    sc = torch.tensor([float(r.double() @ r.double()), float(r.double() @ z.double()), 1e-12],
                      dtype=sv.acc_dtype(dt), device=card)

    def run(kernel):
        xs, rs, ps, scs = x.clone(), r.clone(), p.clone(), sc.clone()
        st = torch.tensor([0, 1], dtype=torch.int64, device=card)
        hist = torch.full((4,), float("nan"), dtype=dt, device=card)
        if kernel:
            rr = sv.update(xs, rs, ps, ap, sv.dot(ps, ap), scs, st)
            rz = sv.dot(rs, z)
            sv.direction(ps, z, rz, scs, st)
            sv.finish(rr, rz, scs, st, hist, 3)
        else:
            rr = sv.update_plain(xs, rs, ps, ap, sv.dot_plain(ps, ap), scs, st)
            rz = sv.dot_plain(rs, z)
            sv.direction_plain(ps, z, rz, scs, st)
            sv.finish_plain(rr, rz, scs, st, hist, 3, False)
        return xs, rs, ps, scs, st, hist

    got, want = run(True), run(False)
    torch.cuda.synchronize()
    d = [t.double() for t in (x, r, p, ap, z)]
    if rel is None:  # bf16: the f64 evaluation
        def f32(v):
            return float(torch.tensor(float(v), dtype=torch.float32))
        rn = got[1].double()
        alpha = f32(f32(sc[1]) / f32(d[2] @ d[3]))
        beta = f32(f32(rn @ d[4]) / f32(sc[1]))
        for a, ex, t in ((got[0], d[0] + alpha * d[2], d[0].abs() + abs(alpha) * d[2].abs()),
                         (got[1], d[1] - alpha * d[3], d[1].abs() + abs(alpha) * d[3].abs()),
                         (got[2], d[4] + beta * d[2], d[4].abs() + abs(beta) * d[2].abs())):
            excess = (a.double() - ex).abs() - (ex.to(torch.bfloat16).double() - ex).abs()
            assert bool((excess <= 2.0 ** -8 * t).all())
        for a, ex, t in ((got[3][0], rn @ rn, (rn * rn).sum()),
                         (got[3][1], rn @ d[4], (rn * d[4]).abs().sum())):
            assert abs(float(a) - float(ex)) <= 1e-5 * float(t)
    else:
        alpha = float(sc[1]) / float(d[2] @ d[3])
        beta = float(want[3][1]) / float(sc[1])
        r_new = want[1].double()
        terms = (d[0].abs() + abs(alpha) * d[2].abs(), d[1].abs() + abs(alpha) * d[3].abs(),
                 d[4].abs() + abs(beta) * d[2].abs(), (r_new * r_new).sum(),
                 (r_new * d[4]).abs().sum())
        outs = list(zip(got[:3], want[:3])) + [(got[3][0], want[3][0]), (got[3][1], want[3][1])]
        for (a, b), t in zip(outs, terms):
            assert bool(((a.double() - b.double()).abs() <= rel * t).all())
    assert got[4].tolist() == want[4].tolist() == [1, 1]
    again = run(True)
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(again, got))


def _loop_system(fmt, dev, grid=16):
    prob = hpcg.generate_problem(grid, grid, grid)
    A = convert(hpcg.to_coo(prob, device=dev), Format[fmt])
    return prob, A, torch.from_numpy(hpcg.rhs_for_ones(prob)).to(dev)


@pytest.mark.parametrize("fmt", ["DIA", "CSR"])
def test_graph_solve_is_bitwise_and_the_cpu_loop(card, fmt):
    """Two captured solves are bitwise equal; they take the CPU loop's
    iterations (through the plain versions) and agree with its x and
    history within the f32 tolerance; the tolerance lands convergence
    inside a block."""
    from repro_torch.core import solvers
    _, A, b = _loop_system(fmt, card)
    _, Ac, bc = _loop_system(fmt, "cpu")
    K = solvers.BLOCK_ITERS
    k_conv = 2 * K + 3
    h = solvers.cg(solvers.operator(Ac), bc, tol=1e-12, maxiter=4 * K).history.double()
    tol = float((h[k_conv - 1] * h[k_conv]).sqrt() / h[0])  # first passes at k_conv
    rc = solvers.cg(solvers.operator(Ac), bc, tol=tol, maxiter=4 * K)
    r1 = solvers.cg(solvers.operator(A), b, tol=tol, maxiter=4 * K)
    loop = solvers.last_loop
    r2 = solvers.cg(solvers.operator(A), b, tol=tol, maxiter=4 * K)
    assert rc.iters == r1.iters == r2.iters == k_conv and k_conv % K
    assert loop.captured and loop.eager == 1 and loop.syncs == 1 + loop.replays == 3
    assert torch.equal(r1.x, r2.x) and torch.equal(_bits(r1.history), _bits(r2.history))
    torch.testing.assert_close(r1.x.cpu(), rc.x, rtol=1e-4, atol=1e-4)
    hg, hc = r1.history.cpu(), rc.history
    assert torch.equal(hg.isnan(), hc.isnan())
    torch.testing.assert_close(hg[~hg.isnan()], hc[~hc.isnan()], rtol=1e-4,
                               atol=1e-6 * float(hc[0]))


def test_graph_solve_counts_the_launches_the_device_ran(card):
    """Over a captured solve the kernels' launch counts are the device's:
    the capture's launches are taken back out and each replay adds them."""
    from repro_torch.core import solvers
    from repro_torch.kernels import solver_vec as sv
    _, A, b = _loop_system("DIA", card)
    kops.reset_launches()
    sv.reset_launches()
    solvers.cg(solvers.operator(A), b, tol=1e-7, maxiter=100)
    loop = solvers.last_loop
    issued = loop.k_block * (loop.eager + loop.replays)
    assert loop.captured and loop.replays >= 1
    assert {k: v for k, v in kops.launch_counts().items() if v} == {"dia_spmv": 1 + issued}
    assert sv.launches == {"dot": 1 + issued, "update": issued, "direction": issued,
                           "finish": issued}


def test_graph_mg_pcg_takes_the_cpu_iterations(card):
    from repro_torch.core import solvers
    from repro_torch.mg import build_hierarchy
    prob, A, b = _loop_system("CSR", card)
    _, Ac, bc = _loop_system("CSR", "cpu")
    res = solvers.pcg(solvers.operator(A), b, tol=1e-7, maxiter=100,
                      apply_M=build_hierarchy(prob, device=card).apply_M())
    loop = solvers.last_loop
    ref = solvers.pcg(solvers.operator(Ac), bc, tol=1e-7, maxiter=100,
                      apply_M=build_hierarchy(prob, device="cpu").apply_M())
    # f32 sums in another order on the card: the reference check's one iteration
    assert ref.iters == 11 and abs(res.iters - ref.iters) <= 1 and loop.captured
    assert loop.k_block == solvers.BLOCK_ITERS_PRECOND
    torch.testing.assert_close(res.x.cpu(), ref.x, rtol=1e-4, atol=1e-4)


def test_cg_fixed_iters_never_syncs_and_a_syncing_apply_a_raises(card):
    from repro_torch.core import solvers
    _, A, b = _loop_system("DIA", card)
    op = solvers.operator(A)
    solvers.cg_fixed_iters(op, b, iters=3)  # the first use builds and loads the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = solvers.cg_fixed_iters(op, b, iters=20)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert res.iters == 20 and solvers.last_loop.replays == 2

    def syncing(v):
        return op(v) * float(v.abs().sum() > 0)  # a device->host read
    with pytest.raises(RuntimeError, match="cannot be captured"):
        solvers.cg(syncing, b, tol=1e-7, maxiter=100)
    assert solvers.cg(op, b, tol=1e-7, maxiter=100).iters > solvers.BLOCK_ITERS


SOLVER_PHASES = {"solver.preamble": "preamble_ms", "solver.eager_block": "eager_ms",
                 "solver.capture": "capture_ms", "solver.replay": "replay_ms",
                 "solver.wait": "wait_ms"}


def test_graph_solve_records_capture_time_and_allocator_calls(card):
    """Every capture gets a private pool of its own, which the allocator
    fills with ``cudaMalloc``: a captured solve reads capture time and at least
    one allocator call."""
    from repro_torch.core import solvers
    _, A, b = _loop_system("DIA", card)
    solvers.cg(solvers.operator(A), b, tol=1e-7, maxiter=100)
    first = solvers.last_loop
    assert first is solvers.loops[-1] and first.captured
    assert first.capture_ms > 0 and first.device_allocs >= 1
    assert all(getattr(first, f) >= 0 for f in SOLVER_PHASES.values())


def test_solver_phase_spans_partition_a_solve_in_summary_mode(card):
    """The five ``solver.*`` spans of a captured solve: each nested in its
    phase of the record (within 20 us an opening), the phases summing to
    the call's wall time."""
    import time

    from repro_torch.core import solvers
    from repro_torch.obs import trace
    _, A, b = _loop_system("DIA", card)
    op = solvers.operator(A)
    solvers.cg(op, b, tol=1e-7, maxiter=100)  # kernels built and loaded
    with trace.tracing("summary"):
        trace.clear()
        t0 = time.perf_counter_ns()
        solvers.cg(op, b, tol=1e-7, maxiter=100)
        wall_ms = (time.perf_counter_ns() - t0) * 1e-6
        agg = trace.aggregate()
    trace.clear()
    L = solvers.last_loop
    counts = {"solver.preamble": 1, "solver.eager_block": L.eager, "solver.capture": 1,
              "solver.replay": L.replays + 1, "solver.wait": L.syncs}
    assert L.captured and {k: agg[k]["count"] for k in counts} == counts
    total = sum(getattr(L, f) for f in SOLVER_PHASES.values())
    assert wall_ms - 0.2 <= total <= wall_ms
    for name, field in SOLVER_PHASES.items():
        ms, span_ms = getattr(L, field), agg[name]["total_us"] * 1e-3
        assert span_ms <= ms <= span_ms + 0.02 * counts[name] + 0.01 * ms, name


@pytest.mark.parametrize("mode", ["off", "summary"])
def test_convert_execute_span_waits_for_the_container(card, mode, monkeypatch):
    """In summary mode ``convert.execute`` synchronizes the converted
    container's device once, at its close (HYB's nested parts too); off
    mode never synchronizes."""
    from repro_torch.obs import trace
    real, calls = torch.cuda.synchronize, []

    def counted(*a):
        calls.append(a)
        real(*a)
    C = coo_from_dense_np(np.eye(512, dtype=np.float32), device=card)
    monkeypatch.setattr(torch.cuda, "synchronize", counted)
    with trace.tracing(mode):
        trace.clear()
        outs = [convert(C, fmt) for fmt in (Format.CSR, Format.HYB)]
        agg = trace.aggregate()
    trace.clear()
    if mode == "off":
        assert calls == [] and agg == {}
    else:
        assert agg["convert.execute"]["count"] == len(calls) >= 2
        assert set(calls) == {(outs[0].device,)}
