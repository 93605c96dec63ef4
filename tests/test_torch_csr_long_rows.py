"""The CSR kernel's long-row plan (``repro_torch.kernels.csr_spmv``) on the
CPU: built by torch ops, held to a numpy computation; its chunks cover each
long row once; it finds the padding row of a stacked part; and the CPU
route's SpMV on those parts against JAX's jnp CSR reference.

The kernel itself runs only on the card (``test_torch_cuda.py``); here the
plan, which the wrapper builds with torch ops, and the schedule's
partition of the entries are checked.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.core.distributed as jd
import repro.core.hpcg as jhpcg
import repro.core.ops as jops
import repro_torch.core.formats as tf
from repro_torch.core import distributed as td
from repro_torch.core.convert import part_of
from repro_torch.core.formats import Format
from repro_torch.core.ops import spmv
from repro_torch.kernels import csr_spmv as kc
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import csr_spmv_ref
from torch_long_rows import MAX_CHUNK_ROW, csr_arrays, plan_np, powerlaw_csr, ragged_lens
from torch_parity import DEV, jconv, tconv
from torch_training import one_torch_thread  # noqa: F401  (module fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NSHARDS = 4
GRID = (8, 8, 16)
SPMV_ATOL = 1e-4  # the CPU route against JAX's jnp reference, f32


def _plan_matches_numpy(indptr_np, capacity, vec):
    indptr = torch.from_numpy(indptr_np)
    plan = kc.long_row_plan(indptr, capacity, vec)
    thr, k_max, chunk_end, chunk_row = plan_np(indptr_np, capacity, vec)
    assert plan.threshold == thr and plan.k_max == k_max and plan.capacity == capacity
    assert plan.indptr is indptr and plan.partials.shape == (k_max,)
    assert plan.partials.dtype == torch.float32
    if k_max == 0:  # no row can be long: nothing for the kernel to read
        assert plan.chunk_end.numel() == plan.chunk_row.numel() == plan.arrive.numel() == 0
        assert int(np.sum(np.diff(indptr_np) > thr)) == 0
        return plan
    assert len(chunk_row) <= k_max  # the host bound holds
    np.testing.assert_array_equal(plan.chunk_end.numpy(), chunk_end)
    np.testing.assert_array_equal(plan.chunk_row[:len(chunk_row)].numpy(), chunk_row)
    assert plan.chunk_end.dtype == plan.chunk_row.dtype == plan.arrive.dtype == torch.int32
    assert not plan.arrive.any() and plan.arrive.shape == (len(indptr_np) - 1,)
    return plan


def _schedule_sum(indptr, idx, val, x, vec, plan):
    """y as the kernel's schedule partitions the work, in float64: a row of
    at most ``plan.threshold`` entries summed whole, a long row as the sum
    of its plan's chunks (chunk_end / chunk_row, CHUNK entries each, the
    last one cut at the row's end). NaN where no schedule wrote a row."""
    m = len(indptr) - 1
    y = np.full(m, np.nan)
    n = len(x)
    prod = val.astype(np.float64) * x[np.clip(idx, 0, n - 1)].astype(np.float64)
    lens = np.diff(indptr.astype(np.int64))
    short = lens <= plan.threshold
    for i in np.flatnonzero(short):
        y[i] = prod[indptr[i]:indptr[i + 1]].sum()
    if plan.k_max == 0:
        return y
    chunk_end = plan.chunk_end.numpy().astype(np.int64)
    nchunks = int(chunk_end[-1])
    rows = plan.chunk_row[:nchunks].numpy()
    partial = np.zeros(nchunks)
    for q, r in enumerate(rows):
        nch = -(-lens[r] // kc.CHUNK)
        c0 = chunk_end[r] - nch
        beg = indptr[r] + (q - c0) * kc.CHUNK
        end = min(beg + kc.CHUNK, indptr[r + 1])
        assert beg < end  # no empty chunk
        partial[q] = prod[beg:end].sum()
    for r in np.flatnonzero(~short):
        nch = -(-lens[r] // kc.CHUNK)
        assert np.isnan(y[r])  # written by exactly one schedule
        y[r] = partial[chunk_end[r] - nch:chunk_end[r]].sum()
    return y


def _holds_to_oracle_and_plain(y, indptr, idx, val, x):
    """``y`` (the schedule's float64 sums) equals each row summed whole in
    float64 to rounding, and the plain version (float32 sums) within 1e-5
    of each row's sum of |products|."""
    n = len(x)
    prod = val.astype(np.float64) * x[np.clip(idx, 0, n - 1)].astype(np.float64)
    rows = range(len(indptr) - 1)
    oracle = np.array([prod[indptr[i]:indptr[i + 1]].sum() for i in rows])
    scale = np.array([np.abs(prod[indptr[i]:indptr[i + 1]]).sum() for i in rows])
    np.testing.assert_allclose(y, oracle, rtol=1e-12, atol=1e-12)
    y_ref = csr_spmv_ref(*(torch.from_numpy(a) for a in (indptr, idx, val, x)), len(rows))
    assert np.all(np.abs(y_ref.numpy() - y) <= 1e-4 + 1e-5 * scale)


@pytest.mark.parametrize("vec", kc.VEC_WIDTHS)
@pytest.mark.parametrize("case", sorted(ragged_lens(2)))
def test_long_row_plan_matches_numpy_on_ragged_rows(case, vec):
    """Empty rows, rows of exactly L and L + 1, k * CHUNK +- 1, one row
    holding every entry, a row of 2^20; NaN capacity past indptr[-1] is
    never read."""
    rng = np.random.default_rng(vec)
    lens = ragged_lens(vec)[case]
    n = 300
    indptr, idx, val = csr_arrays(rng, lens, n)
    plan = _plan_matches_numpy(indptr, len(val), vec)
    if case != "one_row":  # the filler rows keep the threshold at 32 * vec
        assert plan.threshold == kc.LONG_STEPS * vec
    x = rng.standard_normal(n).astype(np.float32)
    y = _schedule_sum(indptr, idx, val, x, vec, plan)
    assert np.isfinite(y).all()  # every row written, no NaN padding read
    _holds_to_oracle_and_plain(y, indptr, idx, val, x)
    want_long = {r for r, ln in enumerate(lens)
                 if ln > kc.long_threshold(vec, len(val), len(lens))}
    assert want_long or case == "all_short"
    if plan.k_max:
        got = set(plan.chunk_row[:int(plan.chunk_end[-1])].tolist())
        assert got == want_long
    else:
        assert not want_long


def test_long_row_plan_on_one_row_of_every_entry():
    """One row of 2^20 entries among 8 (8x the average row): 4096 chunks,
    all of row 0; among 4 it is no longer than 4x the average, and stays on
    the one-row schedule."""
    indptr = np.array([0] + [MAX_CHUNK_ROW] * 8, np.int32)
    plan = _plan_matches_numpy(indptr, MAX_CHUNK_ROW + 5, 2)
    assert plan.chunk_end.tolist() == [MAX_CHUNK_ROW // kc.CHUNK] * 8
    assert not plan.chunk_row[:MAX_CHUNK_ROW // kc.CHUNK].any()
    plan = _plan_matches_numpy(indptr[:5], MAX_CHUNK_ROW, 2)
    assert plan.k_max == 0 and plan.threshold == kc.LONG_OVER_AVG * MAX_CHUNK_ROW // 4


def test_rows_all_alike_stay_on_the_one_row_schedule():
    """At vec 32 (average rows above 256 entries) a row is long only above
    4x the average: the sparse weights' rows of ~1,024 or ~4,096 entries
    keep the sub-warp schedule; one row 5x as long as its neighbours is
    cut."""
    lens = [1024 + (i % 7) * 9 for i in range(64)]
    indptr = np.array([0] + list(np.cumsum(lens)), np.int32)
    plan = _plan_matches_numpy(indptr, int(indptr[-1]), 32)
    assert plan.threshold > max(lens) and int(plan.chunk_end[-1]) == 0
    lens[5] = 5 * 1024
    indptr = np.array([0] + list(np.cumsum(lens)), np.int32)
    plan = _plan_matches_numpy(indptr, int(indptr[-1]), 32)
    assert plan.chunk_row[:int(plan.chunk_end[-1])].tolist() == [5] * 20


def test_long_row_plan_on_a_power_law_matrix():
    """Rows of 1 + floor(pareto(1.5) * 4) entries (a small M): the plan
    lists exactly the rows above the threshold."""
    indptr, idx, val = powerlaw_csr(0, 4096, longest=2048)
    lens = np.diff(indptr)
    assert lens.max() > kc.long_threshold(2, len(val), 4096) == 64
    assert (lens <= 64).mean() > 0.9
    plan = _plan_matches_numpy(indptr, len(val), 2)
    x = np.random.default_rng(1).standard_normal(4096).astype(np.float32)
    y = _schedule_sum(indptr, idx, val, x, 2, plan)
    _holds_to_oracle_and_plain(y, indptr, idx, val, x)
    rows = np.repeat(np.arange(4096), lens)  # columns unique and sorted within a row
    assert np.all(np.diff(rows.astype(np.int64) * 4096 + idx) > 0)


def test_long_row_plan_is_cached_per_container_and_width():
    indptr, idx, val = csr_arrays(np.random.default_rng(3), ragged_lens(2)["edges"], 300)
    A = tf.CSR(*(torch.from_numpy(a) for a in (indptr, idx, val)),
               shape=(len(indptr) - 1, 300), nnz=int(indptr[-1]))
    p2 = kops.csr_plan(A, 2)
    assert kops.csr_plan(A, 2) is p2 and kops.csr_plan(A, 4) is not p2
    assert kops.csr_plan(A, 4).threshold == kc.long_threshold(4, A.capacity, A.shape[0])
    B = tf.CSR(A.indptr, A.indices, A.data * 2, shape=A.shape, nnz=A.nnz)
    assert kops.csr_plan(B, 2) is not p2  # one plan a container


def test_wrapper_refuses_a_plan_of_another_pattern_or_width():
    indptr, idx, val = (torch.from_numpy(a) for a in csr_arrays(
        np.random.default_rng(4), ragged_lens(2)["edges"], 300))
    plan = kc.long_row_plan(indptr, len(val), 2)
    kc._check_plan(plan, indptr, val, 2)
    with pytest.raises(ValueError, match="built for vec=2, not vec=4"):
        kc._check_plan(plan, indptr, val, 4)
    with pytest.raises(ValueError, match="another indptr"):
        kc._check_plan(plan, indptr.clone(), val, 2)
    with pytest.raises(ValueError, match="bounds"):
        kc._check_plan(kc.long_row_plan(indptr, len(val) - 10, 2), indptr, val, 2)


def _boundary_csr_parts():
    """JAX's and the port's stacked boundary parts of the 8x8x16 stencil at
    P = 4 (JAX's mesh-free build), converted to CSR on both sides."""
    p = jhpcg.generate_problem(*GRID)
    row, col, val, shape = p.row, p.col, p.val, p.shape
    jp = jd.plan_partition(row, col, val, shape, NSHARDS)
    tp = td.plan_partition(row, col, val, shape, NSHARDS)
    jl, jr = jd.partition_execute_jit(row, col, val, plan=jp)
    tl, tr = td.partition_execute(row, col, val, tp, device=DEV)
    caps = jd._split_caps(row, col, val, jp.mp, NSHARDS)
    _, jb = jd.split_local_execute_jit(jl, jr, mp=jp.mp, icap=caps[0], bcap=caps[1])
    _, tb = td.split_local_execute(tl, tr, tp.mp, *caps)
    jcsr = jconv.convert_execute_batch(jb, jconv.plan_switch_batch(jb, Format.CSR))
    tcsr = tconv.convert_execute_batch(tb, tconv.plan_switch_batch(tb, Format.CSR))
    return jcsr, tcsr


def test_plan_finds_the_padding_row_of_a_boundary_part():
    """An edge shard's boundary part holds its capacity padding (row 0,
    value 0) at the end of row 0: the plan sends that row to the chunks; a
    middle shard has no long row."""
    _, tcsr = _boundary_csr_parts()
    long_row0 = []
    for p in range(NSHARDS):
        C = part_of(tcsr, p)
        vec = kops.default_config(C)["vec"]
        plan = _plan_matches_numpy(C.indptr.numpy(), C.capacity, vec)
        lens = np.diff(C.indptr.numpy())
        nlong = int(plan.chunk_end[-1]) if plan.k_max else 0
        if lens[0] > plan.threshold:
            long_row0.append(p)
            dead = int((C.data[C.indptr[0]:C.indptr[1]] == 0).sum())
            assert dead > plan.threshold  # long because of its padding
            assert set(plan.chunk_row[:nlong].tolist()) == {0}
        else:
            assert nlong == 0
    assert long_row0 == [0, NSHARDS - 1]  # the two edge shards


def test_cpu_route_on_boundary_parts_matches_jax_reference():
    jcsr, tcsr = _boundary_csr_parts()
    rng = np.random.default_rng(5)
    for p in range(NSHARDS):
        C = part_of(tcsr, p)
        J = jax.tree.map(lambda a, p=p: a[p], jcsr)
        x = rng.standard_normal(C.shape[1]).astype(np.float32)
        yj = np.asarray(jops.spmv(J, jnp.asarray(x), backend="ref"))
        for y in (kops.csr_spmv(C, torch.from_numpy(x)),  # the kernel wrapper's CPU route
                  spmv(C, torch.from_numpy(x))):
            assert y.dtype == torch.float32 and y.shape == yj.shape
            np.testing.assert_allclose(y.numpy(), yj, rtol=SPMV_ATOL, atol=SPMV_ATOL)
        plan = kc.long_row_plan(C.indptr, C.capacity, kops.default_config(C)["vec"])
        y_sched = _schedule_sum(C.indptr.numpy(), C.indices.numpy(), C.data.numpy(), x,
                                kops.default_config(C)["vec"], plan)
        np.testing.assert_allclose(y_sched, yj, rtol=SPMV_ATOL, atol=SPMV_ATOL)
