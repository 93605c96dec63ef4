"""Inputs of the CSR kernel's long-row schedule, shared by the CPU tests
(``test_torch_csr_long_rows.py``) and the card tests (``test_torch_cuda.py``).
Imports neither JAX nor the JAX package.

A row of more than ``long_threshold(vec, capacity, m)`` entries is long and
is reduced in ``CHUNK``-entry chunks (``repro_torch.kernels.csr_spmv``): more
than ``LONG_STEPS * vec`` entries and more than ``LONG_OVER_AVG`` times the
average row. The cases sit on those edges: each is filled with one-entry
rows until the average is low enough that the threshold is
``LONG_STEPS * vec`` itself.
"""
import itertools

import numpy as np

from repro_torch.kernels.csr_spmv import CHUNK, LONG_OVER_AVG, LONG_STEPS

MAX_CHUNK_ROW = 1 << 20  # one row holding 2^20 entries
PAD = 37  # capacity entries past indptr[-1]


def with_filler(lens, vec: int, pad: int = PAD):
    """``lens`` followed by as few one-entry rows as make
    LONG_OVER_AVG * ceil(capacity / m) <= LONG_STEPS * vec (the capacity
    counting ``pad`` entries past the rows)."""
    a = LONG_STEPS * vec // LONG_OVER_AVG  # the largest average row allowed
    total, m = int(sum(lens)) + pad, len(lens)
    return list(lens) + [1] * max(0, -(-(total - a * m) // (a - 1)))


def ragged_lens(vec: int):
    """Row-length lists at the edges of the schedule for ``vec`` lanes
    (L = LONG_STEPS * vec once filled): empty first/middle/last rows, rows
    of exactly L and L + 1 entries, rows of k * CHUNK +- 1, one row holding
    every entry (of 16 rows: long, 16x the average), a block of rows just
    past L, a row of 2^20 entries."""
    L, C = LONG_STEPS * vec, CHUNK
    cases = {
        "edges": [0, L, L + 1, 0, L - 1, C - 1, C, C + 1, 2 * C - 1, 2 * C, 2 * C + 1, 1, 0,
                  5 * C + 3, 7, 0],
        "many_just_long": [L + 1] * 40 + [3] * 100 + [L] * 5,
        "all_short": [0, L, 1, L - 1, 0],
        "huge_row": [0, 3, MAX_CHUNK_ROW, 0, 2],
    }
    cases = {k: with_filler(v, vec) for k, v in cases.items()}
    cases["one_row"] = [0] * 7 + [5 * C + 17] + [0] * 8  # above L at every vec
    return cases


def csr_arrays(rng, lens, n, pad=PAD):
    """(indptr int32, indices int32, values f32) with ``pad`` capacity
    entries past indptr[-1] holding NaN values and columns past both edges
    (the kernel clamps columns and never reads past indptr[-1])."""
    nnz = int(sum(lens))
    indptr = np.array([0] + list(itertools.accumulate(lens)), np.int32)
    idx = rng.integers(-3, n + 3, nnz + pad).astype(np.int32)
    val = rng.standard_normal(nnz + pad).astype(np.float32)
    val[nnz:] = np.nan
    return indptr, idx, val


def powerlaw_csr(seed: int, m: int, longest: int = 65536):
    """A power-law CSR (M = N = m) made with numpy from ``seed``: row
    lengths ``1 + floor(pareto(1.5) * 4)`` capped at ``longest``, columns
    uniform, unique and sorted within a row, values standard normal."""
    rng = np.random.default_rng(seed)
    lens = np.minimum(1 + np.floor(rng.pareto(1.5, m) * 4).astype(np.int64), min(longest, m))
    indptr = np.concatenate([[0], np.cumsum(lens)])
    nnz = int(indptr[-1])
    rows = np.repeat(np.arange(m, dtype=np.int64), lens)
    cols = rng.integers(0, m, nnz)
    while True:  # redraw the columns a row repeats until none does
        key = rows * m + cols
        order = np.argsort(key, kind="stable")
        keys = key[order]
        dup = np.zeros(nnz, bool)
        dup[order[1:]] = keys[1:] == keys[:-1]
        if not dup.any():
            break
        cols[dup] = rng.integers(0, m, int(dup.sum()))
    cols = (keys - rows * m).astype(np.int32)  # sorted within each row
    return indptr.astype(np.int32), cols, rng.standard_normal(nnz).astype(np.float32)


def plan_np(indptr, capacity: int, vec: int):
    """The long-row plan in numpy: (threshold, k_max, chunk_end, chunk_row
    of the chunks there are)."""
    m = len(indptr) - 1
    thr = max(LONG_STEPS * vec, LONG_OVER_AVG * int(np.ceil(capacity / max(m, 1))))
    long_max = min(m, capacity // (thr + 1))
    k_max = capacity // CHUNK + long_max if long_max else 0
    lens = np.diff(np.asarray(indptr, np.int64))
    chunks = np.where(lens > thr, -(-lens // CHUNK), 0)
    return thr, k_max, np.cumsum(chunks), np.repeat(np.arange(m), chunks)
