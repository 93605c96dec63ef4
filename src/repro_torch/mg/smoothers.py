"""Vector-friendly smoothers: multicolored SymGS and weighted Jacobi
(port of ``repro.mg.smoothers``).

HPCG's reference symmetric Gauss-Seidel sweeps rows in lexicographic
order, each update reading the previous one. Under the 2x2x2 (8-color)
coloring of a 3D grid, same-color points are at distance >= 2 along every
axis, so the 27-point stencil never couples two points of one color, and
Gauss-Seidel in *color order* updates each color's rows at once:

    for color c (ascending = forward, descending = backward):
        x[c] += (b[c] - (A x)[c]) / diag[c]

Each per-color partial ``(A x)[c]`` is one SpMV of the color's **row
block**, an ordinary (rows_c, n) sparse matrix in any of the library's
formats, so the sweep runs on the SpMV kernels through
``repro_torch.core.ops.spmv``. The sweep is exactly sequential
Gauss-Seidel over the color-permuted row ordering.

Build path: the 8 row blocks are extracted as ONE stacked ``(8, cap)`` COO
batch (one stable ``argsort`` scatter on the device), featurised in one
``FormatPolicy.select_batch`` pass when a policy is given, and converted
per color through plan/execute, so every color block can have its own
format.

Differences from the JAX package: each color's row ids (int64), its live
row count and its rows of the diagonal are gathered once at build time
(JAX gathers the diagonal every sweep; the values are the same). A sweep
updates x in place with ``index_add_`` over the color's live rows only:
the padded lanes, which JAX's scatter drops, are never written. Within a
color every row id is unique, so the update reruns bitwise on the card.
No sweep syncs with the host.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import ops as _ops
from repro_torch.core.convert import _planned_pull, convert_execute, plan_switch, to_coo
from repro_torch.core.formats import COO, Format

NCOLORS = 8


def color_grid(nx: int, ny: int, nz: int) -> np.ndarray:
    """2x2x2 parity coloring of the x-fastest-ordered grid: color =
    (x%2) + 2*(y%2) + 4*(z%2). Proper for any stencil of reach <= 1 per
    axis (the 27-point stencil): no two same-color points are coupled."""
    idx = np.arange(nx * ny * nz)
    x, y, z = idx % nx, (idx // nx) % ny, idx // (nx * ny)
    return ((x % 2) + 2 * (y % 2) + 4 * (z % 2)).astype(np.int32)


def check_coloring(C: COO, colors: np.ndarray) -> None:
    """Raise if ``colors`` is not a proper coloring of ``C``'s live
    off-diagonal pattern (a host scan; same-color coupling would turn the
    parallel sweep into chaotic relaxation)."""
    r = C.row.cpu().numpy()
    c = C.col.cpu().numpy()
    live = (C.data.cpu().numpy() != 0) & (r != c)
    bad = colors[r[live]] == colors[c[live]]
    if bad.any():
        i = int(np.argmax(bad))
        rr, cc = r[live][i], c[live][i]
        raise ValueError(
            f"improper coloring: rows {rr} and {cc} share color "
            f"{int(colors[rr])} but are coupled; a colored sweep would not "
            f"match sequential Gauss-Seidel")


@dataclasses.dataclass(frozen=True)
class ColoredSystem:
    """Color-permuted view of a square system for parallel Gauss-Seidel.

    ``blocks[c]`` is the (rmax, n) row block of color ``c`` (any format;
    inert padding rows when colors are unevenly sized); ``rows[c]`` holds
    the block's global row ids (int64), padded with ``n`` as JAX pads
    them; ``counts[c]`` is the number of live (unpadded) rows;
    ``diag_rows[c]`` the diagonal at those rows (1 where it is 0); ``diag``
    the full diagonal of A.
    """

    blocks: Tuple
    rows: Tuple[torch.Tensor, ...]
    diag: torch.Tensor
    shape: Tuple[int, int]
    counts: Tuple[int, ...]
    diag_rows: Tuple[torch.Tensor, ...]

    @property
    def ncolors(self) -> int:
        return len(self.blocks)

    @property
    def formats(self) -> Tuple[Format, ...]:
        return tuple(Format(b.format) for b in self.blocks)


def color_ranks(colors: np.ndarray) -> np.ndarray:
    """(n,) rank of every row within its color (host; shared metadata)."""
    order = np.argsort(colors, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order)) - np.concatenate(
        [[0], np.cumsum(np.bincount(colors, minlength=NCOLORS))])[colors[order]]
    return rank.astype(np.int32)


def _color_key(C: COO, colors_d: torch.Tensor) -> torch.Tensor:
    """Per-entry color of its row (int64); dead entries get ``NCOLORS``."""
    return torch.where(C.data != 0, colors_d.index_select(0, C.row.long()),
                       torch.full((), NCOLORS, dtype=torch.int64, device=C.device))


def _split_colors_device(C: COO, colors_d: torch.Tensor, rank_d: torch.Tensor,
                         cap: int):
    """Device core of the color split: one stable argsort scatters the
    entries of a (cap0,) COO into ``(NCOLORS, cap)`` planes. Entry (i, j, v)
    lands in plane ``colors[i]`` at row ``rank_of_i_within_color``; dead
    entries and per-color overflow land in a guard slot that is cut off."""
    cap0 = C.row.shape[0]
    dev = C.device
    key = _color_key(C, colors_d)
    order_e = torch.argsort(key, stable=True)
    k_s = key.index_select(0, order_e)
    r_s = C.row.index_select(0, order_e)
    ones = torch.ones_like(key)
    starts = torch.cat([torch.zeros((1,), dtype=torch.int64, device=dev),
                        _ops.segment_sum(ones, key, NCOLORS + 1).cumsum(0)])
    erank = torch.arange(cap0, dtype=torch.int64, device=dev) - starts.index_select(0, k_s)
    ok = (k_s < NCOLORS) & (erank < cap)
    dest = torch.where(ok, k_s * cap + erank.clamp(max=cap - 1), NCOLORS * cap)
    out = []
    for xs in (rank_d.index_select(0, r_s.long()), C.col.index_select(0, order_e),
               C.data.index_select(0, order_e)):
        buf = torch.zeros((NCOLORS * cap + 1,), dtype=xs.dtype, device=dev)
        # the guard slot takes every dropped entry: which one wins is moot
        buf[dest] = torch.where(ok, xs, torch.zeros((), dtype=xs.dtype, device=dev))
        out.append(buf[:NCOLORS * cap].view(NCOLORS, cap))
    return out[0], out[1], out[2]


def split_colors_stacked(C: COO, colors: np.ndarray, rmax: int, cap: int) -> COO:
    """One device scatter: (cap0,) COO -> stacked (ncolors, cap) row blocks
    (``cap`` must come from a prior count: see :func:`build_colored`)."""
    colors_d = torch.from_numpy(np.asarray(colors, np.int64)).to(C.device)
    rank_d = torch.from_numpy(color_ranks(colors)).to(C.device)
    r, c, v = _split_colors_device(C, colors_d, rank_d, cap)
    return COO(r, c, v, (rmax, C.shape[1]), cap)


def color_rows_padded(colors: np.ndarray, n: int, rmax: int) -> np.ndarray:
    """(ncolors, rmax) global row ids per color, padded with ``n``."""
    rows = np.full((NCOLORS, rmax), n, np.int32)
    for c in range(NCOLORS):
        ids = np.nonzero(colors == c)[0]
        rows[c, :len(ids)] = ids
    return rows


def build_colored(A, colors: Optional[np.ndarray] = None,
                  dims: Optional[Tuple[int, int, int]] = None,
                  fmt: Format = Format.CSR, policy=None,
                  check: bool = False) -> ColoredSystem:
    """Build the per-color row blocks of a square operator ``A`` on its
    device.

    ``colors`` (or ``dims``, from which the 2x2x2 grid coloring is derived)
    assigns every row a color. With a ``FormatPolicy`` each color block
    picks its own format from ONE batched ``select_batch`` pass over the
    stacked blocks; otherwise all blocks use ``fmt``. ``check=True``
    verifies the coloring is proper (host scan). The per-color entry
    capacity is one planned pull.
    """
    C = to_coo(A.concrete if hasattr(A, "concrete") else A)
    n = C.shape[0]
    if colors is None:
        if dims is None:
            raise ValueError("build_colored needs colors= or dims=")
        colors = color_grid(*dims)
    colors = np.asarray(colors, np.int32)
    if len(colors) != n:
        raise ValueError(f"{len(colors)} colors for {n} rows")
    if check:
        check_coloring(C, colors)

    counts = np.bincount(colors, minlength=NCOLORS)
    rmax = max(1, int(counts.max()))
    # per-color entry capacity: one device pass + one planned pull
    colors_d = torch.from_numpy(colors.astype(np.int64)).to(C.device)
    key = _color_key(C, colors_d)
    ecnt = _ops.segment_sum(torch.ones_like(key), key, NCOLORS + 1)[:NCOLORS]
    cap = max(1, int(_planned_pull(ecnt.max())))

    stacked = split_colors_stacked(C, colors, rmax, cap)
    if policy is not None:
        ids = policy.select_batch(stacked)
        fmts = [policy.candidates[i] for i in ids]
    else:
        fmts = [Format(fmt)] * NCOLORS
    blocks = []
    for c in range(NCOLORS):
        blk = COO(stacked.row[c], stacked.col[c], stacked.data[c], (rmax, n), cap)
        blocks.append(convert_execute(blk, plan_switch(blk, fmts[c])))
    rows_np = color_rows_padded(colors, n, rmax)
    rows = tuple(torch.from_numpy(rows_np[c].astype(np.int64)).to(C.device)
                 for c in range(NCOLORS))
    diag = _ops.extract_diagonal(C)
    live = tuple(int(k) for k in counts)
    one = torch.ones((), dtype=diag.dtype, device=diag.device)
    diag_rows = []
    for c in range(NCOLORS):
        dc = diag.index_select(0, rows[c][:live[c]])
        diag_rows.append(torch.where(dc != 0, dc, one))
    return ColoredSystem(tuple(blocks), rows, diag, (n, n), live, tuple(diag_rows))


# ---------------------------------------------------------------------------
# Sweeps
# ---------------------------------------------------------------------------


def _sweep_(cs: ColoredSystem, b: torch.Tensor, x: torch.Tensor, forward: bool,
            backend: Optional[str], cfg) -> torch.Tensor:
    """One color-order Gauss-Seidel sweep, updating ``x`` in place: per
    color one row-block SpMV, a gather of b, and an ``index_add_`` over the
    color's live rows (five launches)."""
    order = range(cs.ncolors) if forward else range(cs.ncolors - 1, -1, -1)
    for c in order:
        k = cs.counts[c]
        if k == 0:
            continue
        y = _ops.spmv(cs.blocks[c], x, backend=backend, cfg=cfg)
        rows = cs.rows[c][:k]
        delta = (b.index_select(0, rows) - y[:k]) / cs.diag_rows[c]
        x.index_add_(0, rows, delta.to(x.dtype))
    return x


def gs_sweep(cs: ColoredSystem, b: torch.Tensor, x: torch.Tensor,
             forward: bool = True, backend: Optional[str] = None,
             cfg=None) -> torch.Tensor:
    """One Gauss-Seidel sweep in color order (exact GS over the color
    permutation); returns a new x. ``backend=None``: the SpMV kernels on
    the card, the reference on the CPU."""
    return _sweep_(cs, b, x.clone(), forward, backend, cfg)


def _symgs_(cs: ColoredSystem, b: torch.Tensor, x: torch.Tensor, sweeps: int,
            backend: Optional[str], cfg) -> torch.Tensor:
    for _ in range(int(sweeps)):
        _sweep_(cs, b, x, True, backend, cfg)
        _sweep_(cs, b, x, False, backend, cfg)
    return x


def symgs(cs: ColoredSystem, b: torch.Tensor, x: Optional[torch.Tensor] = None,
          sweeps: int = 1, backend: Optional[str] = None, cfg=None) -> torch.Tensor:
    """Symmetric Gauss-Seidel: forward then backward color sweep,
    ``sweeps`` times (x defaults to zeros; the input is not modified).
    Self-adjoint in the A-inner product: the V-cycle smoother that keeps
    ``apply_M`` a symmetric preconditioner."""
    x = torch.zeros_like(b) if x is None else x.clone()
    return _symgs_(cs, b, x, sweeps, backend, cfg)


def jacobi(diag: torch.Tensor, apply_A, b: torch.Tensor,
           x: Optional[torch.Tensor] = None, sweeps: int = 1,
           omega: float = 2.0 / 3.0) -> torch.Tensor:
    """Weighted-Jacobi fallback smoother (for operators without a proper
    coloring): x += omega * (b - A x) / diag."""
    zero = torch.zeros((), dtype=diag.dtype, device=diag.device)
    minv = torch.where(diag.abs() > 1e-30, omega / diag, zero)
    if x is None:
        x = minv * b
        start = 1
    else:
        start = 0
    for _ in range(start, int(sweeps)):
        x = x + minv * (b - apply_A(x))
    return x


def symgs_reference_np(row, col, val, colors: np.ndarray, b: np.ndarray,
                       x: np.ndarray, sweeps: int = 1) -> np.ndarray:
    """Sequential NumPy SymGS oracle over the color-permuted row ordering.

    Processes rows one at a time in (color, row) order, forward then
    reverse, always reading the latest x. With a proper coloring the
    parallel :func:`symgs` matches this up to float summation order.
    """
    row = np.asarray(row)
    col = np.asarray(col)
    val = np.asarray(val, np.float64)
    x = np.asarray(x, np.float64).copy()
    b = np.asarray(b, np.float64)
    n = len(x)
    diag = np.zeros(n)
    np.add.at(diag, row[row == col], val[row == col])
    perm = np.lexsort((np.arange(n), colors))  # rows in (color, id) order
    by_row = [[] for _ in range(n)]
    for r, c, v in zip(row, col, val):
        if v != 0:
            by_row[r].append((c, v))
    for _ in range(sweeps):
        for ordering in (perm, perm[::-1]):
            for r in ordering:
                s = sum(v * x[c] for c, v in by_row[r])
                x[r] += (b[r] - s) / diag[r]
    return x
