"""Algorithms over sparse containers (the paper's §III-D algorithm layer).

Port of ``repro.core.ops``. The ``_spmv_*`` and ``_spmm_*`` functions are
the plain torch reference path for every format (the CPU path, and the
``ref`` backend on the card); ``repro_torch.kernels`` holds the hand-written
CUDA kernels, selected with ``backend=``:

  * ``None``: the kernel for a CUDA tensor (always: no record decides
    whether it runs), the reference for a CPU tensor;
  * ``"cuda"``: the kernel, on CUDA tensors only; ``"ref"``: the reference;
  * ``"auto"``: the measured route (:func:`kernel_route`): the kernel only
    where a ``kernel_tune`` record for the matrix's bucket beat the
    reference, with that record's launch knobs; otherwise the reference,
    counted as ``kernel.route.veto`` or ``kernel.route.ref``. Each decision
    leaves a ``kernel.route`` trace event (while tracing is on) and a
    ``kernel.route`` ledger record with its reason: the port routes on
    every call, so a record is taken once per container, op and width
    bucket, and again when the tuning store changes.

Reference semantics carried over from JAX:
  * ``jnp.take(..., mode="clip")`` clamps an index into range — torch's
    gathers raise instead, so every gather index is clamped first;
  * ``segment_sum`` drops ids outside ``[0, num_segments)`` — here an
    ``index_add_`` over masked, int64 ids;
  * SELL ghost lanes (``perm == M``) are dropped by JAX's out-of-bounds
    scatter; here they are masked explicitly.
"""
from __future__ import annotations

import weakref
from typing import Optional

import torch

from repro_torch.core.formats import BSR, COO, CSR, DIA, ELL, Dense, HYB, SELL
from repro_torch.obs import ledger as _ledger
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace

# ---------------------------------------------------------------------------
# Helpers shared with the conversions
# ---------------------------------------------------------------------------


def take_clip(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(x, idx, axis=0, mode="clip")``."""
    flat = idx.reshape(-1).long().clamp(0, max(x.shape[0] - 1, 0))
    return x.index_select(0, flat).reshape(idx.shape + x.shape[1:])


def segment_sum(vals: torch.Tensor, ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: ids outside ``[0, num_segments)`` are dropped."""
    ids = ids.long()
    ok = (ids >= 0) & (ids < num_segments)
    mask = ok.reshape(ok.shape + (1,) * (vals.dim() - 1))
    vals = torch.where(mask, vals, torch.zeros((), dtype=vals.dtype, device=vals.device))
    out = torch.zeros((num_segments,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(0, ids.clamp(0, max(num_segments - 1, 0)), vals)


def csr_row_ids(indptr: torch.Tensor, capacity: int, m: int) -> torch.Tensor:
    """Per-entry row ids of a capacity-padded CSR layout (int32). Padding
    entries past ``indptr[-1]`` clip to row ``m - 1`` (their values are
    zero, so they are inert under accumulate semantics)."""
    k = torch.arange(capacity, dtype=indptr.dtype, device=indptr.device)
    rows = torch.searchsorted(indptr, k, right=True).to(torch.int32) - 1
    return rows.clamp(0, m - 1)


def _result_dtype(a: torch.Tensor, b: torch.Tensor) -> torch.dtype:
    return torch.promote_types(a.dtype, b.dtype)


# ---------------------------------------------------------------------------
# SpMV: y = A @ x (reference path)
# ---------------------------------------------------------------------------


def coo_row_order(A: COO):
    """``A``'s entries sorted by row for :func:`_spmv_coo`: ``(cols, data,
    offsets)``, with each row's live entries in entry order (a stable sort)
    and its segment ``offsets[i]:offsets[i + 1]``; dead entries (the
    capacity padding, row 0 value 0, of which an edge shard's part holds
    tens of thousands) sort past ``offsets[m]`` and are never reduced."""
    m, n = A.shape
    live = (A.data != 0) & (A.row >= 0) & (A.row < m)
    rows, order = torch.sort(torch.where(live, A.row, torch.full_like(A.row, m)), stable=True)
    cols = A.col.index_select(0, order).long().clamp(0, max(n - 1, 0))
    offsets = torch.searchsorted(rows, torch.arange(m + 1, dtype=rows.dtype, device=rows.device))
    return cols, A.data.index_select(0, order), offsets


# coo_row_order of each COO container, made at its first SpMV. Containers
# are immutable (new values make a new container), so the order holds for
# the container's life; the entry goes with it.
_COO_ORDER: "weakref.WeakKeyDictionary[COO, tuple]" = weakref.WeakKeyDictionary()


def _spmv_coo(A: COO, x):
    # COO has no kernel: this is its path on the card too (the remote parts
    # of a distributed matrix are COO by default). One segment reduction a
    # row over the entries in coo_row_order, so y reruns bitwise, which
    # atomic adds would not give.
    order = _COO_ORDER.get(A)
    if order is None:
        order = _COO_ORDER[A] = coo_row_order(A)
    cols, data, offsets = order
    return torch.segment_reduce(data * x.index_select(0, cols), "sum", offsets=offsets)


def _spmv_csr(A: CSR, x):
    rows = csr_row_ids(A.indptr, A.capacity, A.shape[0])
    contrib = A.data * take_clip(x, A.indices)
    return segment_sum(contrib, rows, A.shape[0])


def _spmv_dia(A: DIA, x):
    # One contiguous shifted multiply-add per diagonal, accumulated in the
    # order of the diagonals as the JAX scan does. x is zero-padded by M on
    # both sides, so the shifted window x[i + off] lies inside the padded
    # vector for any offset in [-(M-1), N-1]; the window is read with a
    # device-side index (no host sync on the offset).
    m, n = A.shape
    xp = torch.nn.functional.pad(x, (m, m))
    base = torch.arange(m, device=x.device) + m
    offs = A.offsets.long()
    acc = torch.zeros((m,), dtype=_result_dtype(A.data, x), device=x.device)
    for d in range(A.ndiag):
        w = xp.index_select(0, (base + offs[d]).clamp(0, n + 2 * m - 1))
        acc = acc + A.data[d] * w
    return acc


def _spmv_ell(A: ELL, x):
    return (A.data * take_clip(x, A.cols)).sum(dim=1)


def _bsr_block_rows(A: BSR) -> torch.Tensor:
    k = torch.arange(A.nblocks, dtype=A.indptr.dtype, device=A.indptr.device)
    brow = torch.searchsorted(A.indptr, k, right=True).to(torch.int32) - 1
    return brow.clamp(0, A.shape[0] // A.block_size - 1)


def _spmv_bsr(A: BSR, x):
    bs = A.block_size
    m, n = A.shape
    xb = x.reshape(n // bs, bs)
    gathered = take_clip(xb, A.indices)  # (nblk, bs)
    prod = torch.einsum("nij,nj->ni", A.data, gathered)
    yb = segment_sum(prod, _bsr_block_rows(A), m // bs)
    return yb.reshape(m)


def _spmv_dense(A: Dense, x):
    return A.data @ x


def _spmv_hyb(A: HYB, x):
    return _spmv_ell(A.ell, x) + _spmv_coo(A.coo, x)


def sell_sorted_ids(slice_ptrs: torch.Tensor, c: int, capacity: int,
                    nslices: int) -> torch.Tensor:
    """Per-entry *sorted row position* of a flat SELL layout."""
    q = torch.arange(capacity, dtype=slice_ptrs.dtype, device=slice_ptrs.device)
    s = torch.searchsorted(slice_ptrs, q, right=True).to(torch.int32) - 1
    s = s.clamp(0, nslices - 1)
    lane = (q - slice_ptrs[s.long()]) % c
    return s * c + lane


def _sell_plane_ids(A: SELL) -> torch.Tensor:
    """Slice id of each width *plane* (capacity is a multiple of C)."""
    t = A.capacity // A.c
    q = torch.arange(t, dtype=A.slice_ptrs.dtype, device=A.slice_ptrs.device) * A.c
    sid = torch.searchsorted(A.slice_ptrs, q, right=True).to(torch.int32) - 1
    return sid.clamp(0, A.nslices - 1)


def _spmv_sell(A: SELL, x):
    m = A.shape[0]
    c = A.c
    t = A.capacity // c
    contrib = A.data.reshape(t, c) * take_clip(x, A.cols.reshape(t, c))
    y_sorted = segment_sum(contrib, _sell_plane_ids(A), A.nslices).reshape(-1)
    # ghost lanes carry perm == m: masked out of the scatter
    return segment_sum(y_sorted, A.perm, m)


_SPMV = {COO: _spmv_coo, CSR: _spmv_csr, DIA: _spmv_dia, ELL: _spmv_ell,
         BSR: _spmv_bsr, Dense: _spmv_dense, HYB: _spmv_hyb,
         SELL: _spmv_sell}

def resolve_backend(backend: Optional[str], x: torch.Tensor) -> str:
    """``None`` -> ``"cuda"`` for a CUDA tensor, ``"ref"`` for a CPU one;
    ``"auto"`` is routed per matrix by :func:`kernel_route`."""
    if backend is None:
        return "cuda" if x.is_cuda else "ref"
    if backend not in ("ref", "cuda"):
        raise ValueError(f"unknown backend {backend!r} (ref | cuda | auto | None)")
    return backend


def kernel_route(A, op: str = "spmv", cache=None, ncols: Optional[int] = None):
    """The measured ``"auto"`` decision for a container: ``("cuda", cfg)``
    where a cached ``kernel_tune`` record for ``A``'s (format, shape
    bucket[, rhs-width bucket ``ncols``]) on this card beat the reference
    (``cfg``: the record's knobs), else ``("ref", None)``, also when no
    record exists (an unmeasured kernel is never presumed faster) and for a
    container off the card (the port has no kernel there). Counts
    ``kernel.route.cuda``, ``kernel.route.veto`` (a record that lost) or
    ``kernel.route.ref``. Host dict lookups only."""
    if isinstance(A, _DYN_TYPES):
        A = getattr(A, "concrete", A)
    from repro_torch.tuning import kernel_tune  # lazy: tuning imports core
    if not hasattr(A, "format"):
        _metrics.inc("kernel.route.ref")
        if _ledger.enabled() and _first_route(A, op, ncols, None):
            _ledger.record("kernel.route", op=op, fmt=type(A).__name__, route="ref",
                           reason="not a sparse container — no kernel exists for it")
        return "ref", None
    fmt_name = getattr(A.format, "name", str(A.format))
    if kernel_tune.backend_tag(A.device) != kernel_tune.CUDA_TAG:
        _metrics.inc("kernel.route.ref")
        if _trace.mode() != "off":
            _trace.event("kernel.route", op=op, route="ref", fmt=fmt_name)
        if _ledger.enabled() and _first_route(A, op, ncols, None):
            _ledger.record("kernel.route", op=op, fmt=fmt_name, route="ref",
                           bucket=_route_bucket(A, op, ncols),
                           reason="container off the card — the port's kernels "
                                  "run on CUDA tensors only")
        return "ref", None
    rec = kernel_tune.best_config(A, op=op, ncols=ncols, cache=cache)
    if rec is not None and rec.speedup >= 1.0:
        _metrics.inc("kernel.route.cuda")
        if _trace.mode() != "off":
            _trace.event("kernel.route", op=op, route="cuda", fmt=fmt_name,
                         cfg=str(dict(rec.cfg)))
        if _ledger.enabled() and _first_route(A, op, ncols, rec):
            _ledger.record("kernel.route", op=op, fmt=fmt_name, route="cuda",
                           kernel=_route_kernel_dict(rec),
                           bucket=_route_bucket(A, op, ncols))
        return "cuda", dict(rec.cfg)
    # "no record" differs from "a record exists but measured slower"
    _metrics.inc("kernel.route.veto" if rec is not None else "kernel.route.ref")
    if _trace.mode() != "off":
        _trace.event("kernel.route", op=op, route="veto" if rec is not None else "ref",
                     fmt=fmt_name)
    if _ledger.enabled() and _first_route(A, op, ncols, rec):
        if rec is not None:
            _ledger.record("kernel.route", op=op, fmt=fmt_name, route="veto",
                           kernel=_route_kernel_dict(rec),
                           bucket=_route_bucket(A, op, ncols),
                           reason=f"cached kernel measured {rec.speedup:.2f}x "
                                  "vs ref (< 1.0) — reference path kept")
        else:
            _ledger.record("kernel.route", op=op, fmt=fmt_name, route="ref",
                           bucket=_route_bucket(A, op, ncols),
                           reason="no tuned record for this bucket — an "
                                  "unmeasured kernel is never presumed faster")
    return "ref", None


# The route decisions already in the ledger: container -> {(op, width
# bucket): (store flushes, record)}. The JAX package records a route once
# per jit trace; the port routes on every call and records a decision again
# only for another container, op or width bucket, or after the tuning store
# changed (a flush in this process, or another record for the bucket).
_ROUTES_RECORDED: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _first_route(A, op: str, ncols: Optional[int], rec) -> bool:
    from repro_torch.tuning import cache as _cache
    from repro_torch.tuning.kernel_tune import rhs_bucket
    try:
        seen = _ROUTES_RECORDED.setdefault(A, {})
    except TypeError:  # not weak-referenceable: record every decision
        return True
    key, stamp = (op, rhs_bucket(ncols)), (_cache.FLUSHES, rec)
    if seen.get(key) == stamp:
        return False
    seen[key] = stamp
    return True


def _route_kernel_dict(rec) -> dict:
    return {"fmt": rec.fmt, "op": rec.op, "cfg": dict(rec.cfg),
            "kernel_us": float(rec.kernel_us), "ref_us": float(rec.ref_us),
            "speedup": float(rec.speedup)}


def _route_bucket(A, op: str, ncols: Optional[int]) -> str:
    """The store key ``kernel_route`` consulted (ledger context only)."""
    from repro_torch.tuning import kernel_tune
    try:
        return kernel_tune.kernel_key(A.format, A.shape[0], A.shape[1],
                                      max(1, int(getattr(A, "nnz", 1))), op=op,
                                      ncols=ncols, device=A.device)
    except (AttributeError, TypeError, ValueError):
        return "?"


def _route(A, backend: Optional[str], cfg: Optional[dict], t: torch.Tensor, op: str,
           ncols: Optional[int]):
    """The (backend, cfg) one call runs with."""
    if backend == "auto":
        backend, tuned = kernel_route(A, op=op, ncols=ncols)
        cfg = tuned if cfg is None else cfg
    else:
        backend = resolve_backend(backend, t)
    _cuda_only(backend, t)
    return backend, cfg


def spmv(A, x, backend: Optional[str] = None, cfg: Optional[dict] = None):
    """y = A @ x.

    ``backend`` as in the module docstring. COO and Dense have no kernel in
    the JAX package either and use the reference. ``cfg`` overrides the
    kernel's launch knobs (``repro_torch.kernels.ops.resolve_config``).
    """
    if isinstance(A, _DYN_TYPES):
        return A.spmv(x, backend=backend, cfg=cfg)
    backend, cfg = _route(A, backend, cfg, x, "spmv", None)
    if backend == "cuda":
        from repro_torch.kernels import ops as kops  # lazy: keep core import-light
        fn = kops.SPMV_CUDA.get(type(A))
        if fn is not None:
            return fn(A, x, cfg=cfg)
    return _SPMV[type(A)](A, x)


# ---------------------------------------------------------------------------
# SpMM: Y = A @ B (B dense (N, K)) and Y = X @ A^T (X dense (T, N))
# ---------------------------------------------------------------------------

# Elements of the per-entry product a reference SpMM builds at once. COO and
# CSR build an (nnz, K) product: 17.2 GB in f32 for a 16.7M-entry weight at
# K = 256. Above this budget the rhs is walked in column chunks; each output
# element's sum is the same, since a column of Y depends on that column of B
# alone.
REF_CHUNK_ELEMS = 1 << 27


def by_columns(fn, B: torch.Tensor, per_col: int) -> torch.Tensor:
    """``fn(B)`` for a column-separable ``fn``, over column chunks of ``B``
    (N, K) whose per-entry product holds at most ``REF_CHUNK_ELEMS``
    elements when one column costs ``per_col``."""
    k = B.shape[1]
    step = max(1, REF_CHUNK_ELEMS // max(1, per_col))
    if k <= step:
        return fn(B)
    return torch.cat([fn(B[:, j:j + step]) for j in range(0, k, step)], dim=1)


def _spmm_coo(A: COO, B):
    def part(Bc):
        contrib = A.data[:, None] * take_clip(Bc, A.col)
        return segment_sum(contrib, A.row, A.shape[0])
    return by_columns(part, B, A.capacity)


def _spmm_csr(A: CSR, B):
    rows = csr_row_ids(A.indptr, A.capacity, A.shape[0])

    def part(Bc):
        contrib = A.data[:, None] * take_clip(Bc, A.indices)
        return segment_sum(contrib, rows, A.shape[0])
    return by_columns(part, B, A.capacity)


def _spmm_dia(A: DIA, B):
    m, n = A.shape
    i = torch.arange(m, dtype=torch.int32, device=B.device)[None, :]
    cols = i + A.offsets.to(torch.int32)[:, None]
    valid = ((cols >= 0) & (cols < n))[..., None]

    def part(Bc):
        bv = take_clip(Bc, cols.clamp(0, n - 1))  # (nd, M, Kc)
        prod = A.data[..., None] * bv
        return torch.where(valid, prod, torch.zeros((), dtype=prod.dtype,
                                                    device=prod.device)).sum(dim=0)
    return by_columns(part, B, A.ndiag * m)


def _spmm_ell(A: ELL, B):
    def part(Bc):
        bv = take_clip(Bc, A.cols)  # (M, K, Kc)
        return (A.data[..., None] * bv).sum(dim=1)
    return by_columns(part, B, A.cols.numel())


def _spmm_bsr(A: BSR, B):
    bs = A.block_size
    m, n = A.shape
    brow = _bsr_block_rows(A)

    def part(Bc):
        kb = Bc.shape[1]
        Bb = Bc.reshape(n // bs, bs, kb)
        gathered = take_clip(Bb, A.indices)  # (nblk, bs, Kc)
        prod = torch.einsum("nij,njk->nik", A.data, gathered)
        return segment_sum(prod, brow, m // bs).reshape(m, kb)
    return by_columns(part, B, A.data.numel())


def _spmm_dense(A: Dense, B):
    return A.data @ B


def _spmm_hyb(A: HYB, B):
    return _spmm_ell(A.ell, B) + _spmm_coo(A.coo, B)


def _spmm_sell(A: SELL, B):
    m = A.shape[0]
    c = A.c
    t = A.capacity // c
    planes = _sell_plane_ids(A)

    def part(Bc):
        kb = Bc.shape[1]
        bv = take_clip(Bc, A.cols.reshape(t, c))  # (t, c, Kc)
        contrib = A.data.reshape(t, c)[..., None] * bv
        y_sorted = segment_sum(contrib, planes, A.nslices).reshape(A.nslices * c, kb)
        # ghost lanes carry perm == m: masked out of the scatter
        return segment_sum(y_sorted, A.perm, m)
    return by_columns(part, B, A.capacity)


_SPMM = {COO: _spmm_coo, CSR: _spmm_csr, DIA: _spmm_dia, ELL: _spmm_ell,
         BSR: _spmm_bsr, Dense: _spmm_dense, HYB: _spmm_hyb,
         SELL: _spmm_sell}


def _cuda_only(backend: str, t: torch.Tensor) -> None:
    if backend == "cuda" and not t.is_cuda:
        raise ValueError("backend='cuda' needs CUDA tensors; use backend='ref' on the CPU")


def spmm(A, B, backend: Optional[str] = None, cfg: Optional[dict] = None):
    """Y = A @ B with dense B of shape (N, K); returns (M, K).

    ``backend``/``cfg`` as in :func:`spmv`; ``"auto"`` reads the
    ``op="spmm"`` records of the width bucket of K. On the card CSR, ELL,
    SELL, HYB and BSR run their kernels; COO, DIA and Dense use the
    reference, as the JAX package has no kernel for them either.
    """
    if isinstance(A, _DYN_TYPES):
        return A.spmm(B, backend=backend, cfg=cfg)
    backend, cfg = _route(A, backend, cfg, B, "spmm", B.shape[1])
    if backend == "cuda":
        from repro_torch.kernels import ops as kops
        fn = kops.SPMM_CUDA.get(type(A))
        if fn is not None:
            return fn(A, B, cfg=cfg)
    return _SPMM[type(A)](A, B)


def spmm_t(A, X, backend: Optional[str] = None, cfg: Optional[dict] = None):
    """Y = X @ A^T for activations X of shape (T, N); returns (T, M).

    The serving orientation (``LinearSparse`` stores its weight as
    (d_out, d_in) and keeps activations row-major). ``backend``/``cfg`` as
    in :func:`spmv`; ``"auto"`` reads the ``op="spmm_t"`` records of the
    width bucket of T. On the card CSR, ELL, SELL, HYB and BSR run their
    kernels; COO, DIA and Dense use the reference. The reference is the
    double transpose ``_SPMM[type(A)](A, X.T).T``, as in the JAX package.
    """
    if isinstance(A, _DYN_TYPES):
        return A.spmm_t(X, backend=backend, cfg=cfg)
    backend, cfg = _route(A, backend, cfg, X, "spmm_t", X.shape[0])
    if backend == "cuda":
        from repro_torch.kernels import ops as kops
        fn = kops.SPMM_T_CUDA.get(type(A))
        if fn is not None:
            return fn(A, X, cfg=cfg)
    return _SPMM[type(A)](A, X.T).T


# ---------------------------------------------------------------------------
# Diagonal extract / update (HPCG's TestCG mutates the diagonal)
# ---------------------------------------------------------------------------


def extract_diagonal(A):
    m, n = A.shape
    d = min(m, n)
    if isinstance(A, HYB):
        return extract_diagonal(A.ell) + extract_diagonal(A.coo)
    if isinstance(A, COO):
        on = (A.row == A.col) & (A.row < d)
        vals = torch.where(on, A.data, torch.zeros((), dtype=A.dtype, device=A.device))
        return segment_sum(vals, A.row.clamp(0, d - 1), d)
    if isinstance(A, CSR):
        from repro_torch.core.convert import csr_to_coo
        return extract_diagonal(csr_to_coo(A))
    if isinstance(A, DIA):
        is0 = A.offsets == 0
        slot = torch.argmax(is0.to(torch.int32)).reshape(1)
        return torch.where(is0.any(), A.data.index_select(0, slot)[0, :d],
                           torch.zeros((), dtype=A.dtype, device=A.device))
    if isinstance(A, ELL):
        i = torch.arange(m, dtype=torch.int32, device=A.device)[:, None]
        on = A.cols == i
        zero = torch.zeros((), dtype=A.dtype, device=A.device)
        return torch.where(on, A.data, zero).sum(dim=1)[:d]
    if isinstance(A, BSR):
        from repro_torch.core.convert import bsr_to_coo
        return extract_diagonal(bsr_to_coo(A))
    if isinstance(A, SELL):
        from repro_torch.core.convert import sell_to_coo
        return extract_diagonal(sell_to_coo(A))
    if isinstance(A, Dense):
        return torch.diagonal(A.data)[:d]
    raise TypeError(type(A))


def update_diagonal(A, new_diag: torch.Tensor):
    """Replace the main diagonal values (pattern must already contain it)."""
    nd = new_diag.shape[0]
    if isinstance(A, COO):
        on = A.row == A.col
        vals = take_clip(new_diag, A.row.clamp(0, nd - 1)).to(A.dtype)
        return COO(A.row, A.col, torch.where(on, vals, A.data), A.shape, A.nnz)
    if isinstance(A, CSR):
        rows = csr_row_ids(A.indptr, A.capacity, A.shape[0])
        on = A.indices == rows
        return CSR(A.indptr, A.indices,
                   torch.where(on, take_clip(new_diag, rows).to(A.dtype), A.data),
                   A.shape, A.nnz)
    if isinstance(A, DIA):
        slot = torch.argmax((A.offsets == 0).to(torch.int32))
        row = torch.zeros((A.data.shape[1],), dtype=A.dtype, device=A.device)
        row[:nd] = new_diag.to(A.dtype)
        data = A.data.clone()
        data.index_copy_(0, slot.reshape(1), row[None])
        return DIA(A.offsets, data, A.shape, A.nnz)
    if isinstance(A, ELL):
        i = torch.arange(A.shape[0], dtype=torch.int32, device=A.device)[:, None]
        on = A.cols == i
        vals = take_clip(new_diag, i[:, 0].clamp(0, nd - 1))[:, None].to(A.dtype)
        return ELL(A.cols, torch.where(on, vals, A.data), A.shape, A.nnz)
    if isinstance(A, SELL):
        p = sell_sorted_ids(A.slice_ptrs, A.c, A.capacity, A.nslices)
        rows = take_clip(A.perm, p)
        on = A.cols == rows  # padding col=-1 never matches a row id
        vals = take_clip(new_diag, rows.clamp(0, nd - 1)).to(A.dtype)
        return SELL(A.cols, torch.where(on, vals, A.data), A.perm,
                    A.slice_ptrs, A.shape, A.nnz, A.c, A.sigma)
    if isinstance(A, Dense):
        d = min(A.shape)
        data = A.data.clone()
        data.diagonal()[:d] = new_diag[:d].to(A.dtype)
        return Dense(data, A.shape, A.nnz)
    raise TypeError(type(A))


# ---------------------------------------------------------------------------
# Dense-vector algorithms (paper §III-D: dot, WAXPBY, reduction, assign)
# ---------------------------------------------------------------------------


def dot(x, y):
    return torch.dot(x, y)


def waxpby(alpha, x, beta, y):
    """w = alpha*x + beta*y (HPCG's vector update)."""
    return alpha * x + beta * y


def axpy(alpha, x, y):
    return alpha * x + y


def norm2(x):
    return torch.sqrt(torch.dot(x, x))


# populated by repro_torch.core.dynamic to avoid a circular import
_DYN_TYPES: tuple = ()


def _register_dynamic(*types):
    global _DYN_TYPES
    _DYN_TYPES = tuple(set(_DYN_TYPES) | set(types))
