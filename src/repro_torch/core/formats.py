"""Sparse-matrix storage-format containers (the paper's "concrete formats").

Port of ``repro.core.formats``: each container is a frozen dataclass of
torch tensors with the JAX field names, plus *static* metadata (``shape``,
``nnz``, ``block_size``, ``c``, ``sigma``) held as plain Python values.
``Format`` keeps the JAX integer values, so plans and trees written by the
JAX package name the same formats here.

Padding convention (unchanged): containers are capacity-padded; padding
entries are (row=0, col=0, val=0) and contribute nothing under SpMV
accumulate semantics. Index arrays are int32, as in the JAX package.

:func:`from_numpy` / :func:`to_numpy` carry a container across from the JAX
package (``np.asarray`` of each field) and back.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


class Format(enum.IntEnum):
    """Enum of supported storage formats (paper's `formats_e`)."""

    COO = 0
    CSR = 1
    DIA = 2
    ELL = 3
    BSR = 4
    DENSE = 5
    HYB = 6
    SELL = 7


def static_field():
    return dataclasses.field(metadata={"static": True})


class _Container:
    """Shared accessors of the tensor containers."""

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    def tensors(self) -> Dict[str, torch.Tensor]:
        """The tensor fields, by name (static metadata excluded)."""
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                if not f.metadata.get("static")}


@dataclasses.dataclass(frozen=True, eq=False)
class COO(_Container):
    """Coordinate format: explicit (row, col, val) triplets, no ordering."""

    row: torch.Tensor  # (capacity,) int32
    col: torch.Tensor  # (capacity,) int32
    data: torch.Tensor  # (capacity,) values
    shape: Tuple[int, int] = static_field()
    nnz: int = static_field()  # logical nnz (<= capacity)

    format = Format.COO

    @property
    def capacity(self) -> int:
        return int(self.data.shape[0])


@dataclasses.dataclass(frozen=True, eq=False)
class CSR(_Container):
    """Compressed sparse row: row-pointer array + (col, val) pairs; padding
    lives past ``indptr[-1]`` with val=0/col=0."""

    indptr: torch.Tensor  # (M+1,) int32
    indices: torch.Tensor  # (capacity,) int32 column indices
    data: torch.Tensor  # (capacity,) values
    shape: Tuple[int, int] = static_field()
    nnz: int = static_field()

    format = Format.CSR

    @property
    def capacity(self) -> int:
        return int(self.data.shape[0])


@dataclasses.dataclass(frozen=True, eq=False)
class DIA(_Container):
    """Diagonal format: ``data[d, i]`` holds A[i, i + offsets[d]] (cusp
    convention, zero where the diagonal leaves the matrix). Rectangular
    matrices are supported: offsets range over [-(M-1), N-1]."""

    offsets: torch.Tensor  # (ndiag,) int32 diagonal offsets (k = col - row)
    data: torch.Tensor  # (ndiag, M) values
    shape: Tuple[int, int] = static_field()
    nnz: int = static_field()

    format = Format.DIA

    @property
    def ndiag(self) -> int:
        return int(self.data.shape[0])


@dataclasses.dataclass(frozen=True, eq=False)
class ELL(_Container):
    """ELLPACK: every row padded to K entries; column-index + value planes
    (padding col=-1, val=0)."""

    cols: torch.Tensor  # (M, K) int32
    data: torch.Tensor  # (M, K) values
    shape: Tuple[int, int] = static_field()
    nnz: int = static_field()

    format = Format.ELL

    @property
    def k(self) -> int:
        return int(self.data.shape[1])


@dataclasses.dataclass(frozen=True, eq=False)
class BSR(_Container):
    """Block CSR: (bs x bs) dense blocks addressed CSR-style by block row."""

    indptr: torch.Tensor  # (Mb+1,) int32 block-row pointers
    indices: torch.Tensor  # (blk_capacity,) int32 block-column indices
    data: torch.Tensor  # (blk_capacity, bs, bs) values
    shape: Tuple[int, int] = static_field()  # element shape (multiple of bs)
    nnz: int = static_field()  # logical element nnz
    block_size: int = static_field()

    format = Format.BSR

    @property
    def nblocks(self) -> int:
        return int(self.data.shape[0])


@dataclasses.dataclass(frozen=True, eq=False)
class Dense(_Container):
    """Dense matrix container (paper's DenseMatrix)."""

    data: torch.Tensor  # (M, N)
    shape: Tuple[int, int] = static_field()
    nnz: int = static_field()

    format = Format.DENSE


@dataclasses.dataclass(frozen=True, eq=False)
class HYB(_Container):
    """Hybrid ELL + COO: the regular part of each row (up to k entries) in
    the ELL planes, the overflow in COO."""

    ell: ELL
    coo: COO
    shape: Tuple[int, int] = static_field()
    nnz: int = static_field()

    format = Format.HYB

    @property
    def dtype(self) -> torch.dtype:
        return self.ell.data.dtype

    @property
    def device(self) -> torch.device:
        return self.ell.data.device

    @property
    def k(self) -> int:
        return self.ell.k


@dataclasses.dataclass(frozen=True, eq=False)
class SELL(_Container):
    """SELL-C-sigma: sliced ELLPACK with sigma-window row sorting.

    Flat, column-major within a slice: lane ``r`` of plane ``j`` of slice
    ``s`` lives at ``slice_ptrs[s] + j*C + r``. ``perm[p]`` is the original
    row at sorted position ``p``; ghost lanes past M carry row index M and
    are dropped by the scatter; padding entries carry col=-1/val=0.
    """

    cols: torch.Tensor  # (capacity,) int32, column-major within each slice
    data: torch.Tensor  # (capacity,) values
    perm: torch.Tensor  # (nslices*C,) int32 original row at sorted position
    slice_ptrs: torch.Tensor  # (nslices+1,) int32 flat offset of each slice
    shape: Tuple[int, int] = static_field()
    nnz: int = static_field()
    c: int = static_field()  # slice height C
    sigma: int = static_field()  # sort-window height (multiple of C)

    format = Format.SELL

    @property
    def nslices(self) -> int:
        return int(self.slice_ptrs.shape[-1]) - 1

    @property
    def capacity(self) -> int:
        return int(self.data.shape[-1])


FORMAT_TO_CLS = {
    Format.COO: COO,
    Format.CSR: CSR,
    Format.DIA: DIA,
    Format.ELL: ELL,
    Format.BSR: BSR,
    Format.DENSE: Dense,
    Format.HYB: HYB,
    Format.SELL: SELL,
}


# ---------------------------------------------------------------------------
# numpy <-> torch (the JAX package's containers cross over as numpy arrays)
# ---------------------------------------------------------------------------

def _tensor(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """numpy -> torch on ``device``, bit-exact. numpy has no bfloat16: a
    JAX bf16 array arrives with the ``ml_dtypes`` bfloat16 dtype, whose
    bits are reinterpreted as torch.bfloat16."""
    arr = np.array(arr, order="C")  # a writable copy: JAX's arrays are read-only
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _values(val: np.ndarray, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Host values -> a ``dtype`` tensor. bf16 rounds through float32
    (numpy has no bf16), which matches a direct rounding for every value
    that float32 holds exactly."""
    val = np.asarray(val)
    if dtype == torch.bfloat16:
        return torch.from_numpy(val.astype(np.float32)).to(device=device, dtype=dtype)
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    return torch.from_numpy(val.astype(np_dtype)).to(device)


def _numpy(t: torch.Tensor) -> np.ndarray:
    """torch -> numpy on the host; bf16 is widened (exactly) to float32."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def from_numpy(fmt, fields: dict, shape, nnz: int, *,
               device: DeviceLike = None, **static):
    """Build the port's container of format ``fmt`` from numpy arrays.

    ``fields`` maps each tensor field name (as in the JAX container) to an
    array, e.g. ``{"offsets": ..., "data": ...}`` for DIA. For HYB it holds
    ``{"ell": {...}, "coo": {...}}``; the ELL part keeps the matrix ``nnz``
    and the COO overflow's ``nnz`` is its capacity, as the JAX conversion
    builds them. ``static`` carries the remaining metadata (``block_size``
    for BSR, ``c`` and ``sigma`` for SELL).
    """
    fmt = Format[fmt] if isinstance(fmt, str) else Format(fmt)
    dev = resolve_device(device)
    shape = tuple(int(s) for s in shape)
    if fmt == Format.HYB:
        ell = from_numpy(Format.ELL, fields["ell"], shape, nnz, device=dev)
        cdat = fields["coo"]["data"]
        coo = from_numpy(Format.COO, fields["coo"], shape, int(np.shape(cdat)[0]),
                         device=dev)
        return HYB(ell, coo, shape, int(nnz))
    cls = FORMAT_TO_CLS[fmt]
    kw = {name: _tensor(arr, dev) for name, arr in fields.items()}
    return cls(**kw, shape=shape, nnz=int(nnz), **static)


def to_numpy(A) -> dict:
    """The tensor fields of ``A`` as host numpy arrays (nested for HYB)."""
    if isinstance(A, HYB):
        return {"ell": to_numpy(A.ell), "coo": to_numpy(A.coo)}
    return {name: _numpy(t) for name, t in A.tensors().items()}


# ---------------------------------------------------------------------------
# Host-side builders (setup phase)
# ---------------------------------------------------------------------------

def coo_from_arrays(row, col, val, shape, capacity: Optional[int] = None,
                    dtype: torch.dtype = torch.float32,
                    device: DeviceLike = None) -> COO:
    """Build a COO container from host triplets, padding to ``capacity``."""
    dev = resolve_device(device)
    row = np.asarray(row, dtype=np.int32)
    col = np.asarray(col, dtype=np.int32)
    nnz = int(row.shape[0])
    cap = int(capacity) if capacity is not None else nnz
    if cap < nnz:
        raise ValueError(f"capacity {cap} < nnz {nnz}")
    r = np.zeros((cap,), np.int32)
    c = np.zeros((cap,), np.int32)
    r[:nnz], c[:nnz] = row, col
    v = torch.zeros((cap,), dtype=dtype, device=dev)
    v[:nnz] = _values(val, dtype, dev)
    return COO(torch.from_numpy(r).to(dev), torch.from_numpy(c).to(dev), v,
               tuple(int(s) for s in shape), nnz)


def dense_from_array(a, dtype: Optional[torch.dtype] = None,
                     device: DeviceLike = None) -> Dense:
    a = torch.as_tensor(np.asarray(a), device=resolve_device(device))
    if dtype is not None:
        a = a.to(dtype)
    return Dense(a, tuple(a.shape), int(a.shape[0] * a.shape[1]))


def coo_from_dense_np(a: np.ndarray, capacity: Optional[int] = None,
                      dtype: Optional[torch.dtype] = None,
                      device: DeviceLike = None) -> COO:
    """Host helper: extract non-zeros of a dense numpy matrix into COO."""
    a = np.asarray(a)
    row, col = np.nonzero(a)
    order = np.lexsort((col, row))
    row, col = row[order], col[order]
    val = a[row, col]
    if dtype is None:
        dtype = torch.from_numpy(np.zeros(0, a.dtype)).dtype
    return coo_from_arrays(row, col, val, a.shape, capacity, dtype, device)


def random_coo(seed_or_generator, shape, density: float = 0.05,
               capacity: Optional[int] = None, dtype: torch.dtype = torch.float32,
               device: DeviceLike = None) -> COO:
    """Random sparse matrix for tests and benchmarks, made on the host.

    ``seed_or_generator`` is an int seed, a ``numpy.random.Generator`` or a
    ``torch.Generator`` (one int seed is drawn from it). An int seed gives
    the JAX package's ``random_coo(int)`` entry for entry; JAX's PRNG keys
    (threefry) have no counterpart here."""
    src = seed_or_generator
    if isinstance(src, torch.Generator):
        src = int(torch.randint(0, 2 ** 31 - 1, (), generator=src))
    rng = src if isinstance(src, np.random.Generator) else np.random.default_rng(int(src))
    m, n = shape
    nnz = max(1, int(density * m * n))
    lin = rng.choice(m * n, size=nnz, replace=False)
    lin.sort()
    row, col = lin // n, lin % n
    val = rng.standard_normal(nnz).astype(np.float32)
    # no exact zeros, so nnz is meaningful
    val = np.where(np.abs(val) < 1e-3, 1e-3, val)
    return coo_from_arrays(row, col, val, shape, capacity, dtype, device)


def banded_coo(shape, offsets, fill=None, dtype: torch.dtype = torch.float32,
               capacity: Optional[int] = None, device: DeviceLike = None) -> COO:
    """Banded (multi-diagonal) matrix — the stencil-like regular pattern."""
    m, n = shape
    rows, cols, vals = [], [], []
    for d_i, off in enumerate(offsets):
        r = np.arange(max(0, -off), min(m, n - off), dtype=np.int64)
        rows.append(r)
        cols.append(r + off)
        v = float(len(offsets) - d_i) if fill is None else fill[d_i]
        vals.append(np.full(r.shape, v, np.float64))
    row = np.concatenate(rows)
    col = np.concatenate(cols)
    val = np.concatenate(vals)
    order = np.lexsort((col, row))
    return coo_from_arrays(row[order], col[order], val[order], shape, capacity,
                           dtype, device)


def to_dense_np(A) -> np.ndarray:
    """Host-side densification (oracle for tests)."""
    if isinstance(A, HYB):
        return to_dense_np(A.ell) + to_dense_np(A.coo)
    m, n = A.shape
    f = to_numpy(A)
    out = np.zeros((m, n), dtype=f["data"].dtype)
    if isinstance(A, COO):
        np.add.at(out, (f["row"], f["col"]), f["data"])
    elif isinstance(A, CSR):
        indptr, idx, v = f["indptr"], f["indices"], f["data"]
        for i in range(m):
            sl = slice(indptr[i], indptr[i + 1])
            np.add.at(out, (np.full(indptr[i + 1] - indptr[i], i), idx[sl]), v[sl])
    elif isinstance(A, DIA):
        offs, d = f["offsets"], f["data"]
        for k in range(d.shape[0]):
            off = int(offs[k])
            i = np.arange(max(0, -off), min(m, n - off))
            out[i, i + off] += d[k, i]
    elif isinstance(A, ELL):
        cols, v = f["cols"], f["data"]
        for i in range(m):
            np.add.at(out[i], cols[i], v[i])
    elif isinstance(A, BSR):
        bs = A.block_size
        indptr, idx, v = f["indptr"], f["indices"], f["data"]
        for bi in range(len(indptr) - 1):
            for p in range(indptr[bi], indptr[bi + 1]):
                bj = idx[p]
                out[bi * bs:(bi + 1) * bs, bj * bs:(bj + 1) * bs] += v[p]
    elif isinstance(A, SELL):
        cols, v, perm, ptrs = f["cols"], f["data"], f["perm"], f["slice_ptrs"]
        C = A.c
        for s in range(ptrs.shape[0] - 1):
            w = (int(ptrs[s + 1]) - int(ptrs[s])) // C
            for r in range(C):
                i = int(perm[s * C + r])
                if i >= m:
                    continue  # ghost lane past the last row
                sl = int(ptrs[s]) + r + C * np.arange(w)
                np.add.at(out[i], np.clip(cols[sl], 0, n - 1), v[sl])
    elif isinstance(A, Dense):
        out = f["data"].copy()
    else:
        raise TypeError(type(A))
    return out
