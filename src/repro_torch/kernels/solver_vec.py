"""CG's vector algebra: wrappers of the hand-written CUDA kernels
``csrc/solver_vec.cu``.

Replaces no Pallas kernel: the JAX package's CG loop is one
``lax.while_loop`` whose dots, axpys and waxpby XLA fuses around the SpMV
(``repro/core/solvers.py:96``). :mod:`repro_torch.core.solvers` runs the
loop in blocks of masked iterations captured into a CUDA graph, and these
are its vector kernels:

* :func:`dot` (a): block partials of ``x . y``, reduced in a fixed order by
  whoever reads them (:func:`update`, :func:`direction`, :func:`finish`):
  no atomics, bitwise reruns;
* :func:`update` (b): ``alpha = rho / max(p . Ap, 1e-30)`` from the device
  scalars, ``x += alpha p``, ``r -= alpha Ap``, the partials of ``r . r``;
* :func:`direction` (c): ``p = z + beta p``, ``beta = rho_new / max(rho,
  1e-30)`` (CG: ``z = r``);
* :func:`finish`: the iteration's scalars, ``history[k + 1]``, ``k`` and the
  next iteration's flag.

The loop state they share: ``sc`` (the accumulation dtype, :func:`acc_dtype`)
holds ``[rr, rho, tol2]`` (``rr = r . r``, the convergence test's quantity;
``rho`` is ``rr`` in CG and ``r . z`` in PCG); ``st`` (int64) holds ``[k,
active]``. Every kernel writes nothing when ``st[1]`` is 0, so an inactive
iteration leaves the state bit for bit as it was.

On a CUDA tensor each wrapper launches its kernel (or raises); on a CPU
tensor it runs the plain version beside it, today's ``ops.dot`` /
``ops.axpy`` / ``ops.waxpby`` sequence under the same mask, whose
"partials" are one value: the dot itself. ``launches[name]`` counts kernel
launches and nothing else; a launch recorded into a CUDA graph counts where
the graph is replayed (:mod:`repro_torch.core.solvers` takes the capture's
counts back out and adds them at each replay).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core import ops as _ops
from repro_torch.kernels import _build

NAME = "solver_vec"
DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float64: "f64"}
BLOCK = 256  # threads a block (csrc/solver_vec.cu kBlock)
MAX_PARTS = 1024  # blocks, and partial sums, of a pass
FLOOR = 1e-30  # alpha's and beta's denominators are clamped to it, as in the JAX solvers

launches = {"dot": 0, "update": 0, "direction": 0, "finish": 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ARGTYPES = {
    "dot": [_P, _P, _L, _P, _I, _I, _I, _P],
    "update": [_P, _P, _P, _P, _L, _P, _I, _P, _P, _P, _I, _I, _P],
    "direction": [_P, _P, _L, _P, _I, _P, _P, _I, _I, _P],
    "finish": [_P, _P, _I, _P, _P, _P, _L, _I, _I, _P],
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def launch_counts() -> dict:
    """``"solver_vec.<kernel>"`` -> launches since the last reset."""
    return {f"{NAME}.{k}": v for k, v in launches.items()}


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype of the sums and the loop scalars: float64 for float64
    vectors, float32 otherwise (bfloat16 vectors are summed in float32)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def grid(n: int) -> int:
    """Blocks of a pass over ``n`` entries (a function of ``n`` alone, so
    every dot of one solve has the same number of partials)."""
    return max(1, min(MAX_PARTS, -(-n // (BLOCK * 4))))


@functools.lru_cache(maxsize=None)
def _fn(kernel: str, suffix: str):
    return _build.entry_point(NAME, f"{NAME}_{kernel}_{suffix}", _ARGTYPES[kernel])


def _launch(kernel: str, suffix: str, dev: torch.device, *args) -> None:
    fn, err_str = _fn(kernel, suffix)
    err = fn(*args, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"solver_vec {kernel} launch failed: {err_str(err).decode()} ({err})")
    launches[kernel] += 1


def _on_card(*ts: torch.Tensor) -> bool:
    """True for CUDA tensors (all on one device), False for CPU tensors;
    raises on anything else."""
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError(f"solver_vec: tensors on {sorted({str(t.device) for t in ts})}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"solver_vec runs on cuda or cpu tensors, got {dev}")
    return True


def _check_vectors(*vs: torch.Tensor) -> None:
    n, dtype = vs[0].shape, vs[0].dtype
    for v in vs:
        if v.dim() != 1 or v.shape != n or v.dtype != dtype or not v.is_contiguous():
            raise ValueError(f"solver_vec: vectors must be contiguous 1-D of one length and "
                             f"dtype, got {[(tuple(u.shape), u.dtype) for u in vs]}")
    if dtype not in DTYPES:
        raise ValueError(f"solver_vec: dtype {dtype} (float32, bfloat16 or float64)")


def _check_state(n: int, dtype: torch.dtype, sc: torch.Tensor, st: torch.Tensor,
                 *parts: torch.Tensor) -> None:
    acc = acc_dtype(dtype)
    if sc.dtype != acc or sc.numel() < 3 or not sc.is_contiguous():
        raise ValueError(f"solver_vec: sc must be contiguous {acc} of 3, got {sc.dtype} "
                         f"{tuple(sc.shape)}")
    if st.dtype != torch.int64 or st.numel() < 2 or not st.is_contiguous():
        raise ValueError(f"solver_vec: st must be contiguous int64 of 2, got {st.dtype} "
                         f"{tuple(st.shape)}")
    for p in parts:
        if p.dtype != acc or p.shape != (grid(n),) or not p.is_contiguous():
            raise ValueError(f"solver_vec: partials must be {acc} of ({grid(n)},) (a dot of "
                             f"these vectors), got {p.dtype} {tuple(p.shape)}")


def _vec(*ts: torch.Tensor) -> int:
    """1 when every pointer is 16-byte aligned (the kernels' vector loads)."""
    return int(all(t.data_ptr() % 16 == 0 for t in ts))


# ---------------------------------------------------------------------------
# Plain versions: the ops sequence of the eager loop, under the mask
# ---------------------------------------------------------------------------


def dot_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The partials of ``x . y`` as one value: ``ops.dot(x, y)``."""
    return _ops.dot(x, y).to(acc_dtype(x.dtype)).reshape(1)


def update_plain(x, r, p, ap, pap, sc, st) -> torch.Tensor:
    act = st[1] != 0
    alpha = torch.where(act, sc[1] / torch.clamp(pap.sum(), min=FLOOR),
                        torch.zeros((), dtype=sc.dtype, device=sc.device))
    x_new = _ops.axpy(alpha, p, x)
    r_new = _ops.axpy(-alpha, ap, r)
    x.copy_(torch.where(act, x_new, x))
    r.copy_(torch.where(act, r_new, r))
    return dot_plain(r_new, r_new)


def direction_plain(p, z, rho_parts, sc, st) -> None:
    act = st[1] != 0
    beta = rho_parts.sum() / torch.clamp(sc[1], min=FLOOR)
    p.copy_(torch.where(act, _ops.waxpby(1.0, z, beta, p), p))


def finish_plain(rr_parts, rz_parts, sc, st, hist, maxiter: int, fixed: bool) -> None:
    act = st[1] != 0
    rr = rr_parts.sum()
    rho = rr if rz_parts is None else rz_parts.sum()
    k = st[0] + 1
    nxt = act & (k < maxiter) & ((rr > sc[2]) | fixed)
    at = torch.clamp(k, max=hist.shape[0] - 1).reshape(1)  # in range when inactive at maxiter
    hist.index_copy_(0, at, torch.where(act, torch.sqrt(rr).to(hist.dtype),
                                        hist.index_select(0, at)[0]).reshape(1))
    sc[:2].copy_(torch.where(act, torch.stack([rr, rho]), sc[:2]))
    st[:2].copy_(torch.where(act, torch.stack([k, nxt.to(st.dtype)]), st[:2]))


# ---------------------------------------------------------------------------
# Wrappers: the kernel on a CUDA tensor, the plain version on a CPU tensor
# ---------------------------------------------------------------------------


def dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(a) Partial sums of ``x . y``: ``(grid(n),)`` in :func:`acc_dtype` on
    the card; on the CPU one value, ``ops.dot(x, y)``."""
    if not _on_card(x, y):
        return dot_plain(x, y)
    _check_vectors(x, y)
    n = x.shape[0]
    g = grid(n)
    parts = torch.empty((g,), dtype=acc_dtype(x.dtype), device=x.device)
    _launch("dot", DTYPES[x.dtype], x.device, x.data_ptr(), y.data_ptr(), n, parts.data_ptr(),
            g, _vec(x, y))
    return parts


def update(x, r, p, ap, pap, sc, st) -> torch.Tensor:
    """(b) When ``st[1]``: ``alpha = sc[1] / max(sum(pap), 1e-30)``, ``x +=
    alpha p``, ``r -= alpha Ap`` in place. Returns the partials of the new
    ``r . r`` (not written, and not to be read, when ``st[1]`` is 0)."""
    if not _on_card(x, r, p, ap, pap, sc, st):
        return update_plain(x, r, p, ap, pap, sc, st)
    _check_vectors(x, r, p, ap)
    n = x.shape[0]
    _check_state(n, x.dtype, sc, st, pap)
    rr = torch.empty_like(pap)
    _launch("update", DTYPES[x.dtype], x.device, x.data_ptr(), r.data_ptr(), p.data_ptr(),
            ap.data_ptr(), n, pap.data_ptr(), pap.shape[0], sc.data_ptr(), st.data_ptr(),
            rr.data_ptr(), _vec(x, r, p, ap))
    return rr


def direction(p, z, rho_parts, sc, st) -> None:
    """(c) When ``st[1]``: ``p = z + beta p`` in place, ``beta =
    sum(rho_parts) / max(sc[1], 1e-30)``. Runs before :func:`finish`,
    which overwrites ``sc[1]``."""
    if not _on_card(p, z, rho_parts, sc, st):
        return direction_plain(p, z, rho_parts, sc, st)
    _check_vectors(p, z)
    n = p.shape[0]
    _check_state(n, p.dtype, sc, st, rho_parts)
    _launch("direction", DTYPES[p.dtype], p.device, p.data_ptr(), z.data_ptr(), n,
            rho_parts.data_ptr(), rho_parts.shape[0], sc.data_ptr(), st.data_ptr(), _vec(p, z))


def finish(rr_parts, rz_parts: Optional[torch.Tensor], sc, st, hist, maxiter: int,
           fixed: bool = False) -> None:
    """When ``st[1]``: ``rr = sum(rr_parts)``, ``rho = sum(rz_parts)``
    (``rr`` when None: CG) into ``sc[0]``, ``sc[1]``; ``k = st[0] + 1``,
    ``hist[k] = sqrt(rr)``, ``st[0] = k``, ``st[1] = k < maxiter and (fixed
    or rr > sc[2])``."""
    parts = (rr_parts,) if rz_parts is None else (rr_parts, rz_parts)
    if not _on_card(*parts, sc, st, hist):
        return finish_plain(rr_parts, rz_parts, sc, st, hist, maxiter, fixed)
    if hist.dim() != 1 or hist.shape[0] != maxiter + 1 or hist.dtype not in DTYPES \
            or acc_dtype(hist.dtype) != sc.dtype or not hist.is_contiguous():
        raise ValueError(f"solver_vec.finish: hist must be contiguous ({maxiter + 1},) in the "
                         f"vectors' dtype, got {hist.dtype} {tuple(hist.shape)}")
    if any(q.shape != rr_parts.shape or q.dtype != sc.dtype for q in parts):
        raise ValueError("solver_vec.finish: partials of one dot's shape in sc's dtype")
    _launch("finish", DTYPES[hist.dtype], hist.device, rr_parts.data_ptr(),
            0 if rz_parts is None else rz_parts.data_ptr(), rr_parts.shape[0], sc.data_ptr(),
            st.data_ptr(), hist.data_ptr(), maxiter, int(fixed))
