"""LinearSparse: a linear layer whose weight is a dynamic sparse matrix
(port of ``repro.models.linear_sparse``).

The paper's technique applied to pruned *weights*: a pruned model's linears
are served from a run-time selectable sparse container. Decode (one token,
T = 1) is memory-bound, so storing only the surviving weights turns sparsity
into read-bandwidth savings; prefill (T = 256) runs the same product over a
batch of tokens. The best container is a per-matrix, per-width run-time
decision made by the same tuner that drives SpMV format selection.

    w_sparse = prune_magnitude(w, density=0.25)            # host, once
    layer    = LinearSparse.from_dense(w_sparse)           # tuned pick
    y        = layer(x)                                    # spmm_t path

The weight is stored transposed, (d_out, d_in), and ``forward`` computes
``spmm_t(W^T, x)`` = x @ W with activations row-major on both sides. On the
card the CSR, ELL, SELL and HYB weights run the hand-written SpMM_T kernels;
COO runs the reference, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch.core.convert import convert_execute
from repro_torch.core.dynamic import DynamicMatrix
from repro_torch.core.formats import Format, coo_from_dense_np, from_numpy
from repro_torch.core.ops import spmm_t
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs import metrics as _metrics
from repro_torch.tuning.policy import FormatPolicy

# Weight matrices are ragged after pruning; DIA is never competitive there,
# while HYB handles the long-tail rows a magnitude prune leaves behind.
WEIGHT_CANDIDATES = (Format.CSR, Format.ELL, Format.HYB, Format.SELL, Format.COO)


def prune_magnitude(w: np.ndarray, density: float) -> np.ndarray:
    """Global magnitude pruning: keep the largest |w| entries (numpy, the
    same arithmetic as the JAX package, so the result is bit-identical)."""
    w = np.asarray(w)
    k = max(1, int(density * w.size))
    thresh = np.partition(np.abs(w).ravel(), -k)[-k]
    return np.where(np.abs(w) >= thresh, w, 0.0).astype(w.dtype)


def _policy(tune) -> FormatPolicy:
    return (tune if isinstance(tune, FormatPolicy)
            else FormatPolicy(tune, candidates=WEIGHT_CANDIDATES, profile_iters=3))


def _bias(bias, device: torch.device) -> Optional[torch.Tensor]:
    if bias is None:
        return None
    if isinstance(bias, torch.Tensor):
        return bias.to(device)
    return torch.from_numpy(np.array(bias, order="C")).to(device)


class LinearSparse(nn.Module):
    """y = x @ W with W stored as a DynamicMatrix (any supported format),
    transposed to (d_out, d_in). The bias is a buffer; serving needs no
    gradient.

    ``backend`` is the SpMM_T backend of every call: ``None`` (default) runs
    the kernel on the card and the reference on the CPU, ``"ref"`` the
    reference anywhere, ``"auto"`` the kernel where a ``kernel_tune`` record
    for the call's width bucket beat the reference (else the reference,
    counted). The JAX layer defaults to ``"auto"``; untuned, that runs the
    reference, so the port keeps the kernel as its default.
    """

    def __init__(self, weight: DynamicMatrix, bias: Optional[torch.Tensor] = None,
                 backend: Optional[str] = None):
        super().__init__()
        self.weight = weight if isinstance(weight, DynamicMatrix) else DynamicMatrix(weight)
        self.register_buffer("bias", bias)
        self.backend = backend

    @classmethod
    def from_dense(cls, w, fmt: Optional[Format] = None, bias=None, tune="analytic",
                   backend: Optional[str] = None, ncols: Optional[int] = None,
                   device: DeviceLike = None, **conv_kwargs) -> "LinearSparse":
        """Build from a (pruned) dense weight (d_in, d_out), on ``device``
        (None: the card). ``fmt=None`` picks the format with a
        :class:`FormatPolicy` over ``WEIGHT_CANDIDATES``: ``tune`` is a mode
        string ("ml" | "analytic" | "profile" | "cached") or a policy.
        ``ncols`` (the expected batch width) makes the pick width-aware:
        profile mode times the transposed-rhs SpMM at that width, cached
        mode keys its decision by the width bucket, so decode (1) and
        prefill (256) builds may pick different formats. A SELL weight takes
        the slice geometry of a tuned record at that width, where the
        policy's cache holds one (``FormatPolicy.plan_for``)."""
        dev = resolve_device(device)
        coo = coo_from_dense_np(np.asarray(w).T, device=dev)
        plan = _policy(tune).plan_for(coo, fmt=fmt, op="spmm_t", ncols=ncols, **conv_kwargs)
        return cls(DynamicMatrix(convert_execute(coo, plan)), _bias(bias, dev), backend=backend)

    @classmethod
    def from_numpy(cls, fields: dict, fmt, shape, nnz: int, bias=None,
                   backend: Optional[str] = None, device: DeviceLike = None,
                   **static) -> "LinearSparse":
        """The layer over a weight container given as numpy arrays: the
        fields of a JAX layer's ``weight.concrete`` (nested for HYB), its
        stored (d_out, d_in) ``shape``, ``nnz`` and static metadata (``c``
        and ``sigma`` for SELL, ``block_size`` for BSR). The container is
        bit-identical to the one the arrays came from."""
        dev = resolve_device(device)
        A = from_numpy(fmt, fields, shape, nnz, device=dev, **static)
        return cls(DynamicMatrix(A), _bias(bias, dev), backend=backend)

    @property
    def format(self) -> Format:
        return self.weight.active

    def activate(self, fmt: Format, **kw) -> "LinearSparse":
        """Run-time format switch (the paper's ``activate()``)."""
        return LinearSparse(self.weight.activate(fmt, **kw), self.bias, backend=self.backend)

    def retune(self, ncols: int, tune="profile", **conv_kwargs) -> "LinearSparse":
        """Re-select the weight's format for a new batch width and switch to
        it: the serving loop's hook between decode and prefill. Counts
        ``serve.retune``, and ``serve.format_switch`` when the format
        changes."""
        fmt = _policy(tune).select(self.weight, op="spmm_t", ncols=ncols).best
        _metrics.inc("serve.retune")
        if fmt == self.format:
            return self
        _metrics.inc("serve.format_switch")
        return self.activate(fmt, **conv_kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., d_in) -> (..., d_out) through the transposed-rhs SpMM."""
        shape = x.shape
        xf = x.reshape(-1, shape[-1]).contiguous()  # (T, d_in)
        y = spmm_t(self.weight, xf, backend=self.backend)
        if self.bias is not None:
            y = y + self.bias
        return y.reshape(shape[:-1] + (y.shape[-1],))

    def extra_repr(self) -> str:
        return f"{self.format.name}, shape={self.weight.shape}, nnz={self.weight.nnz}"
