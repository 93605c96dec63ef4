"""DynamicMatrix — the paper's core abstraction (port of ``repro.core.dynamic``).

1. ``DynamicMatrix`` — the State pattern: one concrete container plus its
   format tag; ``activate()``/``convert()`` switch the underlying data
   structure at run time (a conversion, as in the paper) and algorithms
   dispatch on the container type.

2. ``SwitchDynamicMatrix`` — the Visitor pattern: a union of candidate-format
   payloads plus an active id. JAX lowers the dispatch to ``lax.switch``
   inside one SPMD program; here the id is a host-side int and the dispatch
   a Python index, since PyTorch runs eagerly. A *stacked* union
   (:meth:`SwitchDynamicMatrix.build_batched`, the distributed
   Multi-Format parts) holds stacked variants and one host int per part.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import ops as _ops
from repro_torch.core.convert import (SwitchPlan, convert as _convert_fn,
                                      convert_execute as _execute_fn,
                                      convert_execute_batch as _execute_batch_fn,
                                      nparts as _nparts, part_of as _part_of,
                                      plan_switch as _plan_fn,
                                      plan_switch_batch as _plan_batch_fn)
from repro_torch.core.formats import Format


class DynamicMatrix:
    """Single-active-state dynamic matrix (paper Fig. 1)."""

    def __init__(self, concrete):
        if isinstance(concrete, DynamicMatrix):
            concrete = concrete.concrete
        self.concrete = concrete

    @property
    def active(self) -> Format:
        return Format(self.concrete.format)

    @property
    def shape(self) -> Tuple[int, int]:
        return self.concrete.shape

    @property
    def nnz(self) -> int:
        return self.concrete.nnz

    @property
    def dtype(self):
        return self.concrete.dtype

    def activate(self, fmt: Format, plan: Optional[SwitchPlan] = None,
                 **kwargs) -> "DynamicMatrix":
        """Switch the active state; returns the converted matrix. With
        ``plan`` the switch is the pure numeric phase (no host sync)."""
        return DynamicMatrix(_convert_fn(self.concrete, fmt, plan=plan, **kwargs))

    convert = activate

    def plan(self, fmt: Format, **kwargs) -> SwitchPlan:
        """Symbolic phase of :meth:`activate`."""
        return _plan_fn(self.concrete, fmt, **kwargs)

    @classmethod
    def auto(cls, A, policy=None, x=None, **conv_kwargs) -> "DynamicMatrix":
        """Build with the format chosen by a ``repro_torch.tuning.FormatPolicy``
        (a policy, a mode string, or None for the default ``ml`` policy).
        The policy supplies the SwitchPlan; the conversion is the numeric
        phase on the device of ``A``."""
        policy = _resolve_policy(policy)
        A = A.concrete if isinstance(A, DynamicMatrix) else A
        plan = policy.plan_for(A, x=x, **conv_kwargs)
        return cls(_execute_fn(A, plan))

    def spmv(self, x, backend: Optional[str] = None, cfg: Optional[dict] = None):
        return _ops.spmv(self.concrete, x, backend=backend, cfg=cfg)

    def spmm(self, B, backend: Optional[str] = None, cfg: Optional[dict] = None):
        return _ops.spmm(self.concrete, B, backend=backend, cfg=cfg)

    def spmm_t(self, X, backend: Optional[str] = None, cfg: Optional[dict] = None):
        return _ops.spmm_t(self.concrete, X, backend=backend, cfg=cfg)

    def extract_diagonal(self):
        return _ops.extract_diagonal(self.concrete)

    def update_diagonal(self, d) -> "DynamicMatrix":
        return DynamicMatrix(_ops.update_diagonal(self.concrete, d))

    def __repr__(self):
        return f"DynamicMatrix<{self.active.name}>{self.shape}"


# Default candidate order for the union container (BSR/Dense excluded:
# capacity-heavy; pass an explicit candidate set to include them).
DEFAULT_CANDIDATES = (Format.COO, Format.CSR, Format.DIA, Format.ELL, Format.SELL)


def _resolve_policy(policy, candidates: Optional[Sequence[Format]] = None):
    """None / mode-string / FormatPolicy -> FormatPolicy (lazy import: the
    tuning subpackage depends on this module)."""
    from repro_torch.tuning.policy import FormatPolicy
    if isinstance(policy, FormatPolicy):
        return policy
    kwargs = {"candidates": candidates} if candidates is not None else {}
    return FormatPolicy(policy or "ml", **kwargs)


class SwitchDynamicMatrix:
    """Union-of-formats dynamic matrix with run-time dispatch on ``active_id``
    (an index into :attr:`candidates`). A stacked union (variants with a
    leading part axis) holds a tuple of ids, one per part: :meth:`part`
    gives part ``p``'s active container."""

    def __init__(self, variants: Sequence, active_id):
        self.variants = tuple(variants)
        if isinstance(active_id, (int, np.integer)):
            self.active_id = int(active_id)
        else:
            self.active_id = tuple(int(i) for i in active_id)

    @classmethod
    def build(cls, A, candidates: Sequence[Format] = DEFAULT_CANDIDATES,
              active: Optional[Format] = None,
              plans: Optional[dict] = None, **conv_kwargs):
        """One SwitchPlan per candidate (planned on the device unless given
        in ``plans``), then every conversion as the numeric phase."""
        A = A.concrete if isinstance(A, DynamicMatrix) else A
        plans = {Format(f): p for f, p in (plans or {}).items()}
        for fmt, p in plans.items():
            if Format(p.target) != fmt:
                raise ValueError(
                    f"plan for candidate {fmt.name} targets {Format(p.target).name}")
        for fmt in candidates:
            fmt = Format(fmt)
            if fmt not in plans:
                kw = conv_kwargs.get(fmt)
                plans[fmt] = _plan_fn(A, fmt, **(dict(kw) if isinstance(kw, dict) else {}))
        variants = [_execute_fn(A, plans[Format(fmt)]) for fmt in candidates]
        active = Format(active) if active is not None else Format(candidates[0])
        return cls(variants, list(candidates).index(active))

    @classmethod
    def build_batched(cls, C, candidates: Sequence[Format] = DEFAULT_CANDIDATES,
                      plans: Optional[Sequence[SwitchPlan]] = None,
                      active_ids=0) -> "SwitchDynamicMatrix":
        """Union builder over a *stacked* batch of same-shape COO parts
        (``(P, capacity)`` arrays): one shared :func:`plan_switch_batch`
        plan per candidate (unless given in ``plans``), then one batched
        numeric phase per candidate. Every variant is a stacked container;
        ``active_ids`` gives each part's candidate index (a scalar
        broadcasts)."""
        candidates = tuple(Format(f) for f in candidates)
        if plans is None:
            plans = tuple(_plan_batch_fn(C, f) for f in candidates)
        else:
            plans = tuple(plans)
            for fmt, p in zip(candidates, plans):
                if Format(p.target) != fmt:
                    raise ValueError(f"plan for candidate {fmt.name} targets "
                                     f"{Format(p.target).name}")
        variants = [_execute_batch_fn(C, p) for p in plans]
        return cls(variants, _per_part(active_ids, _nparts(C)))

    @classmethod
    def from_matrix(cls, A, candidates: Sequence[Format] = DEFAULT_CANDIDATES,
                    active: Optional[Format] = None,
                    plans: Optional[dict] = None, **conv_kwargs):
        """Build the union by converting ``A`` into every candidate format."""
        return cls.build(A, candidates=candidates, active=active, plans=plans,
                         **conv_kwargs)

    @classmethod
    def auto(cls, A, candidates: Sequence[Format] = DEFAULT_CANDIDATES,
             policy=None, x=None, **conv_kwargs) -> "SwitchDynamicMatrix":
        """Build the union with the active variant chosen by a FormatPolicy."""
        policy = _resolve_policy(policy, candidates)
        A = A.concrete if isinstance(A, DynamicMatrix) else A
        best = policy.select(A, x=x).best
        return cls.build(A, candidates=candidates, active=best, **conv_kwargs)

    @property
    def candidates(self) -> Tuple[Format, ...]:
        return tuple(Format(v.format) for v in self.variants)

    @property
    def batched(self) -> bool:
        """True for a stacked union (one active id per part)."""
        return isinstance(self.active_id, tuple)

    @property
    def active(self):
        """The active format; a tuple, one per part, of a stacked union."""
        if self.batched:
            return tuple(self.candidates[i] for i in self.active_id)
        return self.candidates[self.active_id]

    @property
    def shape(self):
        return self.variants[0].shape

    def part(self, p: int):
        """Part ``p``'s active container (views into the stacked variant)."""
        return _part_of(self.variants[self.active_id[p]], p)

    def activate(self, fmt: Format) -> "SwitchDynamicMatrix":
        """O(1) state switch — no conversion, all payloads resident (every
        part of a stacked union)."""
        idx = list(self.candidates).index(Format(fmt))
        return self.activate_id(idx)

    def activate_id(self, active_id) -> "SwitchDynamicMatrix":
        """Switch by candidate index: a scalar, or (stacked union) one per
        part; a scalar broadcasts over the parts."""
        if self.batched:
            active_id = _per_part(active_id, len(self.active_id))
        return SwitchDynamicMatrix(self.variants, active_id)

    def spmv(self, x, backend: Optional[str] = None, cfg: Optional[dict] = None):
        return _ops.spmv(self.variants[self.active_id], x, backend=backend, cfg=cfg)

    def spmm(self, B, backend: Optional[str] = None, cfg: Optional[dict] = None):
        return _ops.spmm(self.variants[self.active_id], B, backend=backend, cfg=cfg)

    def spmm_t(self, X, backend: Optional[str] = None, cfg: Optional[dict] = None):
        return _ops.spmm_t(self.variants[self.active_id], X, backend=backend, cfg=cfg)

    def __repr__(self):
        return f"SwitchDynamicMatrix<{[f.name for f in self.candidates]}>{self.shape}"


def _per_part(ids, n: int) -> Tuple[int, ...]:
    """A scalar id broadcast to ``n`` parts, or ``n`` ids as host ints."""
    arr = np.asarray(ids)
    if arr.ndim == 0:
        return (int(arr),) * n
    if arr.shape != (n,):
        raise ValueError(f"expected a scalar or {n} ids, got shape {arr.shape}")
    return tuple(int(i) for i in arr)


_ops._register_dynamic(DynamicMatrix, SwitchDynamicMatrix)
