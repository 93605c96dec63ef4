"""FormatPolicy — the format-selection front-end (port of ``repro.tuning.policy``).

    mode="profile"   convert to every candidate, time one SpMV (or SpMM /
                     SpMM_T at a stated width) of each on the device of the
                     matrix, pick the fastest (the paper's tuner; setup
                     phase only).
    mode="ml"        pre-trained decision tree over pattern features; falls
                     back to analytic when no tree is available or it
                     predicts outside the candidate set.
    mode="analytic"  bytes-touched / bandwidth model; zero measurements.

``cached`` needs the selection cache and the kernel tuner (``kernel_tune``);
it raises until that slice is ported.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from repro_torch.core.convert import SwitchPlan, plan_switch as _plan_switch
from repro_torch.core.convert import to_coo as _to_coo_fn
from repro_torch.core.dynamic import DEFAULT_CANDIDATES, DynamicMatrix
from repro_torch.core.formats import Format
from repro_torch.tuning.engines import TuneReport, analytic_select, profile_select
from repro_torch.tuning.features import PatternFeatures
from repro_torch.tuning.tree import DecisionTree, load_default_tree

MODES = ("ml", "analytic", "cached", "profile")
_NOT_PORTED = ("mode 'cached' needs the selection cache (cache.py) and "
               "kernel_tune: ROADMAP Queue 1 item 7, not ported yet")


class FormatPolicy:
    """Format selector with mode ``"ml" | "analytic" | "profile"``.

    ``tree``: a ``DecisionTree``, a path to a serialized one, or None for
    the packaged default tree. ``candidates``: formats considered; the pick
    is always one of these. ``profile_iters``: timing repetitions in
    profile mode.
    """

    def __init__(self, mode: str = "ml",
                 candidates: Sequence[Format] = DEFAULT_CANDIDATES,
                 tree: Union[DecisionTree, str, None] = None,
                 profile_iters: int = 6):
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} not in {MODES}")
        if mode == "cached":
            raise NotImplementedError(_NOT_PORTED)
        self.mode = mode
        self.candidates = tuple(Format(c) for c in candidates)
        self._tree = DecisionTree.load(tree) if isinstance(tree, str) else tree
        self.profile_iters = profile_iters

    @property
    def tree(self) -> Optional[DecisionTree]:
        return self._tree if self._tree is not None else load_default_tree()

    def select(self, A, x=None, op: str = "spmv",
               ncols: Optional[int] = None) -> TuneReport:
        """Pick a format for ``A`` (a concrete container or DynamicMatrix);
        features are computed, and profile runs timed, on the device of
        ``A``. ``op``/``ncols`` state the computation the pick is for:
        ``"spmv"``, ``"spmm"`` with a rhs of ``ncols`` columns, or
        ``"spmm_t"`` with ``ncols`` tokens; profile mode times that op at
        that width. ``x`` is used by profile mode only; when absent it is
        ones of shape (N,), (N, ncols) or (ncols, N). ``ml`` and
        ``analytic`` read the pattern only, as in the JAX package."""
        A = A.concrete if isinstance(A, DynamicMatrix) else A
        if self.mode == "profile":
            if x is None:
                n, w = A.shape[1], ncols or 1
                shape = {"spmv": (n,), "spmm": (n, w), "spmm_t": (w, n)}[op]
                x = torch.ones(shape, dtype=A.dtype, device=A.device)
            return profile_select(A, x, candidates=self.candidates,
                                  iters=self.profile_iters, op=op)
        feats = PatternFeatures.from_coo(_to_coo_fn(A))
        if self.mode == "analytic":
            return analytic_select(feats.to_stats(), candidates=self.candidates)
        return self._select_ml(feats)

    __call__ = select

    def plan_for(self, A, fmt=None, x=None, op: str = "spmv",
                 ncols: Optional[int] = None, **hints) -> SwitchPlan:
        """Select a format for ``A`` (unless ``fmt`` is given) and return the
        :class:`SwitchPlan` the numeric phase needs. ``op``/``ncols`` as in
        :meth:`select`; ``hints`` forward to ``plan_switch``."""
        A = A.concrete if isinstance(A, DynamicMatrix) else A
        if fmt is None:
            fmt = self.select(A, x=x, op=op, ncols=ncols).best
        return _plan_switch(A, Format(fmt), **hints)

    def _select_ml(self, feats: PatternFeatures) -> TuneReport:
        tree = self.tree
        if tree is not None:
            fmt = Format(tree.predict_one(feats.vector()))
            if fmt in self.candidates:
                return TuneReport(fmt, {}, "ml")
        # no tree shipped, or it predicts a format outside the candidate set
        return analytic_select(feats.to_stats(), candidates=self.candidates)
