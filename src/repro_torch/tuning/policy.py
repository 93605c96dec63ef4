"""FormatPolicy — the format-selection front-end (port of ``repro.tuning.policy``).

    mode="profile"   convert to every candidate, time one SpMV (or SpMM /
                     SpMM_T at a stated width) of each on the device of the
                     matrix, pick the fastest (the paper's tuner; setup
                     phase only).
    mode="ml"        pre-trained decision tree over pattern features; falls
                     back to analytic when no tree is available or it
                     predicts outside the candidate set.
    mode="analytic"  bytes-touched / bandwidth model; zero measurements.
    mode="cached"    persistent per-(pattern, backend, device, op, width
                     bucket) decision; on a miss, the ml pick, stored with
                     the kernel pin of the policy's own cache: ("cuda",
                     cfg) where a tuned record beat the reference. A warm
                     cache answers from a dict lookup.

The chain is cached -> ml -> analytic; profile runs only when asked for.

Every decision is observable as in the JAX package: a ``select.policy``
(``select.batch``) span while tracing is on, and ``format.select``,
``format.select_batch`` and ``plan.switch`` ledger records that carry what
the tiers did (features, the tree path, scores, cache hit or miss, the
kernel pin or its veto).
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.convert import SwitchPlan, plan_switch as _plan_switch
from repro_torch.core.convert import to_coo as _to_coo_fn
from repro_torch.core.dynamic import DEFAULT_CANDIDATES, DynamicMatrix
from repro_torch.core.formats import COO, Format
from repro_torch.core.ops import _route_kernel_dict as _kernel_dict
from repro_torch.obs import ledger as _ledger
from repro_torch.obs import trace as _trace
from repro_torch.tuning import kernel_tune
from repro_torch.tuning.cache import SelectionCache
from repro_torch.tuning.engines import TuneReport, analytic_select, profile_select
from repro_torch.tuning.features import FEATURE_NAMES, PatternFeatures, batch_features
from repro_torch.tuning.tree import DecisionTree, load_default_tree

MODES = ("ml", "analytic", "cached", "profile")


class FormatPolicy:
    """Format selector with mode ``"ml" | "analytic" | "cached" | "profile"``.

    ``tree``: a ``DecisionTree``, a path to a serialized one, or None for
    the packaged default tree. ``candidates``: formats considered; the pick
    is always one of these. ``cache``: a ``SelectionCache``, a path, or
    None for the default store (``$REPRO_TUNING_CACHE``); cached mode keeps
    its decisions there and reads the kernel records of the same store.
    ``profile_iters``: timing repetitions in profile mode.
    """

    def __init__(self, mode: str = "ml",
                 candidates: Sequence[Format] = DEFAULT_CANDIDATES,
                 tree: Union[DecisionTree, str, None] = None,
                 cache: Union[SelectionCache, str, None] = None,
                 profile_iters: int = 6):
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} not in {MODES}")
        self.mode = mode
        self.candidates = tuple(Format(c) for c in candidates)
        self._tree = DecisionTree.load(tree) if isinstance(tree, str) else tree
        self.cache = cache if isinstance(cache, SelectionCache) else SelectionCache(cache)
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
        ``analytic`` read the pattern only, as in the JAX package; ``cached``
        keys its decision by the op and the width bucket of ``ncols``."""
        # detail is the ledger's workspace: the tiers fill in what they did
        # only when the ledger wants a record
        detail: Optional[dict] = {} if _ledger.enabled() else None
        if _trace.mode() == "off":
            rep = self._select(A, x, op, ncols, detail)
        else:
            with _trace.span("select.policy", mode=self.mode, op=op) as sp:
                rep = self._select(A, x, op, ncols, detail)
                sp.set(chosen=Format(rep.best).name, tier=rep.mode,
                       backend=rep.backend or "auto")
        if detail is not None:
            _ledger.record("format.select", mode=self.mode, op=op, ncols=ncols,
                           chosen=Format(rep.best).name, tier=rep.mode,
                           backend=rep.backend, cfg=dict(rep.cfg) if rep.cfg else None,
                           **detail)
        return rep

    __call__ = select

    def _select(self, A, x, op: str, ncols: Optional[int],
                detail: Optional[dict]) -> TuneReport:
        A = A.concrete if isinstance(A, DynamicMatrix) else A
        if self.mode == "profile":
            if x is None:
                n, w = A.shape[1], ncols or 1
                shape = {"spmv": (n,), "spmm": (n, w), "spmm_t": (w, n)}[op]
                x = torch.ones(shape, dtype=A.dtype, device=A.device)
            rep = profile_select(A, x, candidates=self.candidates,
                                 iters=self.profile_iters, op=op)
            _fill_scores(detail, rep)
            return rep
        feats = PatternFeatures.from_coo(_to_coo_fn(A))
        _fill_features(detail, feats)
        if self.mode == "analytic":
            rep = analytic_select(feats.to_stats(), candidates=self.candidates)
            _fill_scores(detail, rep)
            return rep
        if self.mode == "ml":
            return self._select_ml(feats, detail)
        return self._select_cached(feats, A.device, op, ncols, detail)

    def _select_cached(self, feats: PatternFeatures, device, op: str,
                       ncols: Optional[int], detail: Optional[dict] = None) -> TuneReport:
        tag = kernel_tune.backend_tag(device)
        key = SelectionCache.key(feats, self.candidates, torch.device(device).type,
                                 kernel_tune.device_kind(device), op_ctx=_op_ctx(op, ncols))
        hit = self.cache.get_decision(key)
        if hit is not None and hit[0] in self.candidates:
            fmt, kb, cfg, pinned_tag = hit
            if kb is not None and pinned_tag != tag:
                # pinned under another tag (a JAX interpret-mode pin, say):
                # never replayed; the pin comes from this tag's records
                if detail is not None:
                    detail["cache"] = ("hit (stale backend tag — kernel pin "
                                       "re-derived for this mode)")
                kb, cfg = self._kernel_decision(fmt, feats, op, ncols, device, detail)
            elif detail is not None:
                detail["cache"] = "hit"
            return TuneReport(fmt, {}, "cached", backend=kb, cfg=cfg)
        if detail is not None:
            detail["cache"] = ("miss" if hit is None
                               else "stale (cached pick left the candidate "
                                    "set) — reselected")
        rep = self._select_ml(feats, detail)
        kb, cfg = self._kernel_decision(rep.best, feats, op, ncols, device, detail)
        self.cache.put_decision(key, rep.best, kb, cfg, tag=tag if kb else None)
        return TuneReport(rep.best, rep.times, f"cached-miss:{rep.mode}", backend=kb, cfg=cfg)

    def select_batch(self, A, x=None) -> np.ndarray:
        """Per-part selection over a *stacked* COO batch (leading axis P):
        an int32 ``(P,)`` vector of indices into ``self.candidates``.

        ``ml``, ``analytic`` and ``cached`` featurise the whole batch in
        one device pass (:func:`~repro_torch.tuning.features.batch_features`,
        one planned pull whatever P is); what remains per part is a tree
        walk or a dict lookup on the host. ``cached`` keys each part as
        :meth:`select` keys an SpMV pick and writes the store once for the
        batch. ``profile`` has no batched form: it runs :meth:`select` on
        each part. One ``format.select_batch`` record counts the picks."""
        A = A.concrete if isinstance(A, DynamicMatrix) else A
        nparts = int(A.data.shape[0])
        if _trace.mode() != "off":
            with _trace.span("select.batch", mode=self.mode, parts=nparts):
                ids = self._select_batch(A, x, nparts)
        else:
            ids = self._select_batch(A, x, nparts)
        if _ledger.enabled():
            counts: dict = {}
            for i in ids:
                name = self.candidates[int(i)].name
                counts[name] = counts.get(name, 0) + 1
            _ledger.record("format.select_batch", mode=self.mode, parts=nparts,
                           chosen_counts=counts)
        return ids

    def _select_batch(self, A, x, nparts: int) -> np.ndarray:
        if self.mode == "profile":
            ids = [self.candidates.index(self.select(
                COO(A.row[i], A.col[i], A.data[i], A.shape, A.nnz), x=x).best)
                for i in range(nparts)]
            return np.asarray(ids, np.int32)
        feats = batch_features(A)
        if self.mode == "cached":
            autoflush, self.cache.autoflush = self.cache.autoflush, False
            try:
                reps = [self._select_cached(f, A.device, "spmv", None) for f in feats]
            finally:
                self.cache.autoflush = autoflush
            if autoflush and any(r.mode.startswith("cached-miss") for r in reps):
                self.cache.flush()  # one write for the whole batch
            return np.asarray([self.candidates.index(r.best) for r in reps], np.int32)
        pick = ((lambda f: analytic_select(f.to_stats(), candidates=self.candidates).best)
                if self.mode == "analytic" else (lambda f: self._select_ml(f).best))
        return np.asarray([self.candidates.index(pick(f)) for f in feats], np.int32)

    def _kernel_decision(self, fmt: Format, feats: PatternFeatures, op: str,
                         ncols: Optional[int], device, detail: Optional[dict] = None):
        """(backend, cfg) pinned beside a format pick: ``("cuda", cfg)``
        where this policy's cache holds a record for the pattern's (format,
        shape bucket[, width bucket]) on ``device`` that beat the
        reference, else ``(None, None)`` (the route stays per call)."""
        rec = kernel_tune.best_config_for(fmt, feats.m, feats.n, max(1, feats.nnz), op=op,
                                          ncols=ncols, cache=self.cache, device=device)
        if detail is not None and rec is not None:
            detail["kernel"] = _kernel_dict(rec)
        if rec is not None and rec.speedup >= 1.0:
            return "cuda", dict(rec.cfg)
        if detail is not None:
            detail["kernel_veto"] = (
                f"cached kernel measured {rec.speedup:.2f}x vs ref (< 1.0): "
                "CUDA pin refused" if rec is not None
                else "no tuned kernel record for this "
                     "(format, shape bucket, op) — route stays auto/ref")
        return None, None

    def plan_for(self, A, fmt=None, x=None, op: str = "spmv",
                 ncols: Optional[int] = None, **hints) -> SwitchPlan:
        """Select a format for ``A`` (unless ``fmt`` is given) and return the
        :class:`SwitchPlan` the numeric phase needs. ``op``/``ncols`` as in
        :meth:`select`; ``hints`` forward to ``plan_switch``. For SELL
        without ``c``/``sigma`` hints, a tuned record of this policy's cache
        for the op and width seeds them: the geometry that was timed. A
        ``plan.switch`` record says where the geometry came from."""
        A = A.concrete if isinstance(A, DynamicMatrix) else A
        if fmt is None:
            fmt = self.select(A, x=x, op=op, ncols=ncols).best
        fmt = Format(fmt)
        geometry_source = "caller hints" if hints else None
        if fmt == Format.SELL and "c" not in hints and "sigma" not in hints:
            rec = kernel_tune.best_config_for(fmt, A.shape[0], A.shape[1], max(1, int(A.nnz)),
                                              op=op, ncols=ncols, cache=self.cache,
                                              device=A.device)
            if rec is not None and "c" in rec.cfg:
                hints = dict(hints, c=int(rec.cfg["c"]),
                             sigma=int(rec.cfg.get("sigma", 8 * rec.cfg["c"])))
                geometry_source = "tuned kernel record"
        if _ledger.enabled():
            _ledger.record("plan.switch", fmt=fmt.name,
                           hints={k: v for k, v in hints.items()
                                  if isinstance(v, (int, float, str, bool))},
                           geometry_source=geometry_source)
        return _plan_switch(A, fmt, **hints)

    def _select_ml(self, feats: PatternFeatures,
                   detail: Optional[dict] = None) -> TuneReport:
        tree = self.tree
        if tree is not None:
            vec = feats.vector()
            fmt = Format(tree.predict_one(vec))
            if detail is not None:
                path = tree.decision_path(vec)
                for step in path:
                    if step.get("leaf"):
                        step["predict_name"] = Format(step["predict"]).name
                detail["tree_path"] = path
            if fmt in self.candidates:
                return TuneReport(fmt, {}, "ml")
            if detail is not None:
                detail["tree_rejected"] = (f"{fmt.name} outside the candidate "
                                           "set — analytic fallback")
        # no tree shipped, or it predicts a format outside the candidate set
        rep = analytic_select(feats.to_stats(), candidates=self.candidates)
        _fill_scores(detail, rep)
        return rep


def _fill_features(detail: Optional[dict], feats: PatternFeatures) -> None:
    if detail is not None:
        detail["features"] = {n: float(v) for n, v in zip(FEATURE_NAMES, feats.vector())}


def _fill_scores(detail: Optional[dict], rep: TuneReport) -> None:
    if detail is not None and rep.times:
        detail["scores"] = {Format(f).name: float(t) for f, t in rep.times.items()}


def _op_ctx(op: str, ncols: Optional[int]) -> str:
    """Cache-key op context: empty for SpMV, ``"<op>-b<lg width>"`` for the
    SpMM ops (the JAX package's keys)."""
    return "" if op == "spmv" else f"{op}-{kernel_tune.rhs_bucket(ncols)}"
