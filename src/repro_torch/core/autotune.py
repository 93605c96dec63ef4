"""Format auto-tuner entry point (port of ``repro.core.autotune``).

``autotune(A, x, mode=...)`` answers "which format for ``A``?" through the
``repro_torch.tuning`` engines:

* ``profile``  — the paper's §V-E tuner: convert to every candidate, time
  one SpMV of each on the device of ``A``, pick the fastest;
* ``analytic`` — bytes-touched / bandwidth model, no runs;
* ``ml``       — the pre-trained decision tree over pattern features;
* ``cached``   — the persistent selection cache in front of ``ml``
  (``FormatPolicy("cached")``), with the kernel pin of measured records.

The tuning package imports ``repro_torch.core``, so this module imports it
inside the function.
"""
from __future__ import annotations


def autotune(A, x=None, mode: str = "profile", **kwargs):
    """Select the best format for ``A``; returns a ``TuneReport``.

    ``mode='profile'`` needs ``x`` (kwargs go to ``profile_select``:
    ``candidates``, ``iters``, ``backends``, ...); ``'analytic'`` takes
    ``candidates``; ``'ml'`` and ``'cached'`` delegate to a
    ``FormatPolicy`` (kwargs: ``candidates``, ``tree``; ``cache`` for
    ``'cached'``).
    """
    from repro_torch.core.convert import to_coo
    from repro_torch.core.dynamic import DynamicMatrix
    from repro_torch.tuning.engines import analytic_select, profile_select
    from repro_torch.tuning.features import PatternStats
    from repro_torch.tuning.policy import FormatPolicy

    if mode == "profile":
        if x is None:
            raise ValueError("profile mode requires x")
        return profile_select(A, x, **kwargs)
    if mode == "analytic":
        A = A.concrete if isinstance(A, DynamicMatrix) else A
        return analytic_select(PatternStats.from_coo(to_coo(A)), **kwargs)
    if mode in ("ml", "cached"):
        return FormatPolicy(mode, **kwargs).select(A, x=x)
    raise ValueError(f"unknown mode {mode!r} (profile | analytic | ml | cached)")
