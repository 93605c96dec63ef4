"""repro_torch.tuning — format selection (port of ``repro.tuning``).

    from repro_torch.tuning import FormatPolicy
    fmt = FormatPolicy("ml").select(A).best

The ``ml``, ``analytic`` and ``profile`` modes are ported, with the pattern
features, the decision tree (its own copy of ``default_tree.json``) and the
profiling tuner (``profile_select``, ``time_fn``). ``cached`` waits for the
selection cache and ``kernel_tune``.
"""
from repro_torch.tuning.engines import (GATHER_PENALTY, HBM_BW, TuneReport,
                                        analytic_select, predicted_bytes,
                                        profile_select, time_fn)
from repro_torch.tuning.features import FEATURE_NAMES, PatternFeatures, PatternStats
from repro_torch.tuning.policy import MODES, FormatPolicy
from repro_torch.tuning.tree import (DEFAULT_TREE_PATH, DecisionTree,
                                     load_default_tree)

__all__ = [
    "FormatPolicy", "MODES", "PatternFeatures", "PatternStats", "FEATURE_NAMES",
    "DecisionTree", "load_default_tree", "DEFAULT_TREE_PATH",
    "TuneReport", "analytic_select", "predicted_bytes", "HBM_BW", "GATHER_PENALTY",
    "profile_select", "time_fn",
]
