"""repro_torch.tuning — format selection (port of ``repro.tuning``).

    from repro_torch.tuning import FormatPolicy
    fmt = FormatPolicy("ml").select(A).best

Every mode is ported: ``ml``, ``analytic``, ``profile`` and ``cached``, with
the pattern features, the decision tree (its own copy of
``default_tree.json``), the profiling tuner (``profile_select``,
``time_fn``), the persistent selection cache (``SelectionCache``, the JAX
package's file format) and the kernel tuner (``kernel_tune``: measured
launch knobs and the ``backend="auto"`` records), the measured gather
penalty (``calibrate_gather_penalty``) and the training corpus
(``python -m repro_torch.tuning.corpus``, imported on demand).
"""
from repro_torch.tuning import kernel_tune
from repro_torch.tuning.cache import (CACHE_PATH_ENV, SelectionCache, decode_decision,
                                      default_cache_path, encode_decision,
                                      pattern_signature)
from repro_torch.tuning.engines import (GATHER_PENALTY, HBM_BW, TuneReport,
                                        analytic_select, calibrate_gather_penalty,
                                        predicted_bytes, profile_select, time_fn)
from repro_torch.tuning.features import FEATURE_NAMES, PatternFeatures, PatternStats
from repro_torch.tuning.kernel_tune import (KernelRecord, backend_tag, best_config,
                                            best_config_for, default_grid,
                                            default_kernel_cache, kernel_key, rhs_bucket,
                                            shape_bucket, tune_kernel)
from repro_torch.tuning.policy import MODES, FormatPolicy
from repro_torch.tuning.tree import (DEFAULT_TREE_PATH, DecisionTree,
                                     load_default_tree)

__all__ = [
    "FormatPolicy", "MODES", "PatternFeatures", "PatternStats", "FEATURE_NAMES",
    "DecisionTree", "load_default_tree", "DEFAULT_TREE_PATH",
    "TuneReport", "analytic_select", "predicted_bytes", "HBM_BW", "GATHER_PENALTY",
    "calibrate_gather_penalty",
    "profile_select", "time_fn",
    "SelectionCache", "CACHE_PATH_ENV", "default_cache_path", "pattern_signature",
    "encode_decision", "decode_decision",
    "kernel_tune", "KernelRecord", "tune_kernel", "best_config", "best_config_for",
    "default_grid", "default_kernel_cache", "kernel_key", "shape_bucket", "rhs_bucket",
    "backend_tag",
]
