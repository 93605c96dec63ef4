"""Pure-numpy CART decision tree: inference half (port of ``repro.tuning.tree``).

Trees are stored as parallel node arrays in JSON; the port ships its own
copy of the JAX package's trained ``default_tree.json`` (byte-identical),
so the same features take the same ``decision_path``. Training (``fit``)
comes with the corpus generator.

Labels are ``Format`` integer values; ``Format(tree.predict_one(v))``
recovers the enum.
"""
from __future__ import annotations

import functools
import json
import os
from typing import Optional, Sequence

import numpy as np

from repro_torch.tuning.features import FEATURE_NAMES


class DecisionTree:
    """CART classifier stored as parallel node arrays.

    ``feature[i] < 0`` marks node i as a leaf predicting ``value[i]`` (an
    index into ``classes_``); internal nodes route ``x[feature] <= thresh``
    to ``left`` else ``right``.
    """

    def __init__(self, feature_names: Sequence[str] = FEATURE_NAMES):
        self.feature_names = tuple(feature_names)
        self.classes_ = np.zeros((0,), np.int64)
        self.feature = np.zeros((0,), np.int32)
        self.thresh = np.zeros((0,), np.float64)
        self.left = np.zeros((0,), np.int32)
        self.right = np.zeros((0,), np.int32)
        self.value = np.zeros((0,), np.int32)

    def predict_one(self, x) -> int:
        x = np.asarray(x, np.float64)
        i = 0
        while self.feature[i] >= 0:
            i = self.left[i] if x[self.feature[i]] <= self.thresh[i] else self.right[i]
        return int(self.classes_[self.value[i]])

    def predict(self, X) -> np.ndarray:
        X = np.asarray(X, np.float64)
        return np.array([self.predict_one(row) for row in X], np.int64)

    def decision_path(self, x) -> list:
        """The node-by-node route ``predict_one(x)`` takes, as JSON-ready
        step dicts; the final step is the leaf with its predicted class."""
        x = np.asarray(x, np.float64)
        path = []
        i = 0
        while self.feature[i] >= 0:
            f = int(self.feature[i])
            name = (self.feature_names[f]
                    if f < len(self.feature_names) else f"f{f}")
            v, thr = float(x[f]), float(self.thresh[i])
            went = "left" if v <= thr else "right"
            path.append({"node": i, "feature": name, "value": v,
                         "thresh": thr, "went": went})
            i = int(self.left[i] if v <= thr else self.right[i])
        path.append({"node": i, "leaf": True,
                     "predict": int(self.classes_[self.value[i]])})
        return path

    @property
    def n_nodes(self) -> int:
        return len(self.feature)

    @classmethod
    def from_dict(cls, d: dict) -> "DecisionTree":
        t = cls(tuple(d["feature_names"]))
        t.classes_ = np.asarray(d["classes"], np.int64)
        t.feature = np.asarray(d["feature"], np.int32)
        t.thresh = np.asarray(d["thresh"], np.float64)
        t.left = np.asarray(d["left"], np.int32)
        t.right = np.asarray(d["right"], np.int32)
        t.value = np.asarray(d["value"], np.int32)
        return t

    @classmethod
    def load(cls, path: str) -> "DecisionTree":
        with open(path) as f:
            return cls.from_dict(json.load(f))


DEFAULT_TREE_PATH = os.path.join(os.path.dirname(__file__), "default_tree.json")


@functools.lru_cache(maxsize=1)
def load_default_tree() -> Optional[DecisionTree]:
    """The packaged pre-trained tree, or None when the package ships
    without one (memoized: one read per process)."""
    if not os.path.exists(DEFAULT_TREE_PATH):
        return None
    return DecisionTree.load(DEFAULT_TREE_PATH)
