"""Pure-numpy CART decision tree (port of ``repro.tuning.tree``).

Axis-aligned splits, Gini impurity, greedy growth with depth / leaf-size /
gain stopping rules: the JAX package's trainer, split for split and with
the same tie order, so the same ``(X, y)`` gives a JSON-identical tree.
Trees are stored as parallel node arrays in JSON; the port ships its own
copy of the JAX package's trained ``default_tree.json`` (byte-identical),
so the same features take the same ``decision_path``.
``python -m repro_torch.tuning.corpus`` trains one on the card.

Labels are ``Format`` integer values; ``Format(tree.predict_one(v))``
recovers the enum.
"""
from __future__ import annotations

import functools
import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.tuning.features import FEATURE_NAMES


def _gini(counts: np.ndarray) -> np.ndarray:
    """Gini impurity of class-count rows; counts (..., n_classes)."""
    tot = counts.sum(axis=-1, keepdims=True)
    with np.errstate(invalid="ignore", divide="ignore"):
        p = counts / tot
    g = 1.0 - np.nansum(p * p, axis=-1)
    return np.where(tot[..., 0] > 0, g, 0.0)


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

    # -- training -----------------------------------------------------------

    def fit(self, X, y, max_depth: int = 10, min_samples_leaf: int = 2,
            min_gain: float = 1e-7) -> "DecisionTree":
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.int64)
        if X.ndim != 2 or len(X) != len(y) or not len(y):
            raise ValueError(f"bad training set: X{X.shape} y{y.shape}")
        self.classes_, yi = np.unique(y, return_inverse=True)
        nodes = []  # list of [feature, thresh, left, right, value]

        def grow(idx: np.ndarray, depth: int) -> int:
            node_id = len(nodes)
            counts = np.bincount(yi[idx], minlength=len(self.classes_))
            majority = int(counts.argmax())
            nodes.append([-1, 0.0, -1, -1, majority])
            if (depth >= max_depth or len(idx) < 2 * min_samples_leaf
                    or counts.max() == len(idx)):
                return node_id
            split = self._best_split(X[idx], yi[idx], len(self.classes_),
                                     min_samples_leaf)
            if split is None or split[2] < min_gain:
                return node_id
            f, thr, _gain = split
            go_left = X[idx, f] <= thr
            nodes[node_id][0] = f
            nodes[node_id][1] = thr
            nodes[node_id][2] = grow(idx[go_left], depth + 1)
            nodes[node_id][3] = grow(idx[~go_left], depth + 1)
            return node_id

        grow(np.arange(len(yi)), 0)
        arr = np.asarray(nodes, np.float64)
        self.feature = arr[:, 0].astype(np.int32)
        self.thresh = arr[:, 1]
        self.left = arr[:, 2].astype(np.int32)
        self.right = arr[:, 3].astype(np.int32)
        self.value = arr[:, 4].astype(np.int32)
        return self

    @staticmethod
    def _best_split(X: np.ndarray, yi: np.ndarray, n_classes: int,
                    min_samples_leaf: int) -> Optional[Tuple[int, float, float]]:
        """Best (feature, threshold, gini gain) over all features, or None."""
        n = len(yi)
        onehot = np.eye(n_classes)[yi]
        base = float(_gini(onehot.sum(axis=0)))
        best = None
        for f in range(X.shape[1]):
            order = np.argsort(X[:, f], kind="stable")
            xs = X[order, f]
            # cumulative class counts left of each candidate split point
            left_counts = np.cumsum(onehot[order], axis=0)[:-1]
            right_counts = left_counts[-1] + onehot[order][-1] - left_counts
            nl = np.arange(1, n)
            valid = (xs[1:] != xs[:-1]) & (nl >= min_samples_leaf) \
                    & (n - nl >= min_samples_leaf)
            if not valid.any():
                continue
            g = (nl * _gini(left_counts) + (n - nl) * _gini(right_counts)) / n
            g = np.where(valid, g, np.inf)
            k = int(np.argmin(g))
            gain = base - float(g[k])
            if best is None or gain > best[2]:
                best = (f, float((xs[k] + xs[k + 1]) / 2), gain)
        return best

    # -- inference ----------------------------------------------------------

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

    def score(self, X, y) -> float:
        return float(np.mean(self.predict(X) == np.asarray(y, np.int64)))

    @property
    def n_nodes(self) -> int:
        return len(self.feature)

    # -- serialization ------------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "feature_names": list(self.feature_names),
            "classes": self.classes_.tolist(),
            "feature": self.feature.tolist(),
            "thresh": self.thresh.tolist(),
            "left": self.left.tolist(),
            "right": self.right.tolist(),
            "value": self.value.tolist(),
        }

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

    def save(self, path: str) -> None:
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f, indent=1)
        os.replace(tmp, path)

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
