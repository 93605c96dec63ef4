"""Weights and caches across packages: nested dicts of numpy arrays <-> the
port's nested dicts of tensors.

The JAX package's param tree (``jax.tree.map(np.asarray, params)``) and its
decode cache have the port's names and shapes, so they cross leaf by leaf.
bf16 arrays (numpy's ``ml_dtypes`` bfloat16) cross bit-exact; going back,
bf16 tensors are widened to float32, exactly.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.formats import _numpy, _tensor
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.spec import tree_map


def params_from_numpy(tree, device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None) -> dict:
    """A numpy param tree as the port's tensors on ``device`` (the card
    unless the caller names the CPU); ``dtype`` recasts every floating
    leaf."""
    dev = resolve_device(device)

    def leaf(a):
        t = _tensor(np.asarray(a), dev)
        return t.to(dtype) if dtype is not None and t.is_floating_point() else t

    return tree_map(leaf, tree)


def params_to_numpy(tree) -> dict:
    """The port's param tree as host numpy arrays."""
    return tree_map(_numpy, tree)


def cache_from_numpy(tree, device: DeviceLike = None) -> dict:
    """A numpy decode cache (k, v[, k_scale, v_scale]) as tensors, dtypes kept."""
    return params_from_numpy(tree, device)


def cache_to_numpy(tree) -> dict:
    return params_to_numpy(tree)
