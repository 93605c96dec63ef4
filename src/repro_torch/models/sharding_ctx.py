"""Activation-sharding context (port of ``repro.models.sharding_ctx``): lets
a launcher name mesh axes for model code without coupling model definitions
to a mesh.

The launcher calls ``set_policy(dp=..., tp=...)`` (or uses ``policy()`` as a
context manager); model code calls ``constrain(x, kind)`` at the places
where the JAX package anchors GSPMD propagation (post-embed activations,
layer carries, logits). The port has no device mesh yet, so ``constrain``
returns ``x`` under every policy, as the JAX package's does without a mesh.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Tuple, Union

Axes = Union[None, str, Tuple[str, ...]]


@dataclasses.dataclass
class Policy:
    dp: Axes = None   # data-parallel axes (batch dim)
    tp: Axes = None   # tensor-parallel axis (vocab/mlp dims)
    sp: Axes = None   # sequence-parallel axis (S dim of activations)


_POLICY = Policy()


def set_policy(dp: Axes = None, tp: Axes = None, sp: Axes = None):
    global _POLICY
    _POLICY = Policy(dp, tp, sp)


def get_policy() -> Policy:
    return _POLICY


@contextlib.contextmanager
def policy(dp: Axes = None, tp: Axes = None, sp: Axes = None):
    global _POLICY
    old = _POLICY
    _POLICY = Policy(dp, tp, sp)
    try:
        yield
    finally:
        _POLICY = old


def constrain(x, kind: str):
    """kind: 'act' (B,S,D) | 'logits' (B,S,V) | 'logits_chunk' |
    'expert_rows' | 'batch' (B,...). No mesh: ``x`` unchanged."""
    del kind
    return x
