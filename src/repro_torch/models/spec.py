"""Parameter-spec system (port of ``repro.models.spec``): single source of
truth for shapes, dtypes, logical sharding axes, and initializers.

Every model family defines a nested dict of ``P`` leaves; ``init_params``
materializes tensors from a seeded ``torch.Generator`` on the target device,
leaf by leaf; ``abstract_params`` gives meta-device tensors (shapes and
dtypes, no storage); ``logical_axes`` the parallel tree of logical-axis
tuples. Params are nested dicts of tensors, so a JAX param tree crosses by
name (:mod:`repro_torch.models.weights`).

Logical axes vocabulary (as in the JAX package):
  "vocab"   embedding/unembedding vocabulary dim
  "embed"   d_model dim
  "mlp"     ffn hidden dim
  "heads"   attention heads * head_dim fused dim
  "kv"      kv heads * head_dim fused dim
  "expert"  MoE expert dim
  "layers"  stacked layer dim (never sharded)
  None      replicated
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class P:
    """One parameter spec leaf."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"  # normal | zeros | ones | small_normal
    dtype: torch.dtype = torch.float32
    fan_in_dims: Tuple[int, ...] = ()  # dims to scale 1/sqrt(fan_in) over

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def is_spec(x) -> bool:
    return isinstance(x, P)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of a nested dict (specs, tensors or arrays);
    with ``rest``, over the matching leaves of trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> List:
    """Leaves in sorted-key order, the order ``jax.tree.leaves`` gives."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def _init_leaf(spec: P, gen: torch.Generator, device: torch.device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    fan_in = 1
    for d in (spec.fan_in_dims or range(len(spec.shape) - 1)):
        fan_in *= spec.shape[d]
    scale = 1.0 / math.sqrt(max(1, fan_in))
    if spec.init == "small_normal":
        scale *= 0.1
    out = torch.randn(spec.shape, generator=gen, dtype=torch.float32, device=device)
    return out.mul_(scale).to(spec.dtype)


def init_params(specs, seed: int, device: DeviceLike = None) -> dict:
    """Materialize a params tree from a spec tree on ``device`` (the card
    unless the caller names the CPU): one generator seeded with ``seed`` on
    that device draws the leaves in ``tree_leaves`` order, each made in its
    own dtype before the next is drawn."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    out: dict = {}

    def fill(dst: dict, sub: dict) -> None:
        for k in sorted(sub):
            if isinstance(sub[k], dict):
                dst[k] = {}
                fill(dst[k], sub[k])
            else:
                dst[k] = _init_leaf(sub[k], gen, dev)

    fill(out, specs)
    return out


def abstract_params(specs) -> dict:
    """Meta-device tensors: shapes and dtypes, no storage allocated."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"), specs)


def logical_axes(specs) -> dict:
    """Parallel tree of logical-axis tuples."""
    return tree_map(lambda s: s.axes, specs)


def cast_dtype(specs, dtype: torch.dtype) -> dict:
    """Spec tree with every floating leaf recast (e.g. bf16 inference)."""
    return tree_map(
        lambda s: dataclasses.replace(s, dtype=dtype) if s.dtype.is_floating_point else s,
        specs)


def param_count(specs) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(specs))
