"""Sharding rules: logical param axes -> mesh axes (port of
``repro.launch.sharding``).

Rules are plain data. Every rule is divisibility-checked against the
actual dim size; a dim that does not divide falls back to replication, and
no mesh axis is used twice in one spec.

Train layout (DP/FSDP x TP, 2-D sharded params): embed-ish dims -> 'data'
(FSDP), wide dims -> 'model'. Decode layout: params TP over 'model',
replicated over 'data' (batch over 'data').

Inputs are the port's spec trees (``models/spec.py::P`` leaves) and
meta-device tensors; outputs are :class:`PartitionSpec` trees whose entries
equal JAX's. JAX's ``param_shardings`` (a ``NamedSharding`` tree) has no
counterpart beyond :func:`param_pspecs`: the port places no tensor on a
device mesh. For the same reason :func:`with_dp_constraint` returns its
input, as ``models/sharding_ctx.py::constrain`` does.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

from repro_torch.core.compat import PartitionSpec, leading_axis_spec
from repro_torch.models.spec import P as SpecP
from repro_torch.models.spec import tree_map

__all__ = ["PartitionSpec", "TRAIN_RULES", "DECODE_RULES", "spec_to_pspec", "param_pspecs",
           "batch_pspec", "cache_pspec", "with_dp_constraint"]

# logical axis -> mesh axis, per step kind
TRAIN_RULES: Dict[str, Optional[str]] = {
    "vocab": "model",
    "embed": "data",      # FSDP shard over data
    "mlp": "model",
    "heads": "model",
    "kv": "model",
    "expert": "model",    # EP
    "layers": None,
}

DECODE_RULES: Dict[str, Optional[str]] = {
    "vocab": "model",
    "embed": None,
    "mlp": "model",
    "heads": "model",
    "kv": "model",
    "expert": "model",
    "layers": None,
}


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        return math.prod(int(mesh.shape[a]) for a in axis)
    return int(mesh.shape[axis])


def spec_to_pspec(spec: SpecP, mesh, rules: Dict[str, Optional[str]]) -> PartitionSpec:
    """Logical axes -> PartitionSpec with divisibility fallback."""
    used = set()
    out = []
    for dim, ax in zip(spec.shape, spec.axes):
        mesh_axis = rules.get(ax) if ax is not None else None
        if mesh_axis is None or mesh_axis in used:
            out.append(None)
            continue
        if dim % _axis_size(mesh, mesh_axis) != 0:
            out.append(None)  # replicate: non-divisible (e.g. 40 heads / 16)
            continue
        used.add(mesh_axis)
        out.append(mesh_axis)
    return PartitionSpec(*out)


def param_pspecs(specs, mesh, rules=None):
    rules = rules or TRAIN_RULES
    return tree_map(lambda s: spec_to_pspec(s, mesh, rules), specs)


# ---------------------------------------------------------------------------
# Batch / cache shardings
# ---------------------------------------------------------------------------


def _dp(mesh):
    names = mesh.axis_names
    axes = tuple(a for a in ("pod", "data") if a in names)
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def batch_pspec(mesh, batch_specs: dict) -> dict:
    """Token batches: leading (batch) dim over DP axes when divisible."""
    dp = _dp(mesh)
    dp_size = _axis_size(mesh, dp)

    def one(s):
        b = s.shape[0]
        lead = dp if (dp is not None and b % dp_size == 0) else None
        return leading_axis_spec(lead, len(s.shape))

    return tree_map(one, batch_specs)


def cache_pspec(mesh, cache_specs: dict, cfg) -> dict:
    """Decode caches, by leaf name.

    KV caches (L, B, S, KVH, HD): batch over DP; kv heads over 'model' when
    they divide it, else the sequence dim (the attention contraction over S
    becomes a small reduction of (B, H)-sized partials). int8 scales
    (L, B, S, KVH) likewise. SSM states (L, B, H, N, P): batch over DP,
    heads over 'model'; conv windows (L, B, W-1, C): channels over 'model'.
    """
    del cfg
    dp = _dp(mesh)
    dp_size = _axis_size(mesh, dp)
    tp = "model" if "model" in mesh.axis_names else None
    tp_size = _axis_size(mesh, tp)

    def one(name, s):
        b = s.shape[1]
        bax = dp if (dp is not None and b % dp_size == 0) else None
        if name in ("k_scale", "v_scale"):
            if tp and s.shape[-1] % tp_size == 0:
                return PartitionSpec(None, bax, None, tp)
            if tp and s.shape[2] % tp_size == 0:
                return PartitionSpec(None, bax, tp, None)
            return PartitionSpec(None, bax, None, None)
        if name in ("k", "v"):
            if tp and s.shape[-2] % tp_size == 0:
                return PartitionSpec(None, bax, None, tp, None)  # head-sharded
            if tp and s.shape[2] % tp_size == 0:
                return PartitionSpec(None, bax, tp, None, None)  # sequence-sharded
            return PartitionSpec(None, bax, None, None, None)
        if name == "ssm":
            h_ok = tp and s.shape[2] % tp_size == 0
            return PartitionSpec(None, bax, tp if h_ok else None, None, None)
        if name == "conv":
            c_ok = tp and s.shape[-1] % tp_size == 0
            return PartitionSpec(None, bax, None, tp if c_ok else None)
        return PartitionSpec(*(None,) * len(s.shape))

    def walk(tree, name=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return one(name, tree)

    return walk(cache_specs)


def with_dp_constraint(x, mesh):
    """Activation constraint: batch dim over DP axes. The port holds every
    tensor whole on one device, so ``x`` is returned unchanged."""
    del mesh
    return x
