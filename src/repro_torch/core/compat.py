"""Sharding vocabulary shared by the distributed layer and the launcher
(port of ``repro.core.compat``).

The JAX module resolves ``shard_map`` and ``pcast`` across JAX versions.
Neither has a torch counterpart, and the port has no stubs for them:

* ``shard_map`` runs one body per device of a mesh. The port runs its P
  shards in one process on one device (``core/distributed.py``), as one
  stacked computation, so there is no per-device body to map.
* ``pcast`` marks a value as varying across mesh axes for JAX's
  replication checker. Autograd tracks no such property and needs no
  marks.

What stays is the partition-spec convention: :class:`PartitionSpec`, the
port's counterpart of ``jax.sharding.PartitionSpec``, and
:func:`leading_axis_spec`.
"""
from __future__ import annotations


class PartitionSpec(tuple):
    """One entry a dimension: ``None`` (replicated), a mesh axis name, or a
    tuple of names (the dimension split over their product). A tuple, so
    it compares equal to ``tuple(jax.sharding.PartitionSpec(...))``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "PartitionSpec(" + ", ".join(map(repr, self)) + ")"


def leading_axis_spec(axis, ndim: int) -> PartitionSpec:
    """``PartitionSpec(axis, None, ...)``: shard the leading axis, replicate
    the rest. The spec of every stacked shard container and batch tensor."""
    return PartitionSpec(axis, *(None,) * (ndim - 1))
