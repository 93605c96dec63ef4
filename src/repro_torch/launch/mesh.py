"""Mesh descriptors (port of ``repro.launch.mesh``).

A :class:`Mesh` here is a shape and axis names, the part of JAX's ``Mesh``
that the launch code reads (``.shape`` as an ordered ``{axis: size}``
mapping, ``.axis_names``). It allocates nothing and needs no process
group: the sharding rules and the dry-run read it, and the port runs on
one device. A ``torch.distributed`` mesh over real ranks waits for a host
with more than one card.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"{len(self.sizes)} sizes for axes {self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 chips per pod; 2 pods = 512 chips multi-pod."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_mesh(shape, axes) -> Mesh:
    """General mesh descriptor for tests and the launcher (e.g. (1, 1),
    ('data', 'model'))."""
    return Mesh(tuple(axes), tuple(int(s) for s in shape))


def dp_axes(mesh) -> tuple:
    """The data-parallel axes of a production mesh ('pod' included)."""
    names = mesh.axis_names
    return tuple(a for a in ("pod", "data") if a in names)


def tp_axis(mesh):
    return "model" if "model" in mesh.axis_names else None


def flat_axes(mesh) -> tuple:
    """All axes flattened (the HPCG row partition's 512-way split)."""
    return tuple(mesh.axis_names)
