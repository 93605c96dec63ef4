"""AdamW optimizer (port of ``repro.optim.adamw``) over a nested dict of
tensors.

The state mirrors params: ``m`` and ``v`` in float32 and an int32 scalar
``step`` tensor. Arithmetic follows the JAX package's: the schedule is
computed in float32 tensors (JAX's weak-typed jnp arithmetic), the clipping
norm sums the leaves' squares in ``jax.tree.leaves`` order (sorted keys,
nested) starting from 0, and ``b1 ** step`` is a float32 power.

``update`` writes the new parameters, ``m`` and ``v`` into the given
tensors in place, under ``torch.no_grad()`` (JAX returns new ones), leaf by
leaf and in slices of the leading dim, so it needs no more than a slice's
temporaries beyond params, grads, m and v: a full-size model's state fits
the card beside its params (elementwise arithmetic: slicing changes no
value). It returns the same params dict and a state holding the same m, v.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.models.spec import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: dict
    v: dict


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: Optional[float] = 1.0
    warmup_steps: int = 100
    lr_min_ratio: float = 0.1
    total_steps: int = 10000

    def init(self, params) -> AdamWState:
        z = lambda t: tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), t)
        dev = tree_leaves(params)[0].device
        return AdamWState(torch.zeros((), dtype=torch.int32, device=dev), z(params), z(params))

    def schedule(self, step):
        """Linear warmup + cosine decay to lr_min_ratio, in float32."""
        step = torch.as_tensor(step, dtype=torch.int32)
        dev = step.device
        warm = torch.clamp((step + 1) / max(1, self.warmup_steps), max=1.0)
        prog = torch.clamp((step - self.warmup_steps)
                           / max(1, self.total_steps - self.warmup_steps), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(_f32(math.pi, dev) * prog))
        return (_f32(self.lr, dev) * warm) * (_f32(self.lr_min_ratio, dev)
                                              + _f32(1 - self.lr_min_ratio, dev) * cos)

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        step = state.step + 1
        dev = step.device
        scale = None
        if self.grad_clip is not None:
            total = torch.zeros((), dtype=torch.float32, device=dev)
            for g in tree_leaves(grads):
                gf = g.reshape(-1).float()
                total = total + torch.dot(gf, gf)  # sum of squares, no leaf-sized temporary
            gnorm = torch.sqrt(total)
            scale = torch.clamp(self.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)

        stepf = step.float()
        c1 = 1 - torch.pow(_f32(self.b1, dev), stepf)
        c2 = 1 - torch.pow(_f32(self.b2, dev), stepf)
        lr = self.schedule(step)
        for p, g, mm, vv in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state.m),
                                tree_leaves(state.v)):
            for sl in _slices(p):
                self._update(p[sl], g[sl], mm[sl], vv[sl], scale, c1, c2, lr)
        return params, AdamWState(step, state.m, state.v)

    def _update(self, p, g, mm, vv, scale, c1, c2, lr):
        g = g.float() if scale is None else g.float() * scale
        b1, b2 = self.b1, self.b2
        mm.copy_(b1 * mm + (1 - b1) * g)
        vv.copy_(b2 * vv + (1 - b2) * torch.square(g))
        u = (mm / c1) / (torch.sqrt(vv / c2) + self.eps)
        if self.weight_decay:
            u = u + self.weight_decay * p.float()
        p.copy_((p.float() - lr * u).to(p.dtype))


SLICE_ELEMS = 1 << 26  # elements of one slice of a leaf's update (256 MB in f32)


def _slices(t: torch.Tensor):
    """Index ranges of ``t``'s leading dim, each of at most ``SLICE_ELEMS``
    elements (at least one row); a 0-d tensor is one slice."""
    if t.dim() == 0 or t.numel() <= SLICE_ELEMS:
        return [...]
    rows = max(1, SLICE_ELEMS // (t.numel() // t.shape[0]))
    return [slice(i, i + rows) for i in range(0, t.shape[0], rows)]
