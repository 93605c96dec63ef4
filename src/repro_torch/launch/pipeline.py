"""Pipeline parallelism: the GPipe microbatch schedule over a 'stage' axis
(port of ``repro.launch.pipeline``).

Each stage owns L/S contiguous layers of the layer-stacked params. The
schedule runs M + S - 1 ticks; at tick t stage s works on microbatch t - s
(bubble fraction (S-1)/(M+S-1)). The stage body is rematerialised
(``torch.utils.checkpoint``, as JAX's ``jax.checkpoint(stage_fn)``), so
saved activations stay one tensor a (stage, microbatch) pair, not one a
layer. Gradients come from autograd through the schedule.

All S stages run in one process on one device, and the hand-off between
neighbouring stages is the tensor itself (JAX's ``ppermute`` inside
``shard_map``). JAX computes every stage at every tick and zeroes the
pairs outside the schedule (its masked ``where``); here those
(S-1)·S pairs are skipped. A zeroed pair reaches no output and its
cotangent is zero, so outputs and gradients are the same. On one device
the tick order gives the same results as running each microbatch through
the stages in turn; it is kept so that a rank-per-stage version runs the
same pairs at the same ticks. A rank-per-stage
hand-off (point-to-point over NCCL) waits for a host with more than one
card.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.spec import tree_map


def schedule(n_stages: int, n_micro: int) -> list:
    """The GPipe ticks: for each of the M + S - 1 ticks, the (stage,
    microbatch) pairs it runs, stage s on microbatch t - s."""
    return [[(s, t - s) for s in range(n_stages) if 0 <= t - s < n_micro]
            for t in range(n_micro + n_stages - 1)]


def _stage_slabs(params_staged, n_stages: int) -> list:
    """Stage ``i``'s slab of every leaf, by one ``unbind`` a leaf (its
    backward stacks the stages' gradients once)."""
    cols = tree_map(lambda a: a.unbind(0), params_staged)
    return [tree_map(lambda c: c[i], cols) for i in range(n_stages)]


def pipeline_apply(stage_fn: Callable, params_staged, x_micro: torch.Tensor, mesh,
                   axis: str = "stage") -> torch.Tensor:
    """Run microbatches through the stage pipeline.

    stage_fn(params_slab, x) -> x        one stage's compute (L/S layers)
    params_staged: tree, leaves (S, ...) — one slab a stage
    x_micro: (M, mb, ...) microbatched activations
    mesh: its ``shape[axis]`` is S.
    Returns the (M, mb, ...) outputs of the LAST stage.
    """
    s = int(mesh.shape[axis])
    slabs = _stage_slabs(params_staged, s)
    h = list(x_micro.unbind(0))  # each microbatch's activation, where it now stands
    for pairs in schedule(s, x_micro.shape[0]):
        for stage, mb in pairs:  # stage - 1 ran microbatch mb at the tick before
            h[mb] = checkpoint(stage_fn, slabs[stage], h[mb], use_reentrant=False)
    return torch.stack(h)


def stage_params(params_stacked, n_stages: int):
    """Reshape (L, ...) layer-stacked params to (S, L/S, ...) stage slabs."""
    def one(a):
        l = a.shape[0]
        if l % n_stages:
            raise ValueError(f"{l} layers do not split into {n_stages} stages")
        return a.reshape((n_stages, l // n_stages) + tuple(a.shape[1:]))
    return tree_map(one, params_stacked)
