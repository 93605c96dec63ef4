"""Gradient compression (port of ``repro.optim.grad_compress``): int8
block-quantized gradients with error feedback.

Each tensor is scaled per block of 256 values and quantized to int8; the
mean across ranks runs on the dequantized float32 values (a sum of int8
payloads would overflow), so the wire format is the int8 payload plus the
scales, and error feedback keeps the quantization noise from biasing
convergence. Payloads and scales are bitwise the JAX package's: both
round half to even.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.spec import tree_map

BLOCK = 256


def _pad_to_block(x: torch.Tensor):
    n = x.numel()
    return F.pad(x.reshape(-1), (0, (-n) % BLOCK)), n


def quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """g -> (int8 payload (n_blocks, 256), float32 per-block scales (n_blocks, 1))."""
    flat, _ = _pad_to_block(g.float())
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    q = torch.round(blocks / torch.clamp(scale, min=1e-12)).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, shape, dtype) -> torch.Tensor:
    deq = (q.float() * scale).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return deq[:n].reshape(shape).to(dtype)


def compress_tree(grads, errors=None):
    """Quantize a gradient tree with error feedback.

    Returns (payload_tree, new_error_tree) where payload leaves are
    (int8, scales) tuples."""
    if errors is None:
        errors = tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32), grads)

    def one(g, e):
        corrected = g.float() + e
        q, s = quantize(corrected)
        return (q, s), corrected - dequantize(q, s, g.shape, torch.float32)

    pairs = tree_map(one, grads, errors)
    return _part(pairs, 0), _part(pairs, 1)


def _part(tree, i: int):
    """Item ``i`` of every (payload, error) leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: _part(v, i) for k, v in tree.items()}
    return tree[i]


def decompress_tree(payload, shapes_like):
    return tree_map(lambda ref, qs: dequantize(qs[0], qs[1], ref.shape, ref.dtype),
                    shapes_like, payload)


def compressed_psum(grads, group=None, errors=None):
    """Cross-rank gradient mean with the int8 wire format + error feedback.

    ``torch.distributed.all_reduce`` of the dequantized float32 leaves
    followed by a division by the world size takes the place of JAX's
    ``lax.pmean``. ``group`` is a process group (the default group when
    None). A process that has not joined a group is the only rank: its
    mean is the dequantized tree."""
    import torch.distributed as dist

    payload, new_errors = compress_tree(grads, errors)
    deq = decompress_tree(payload, grads)
    if group is None and not dist.is_initialized():
        return deq, new_errors
    world = dist.get_world_size(group)

    def mean(g):
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
        return g / world

    return tree_map(mean, deq), new_errors
