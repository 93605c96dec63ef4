"""Assigned input-shape cells and abstract input specs for the dry-run (port
of ``repro.configs.shapes``).

  train_4k      seq 4096,    global_batch 256   -> train_step
  prefill_32k   seq 32768,   global_batch 32    -> prefill (serve)
  decode_32k    seq 32768,   global_batch 128   -> serve_step (1 token, KV cache)
  long_500k     seq 524288,  global_batch 1     -> serve_step, sub-quadratic only

``input_specs`` returns meta-device tensors only (shapes and dtypes, no
storage), with the JAX package's shapes and the torch dtypes of its dtypes.
``skip_reason`` encodes the assignment's skip rules.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.configs.registry import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}

SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def skip_reason(cfg: ArchConfig, shape: str) -> Optional[str]:
    cell = SHAPES[shape]
    if cell.name == "long_500k" and cfg.family not in SUBQUADRATIC_FAMILIES:
        return "long_500k needs sub-quadratic attention; pure full-attention arch (per assignment)"
    if cfg.encoder_only and cell.kind == "decode":
        return "encoder-only arch has no decode step (per assignment)"
    return None


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def token_input_specs(cfg: ArchConfig, cell: ShapeCell,
                      with_labels: bool) -> Dict[str, torch.Tensor]:
    b, s = cell.global_batch, cell.seq_len
    i32 = torch.int32
    if cfg.frontend == "audio":
        out = {"frames": _meta((b, s, cfg.frontend_dim), torch.bfloat16)}
    elif cfg.frontend == "vision":
        np_ = cfg.n_patches
        out = {"patches": _meta((b, np_, cfg.frontend_dim), torch.bfloat16),
               "tokens": _meta((b, s - np_), i32)}
    else:
        out = {"tokens": _meta((b, s), i32)}
    if with_labels:
        out["labels"] = _meta((b, s), i32)
    return out


def input_specs(cfg: ArchConfig, shape: str, model=None) -> dict:
    """Abstract inputs for the (arch x shape) cell.

    train:   {batch: {tokens/frames/patches, labels}}
    prefill: {batch: {tokens/...}}
    decode:  {cache, tokens (B,), pos (B,)}
    """
    cell = SHAPES[shape]
    if cell.kind == "train":
        return {"batch": token_input_specs(cfg, cell, with_labels=True)}
    if cell.kind == "prefill":
        return {"batch": token_input_specs(cfg, cell, with_labels=False)}
    # decode: one new token against a seq_len cache
    from repro_torch.models.model import build_model
    model = model or build_model(cfg)
    b = cell.global_batch
    return {"cache": model.cache_specs(b, cell.seq_len),
            "tokens": _meta((b,), torch.int32),
            "pos": _meta((b,), torch.int32)}
