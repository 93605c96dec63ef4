"""Assigned input-shape cells and their skip rules (port of
``repro.configs.shapes``, its pure-Python part).

  train_4k      seq 4096,    global_batch 256   -> train_step
  prefill_32k   seq 32768,   global_batch 32    -> prefill (serve)
  decode_32k    seq 32768,   global_batch 128   -> serve_step (1 token, KV cache)
  long_500k     seq 524288,  global_batch 1     -> serve_step, sub-quadratic only

The abstract input builders of the dry-run (``input_specs``,
``token_input_specs``) come with the launch plumbing.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

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
