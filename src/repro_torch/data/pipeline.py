"""Data pipeline (port of ``repro.data.pipeline``): deterministic,
stateless-seekable token streams.

``batch_at(step)`` is a pure function of (seed, step), so after a restart
at step k the pipeline resumes at exactly batch k with no replay and no
skip. Batches are numpy arrays, bitwise equal to the JAX package's for
every (seed, step); :func:`to_device` puts one on a device.

Three sources:
  * SyntheticLM     — hash-based pseudo-token stream (benchmarks, smoke)
  * SyntheticFrames — frame embeddings + frame labels (the audio family)
  * MemmapTokens    — binary token file (np.memmap), strided per step
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    """Deterministic synthetic next-token data with learnable structure
    (token t+1 = f(token t) mixture + noise) so smoke training can show a
    decreasing loss."""

    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        b, s = self.global_batch, self.seq_len
        start = rng.integers(0, self.vocab, (b, 1))
        # affine walk mod vocab => learnable bigram structure
        mult = 31 % self.vocab or 1
        steps = np.arange(s, dtype=np.int64)[None, :]
        toks = (start * pow(mult, 1, self.vocab) + 17 * steps) % self.vocab
        noise = rng.integers(0, self.vocab, (b, s))
        mask = rng.random((b, s)) < 0.05
        toks = np.where(mask, noise, toks).astype(np.int32)
        labels = np.concatenate([toks[:, 1:], toks[:, :1]], axis=1).astype(np.int32)
        return {"tokens": toks, "labels": labels}


@dataclasses.dataclass(frozen=True)
class SyntheticFrames:
    """Audio-family stand-in: frame embeddings + frame labels."""

    dim: int
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step, 1))
        b, s = self.global_batch, self.seq_len
        frames = rng.standard_normal((b, s, self.dim)).astype(np.float32)
        labels = rng.integers(0, self.vocab, (b, s)).astype(np.int32)
        return {"frames": frames, "labels": labels}


@dataclasses.dataclass(frozen=True)
class MemmapTokens:
    """Token file source: flat int32 binary, strided deterministically."""

    path: str
    seq_len: int
    global_batch: int
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "_data", np.memmap(self.path, dtype=np.int32, mode="r"))

    @property
    def n_tokens(self) -> int:
        return int(self._data.shape[0])

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        b, s = self.global_batch, self.seq_len
        n_seq = max(1, (self.n_tokens - 1) // s)
        rng = np.random.default_rng((self.seed, step))
        idx = rng.integers(0, n_seq, (b,))
        toks = np.stack([self._data[i * s:(i + 1) * s] for i in idx]).astype(np.int32)
        labels = np.stack([self._data[i * s + 1:(i + 1) * s + 1] for i in idx]).astype(np.int32)
        return {"tokens": toks, "labels": labels}


def make_source(cfg, seq_len: int, global_batch: int, seed: int = 0,
                path: Optional[str] = None):
    if path:
        return MemmapTokens(path, seq_len, global_batch, seed)
    if cfg.frontend == "audio":
        return SyntheticFrames(cfg.frontend_dim, cfg.vocab, seq_len, global_batch, seed)
    return SyntheticLM(cfg.vocab, seq_len, global_batch, seed)


def to_device(batch: Dict[str, np.ndarray], device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """A host batch as tensors on ``device`` (the card unless the caller
    names the CPU), dtypes kept. Takes the place of JAX's ``shard_batch``:
    the port has no mesh to place on."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
