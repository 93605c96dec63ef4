"""Checkpointing (port of ``repro.checkpoint.ckpt``), in the JAX package's
on-disk layout, so a checkpoint either package writes restores in the
other:

  <dir>/step_<k:08d>/manifest.json   leaf count, shapes, dtypes, checksums
  <dir>/step_<k:08d>/arr_<i:05d>.npy one file per leaf

Leaves are flattened in JAX's order: dict keys sorted, a tuple's or
NamedTuple's fields in order, None holding no leaf; so
``TrainState(params, AdamWState(step, m, v))`` flattens as JAX's does. A
bf16 leaf is stored as its ``uint8`` byte view with ``"bfloat16"`` in the
manifest, as JAX stores it.

Fault-tolerance properties:
  * atomic publish: leaf files and the manifest (fsync'd) are written into
    ``step_<k>.tmp``, which is then renamed — a crash mid-write leaves no
    ``step_<k>`` directory with a manifest, and ``latest_step`` skips it;
  * per-file CRC32 checksums catch torn writes on restore;
  * restore checks the leaf count and every shape against ``like``.

The manifest's ``treedef`` holds JAX's tree string when JAX wrote it and
the port's own fingerprint (``repro_torch:...``) when the port did;
neither package reads it back.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import zlib
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def _is_node(tree) -> bool:
    return tree is None or isinstance(tree, (dict, tuple, list))


def _children(tree) -> List:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    return list(tree)


def _flatten(tree) -> List:
    if not _is_node(tree):
        return [tree]
    return [leaf for c in _children(tree) for leaf in _flatten(c)]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if not _is_node(like):
        return next(leaves)
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    kids = [_unflatten(c, leaves) for c in like]
    if isinstance(like, list):
        return kids
    return type(like)(*kids) if hasattr(like, "_fields") else tuple(kids)


def _fingerprint(tree) -> str:
    if not _is_node(tree):
        return "*"
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_fingerprint(tree[k])}" for k in sorted(tree)) + "}"
    inner = ", ".join(_fingerprint(c) for c in tree)
    return f"{type(tree).__name__}({inner})"


def _host(leaf) -> np.ndarray:
    """A leaf as the numpy array JAX would save: bf16 as its byte view."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint8).numpy()
        return t.numpy()
    return np.asarray(leaf)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return str(np.asarray(leaf).dtype)


def _crc(path: str) -> int:
    with open(path, "rb") as f:
        return zlib.crc32(f.read())


def save(ckpt_dir: str, step: int, tree: Any) -> str:
    """Write checkpoint for ``step``; returns the step directory."""
    stepdir = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmpdir = stepdir + ".tmp"
    os.makedirs(tmpdir, exist_ok=True)
    flat = _flatten(tree)
    manifest = {"step": step, "n_leaves": len(flat),
                "treedef": "repro_torch:" + _fingerprint(tree), "leaves": []}
    for i, leaf in enumerate(flat):
        path = os.path.join(tmpdir, f"arr_{i:05d}.npy")
        np.save(path, _host(leaf))
        manifest["leaves"].append({"file": os.path.basename(path),
                                   "shape": list(leaf.shape), "dtype": _dtype_name(leaf),
                                   "crc32": _crc(path)})
    mpath = os.path.join(tmpdir, "manifest.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmpdir, stepdir)  # atomic publish
    return stepdir


def _steps(ckpt_dir: str) -> List[str]:
    return [name for name in os.listdir(ckpt_dir) if re.fullmatch(r"step_(\d+)", name)]


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(name[5:]) for name in _steps(ckpt_dir)
             if os.path.exists(os.path.join(ckpt_dir, name, "manifest.json"))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like: Any, device: DeviceLike = None) -> Any:
    """Restore into the structure of ``like`` (tensors, meta tensors or
    arrays: only their shapes are read) as tensors on ``device`` (the card
    unless the caller names the CPU), each in the dtype the manifest names."""
    dev = resolve_device(device)
    stepdir = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(stepdir, "manifest.json")) as f:
        manifest = json.load(f)
    flat_like = _flatten(like)
    if manifest["n_leaves"] != len(flat_like):
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                         f"target structure has {len(flat_like)}")
    out = []
    for i, (meta, ref) in enumerate(zip(manifest["leaves"], flat_like)):
        path = os.path.join(stepdir, meta["file"])
        if _crc(path) != meta["crc32"]:
            raise IOError(f"checksum mismatch in {path} (torn write?)")
        t = torch.from_numpy(np.load(path))
        if meta["dtype"] == "bfloat16":
            t = t.view(torch.bfloat16)
        if list(t.shape) != list(ref.shape):
            raise ValueError(f"leaf {i}: shape {tuple(t.shape)} != {tuple(ref.shape)}")
        out.append(t.to(dev))
    return _unflatten(like, iter(out))


def cleanup(ckpt_dir: str, keep: int = 3):
    """Retain the newest ``keep`` steps (bounded disk for long runs)."""
    if not os.path.isdir(ckpt_dir):
        return
    for s in sorted(int(name[5:]) for name in _steps(ckpt_dir))[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)
