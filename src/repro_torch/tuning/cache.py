"""Persistent on-disk selection cache (port of ``repro.tuning.cache``).

Selections are keyed by *pattern signature x backend x device kind x
candidate set* (and, for the batched ops, the op and rhs-width bucket): the
winning format is a property of (sparsity pattern, hardware), so a selection
learned on one device must never be replayed on another, while a restarted
process on the same device pays no re-selection cost.

The store is a flat JSON dict written atomically (tmp + rename), merged with
what is on disk at each flush; a corrupt or missing file reads as an empty
cache, never as an error. The file format, the keys and both value schemas
are the JAX package's, so a file that either package writes loads in the
other:

* v1 — a bare format name (``"DIA"``), written by :meth:`SelectionCache.put`;
* v2 — a *(format, backend, kernel config, mode tag)* decision,
  ``"v2|ELL|cuda|cuda-native|{\\"vec\\": 32}"`` (:func:`encode_decision`).
  The tag is ``repro_torch.tuning.kernel_tune.backend_tag()`` of the process
  that pinned the (backend, cfg): a reader never replays a pin made under
  another tag (a JAX ``cpu-interp`` pin never routes the port's kernels).

The ``kernel:`` key namespace (raw JSON values, ``kernel_tune``) rides the
same store through :meth:`get_raw` / :meth:`put_raw`.
"""
from __future__ import annotations

import hashlib
import json
import os
import warnings
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.core.formats import Format
from repro_torch.obs import metrics as _metrics
from repro_torch.tuning.features import PatternFeatures

CACHE_PATH_ENV = "REPRO_TUNING_CACHE"
DECISION_PREFIX = "v2|"
# Flushes written by any store of this process: a reader holding a file's
# contents re-reads it when this moved, with no file-system call.
FLUSHES = 0


def encode_decision(fmt: Format, backend: Optional[str] = None,
                    cfg: Optional[dict] = None, tag: Optional[str] = None) -> str:
    """Serialize a (format, backend, kernel cfg, mode tag) decision (v2)."""
    return (f"{DECISION_PREFIX}{Format(fmt).name}|{backend or ''}|{tag or ''}|"
            f"{json.dumps(cfg, sort_keys=True) if cfg else ''}")


def decode_decision(value: str) -> Tuple[Optional[Format], Optional[str],
                                         Optional[dict], Optional[str]]:
    """``(format, backend, cfg, tag)`` of a stored value of either schema;
    backend, cfg and tag are None for v1 values or empty v2 fields. An
    unknown format decodes to all None (a stale entry)."""
    backend = cfg = tag = None
    name = value
    if value.startswith(DECISION_PREFIX):
        try:
            name, backend_s, tag_s, cfg_s = value[len(DECISION_PREFIX):].split("|", 3)
        except ValueError:
            return None, None, None, None
        backend, tag = backend_s or None, tag_s or None
        if cfg_s:
            try:
                cfg = json.loads(cfg_s)
            except ValueError:
                cfg = None
    try:
        return Format[name], backend, cfg, tag
    except KeyError:
        return None, None, None, None


def default_cache_path() -> str:
    """``$REPRO_TUNING_CACHE``, else ``$XDG_CACHE_HOME`` (or ``~/.cache``)
    ``/repro-tuning/selections.json``: the JAX package's default too."""
    env = os.environ.get(CACHE_PATH_ENV)
    if env:
        return env
    base = os.environ.get("XDG_CACHE_HOME", os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(base, "repro-tuning", "selections.json")


def pattern_signature(feats: PatternFeatures, digits: int = 4) -> str:
    """Stable short hash of the quantized feature vector and the exact
    (m, n, nnz): the JAX package's signature of the same pattern."""
    payload = ",".join(f"{v:.{digits}e}" for v in feats.vector())
    payload += f"|{feats.m}x{feats.n}|{feats.nnz}"
    return hashlib.sha1(payload.encode()).hexdigest()[:16]


class SelectionCache:
    """Dict-on-disk of selection keys -> decisions (and ``kernel:`` records)."""

    def __init__(self, path: Optional[str] = None, autoflush: bool = True):
        self.path = path or default_cache_path()
        self.autoflush = autoflush
        self._data: Optional[Dict[str, str]] = None
        self._write_failed = False

    def _load(self) -> Dict[str, str]:
        if self._data is None:
            self._data = self._read_disk()
        return self._data

    def _read_disk(self) -> Dict[str, str]:
        try:
            with open(self.path) as f:
                raw = json.load(f)
        except (OSError, ValueError):
            return {}
        if not isinstance(raw, dict):
            return {}
        return {str(k): str(v) for k, v in raw.items()}

    def flush(self) -> None:
        """Write the store, merged over what is on disk now (concurrent
        writers lose only true per-key races). An unwritable path warns once
        and leaves the cache in memory."""
        global FLUSHES
        if self._data is None:
            return
        try:
            self._data = {**self._read_disk(), **self._data}
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            tmp = f"{self.path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(self._data, f, indent=0, sort_keys=True)
            os.replace(tmp, self.path)
            FLUSHES += 1
        except OSError as e:
            if not self._write_failed:
                self._write_failed = True
                warnings.warn(f"selection cache not persistable at {self.path!r}: {e}")

    def clear(self) -> None:
        self._data = {}
        if self.autoflush:
            self.flush()

    def __len__(self) -> int:
        return len(self._load())

    @staticmethod
    def key(feats: PatternFeatures, candidates: Sequence[Format], backend: str,
            device_kind: str, op_ctx: str = "") -> str:
        """``op_ctx`` carries the operation context (``"spmm_t-b8"``: op and
        rhs-width bucket); empty for SpMV."""
        cand = "-".join(Format(c).name for c in candidates)
        base = f"{pattern_signature(feats)}|{backend}|{device_kind}|{cand}"
        return f"{base}|{op_ctx}" if op_ctx else base

    def get(self, key: str) -> Optional[Format]:
        value = self._load().get(key)
        fmt = decode_decision(value)[0] if value is not None else None
        _metrics.inc("selection.cache_hit" if fmt is not None else "selection.cache_miss")
        return fmt

    def put(self, key: str, fmt: Format) -> None:
        self._load()[key] = Format(fmt).name
        if self.autoflush:
            self.flush()

    def get_decision(self, key: str) -> Optional[Tuple[Format, Optional[str],
                                                       Optional[dict], Optional[str]]]:
        """``(format, backend, cfg, tag)``, or None (counted as a miss) for
        an absent or stale entry."""
        value = self._load().get(key)
        decision = decode_decision(value) if value is not None else (None,)
        if decision[0] is None:
            _metrics.inc("selection.cache_miss")
            return None
        _metrics.inc("selection.cache_hit")
        return decision

    def put_decision(self, key: str, fmt: Format, backend: Optional[str] = None,
                     cfg: Optional[dict] = None, tag: Optional[str] = None) -> None:
        self._load()[key] = encode_decision(fmt, backend, cfg, tag)
        if self.autoflush:
            self.flush()

    def get_raw(self, key: str) -> Optional[str]:
        return self._load().get(key)

    def put_raw(self, key: str, value: str) -> None:
        self._load()[key] = str(value)
        if self.autoflush:
            self.flush()
