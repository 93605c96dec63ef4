"""Process settings of the port, applied before the first GEMM on the card
(port of ``repro.env``).

The JAX module sets ``XLA_FLAGS`` before JAX starts its backend. The port's
counterparts are the settings that PyTorch and cuBLAS read:

* ``CUBLAS_WORKSPACE_CONFIG``: cuBLAS reads it once, when the process's
  first handle is made (its first GEMM). ``torch.use_deterministic_algorithms``
  refuses cuBLAS without one of its deterministic settings, so :func:`apply`
  sets ``:4096:8`` where the caller has set nothing, and keeps a caller's
  value.
* TF32: on ``cuda`` :func:`apply` turns it off for matmuls and cuDNN, so
  float32 products are float32 (the port's parity checks hold float32 to
  float64 bounds).

This module imports nothing at module level; ``torch`` is imported inside
the functions that read or set its switches. Entry points call
:func:`apply` first thing::

    from repro_torch import env
    env.apply()              # the card: workspace setting, TF32 off
    import torch             # (or torch already imported, CUDA not yet used)

:func:`describe` reports what was applied and the live TF32 switches, for
the provenance of a benchmark's records.
"""
from __future__ import annotations

import os
import sys
import warnings
from typing import Dict, Optional

WORKSPACE_VAR = "CUBLAS_WORKSPACE_CONFIG"
WORKSPACE = ":4096:8"

_applied: Optional[Dict[str, object]] = None


def resolve_backend(backend: Optional[str] = None) -> str:
    """Explicit argument > ``REPRO_BACKEND`` > ``"cuda"``: the port's entry
    points run on the card unless asked otherwise."""
    if backend:
        return backend.lower()
    v = os.environ.get("REPRO_BACKEND")
    if v:
        return v.split(",")[0].strip().lower()
    return "cuda"


def _cuda_initialized() -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and torch.cuda.is_initialized()


def _tf32() -> Dict[str, Optional[bool]]:
    torch = sys.modules.get("torch")
    if torch is None:
        return {"matmul": None, "cudnn": None}
    return {"matmul": bool(torch.backends.cuda.matmul.allow_tf32),
            "cudnn": bool(torch.backends.cudnn.allow_tf32)}


def apply(backend: Optional[str] = None,
          host_devices: Optional[int] = None) -> Dict[str, object]:
    """Set the process settings for ``backend`` (see :func:`resolve_backend`).

    ``host_devices`` is recorded only: the JAX package forces N host devices
    for its SPMD harness, while the port runs P shards in one process on
    one device and needs no forced devices.

    Idempotent. Warns when CUDA is already initialised in this process:
    cuBLAS may have read the workspace setting already (the environment is
    still set, for child processes).
    """
    global _applied
    bk = resolve_backend(backend)
    caller_value = os.environ.get(WORKSPACE_VAR)
    late = _cuda_initialized()
    if late:
        warnings.warn(
            "repro_torch.env.apply() called after CUDA was initialised: cuBLAS "
            f"may already have read {WORKSPACE_VAR} (child processes will see it).",
            RuntimeWarning, stacklevel=2)
    os.environ.setdefault(WORKSPACE_VAR, WORKSPACE)
    if bk == "cuda":
        import torch
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    _applied = {"backend": bk, "host_devices": host_devices,
                WORKSPACE_VAR: os.environ[WORKSPACE_VAR],
                "workspace_from": "caller" if caller_value is not None else "env.apply",
                "cuda_initialized_before": late}
    return describe()


def describe() -> Dict[str, object]:
    """What :func:`apply` last did, and the live TF32 switches (None where
    torch is not imported); reads the live environment when :func:`apply`
    was never called in this process."""
    if _applied is not None:
        out = dict(_applied)
    else:
        out = {"backend": resolve_backend(), "host_devices": None,
               WORKSPACE_VAR: os.environ.get(WORKSPACE_VAR), "workspace_from": None,
               "cuda_initialized_before": None}
    out["tf32"] = _tf32()
    return out
