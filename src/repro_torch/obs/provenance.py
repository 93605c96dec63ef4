"""Run provenance: the environment fingerprint every artifact carries (port
of ``repro.obs.provenance``).

``env_info()`` collects the facts that decide whether two measurements are
comparable: the torch and CUDA versions, the backend, the card's name,
count and power limit (a card set below its maximum runs slower under
load), and the git revision of the code that ran. The keys
``backend``/``device_kind``/``interpret_mode`` are the ones
``repro_torch.obs.regress`` compares, as the JAX package's gate does.
"""
from __future__ import annotations

import os
import platform
import subprocess
import sys
from typing import Optional


def git_rev(cwd: Optional[str] = None) -> Optional[str]:
    """Short git revision of the running checkout (None outside a repo)."""
    if cwd is None:
        cwd = os.path.dirname(os.path.abspath(__file__))
    try:
        out = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             cwd=cwd, capture_output=True, text=True,
                             timeout=5)
        rev = out.stdout.strip()
        return rev if out.returncode == 0 and rev else None
    except (OSError, subprocess.SubprocessError):
        return None


def power_limit() -> Optional[str]:
    """The first card's power limit as ``nvidia-smi`` reports it
    (``"700.00 W"``), or None where there is no ``nvidia-smi``."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=10)
        lines = out.stdout.strip().splitlines()
        return lines[0].strip() if out.returncode == 0 and lines else None
    except (OSError, subprocess.SubprocessError):
        return None


def env_info() -> dict:
    """Environment and provenance dict for every benchmark artifact.

    Always JSON-serializable; a failure degrades to a None field, never to
    an exception. ``interpret_mode`` is always False: the port's kernels
    have no interpret mode (off the card the wrappers run their plain
    versions, which the ``backend`` field says).
    """
    torch_version = cuda_version = None
    backend, device_kind, device_count = "cpu", "cpu", 1
    try:
        import torch

        torch_version = torch.__version__
        cuda_version = torch.version.cuda
        if torch.cuda.is_available():
            backend = "cuda"
            device_count = torch.cuda.device_count()
            device_kind = torch.cuda.get_device_name(0)
    except Exception:  # a broken install still yields a fingerprint
        backend, device_kind, device_count = None, None, 0
    return {
        "torch_version": torch_version,
        "cuda_version": cuda_version,
        "backend": backend,
        "device_kind": device_kind,
        "device_count": device_count,
        "power_limit": power_limit() if backend == "cuda" else None,
        "interpret_mode": False,
        "trace_mode": os.environ.get("REPRO_TRACE") or "off",
        "git_rev": git_rev(),
        "python": sys.version.split()[0],
        "platform": platform.platform(),
    }
