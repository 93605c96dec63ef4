"""What a run must not load, and the card it must have."""
from __future__ import annotations

import sys
from typing import Iterable, List

# Top-level module names a run may not hold: JAX and the JAX package of
# this repository (``repro``; its port ``repro_torch`` is another name).
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# Top-level names the reference may not import: the above and the port.
REFERENCE_FORBIDDEN = FORBIDDEN + ("repro_torch",)


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(modules: Iterable[str] = None, forbidden=FORBIDDEN) -> List[str]:
    """The loaded modules whose whole top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    bad = set(forbidden)
    return sorted(m for m in names if top_level(m) in bad)


def require_cuda(chips: int) -> str:
    """The card's name; raises where torch sees no card or fewer than
    ``chips`` cards. There is no fallback to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise RuntimeError(f"the cell needs {chips} cards, torch sees "
                           f"{torch.cuda.device_count()}")
    return torch.cuda.get_device_name(0)
