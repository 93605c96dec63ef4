"""repro_torch.models — model layers (port of ``repro.models``).

Ported so far: :class:`LinearSparse`, the linear layer over a dynamic
sparse weight, with ``prune_magnitude`` and ``WEIGHT_CANDIDATES``.
"""
from repro_torch.models.linear_sparse import LinearSparse, WEIGHT_CANDIDATES, prune_magnitude

__all__ = ["LinearSparse", "WEIGHT_CANDIDATES", "prune_magnitude"]
