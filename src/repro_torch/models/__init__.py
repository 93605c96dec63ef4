"""repro_torch.models — model stack (port of ``repro.models``).

Ported so far: :class:`LinearSparse`, the linear layer over a dynamic
sparse weight, with ``prune_magnitude`` and ``WEIGHT_CANDIDATES``; and the
serving half of every model family: ``spec``, ``layers``, ``flash``
(forward), ``attention``, ``moe``, ``mamba2``, ``sharding_ctx``,
``transformer``, ``model`` (:class:`Model`, :func:`build_model`) and
``weights`` (param and cache trees across packages).
"""
from repro_torch.models.linear_sparse import LinearSparse, WEIGHT_CANDIDATES, prune_magnitude
from repro_torch.models.model import Model, build_model

__all__ = ["LinearSparse", "WEIGHT_CANDIDATES", "prune_magnitude", "Model", "build_model"]
