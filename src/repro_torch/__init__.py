"""repro_torch — the PyTorch/CUDA port of the dynamic-sparse-matrix library.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``core/``, ``kernels/``, ``tuning/``, ``obs/``) and module names so each
counterpart is found at the same path. Containers are frozen dataclasses of
torch tensors; the hot SpMV formats (CSR, DIA) run hand-written CUDA kernels
for Hopper (``csrc/``), built at first use with ``nvcc``.

Entry points take ``device=None``, meaning ``"cuda"``; without a card they
raise unless the caller passes ``device="cpu"`` (see :mod:`repro_torch.device`).

    python -m repro_torch.hpcg_solve --grid 104 104 104
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
