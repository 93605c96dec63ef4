"""repro_torch.launch — entry points (port of ``repro.launch``).

Ported so far: :mod:`repro_torch.launch.serve` (``DecodeEngine``, ``serve``,
``python -m repro_torch.launch.serve``).
"""
