"""repro_torch.launch — entry points and their plumbing (port of
``repro.launch``).

:mod:`~repro_torch.launch.serve` (``DecodeEngine``, ``python -m
repro_torch.launch.serve``), :mod:`~repro_torch.launch.train` (``python -m
repro_torch.launch.train``), :mod:`~repro_torch.launch.mesh` (mesh
descriptors), :mod:`~repro_torch.launch.sharding` (the sharding rules),
:mod:`~repro_torch.launch.dryrun` (the production-mesh dry-run on the meta
device) and :mod:`~repro_torch.launch.pipeline` (the GPipe schedule).
"""
