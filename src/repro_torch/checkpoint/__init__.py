"""repro_torch.checkpoint — atomic, checksummed checkpoints (port of
``repro.checkpoint``), in the JAX package's on-disk layout."""
