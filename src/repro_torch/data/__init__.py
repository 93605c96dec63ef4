"""repro_torch.data — deterministic token streams (port of ``repro.data``)."""
