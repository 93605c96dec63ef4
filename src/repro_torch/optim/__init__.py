"""repro_torch.optim — AdamW and gradient compression (port of ``repro.optim``)."""
