"""mamba2-2.7b [ssm] — 64L d_model=2560 (attention-free) vocab=50280,
ssm_state=128 — SSD (state-space duality). [arXiv:2405.21060; unverified]

§Arch-applicability: attention-format selection is inapplicable (attention
free); the SSD scan is dense. Runs long_500k natively (O(1) decode state).
"""
import dataclasses

from repro_torch.configs.registry import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b", family="ssm", n_layers=64, d_model=2560,
    n_heads=0, n_kv=0, d_ff=0, vocab=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, vocab=256, ssm_state=16, ssm_head_dim=16,
    ssm_chunk=32,
)
