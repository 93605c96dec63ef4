"""internvl2-26b [vlm] — 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553 — InternViT + InternLM2 backbone. [arXiv:2404.16821; hf]

Per the assignment the ViT frontend is a STUB: input_specs() provides
precomputed patch embeddings (B, 256, 1024) which are projected and
prepended to the token sequence. vocab padded 92553 -> 92672 (x256) for TP.
"""
import dataclasses

from repro_torch.configs.registry import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b", family="vlm", n_layers=48, d_model=6144,
    n_heads=48, n_kv=8, d_ff=16384, vocab=92553,
    frontend="vision", frontend_dim=1024, n_patches=256,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=96, n_heads=6, n_kv=2, d_ff=256, vocab=256,
    frontend_dim=32, n_patches=8,
)
