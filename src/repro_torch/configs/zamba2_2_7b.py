"""zamba2-2.7b [hybrid] — 54L d_model=2560 32H (kv=32) d_ff=10240
vocab=32000, ssm_state=64 — Mamba2 backbone + shared attention block.
[arXiv:2411.15242; hf]

The shared transformer block (attention + MLP, one parameter set) is
applied after every 6 Mamba2 blocks (9 applications over 54 layers).
Zamba2's concatenated-embedding input to the shared block is simplified to
a standard residual application (DESIGN.md §8).
"""
import dataclasses

from repro_torch.configs.registry import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
    n_heads=32, n_kv=32, d_ff=10240, vocab=32000,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, attn_every=6,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv=4, d_ff=160, vocab=256,
    ssm_state=16, ssm_head_dim=16, attn_every=2, ssm_chunk=32,
)
