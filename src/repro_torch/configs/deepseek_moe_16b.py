"""deepseek-moe-16b [moe] — 28L d_model=2048 16H (GQA kv=16) d_ff=1408,
vocab=102400, MoE 64 routed top-6 + 2 shared, fine-grained experts.
[arXiv:2401.06066; hf]"""
import dataclasses

from repro_torch.configs.registry import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe", n_layers=28, d_model=2048,
    n_heads=16, n_kv=16, d_ff=1408, vocab=102400,
    n_experts=64, top_k=6, n_shared_experts=2,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=48, vocab=256,
    n_experts=8, top_k=2, n_shared_experts=1,
)
