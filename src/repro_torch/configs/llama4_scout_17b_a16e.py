"""llama4-scout-17b-a16e [moe] — 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16e top-1 (+1 shared expert), early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
import dataclasses

from repro_torch.configs.registry import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe", n_layers=48, d_model=5120,
    n_heads=40, n_kv=8, d_ff=8192, vocab=202048,
    n_experts=16, top_k=1, n_shared_experts=1,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=96, vocab=256,
    n_experts=4, top_k=1, n_shared_experts=1,
)
