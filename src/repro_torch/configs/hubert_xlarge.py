"""hubert-xlarge [audio] — 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504,
encoder-only (w2v2-style backbone). [arXiv:2106.07447; unverified]

Per the assignment the modality frontend is a STUB: input_specs() provides
precomputed frame embeddings (B, S, 512); the conv feature extractor is out
of scope. Encoder-only => no decode shapes (skip recorded in DESIGN.md).
Positional encoding uses RoPE in place of HuBERT's conv-pos embedding
(modernisation; noted in DESIGN.md §8).
"""
import dataclasses

from repro_torch.configs.registry import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge", family="audio", n_layers=48, d_model=1280,
    n_heads=16, n_kv=16, d_ff=5120, vocab=504, mlp_act="gelu",
    encoder_only=True, frontend="audio", frontend_dim=512,
    vocab_pad=8,  # 504 -> 504 (tiny head; replicated under TP anyway)
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=160, vocab=32,
    frontend_dim=24,
)
