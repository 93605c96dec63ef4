"""qwen1.5-32b [dense] — 64L d_model=5120 40H (GQA kv=40) d_ff=27392
vocab=152064, QKV bias. [hf:Qwen/Qwen1.5-0.5B family; hf]"""
import dataclasses

from repro_torch.configs.registry import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b", family="dense", n_layers=64, d_model=5120,
    n_heads=40, n_kv=40, d_ff=27392, vocab=152064, qkv_bias=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=160, vocab=256,
)
