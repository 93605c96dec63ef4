"""minitron-8b [dense] — 32L d_model=4096 32H (GQA kv=8) d_ff=16384
vocab=256000 — pruned nemotron. [arXiv:2407.14679; hf]

Pruned-model note (DESIGN.md §4): Minitron is the arch where the paper's
technique applies to *weights* — serving its pruned linears as dynamic
sparse matrices (LinearSparse / BSR) is supported by the model stack.
"""
import dataclasses

from repro_torch.configs.registry import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b", family="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv=8, d_ff=16384, vocab=256000, head_dim=128,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=160, vocab=256,
    head_dim=16,
)
