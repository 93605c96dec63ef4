"""command-r-plus-104b [dense] — 64L d_model=12288 96H (GQA kv=8)
d_ff=33792 vocab=256000, no bias. [hf:CohereForAI/c4ai-command-r-v01;
unverified]"""
import dataclasses

from repro_torch.configs.registry import ArchConfig

CONFIG = ArchConfig(
    name="command-r-plus-104b", family="dense", n_layers=64, d_model=12288,
    n_heads=96, n_kv=8, d_ff=33792, vocab=256000,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=96, n_heads=6, n_kv=2, d_ff=256, vocab=256,
)
