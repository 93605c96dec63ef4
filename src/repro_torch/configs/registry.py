"""Architecture config schema + registry (``--arch <id>`` selection).

A copy of ``repro.configs.registry``: the port keeps its own configs so that
it imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | audio | hybrid | ssm | vlm
    n_layers: int
    d_model: int
    n_heads: int  # 0 => attention-free
    n_kv: int
    d_ff: int
    vocab: int
    qkv_bias: bool = False
    head_dim: Optional[int] = None
    mlp_act: str = "swiglu"  # swiglu | gelu
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    moe_dispatch: str = "sort"  # dense | sort | bsr (dynamic-format selectable)
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    # --- hybrid (zamba2): one shared attention block every k SSM blocks ---
    attn_every: int = 0
    # --- modality frontends (stubs per assignment) ---
    frontend: Optional[str] = None  # audio | vision
    frontend_dim: int = 0
    n_patches: int = 0
    encoder_only: bool = False
    # --- misc ---
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    vocab_pad: int = 256  # pad vocab to a multiple (TP divisibility)
    dtype: str = "bfloat16"

    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(1, self.n_heads)

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab, self.vocab_pad)

    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def n_params(self) -> int:
        """Analytic parameter count (for 6·N·D roofline checks)."""
        d, L = self.d_model, self.n_layers
        emb = self.padded_vocab * d * (1 if self.encoder_only else 2)
        per_layer = 0
        if self.family in ("dense", "moe", "audio", "vlm"):
            hd = self.hd
            attn = d * self.n_heads * hd + 2 * d * self.n_kv * hd + self.n_heads * hd * d
            if self.qkv_bias:
                attn += (self.n_heads + 2 * self.n_kv) * hd
            if self.family == "moe":
                e_ff = 3 * d * self.d_ff
                mlp = (self.n_experts + self.n_shared_experts) * e_ff + d * self.n_experts
            elif self.mlp_act == "swiglu":
                mlp = 3 * d * self.d_ff
            else:
                mlp = 2 * d * self.d_ff
            per_layer = attn + mlp + 2 * d
        elif self.family == "ssm":
            di, ds, nh = self.d_inner, self.ssm_state, self.ssm_heads
            per_layer = (d * (2 * di + 2 * ds + nh)  # in_proj (z,x,B,C,dt)
                         + (di + 2 * ds) * self.ssm_conv + di * d + 2 * d + 3 * nh)
        elif self.family == "hybrid":
            di, ds, nh = self.d_inner, self.ssm_state, self.ssm_heads
            per_layer = (d * (2 * di + 2 * ds + nh)
                         + (di + 2 * ds) * self.ssm_conv + di * d + 2 * d + 3 * nh)
            hd = self.hd
            shared_attn = (d * self.n_heads * hd + 2 * d * self.n_kv * hd
                           + self.n_heads * hd * d + 3 * d * self.d_ff + 2 * d)
            return emb + L * per_layer + shared_attn + d
        if self.frontend:
            emb += self.frontend_dim * d
        return emb + L * per_layer + d  # final norm

    def n_active_params(self) -> int:
        """Active params per token (MoE: only routed-in experts count)."""
        if self.family != "moe":
            return self.n_params()
        d = self.d_model
        full = self.n_params()
        e_ff = 3 * d * self.d_ff
        inactive = (self.n_experts - self.top_k) * e_ff * self.n_layers
        return full - inactive


ARCH_IDS = [
    "qwen1_5_32b", "command_r_plus_104b", "stablelm_1_6b", "minitron_8b",
    "llama4_scout_17b_a16e", "deepseek_moe_16b", "hubert_xlarge",
    "zamba2_2_7b", "mamba2_2_7b", "internvl2_26b",
]

# canonical external names (--arch accepts both)
ALIASES = {
    "qwen1.5-32b": "qwen1_5_32b",
    "command-r-plus-104b": "command_r_plus_104b",
    "stablelm-1.6b": "stablelm_1_6b",
    "minitron-8b": "minitron_8b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "hubert-xlarge": "hubert_xlarge",
    "zamba2-2.7b": "zamba2_2_7b",
    "mamba2-2.7b": "mamba2_2_7b",
    "internvl2-26b": "internvl2_26b",
    "hpcg": "hpcg",
}


def get_config(arch: str, smoke: bool = False) -> ArchConfig:
    mod_name = ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.SMOKE if smoke else mod.CONFIG


def list_archs():
    return list(ARCH_IDS)
