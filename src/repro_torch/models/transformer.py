"""Model assembly (port of ``repro.models.transformer``), the dense family.

Layers are stacked (a leading ``layers`` dim on every block param, as in the
JAX package) and driven by a Python loop over ``i`` that takes views of the
stacked params, never copies. The moe, vlm, audio, ssm and hybrid families
follow in later slices (``ROADMAP.md`` Queue 1 item 2).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.models import attention as attn
from repro_torch.models.layers import (P, embed_apply, embed_specs, mlp_apply,
                                       mlp_specs, rms_norm, unembed_apply,
                                       unembed_specs)
from repro_torch.models.sharding_ctx import constrain
from repro_torch.models.spec import tree_map

PORTED_FAMILIES = ("dense",)


def check_family(cfg) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family} family ({cfg.name}) is not ported yet: see ROADMAP.md "
            "Queue 1 item 2 (model stack and serving); ported: "
            f"{', '.join(PORTED_FAMILIES)}")


def compute_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _stack_specs(specs: dict, n: int) -> dict:
    """Prefix every spec in the tree with a ``layers`` dim of size n."""
    return tree_map(
        lambda s: dataclasses.replace(s, shape=(n,) + s.shape, axes=("layers",) + s.axes),
        specs)


def layer_view(stacked, i: int):
    """Layer ``i`` of a stacked params (or cache) tree: views, no copies."""
    return tree_map(lambda a: a[i], stacked)


# ---------------------------------------------------------------------------
# Block body (one layer)
# ---------------------------------------------------------------------------


def _attn_block_specs(cfg) -> dict:
    return {
        "ln1": P((cfg.d_model,), ("embed",), init="ones"),
        "attn": attn.attn_specs(cfg),
        "ln2": P((cfg.d_model,), ("embed",), init="ones"),
        "mlp": mlp_specs(cfg.d_model, cfg.d_ff, cfg.mlp_act),
    }


def _attn_block(p, x, cfg, *, causal, positions=None, q_chunk, kv_chunk,
                unroll=False, return_kv=False):
    h, kv = attn.attention_block(p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps),
                                 cfg, causal=causal, positions=positions,
                                 q_chunk=q_chunk, kv_chunk=kv_chunk,
                                 unroll=unroll, return_kv=return_kv)
    x = x + h
    hin = rms_norm(x, p["ln2"], cfg.norm_eps)
    h = mlp_apply(p["mlp"], hin, cfg.mlp_act)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_kv:
        return x + h, aux, kv
    return x + h, aux


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


def model_specs(cfg) -> dict:
    check_family(cfg)
    d, v = cfg.d_model, cfg.padded_vocab
    s: Dict[str, Any] = {"final_ln": P((d,), ("embed",), init="ones"),
                         "embed": embed_specs(v, d)}
    if not cfg.encoder_only:
        s["unembed"] = unembed_specs(d, v)
    s["blocks"] = _stack_specs(_attn_block_specs(cfg), cfg.n_layers)
    return s


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------


def _embed_inputs(params, batch, cfg, dtype):
    """Token embedding (the token frontend). Returns (x, positions)."""
    x = embed_apply(params["embed"], batch["tokens"], dtype)
    s = x.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
    return x, positions


def forward(params, batch, cfg, *, remat: bool = True,
            q_chunk: int = 512, kv_chunk: int = 1024,
            logits_mode: str = "all", unroll: bool = False,
            collect_kv: bool = False):
    """Full-sequence forward. Returns (logits, aux_loss).

    logits_mode: 'all' | 'last' (prefill serving) | 'none' (the final-norm
    activations). collect_kv: also return every layer's projected (k, v),
    stacked to (L, B, S, KV, hd) each, so a serving prefill primes the
    decode cache from ONE forward; the return becomes (out, aux, (k, v)).
    ``remat`` and ``unroll`` are accepted for the JAX signature and change
    no value: nothing is differentiated here, and the loops are Python loops.
    """
    del remat
    check_family(cfg)
    dtype = compute_dtype(cfg)
    x, positions = _embed_inputs(params, batch, cfg, dtype)
    x = constrain(x, "act")
    causal = not cfg.encoder_only

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ks, vs = [], []
    blocks = params["blocks"]
    for i in range(cfg.n_layers):
        out = _attn_block(layer_view(blocks, i), x, cfg, causal=causal,
                          positions=positions, q_chunk=q_chunk, kv_chunk=kv_chunk,
                          unroll=unroll, return_kv=collect_kv)
        if collect_kv:
            x, a, (k, v) = out
            ks.append(k)
            vs.append(v)
        else:
            x, a = out
        x, aux = constrain(x, "act"), aux + a

    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    kvs = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    if logits_mode == "none":
        return (x, aux, kvs) if collect_kv else (x, aux)
    if logits_mode == "last":
        x = x[:, -1:, :]
    logits = constrain(unembed_apply(params["unembed"], x), "logits")
    return (logits, aux, kvs) if collect_kv else (logits, aux)
