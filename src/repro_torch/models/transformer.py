"""Model assembly (port of ``repro.models.transformer``): the stacks of every
family.

One decoder/encoder runtime covers dense / moe / audio / vlm; the ssm family
stacks Mamba2 blocks; hybrid (zamba2) interleaves groups of Mamba2 blocks
with one *shared* attention block (one parameter set, applied after every
group). Layers are stacked (a leading ``layers`` dim on every block param,
as in the JAX package) and driven by a Python loop over ``i`` that takes
views of the stacked params, never copies.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import mamba2 as m2
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (P, embed_apply, embed_specs, mlp_apply,
                                       mlp_specs, rms_norm, unembed_apply,
                                       unembed_specs)
from repro_torch.models.sharding_ctx import constrain
from repro_torch.models.spec import tree_map

ATTN_FAMILIES = ("dense", "moe", "vlm", "audio")


_COMPUTE = {"bfloat16": torch.bfloat16, "float64": torch.float64}


def compute_dtype(cfg) -> torch.dtype:
    """The activations' dtype: bf16 or f32 as in the JAX package; the port
    also runs ``dtype="float64"`` (its float64 witnesses)."""
    return _COMPUTE.get(cfg.dtype, torch.float32)


def _stack_specs(specs: dict, n: int) -> dict:
    """Prefix every spec in the tree with a ``layers`` dim of size n."""
    return tree_map(
        lambda s: dataclasses.replace(s, shape=(n,) + s.shape, axes=("layers",) + s.axes),
        specs)


def layer_view(stacked, i: int):
    """Layer ``i`` of a stacked params (or cache) tree: views, no copies."""
    return tree_map(lambda a: a[i], stacked)


def layer_views(stacked, n: int) -> list:
    """All ``n`` layers of a stacked params tree as views, by one ``unbind``
    a leaf: its backward stacks the layers' gradients once, where ``a[i]``
    a layer would add a zero-padded full-size gradient into the leaf's for
    every layer."""
    cols = tree_map(lambda a: a.unbind(0), stacked)
    return [tree_map(lambda c: c[i], cols) for i in range(n)]


# ---------------------------------------------------------------------------
# Block body (one layer)
# ---------------------------------------------------------------------------


def _attn_block_specs(cfg) -> dict:
    s = {
        "ln1": P((cfg.d_model,), ("embed",), init="ones"),
        "attn": attn.attn_specs(cfg),
        "ln2": P((cfg.d_model,), ("embed",), init="ones"),
    }
    if cfg.family == "moe":
        s["moe"] = moe_mod.moe_specs(cfg)
    else:
        s["mlp"] = mlp_specs(cfg.d_model, cfg.d_ff, cfg.mlp_act)
    return s


def _attn_block(p, x, cfg, *, causal, positions=None, q_chunk, kv_chunk,
                unroll=False, return_kv=False):
    h, kv = attn.attention_block(p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps),
                                 cfg, causal=causal, positions=positions,
                                 q_chunk=q_chunk, kv_chunk=kv_chunk,
                                 unroll=unroll, return_kv=return_kv)
    x = x + h
    hin = rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
        h, aux = moe_mod.moe_apply(p["moe"], hin, cfg)
    else:
        h = mlp_apply(p["mlp"], hin, cfg.mlp_act)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_kv:
        return x + h, aux, kv
    return x + h, aux


def _mamba_block_specs(cfg) -> dict:
    return {"ln": P((cfg.d_model,), ("embed",), init="ones"),
            "mixer": m2.mamba_specs(cfg)}


def _mamba_block(p, x, cfg, *, return_state=False, unroll=False):
    h, state = m2.mamba_apply(p["mixer"], rms_norm(x, p["ln"], cfg.norm_eps),
                              cfg, return_state=return_state, unroll=unroll)
    return x + h, state


# ---------------------------------------------------------------------------
# Specs per family
# ---------------------------------------------------------------------------


def model_specs(cfg) -> dict:
    d, v = cfg.d_model, cfg.padded_vocab
    s: Dict[str, Any] = {"final_ln": P((d,), ("embed",), init="ones")}

    if cfg.frontend == "audio":
        s["frontend"] = {"proj": P((cfg.frontend_dim, d), (None, "embed"))}
    elif cfg.frontend == "vision":
        s["frontend"] = {"proj": P((cfg.frontend_dim, d), (None, "embed"))}
        s["embed"] = embed_specs(v, d)
    else:
        s["embed"] = embed_specs(v, d)

    if not cfg.encoder_only or cfg.family == "audio":
        s["unembed"] = unembed_specs(d, v)

    if cfg.family in ATTN_FAMILIES:
        s["blocks"] = _stack_specs(_attn_block_specs(cfg), cfg.n_layers)
    elif cfg.family == "ssm":
        s["blocks"] = _stack_specs(_mamba_block_specs(cfg), cfg.n_layers)
    elif cfg.family == "hybrid":
        if cfg.n_layers % cfg.attn_every:
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not groups of "
                             f"attn_every = {cfg.attn_every}")
        s["blocks"] = _stack_specs(_mamba_block_specs(cfg), cfg.n_layers)
        # one block, reused after every attn_every Mamba2 blocks
        s["shared_attn"] = _attn_block_specs(_as_dense(cfg))
    else:
        raise ValueError(cfg.family)
    return s


def _as_dense(cfg):
    return dataclasses.replace(cfg, family="dense")


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------


def _embed_inputs(params, batch, cfg, dtype):
    """Token/frontend embedding. Returns (x, positions): audio frames and
    vision patches go through ``frontend.proj``; patches come before the
    token embeddings."""
    if cfg.frontend == "audio":
        x = batch["frames"].to(dtype) @ params["frontend"]["proj"].to(dtype)
    elif cfg.frontend == "vision":
        pe = batch["patches"].to(dtype) @ params["frontend"]["proj"].to(dtype)
        te = embed_apply(params["embed"], batch["tokens"], dtype)
        x = torch.cat([pe, te], dim=1)
    else:
        x = embed_apply(params["embed"], batch["tokens"], dtype)
    s = x.shape[1]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
    return x, positions


def _remat(fn, on: bool):
    """``fn`` under ``checkpoint`` (JAX's ``jax.checkpoint``) when ``on``:
    its activations are recomputed in the backward instead of saved."""
    if not on:
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def forward(params, batch, cfg, *, remat: bool = True,
            q_chunk: int = 512, kv_chunk: int = 1024,
            logits_mode: str = "all", unroll: bool = False,
            collect_kv: bool = False):
    """Full-sequence forward. Returns (logits, aux_loss); aux sums the MoE
    layers' load-balance losses (0 for the other families).

    logits_mode: 'all' (training CE) | 'last' (prefill serving) | 'none'
    (the final-norm activations). collect_kv: also return every layer's
    projected (k, v), stacked to (L, B, S, KV, hd) each, so a serving
    prefill primes the decode cache from ONE forward; the return becomes
    (out, aux, (k, v)). Attention families only: ssm/hybrid state is
    recurrent, not a kv cache. ``remat`` wraps each layer's body (a hybrid
    group's Mamba2 blocks and shared attention block as one unit) in
    ``checkpoint`` when autograd is recording; it changes no value.
    ``unroll`` is accepted for the JAX signature: the loops are Python
    loops. An encoder-only model attends without the causal mask.
    """
    dtype = compute_dtype(cfg)
    x, positions = _embed_inputs(params, batch, cfg, dtype)
    x = constrain(x, "act")
    causal = not cfg.encoder_only
    if collect_kv and cfg.family not in ATTN_FAMILIES:
        raise ValueError(f"collect_kv: {cfg.family} has no kv cache — "
                         "prefill ssm/hybrid families by decode steps")
    remat = remat and torch.is_grad_enabled()

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ks, vs = [], []
    blocks = layer_views(params["blocks"], cfg.n_layers)
    if cfg.family in ATTN_FAMILIES:
        def body(x, i):
            return _attn_block(blocks[i], x, cfg, causal=causal,
                               positions=positions, q_chunk=q_chunk, kv_chunk=kv_chunk,
                               unroll=unroll, return_kv=collect_kv)
        body = _remat(body, remat)
        for i in range(cfg.n_layers):
            out = body(x, i)
            if collect_kv:
                x, a, (k, v) = out
                ks.append(k)
                vs.append(v)
            else:
                x, a = out
            x, aux = constrain(x, "act"), aux + a
    elif cfg.family == "ssm":
        body = _remat(lambda x, i: _mamba_block(blocks[i], x, cfg, unroll=unroll)[0], remat)
        for i in range(cfg.n_layers):
            x = constrain(body(x, i), "act")
    elif cfg.family == "hybrid":
        g = cfg.attn_every
        dcfg = _as_dense(cfg)

        def group_body(x, grp):
            for i in range(grp * g, (grp + 1) * g):
                x, _ = _mamba_block(blocks[i], x, cfg, unroll=unroll)
            return _attn_block(params["shared_attn"], x, dcfg, causal=causal,
                               positions=positions, q_chunk=q_chunk, kv_chunk=kv_chunk,
                               unroll=unroll)
        group_body = _remat(group_body, remat)
        for grp in range(cfg.n_layers // g):
            x, a = group_body(x, grp)
            x, aux = constrain(x, "act"), aux + a
    else:
        raise ValueError(cfg.family)

    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    kvs = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    if logits_mode == "none":
        return (x, aux, kvs) if collect_kv else (x, aux)
    if logits_mode == "last":
        x = x[:, -1:, :]
    logits = constrain(unembed_apply(params["unembed"], x), "logits")
    return (logits, aux, kvs) if collect_kv else (logits, aux)
