"""Public model API (port of ``repro.models.model``).

``build_model(cfg)`` returns a ``Model`` with:
    specs()                      parameter P-spec tree
    init(seed, device=)          materialized params (the card by default)
    abstract_params()            meta-device tensors (no allocation)
    forward(params, batch)       logits (train/prefill)
    loss(params, batch)          scalar LM loss (+ 0.01 * MoE aux)
    cache_specs(b, s)            decode cache shapes (meta-device tensors)
    init_cache(b, s, device=)    decode cache
    prefill(params, batch)       last-token logits
    prefill_cache(...)           one forward that primes the decode cache
    decode_step(params, cache, tokens, pos)   one-token serve step

Every family builds, serves and trains. The decode cache is written in
place: each step stores its k/v, conv window and SSM state into the cache
tensors it was given (JAX returns updated copies); the training forward
never takes that path.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.registry import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mamba2 as m2
from repro_torch.models import moe as moe_mod
from repro_torch.models import spec as spec_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (acc_dtype, embed_apply, mlp_apply, rms_norm,
                                       unembed_apply)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def _nll_sum(logits, labels, vocab: int):
    """(sum of the token NLLs where label >= 0, count of such labels), the
    NLLs in f32 (f64 for float64 logits)."""
    logp = torch.log_softmax(logits.to(acc_dtype(logits.dtype)), dim=-1)
    mask = labels >= 0
    safe = torch.clamp(labels, 0, vocab - 1).long()
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return torch.sum(nll * mask), torch.sum(mask)


def lm_loss(logits, labels, vocab: int):
    """Token cross-entropy, f32, ignoring label == -1."""
    tot, cnt = _nll_sum(logits, labels, vocab)
    return tot / torch.clamp(cnt, min=1)


def _ce_chunk(w, xi, li, vocab: int):
    return _nll_sum(unembed_apply({"out": w}, xi), li, vocab)


def lm_loss_chunked(unembed_params, x, labels, vocab: int, chunk: int,
                    unroll: bool = False):
    """CE without materialising the full (B, S, V) logits: a loop over
    sequence chunks, each chunk's body under ``checkpoint`` (JAX's
    ``jax.checkpoint`` scan), bounds peak memory at one (B, chunk, V) chunk.
    ``unroll`` is accepted for the JAX signature: the loop is a Python loop."""
    del unroll
    s = x.shape[1]
    adt = acc_dtype(x.dtype)
    tot = torch.zeros((), dtype=adt, device=x.device)
    cnt = torch.zeros((), dtype=adt, device=x.device)
    for i in range(s // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        t, c = checkpoint(_ce_chunk, unembed_params["out"], x[:, sl], labels[:, sl], vocab,
                          use_reentrant=False)
        tot, cnt = tot + t, cnt + c
    return tot / torch.clamp(cnt, min=1)


# ---------------------------------------------------------------------------
# Decode bodies
# ---------------------------------------------------------------------------


def _decode_attn_family(params, cache, x, pos, cfg):
    """Every layer's one-token step; layer ``i`` reads views of the stacked
    params and writes its new k/v into ``cache`` in place."""
    blocks = params["blocks"]
    quant = "k_scale" in cache
    for i in range(cfg.n_layers):
        pl = tfm.layer_view(blocks, i)
        scales = (cache["k_scale"][i], cache["v_scale"][i]) if quant else (None, None)
        h = rms_norm(x, pl["ln1"], cfg.norm_eps)
        out = attn.decode_attention(pl["attn"], h, cache["k"][i], cache["v"][i], pos, cfg,
                                    *scales)[0]
        x = x + out
        h2 = rms_norm(x, pl["ln2"], cfg.norm_eps)
        if cfg.family == "moe":
            h2, _ = moe_mod.moe_apply(pl["moe"], h2, cfg)
        else:
            h2 = mlp_apply(pl["mlp"], h2, cfg.mlp_act)
        x = x + h2
    return x, cache


def _mamba_step(pl, x, cache, i, cfg):
    h = rms_norm(x, pl["ln"], cfg.norm_eps)
    out = m2.mamba_decode(pl["mixer"], h, cache["conv"][i], cache["ssm"][i], cfg)[0]
    return x + out


def _decode_ssm_family(params, cache, x, pos, cfg):
    """Every Mamba2 layer's one-token step; layer ``i`` updates
    ``cache["conv"][i]`` and ``cache["ssm"][i]`` in place."""
    del pos  # the recurrent state is not positional
    blocks = params["blocks"]
    for i in range(cfg.n_layers):
        x = _mamba_step(tfm.layer_view(blocks, i), x, cache, i, cfg)
    return x, cache


def _decode_hybrid(params, cache, x, pos, cfg):
    """Groups of ``attn_every`` Mamba2 steps, each followed by the shared
    attention block on the group's k/v cache ``cache["k"][group]``."""
    g = cfg.attn_every
    blocks, shared = params["blocks"], params["shared_attn"]
    dcfg = tfm._as_dense(cfg)
    for grp in range(cfg.n_layers // g):
        for i in range(grp * g, (grp + 1) * g):
            x = _mamba_step(tfm.layer_view(blocks, i), x, cache, i, cfg)
        h = rms_norm(x, shared["ln1"], cfg.norm_eps)
        out = attn.decode_attention(shared["attn"], h, cache["k"][grp], cache["v"][grp],
                                    pos, dcfg)[0]
        x = x + out
        h2 = rms_norm(x, shared["ln2"], cfg.norm_eps)
        x = x + mlp_apply(shared["mlp"], h2, cfg.mlp_act)
    return x, cache


_DECODE = {"dense": _decode_attn_family, "moe": _decode_attn_family,
           "vlm": _decode_attn_family, "ssm": _decode_ssm_family,
           "hybrid": _decode_hybrid}


# ---------------------------------------------------------------------------
# Model bundle
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    # -- params -----------------------------------------------------------
    def specs(self, param_dtype: torch.dtype = torch.float32) -> dict:
        s = tfm.model_specs(self.cfg)
        if param_dtype != torch.float32:
            s = spec_mod.cast_dtype(s, param_dtype)
        return s

    def init(self, seed: int = 0, param_dtype: torch.dtype = torch.float32,
             device: DeviceLike = None) -> dict:
        return spec_mod.init_params(self.specs(param_dtype), seed, device)

    def abstract_params(self, param_dtype: torch.dtype = torch.float32) -> dict:
        return spec_mod.abstract_params(self.specs(param_dtype))

    def logical_axes(self) -> dict:
        return spec_mod.logical_axes(self.specs())

    def n_params(self) -> int:
        return spec_mod.param_count(self.specs())

    def forward(self, params, batch, **kw):
        return tfm.forward(params, batch, self.cfg, **kw)

    def loss(self, params, batch, ce_chunk: int = 1024, **kw):
        cfg = self.cfg
        labels = batch["labels"]
        s = labels.shape[1]
        # chunk the CE when the full (B,S,V) logits tensor is memory-hostile
        if s % max(1, ce_chunk) == 0 and s // ce_chunk > 1 \
                and s * cfg.padded_vocab > 2 ** 27:
            x, aux = tfm.forward(params, batch, cfg, logits_mode="none", **kw)
            ce = lm_loss_chunked(params["unembed"], x, labels, cfg.padded_vocab, ce_chunk)
            return ce + 0.01 * aux
        logits, aux = tfm.forward(params, batch, cfg, **kw)
        return lm_loss(logits, labels, cfg.padded_vocab) + 0.01 * aux

    # -- serving -----------------------------------------------------------
    def cache_specs(self, batch: int, max_len: int, dtype: torch.dtype = torch.bfloat16,
                    kv_quant: bool = False) -> dict:
        """Meta-device tensors of the decode cache, JAX's keys and shapes.

        Attention families: k and v of shape (L, B, S_max, KV, hd);
        ``kv_quant=True``: int8 k/v + bf16 per-(token, head) scales, 4x
        smaller than bf16 k/v. ssm: ``conv`` (L, B, W-1, conv_dim) in
        ``dtype`` and ``ssm`` (L, B, H, N, P) in float32; hybrid adds k/v of
        (L / attn_every, B, S_max, KV, hd) (no int8 mode, as in JAX). The
        audio encoder has no decode cache: ``ValueError``."""
        cfg = self.cfg

        def meta(shape, dt):
            return torch.empty(shape, dtype=dt, device="meta")

        if cfg.family in ("dense", "moe", "vlm"):
            kv = (cfg.n_layers, batch, max_len, cfg.n_kv, cfg.hd)
            if kv_quant:
                return {"k": meta(kv, torch.int8), "v": meta(kv, torch.int8),
                        "k_scale": meta(kv[:-1], torch.bfloat16),
                        "v_scale": meta(kv[:-1], torch.bfloat16)}
            return {"k": meta(kv, dtype), "v": meta(kv, dtype)}
        if cfg.family not in ("ssm", "hybrid"):
            raise ValueError(f"{cfg.family} has no decode cache")
        conv_dim = cfg.d_inner + 2 * cfg.ssm_state
        out = {"conv": meta((cfg.n_layers, batch, cfg.ssm_conv - 1, conv_dim), dtype),
               "ssm": meta((cfg.n_layers, batch, cfg.ssm_heads, cfg.ssm_state,
                            cfg.ssm_head_dim), torch.float32)}
        if cfg.family == "hybrid":
            kv = (cfg.n_layers // cfg.attn_every, batch, max_len, cfg.n_kv, cfg.hd)
            out.update(k=meta(kv, dtype), v=meta(kv, dtype))
        return out

    def init_cache(self, batch: int, max_len: int, dtype: torch.dtype = torch.bfloat16,
                   kv_quant: bool = False, device: DeviceLike = None) -> dict:
        dev = resolve_device(device)
        return {name: torch.zeros(t.shape, dtype=t.dtype, device=dev)
                for name, t in self.cache_specs(batch, max_len, dtype, kv_quant).items()}

    def decode_step(self, params, cache, tokens, pos):
        """tokens: (B,) int; pos: (B,) write positions. -> (logits, cache);
        ``cache`` is updated in place and returned."""
        cfg = self.cfg
        decode = _DECODE.get(cfg.family)
        if decode is None:
            raise ValueError(f"{cfg.family} has no decode cache")
        # the vlm decodes on tokens alone, as the JAX package's does
        x = embed_apply(params["embed"], tokens, tfm.compute_dtype(cfg))[:, None, :]
        x, cache = decode(params, cache, x, pos, cfg)
        x = rms_norm(x, params["final_ln"], cfg.norm_eps)
        logits = unembed_apply(params["unembed"], x)[:, 0]
        return logits, cache

    def prefill(self, params, batch, **kw):
        """Prefill forward: last-token logits."""
        return tfm.forward(params, batch, self.cfg, logits_mode="last", remat=False, **kw)

    def supports_prefill_cache(self) -> bool:
        """Whether :meth:`prefill_cache` is available: attention families
        with a token frontend (the kv cache is addressable by position;
        ssm/hybrid recurrent state is built by stepping)."""
        return self.cfg.family in ("dense", "moe")

    def prefill_cache(self, params, cache, tokens, slots, lengths):
        """ONE forward that primes the decode cache for R prompts.

        tokens: (R, P) right-padded prompt rows; slots: (R,) batch rows of
        ``cache`` to fill; lengths: (R,) true prompt lengths (<= P).
        Returns (last_logits (R, V), cache) — the logits at each prompt's
        final real token; ``cache[:, slots, :P]`` is written in
        place. Positions >= length hold kv computed from pad tokens, never
        read: ``decode_attention`` masks to ``arange <= pos`` and overwrites
        each slot before first attending it.
        """
        cfg = self.cfg
        if not self.supports_prefill_cache():
            raise ValueError(f"{cfg.family} has no batched cache prefill")
        p_len = tokens.shape[1]
        x, _, (k, v) = tfm.forward(params, {"tokens": tokens}, cfg,
                                   logits_mode="none", remat=False, collect_kv=True)
        # k/v: (L, R, P, KV, hd); cache["k"]: (L, B, S_max, KV, hd)
        rows = slots.long()
        if "k_scale" in cache:
            kq, ks = attn._quantize_kv(k)
            vq, vs = attn._quantize_kv(v)
            cache["k"][:, rows, :p_len] = kq
            cache["v"][:, rows, :p_len] = vq
            cache["k_scale"][:, rows, :p_len] = ks
            cache["v_scale"][:, rows, :p_len] = vs
        else:
            kv_dt = cache["k"].dtype
            cache["k"][:, rows, :p_len] = k.to(kv_dt)
            cache["v"][:, rows, :p_len] = v.to(kv_dt)
        r = torch.arange(tokens.shape[0], device=x.device)
        last = x[r, lengths.long() - 1][:, None, :]  # (R, 1, d)
        logits = unembed_apply(params["unembed"], last)[:, 0]
        return logits, cache


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)
