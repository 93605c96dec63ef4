"""Shared inputs and checks of the model-family parity tests
(``tests/test_torch_families.py``, ``tests/test_torch_recurrent.py``): the
port's ``forward`` and ``decode_step`` against the JAX package's at the
smoke configs, on JAX's initialised weights and numpy inputs. JAX's outputs
are computed once per test module (``compute_refs``).
"""
import dataclasses
import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

import repro.configs as jconfigs
from repro.models import build_model as jbuild
from repro_torch import configs as tconfigs
from repro_torch.models import build_model
from repro_torch.models import weights
from torch_parity import tol

DEV = "cpu"
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
ALL_ARCHS = ["deepseek_moe_16b", "llama4_scout_17b_a16e", "mamba2_2_7b", "zamba2_2_7b",
             "internvl2_26b", "hubert_xlarge"]
B, S = 2, 16
CHAIN = 6  # decode steps of the chain


def as_np(t) -> np.ndarray:
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def cfg_pair(arch, dtype_name="float32"):
    j = dataclasses.replace(jconfigs.get_config(arch, smoke=True), dtype=dtype_name)
    t = dataclasses.replace(tconfigs.get_config(arch, smoke=True), dtype=dtype_name)
    return j, t


def make_batch(cfg, seed):
    """The forward's inputs: frames (audio), patches + tokens (vision), or
    tokens, from numpy."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        return {"frames": rng.standard_normal((B, S, cfg.frontend_dim)).astype(np.float32)}
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.frontend == "vision":
        out["patches"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.frontend_dim)).astype(np.float32)
    return out


def batch_to_jax(batch, dtype):
    return {k: jnp.asarray(v, dtype if v.dtype == np.float32 else None) for k, v in batch.items()}


def batch_to_torch(batch, dtype):
    return {k: torch.from_numpy(v).to(dtype) if v.dtype == np.float32 else torch.from_numpy(v)
            for k, v in batch.items()}


def compute_refs(archs, decode_archs):
    """Per architecture: JAX's weights (numpy, f32), the forward's inputs,
    JAX's forward in both dtypes, and JAX's decode chain (float32 cache).
    Each architecture has its own seed (its index in ``ALL_ARCHS``)."""
    out = {}
    for arch in archs:
        a = ALL_ARCHS.index(arch)
        jcfg, _ = cfg_pair(arch)
        p = jax.tree.map(np.asarray, jax.jit(jbuild(jcfg).init)(jax.random.PRNGKey(a)))
        batch = make_batch(jcfg, a)
        fwd = {}
        for dtype_name, (jd, _) in DTYPES.items():
            jcfg, _ = cfg_pair(arch, dtype_name)
            fn = jax.jit(functools.partial(jbuild(jcfg).forward, q_chunk=8, kv_chunk=8))
            logits, aux = fn(jax.tree.map(jnp.asarray, p), batch_to_jax(batch, jd))
            fwd[dtype_name] = (np.asarray(logits), float(aux))
        chain = None
        if arch in decode_archs:
            jcfg, _ = cfg_pair(arch)
            jm = jbuild(jcfg)
            rng = np.random.default_rng(100 + a)
            toks = rng.integers(0, jcfg.vocab, (CHAIN, B)).astype(np.int32)
            pos = np.array([0, 3], np.int32)
            cache = jm.init_cache(B, 16, jnp.float32)
            step = jax.jit(jm.decode_step)
            rows = []
            for i in range(CHAIN):
                lg, cache = step(jax.tree.map(jnp.asarray, p), cache, jnp.asarray(toks[i]),
                                 jnp.asarray(pos + i))
                rows.append(np.asarray(lg))
            chain = dict(toks=toks, pos=pos, logits=rows,
                         cache=jax.tree.map(np.asarray, cache))
        out[arch] = dict(p=p, batch=batch, fwd=fwd, chain=chain)
    return out


def check_forward(refs, arch, dtype_name):
    _, tcfg = cfg_pair(arch, dtype_name)
    r = refs[arch]
    logits, aux = build_model(tcfg).forward(weights.params_from_numpy(r["p"], DEV),
                                            batch_to_torch(r["batch"], DTYPES[dtype_name][1]),
                                            q_chunk=8, kv_chunk=8)
    want, want_aux = r["fwd"][dtype_name]
    assert logits.dtype == torch.float32 and tuple(logits.shape) == want.shape
    if dtype_name == "float32":
        np.testing.assert_allclose(logits.numpy(), want, **tol("float32"))
    else:
        # bf16 products over the layers: where the two packages round one bf16
        # intermediate to neighbouring values, every logit moves by about one
        # bf16 ulp of the logits' scale (tests/test_torch_models.py)
        np.testing.assert_allclose(logits.numpy(), want, rtol=2e-2,
                                   atol=2e-2 * np.abs(want).max())
    np.testing.assert_allclose(float(aux), want_aux, **tol(dtype_name))
    assert (float(aux) > 0) == (tcfg.family == "moe")


def check_decode_chain(refs, arch):
    """Six decode steps from an empty float32 cache, rows at positions 0 and
    3: every step's logits and the final cache, against JAX's."""
    _, tcfg = cfg_pair(arch)
    tm = build_model(tcfg)
    tp = weights.params_from_numpy(refs[arch]["p"], DEV)
    chain = refs[arch]["chain"]
    cache = tm.init_cache(B, 16, torch.float32, device=DEV)
    for i in range(CHAIN):
        lg, c2 = tm.decode_step(tp, cache, torch.from_numpy(chain["toks"][i]),
                                torch.from_numpy(chain["pos"] + i))
        assert c2 is cache
        np.testing.assert_allclose(lg.numpy(), chain["logits"][i], err_msg=f"step {i}",
                                   **tol("float32"))
    assert set(cache) == set(chain["cache"])
    for name, t in cache.items():
        np.testing.assert_allclose(as_np(t), chain["cache"][name], err_msg=name,
                                   **tol("float32"))


def check_decode_matches_forward(refs, arch):
    """Teacher-forced decode reproduces forward's logits at every position
    (moe at a capacity that drops nothing: a forward row of 16 tokens and a
    decode token have different capacities otherwise)."""
    _, tcfg = cfg_pair(arch)
    if tcfg.family == "moe":
        tcfg = dataclasses.replace(tcfg, capacity_factor=2 * tcfg.n_experts / tcfg.top_k)
    tm = build_model(tcfg)
    tp = weights.params_from_numpy(refs[arch]["p"], DEV)
    toks = torch.from_numpy(refs[arch]["batch"]["tokens"])
    full, _ = tm.forward(tp, {"tokens": toks}, q_chunk=8, kv_chunk=8)
    cache = tm.init_cache(B, S, torch.float32, device=DEV)
    for i in range(S):
        lg, _ = tm.decode_step(tp, cache, toks[:, i], torch.full((B,), i))
        np.testing.assert_allclose(lg.numpy(), full[:, i].numpy(), rtol=1e-3, atol=1e-3)
