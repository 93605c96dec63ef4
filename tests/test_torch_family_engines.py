"""The serving engine on the moe and vlm families (``repro_torch.launch.serve``)
on the CPU against the JAX package, at the smoke configs: moe through batched
prefills against JAX's engine, the vlm (prefilled by decode steps) against
JAX's single-request decode chain. JAX's initialised weights cross with
``weights.params_from_numpy``; float32 throughout.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.launch.serve as jserve
from repro.models import build_model as jbuild
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model
from repro_torch.models import weights
from torch_families import ALL_ARCHS, DEV, cfg_pair
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

ARCHS = ["deepseek_moe_16b", "llama4_scout_17b_a16e", "internvl2_26b"]


@pytest.fixture(scope="module")
def weights_np():
    """JAX's initialised float32 weights per architecture, as numpy (the
    seeds of ``tests/torch_families.py``)."""
    out = {}
    for arch in ARCHS:
        jcfg, _ = cfg_pair(arch)
        key = jax.random.PRNGKey(ALL_ARCHS.index(arch))
        out[arch] = jax.tree.map(np.asarray, jax.jit(jbuild(jcfg).init)(key))
    return out


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "llama4_scout_17b_a16e"])
def test_moe_engine_matches_jax_engine(weights_np, arch):
    """Float32, 5 ragged requests through 2 slots, batched prefills: the
    greedy outputs equal JAX's engine's (at a capacity that drops nothing,
    so the batched prefill and the decode steps route alike in both)."""
    jcfg, tcfg = cfg_pair(arch)
    cf = 2 * tcfg.n_experts / tcfg.top_k
    jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
    tcfg = dataclasses.replace(tcfg, capacity_factor=cf)
    reqs = _requests(tcfg.vocab)
    p = weights_np[arch]
    jdone, _ = jserve.serve(jserve.DecodeEngine(jbuild(jcfg), jax.tree.map(jnp.asarray, p),
                                                2, 24), reqs, 5)
    engine = tserve.DecodeEngine(build_model(tcfg), weights.params_from_numpy(p, DEV), 2, 24,
                                 device=DEV)
    tdone, _ = tserve.serve(engine, reqs, 5)
    assert dict(tdone) == dict(jdone)
    assert 1 < engine.prefill_calls < len(reqs)


def test_vlm_engine_matches_the_single_request_chain(weights_np):
    """internvl2 prefills by decode steps on its own slot: with float32
    caches every request's greedy output equals JAX's single-request decode
    chain. (JAX's engine is not the reference here: its prefill loop hands
    ``jnp.asarray`` a host array that the next iteration overwrites while
    the step may still be queued; with copies it gives these outputs.)"""
    jcfg, tcfg = cfg_pair("internvl2_26b")
    jm, tm = jbuild(jcfg), build_model(tcfg)
    p = weights_np["internvl2_26b"]
    jp = jax.tree.map(jnp.asarray, p)
    reqs = _requests(tcfg.vocab)
    engine = tserve.DecodeEngine(tm, weights.params_from_numpy(p, DEV), 2, 24, device=DEV)
    engine.cache = tm.init_cache(2, 24, torch.float32, device=DEV)
    done, _ = tserve.serve(engine, reqs, 5)
    assert engine.prefill_calls == len(reqs)
    step = jax.jit(jm.decode_step)
    for rid, prompt in reqs:
        cache = jm.init_cache(1, 24, jnp.float32)
        out = []
        for i, tok in enumerate(list(prompt) + [None] * 4):
            tok = int(tok) if tok is not None else out[-1]
            lg, cache = step(jp, cache, jnp.asarray([tok], jnp.int32), jnp.asarray([i], jnp.int32))
            if i >= len(prompt) - 1:
                out.append(int(jnp.argmax(lg[0])))
        assert dict(done)[rid] == out, rid


def _requests(vocab):
    rng = np.random.default_rng(7)
    return [(i, rng.integers(0, vocab, (n,)).astype(np.int32))
            for i, n in enumerate((5, 9, 3, 7, 4))]
