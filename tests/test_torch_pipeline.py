"""The port's GPipe schedule (``repro_torch.launch.pipeline``) against serial
execution: JAX's toy of ``tests/test_pipeline.py`` (S 4, L 8, M 6, MB 2, D
16, numpy seed 0) held against JAX's serial stack run in this process on
JAX's CPU backend (``jax.vmap`` of the serial loop, ``jax.grad`` of it: one
device, no mesh), and a 2-layer smoke stablelm cut into 2 stages against the
port's own serial forward.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.launch.pipeline import stage_params as jstage_params
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.pipeline import pipeline_apply, schedule, stage_params
from repro_torch.models import build_model
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import rms_norm, unembed_apply
from repro_torch.models.spec import tree_leaves
from torch_training import one_torch_thread  # noqa: F401  (autouse)

FWD_TOL, GRAD_REL = 1e-5, 1e-4  # tests/test_pipeline.py's limits
L, MB, D = 8, 2, 16


def _toy(m):
    rng = np.random.default_rng(0)
    ws = rng.standard_normal((L, D, D)).astype(np.float32) * 0.2
    x = rng.standard_normal((m, MB, D)).astype(np.float32)
    return ws, x


def _jax_serial(ws, x):
    """JAX's serial stack and its gradient (tests/test_pipeline.py)."""
    def serial(w, h):
        for i in range(L):
            h = jnp.tanh(h @ w[i])
        return h

    def loss(w):
        return (jax.vmap(lambda xi: serial(w, xi))(jnp.asarray(x)) ** 2).sum()

    y = jax.vmap(lambda xi: serial(jnp.asarray(ws), xi))(jnp.asarray(x))
    return np.asarray(y), np.asarray(jax.grad(loss)(jnp.asarray(ws)))


def _toy_stage(w_slab, h):  # (L/S, D, D)
    for w in w_slab.unbind(0):
        h = torch.tanh(h @ w)
    return h


@pytest.mark.parametrize("s,m", [(4, 6), (1, 6), (2, 1), (4, 2), (8, 3), (2, 6)])
def test_pipeline_matches_jax_serial(s, m):
    ws, x = _toy(m)
    y_ser, g_ser = _jax_serial(ws, x)
    staged = stage_params(torch.from_numpy(ws), s).requires_grad_(True)
    y = pipeline_apply(_toy_stage, staged, torch.from_numpy(x), make_mesh((s,), ("stage",)))
    assert y.shape == (m, MB, D)
    fwd_err = float(np.abs(y.detach().numpy() - y_ser).max())
    assert fwd_err < FWD_TOL, fwd_err
    (y ** 2).sum().backward()
    g = staged.grad.reshape(L, D, D).numpy()
    g_err = float(np.abs(g - g_ser).max() / (np.abs(g_ser).max() + 1e-9))
    assert g_err < GRAD_REL, g_err


@pytest.mark.parametrize("s,m", [(4, 6), (1, 1), (3, 2)])
def test_schedule_is_gpipes(s, m):
    ticks = schedule(s, m)
    assert len(ticks) == m + s - 1
    pairs = [p for t in ticks for p in t]
    assert sorted(pairs) == [(st, mb) for st in range(s) for mb in range(m)]
    for t, tick in enumerate(ticks):  # stage s works on microbatch t - s
        assert all(mb == t - st for st, mb in tick)
    assert s * (m + s - 1) - len(pairs) == s * (s - 1)  # the pairs JAX masks


def test_stage_params_is_bitwise_jaxs():
    rng = np.random.default_rng(3)
    tree = {"w": rng.standard_normal((8, 3, 5)).astype(np.float32),
            "ln": {"g": rng.standard_normal((8, 7)).astype(np.float32)},
            "b": rng.integers(0, 9, (8,)).astype(np.int32)}
    for s in (1, 2, 4, 8):
        want = jstage_params(jax.tree.map(jnp.asarray, tree), s)
        got = stage_params({k: (torch.from_numpy(v) if not isinstance(v, dict) else
                                {kk: torch.from_numpy(vv) for kk, vv in v.items()})
                            for k, v in tree.items()}, s)
        for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
            assert a.shape == b.shape and a.numpy().tobytes() == np.asarray(b).tobytes()
    with pytest.raises(ValueError, match="do not split"):
        stage_params({"w": torch.zeros(6, 2)}, 4)


def _attn_stage(cfg, positions):
    def stage_fn(slab, x):
        n = tree_leaves(slab)[0].shape[0]
        for p in tfm.layer_views(slab, n):
            x, _ = tfm._attn_block(p, x, cfg, causal=True, positions=positions,
                                   q_chunk=8, kv_chunk=8)
        return x
    return stage_fn


def test_pipeline_of_stablelm_smoke_matches_forward():
    """2 layers in 2 stages, 2 microbatches of one row: the pipeline between
    the embedding and the final norm + unembedding gives the serial
    forward's logits and block gradients."""
    cfg = dataclasses.replace(get_config("stablelm_1_6b", smoke=True), dtype="float32")
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    m, seq = 2, 16
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (m, seq)))

    for p in tree_leaves(params):
        p.requires_grad_(True)
    want, _ = model.forward(params, {"tokens": tokens}, remat=False, q_chunk=8, kv_chunk=8)
    want.square().sum().backward()
    g_want = [p.grad.clone() for p in tree_leaves(params["blocks"])]
    for p in tree_leaves(params):
        p.grad = None

    x, positions = tfm._embed_inputs(params, {"tokens": tokens}, cfg, torch.float32)
    staged = stage_params(params["blocks"], 2)
    y = pipeline_apply(_attn_stage(cfg, positions), staged, x[:, None],
                       make_mesh((2,), ("stage",)))[:, 0]
    got = unembed_apply(params["unembed"], rms_norm(y, params["final_ln"], cfg.norm_eps))
    assert got.shape == want.shape
    scale = float(want.detach().abs().max())
    assert float((got - want).detach().abs().max()) <= FWD_TOL * scale
    got.square().sum().backward()
    for a, b in zip(tree_leaves(params["blocks"]), g_want):
        assert float((a.grad - b).abs().max()) <= GRAD_REL * float(b.abs().max())
