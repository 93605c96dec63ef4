"""Shared inputs and checks of the training parity tests
(``tests/test_torch_training_*.py``): the port's ``Model.loss`` and its
gradients against the JAX package's ``jax.value_and_grad`` of
``Model.loss`` at the smoke configs in float32, on JAX's initialised
weights carried across with ``weights.params_from_numpy``, on numpy batches
whose labels include ignored (-1) positions.
"""
import dataclasses
import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

import repro.configs as jconfigs
import repro.models.model as jmodel
from repro.models import build_model as jbuild
from repro_torch import configs as tconfigs
from repro_torch.models import build_model
from repro_torch.models import model as tmodel
from repro_torch.models import weights
from repro_torch.models.spec import tree_leaves
from torch_parity import one_torch_thread  # noqa: F401  (re-exported: autouse where imported)

DEV = "cpu"
B = 2
LOSS_REL = 1e-5  # |loss_port - loss_jax| <= LOSS_REL * |loss_jax|
GRAD_REL = 2e-5  # every leaf: max|g_port - g_jax| <= GRAD_REL * max|g_jax| (worst seen: 8.1e-6, zamba2)
CHUNKS = dict(q_chunk=8, kv_chunk=8)


def cfg_pair(arch, **kw):
    kw.setdefault("dtype", "float32")
    return (dataclasses.replace(jconfigs.get_config(arch, smoke=True), **kw),
            dataclasses.replace(tconfigs.get_config(arch, smoke=True), **kw))


def train_batch(cfg, seq, seed):
    """Inputs and labels (B, positions) with a tenth of the labels -1."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        out = {"frames": rng.standard_normal((B, seq, cfg.frontend_dim)).astype(np.float32)}
        n = seq
    else:
        out = {"tokens": rng.integers(0, cfg.vocab, (B, seq)).astype(np.int32)}
        n = seq
        if cfg.frontend == "vision":
            out["patches"] = rng.standard_normal(
                (B, cfg.n_patches, cfg.frontend_dim)).astype(np.float32)
            n += cfg.n_patches
    labels = rng.integers(0, cfg.vocab, (B, n)).astype(np.int32)
    labels[rng.random((B, n)) < 0.1] = -1
    out["labels"] = labels
    return out


def jax_params(jcfg, seed):
    return jax.tree.map(np.asarray, jax.jit(jbuild(jcfg).init)(jax.random.PRNGKey(seed)))


def jax_loss_grads(jcfg, p, batch):
    f = functools.partial(jbuild(jcfg).loss, batch=jax.tree.map(jnp.asarray, batch), **CHUNKS)
    loss, g = jax.jit(jax.value_and_grad(lambda pp: f(pp)))(jax.tree.map(jnp.asarray, p))
    return float(loss), jax.tree.map(np.asarray, g)


def port_loss_grads(tcfg, p, batch, **kw):
    """(loss tensor, grads tree) of the port's ``Model.loss`` on numpy weights."""
    params = weights.params_from_numpy(p, DEV)
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss = build_model(tcfg).loss(params, {k: torch.from_numpy(v) for k, v in batch.items()},
                                  **CHUNKS, **kw)
    loss.backward()
    grads = weights.tree_map(lambda t: t.grad, params)
    return loss.detach(), grads


def assert_grads_close(grads_t, grads_j, rel=GRAD_REL):
    lt, lj = tree_leaves(grads_t), tree_leaves(grads_j)
    assert len(lt) == len(lj)
    for i, (t, j) in enumerate(zip(lt, lj)):
        assert tuple(t.shape) == j.shape, i
        t = t.numpy()
        bound = rel * max(np.abs(j).max(), 1e-30)
        assert np.isfinite(t).all(), f"leaf {i}: non-finite gradient"
        err = np.abs(t - j).max()
        assert err <= bound, f"leaf {i} {j.shape}: max|diff| {err:.3e} > {bound:.3e}"


def check_family(arch, seq, seed, **kw):
    """Loss within LOSS_REL, every gradient leaf within GRAD_REL * max|g| of
    JAX's; remat on and off give bitwise equal losses and gradients."""
    jcfg, tcfg = cfg_pair(arch, **kw)
    p = jax_params(jcfg, seed)
    batch = train_batch(jcfg, seq, seed)
    want_loss, want = jax_loss_grads(jcfg, p, batch)
    loss, grads = port_loss_grads(tcfg, p, batch)
    assert abs(float(loss) - want_loss) <= LOSS_REL * abs(want_loss), (float(loss), want_loss)
    assert_grads_close(grads, want)
    loss_nr, grads_nr = port_loss_grads(tcfg, p, batch, remat=False)
    assert torch.equal(loss, loss_nr)
    for a, b in zip(tree_leaves(grads), tree_leaves(grads_nr)):
        assert torch.equal(a, b)


def check_no_inplace_error(arch, dtype_name, seq):
    """``loss.backward()`` under remat in ``dtype_name`` raises nothing (no
    "modified by an inplace operation") and every gradient is finite."""
    _, tcfg = cfg_pair(arch, dtype=dtype_name)
    model = build_model(tcfg)
    params = model.init(0, device=DEV)
    for t in tree_leaves(params):
        t.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in train_batch(tcfg, seq, 1).items()}
    loss = model.loss(params, batch, **CHUNKS)
    loss.backward()
    assert torch.isfinite(loss)
    for t in tree_leaves(params):
        assert t.grad is not None and torch.isfinite(t.grad).all()


def check_lm_loss_chunked(seed, b=2, s=32, d=16, vocab=64, chunk=8):
    """``lm_loss_chunked`` against JAX's (value and gradients w.r.t. x and
    the unembedding) and against ``lm_loss`` of the full logits."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    w = (rng.standard_normal((d, vocab)) / np.sqrt(d)).astype(np.float32)
    labels = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels[rng.random((b, s)) < 0.2] = -1
    jf = lambda xx, ww: jmodel.lm_loss_chunked({"out": ww}, xx, jnp.asarray(labels), vocab,
                                                chunk)
    want, (gx_j, gw_j) = jax.value_and_grad(jf, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt, wt = (torch.tensor(a, requires_grad=True) for a in (x, w))
    got = tmodel.lm_loss_chunked({"out": wt}, xt, torch.from_numpy(labels), vocab, chunk)
    got.backward()
    got = got.detach()
    assert abs(float(got) - float(want)) <= LOSS_REL * abs(float(want))
    assert_grads_close({"x": xt.grad, "w": wt.grad}, {"x": np.asarray(gx_j), "w": np.asarray(gw_j)},
                       rel=1e-5)
    full = tmodel.lm_loss(tmodel.unembed_apply({"out": wt}, xt), torch.from_numpy(labels),
                          vocab).detach()
    assert abs(float(full) - float(got)) <= LOSS_REL * abs(float(got))
    want_full = jmodel.lm_loss(jnp.asarray(x) @ jnp.asarray(w), jnp.asarray(labels), vocab)
    assert abs(float(full) - float(want_full)) <= LOSS_REL * abs(float(want_full))
