"""The port's optimizer and gradient compression (``repro_torch.optim``) on
the CPU against the JAX package's: the AdamW schedule, five updates of a
nested tree with clipping active, ``tests/test_training.py``'s three AdamW
properties, int8 quantization and error-feedback compression bitwise over
three rounds, and ``compressed_psum`` on a one-rank gloo group."""
import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

import repro.optim.adamw as jadamw
import repro.optim.grad_compress as jgc
from repro_torch.models.spec import tree_leaves
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import grad_compress as tgc
from torch_training import one_torch_thread  # noqa: F401 (autouse)

F32_ULP = np.finfo(np.float32).eps
UPDATE_REL = 1e-6  # params, m and v after 5 updates: max|diff| <= UPDATE_REL * max|jax|


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("step", [0, 1, 9, 10, 11, 99, 100])
def test_schedule_matches_jax(step):
    """warmup 10, total 100: steps 0, 1, warmup - 1, warmup, warmup + 1 and
    the total; within 1 f32 ulp of JAX's (XLA's cos may round apart from
    torch's), and bitwise in the warmup, where no cos is taken."""
    kw = dict(lr=3e-3, warmup_steps=10, total_steps=100, lr_min_ratio=0.1)
    j = float(jadamw.AdamW(**kw).schedule(jnp.asarray(step, jnp.int32)))
    t = tadamw.AdamW(**kw).schedule(torch.tensor(step, dtype=torch.int32))
    assert t.dtype == torch.float32 and t.shape == ()
    assert abs(float(t) - j) <= F32_ULP * abs(j)
    if step < 10:
        assert float(t) == j
    # a Python int step gives the same schedule
    assert float(tadamw.AdamW(**kw).schedule(step)) == float(t)


def _tree(rng):
    return {"b": {"w": rng.standard_normal((5, 3)).astype(np.float32),
                  "z": rng.standard_normal((7,)).astype(np.float32)},
            "a": rng.standard_normal((4,)).astype(np.float32)}


def test_five_updates_match_jax_with_clipping():
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    grads = [jax.tree.map(lambda a, s=s: a * s, _tree(rng)) for s in (5.0, 0.1, 3.0, 0.05, 1.0)]
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=1.0)
    jopt, topt = jadamw.AdamW(**kw), tadamw.AdamW(**kw)
    jp = jax.tree.map(jnp.asarray, p0)
    js = jopt.init(jp)
    tp = jax.tree.map(lambda a: torch.tensor(a), p0)
    ts = topt.init(tp)
    clipped = 0
    for g in grads:
        gn = np.sqrt(sum(np.sum(np.square(x)) for x in jax.tree.leaves(g)))
        clipped += gn > 1.0
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp2, ts = topt.update(jax.tree.map(torch.tensor, g), ts, tp)
        assert tp2 is tp
    assert clipped >= 1
    assert int(ts.step) == int(js.step) == 5 and ts.step.dtype == torch.int32
    for t, j in [(tp, jp), (ts.m, js.m), (ts.v, js.v)]:
        for a, b in zip(tree_leaves(t), jax.tree.leaves(j)):
            a, b = _np(a), np.asarray(b)
            assert a.dtype == np.float32
            assert np.abs(a - b).max() <= UPDATE_REL * np.abs(b).max()


def test_adamw_decreases_quadratic():
    opt = tadamw.AdamW(lr=0.1, weight_decay=0.0, warmup_steps=1, total_steps=100)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    for _ in range(60):
        params, state = opt.update({"w": 2 * params["w"]}, state, params)
    assert float(params["w"].abs().max()) < 0.3


def test_adamw_grad_clip():
    opt = tadamw.AdamW(lr=0.0, grad_clip=1.0)
    params = {"w": torch.zeros(3)}
    state = opt.init(params)
    _, state = opt.update({"w": torch.full((3,), 1e6)}, state, params)
    # clipped first moment magnitude bounded by (1-b1)*clip
    assert float(state.m["w"].abs().max()) <= 0.11


def test_adamw_schedule_warmup_and_decay():
    opt = tadamw.AdamW(lr=1.0, warmup_steps=10, total_steps=100, lr_min_ratio=0.1)
    assert float(opt.schedule(0)) < float(opt.schedule(9))
    assert abs(float(opt.schedule(10)) - 1.0) < 0.05
    assert float(opt.schedule(99)) < 0.2


def test_quantize_matches_jax_bitwise():
    rng = np.random.default_rng(1)
    g = (rng.standard_normal((1000,)) * 3).astype(np.float32)
    g[:256] = 0.0  # an all-zero block: scale 0, payload 0
    g[256] = 127.0  # block 1's scale is exactly 1: its halves are ties, rounded to even
    g[300:303] = (2.5, 3.5, -2.5)
    qj, sj = jgc.quantize(jnp.asarray(g))
    qt, st = tgc.quantize(torch.from_numpy(g))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert qt[1, 44:47].tolist() == [2, 4, -2]
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(tgc.dequantize(qt, st, (1000,), torch.float32).numpy(),
                                  np.asarray(jgc.dequantize(qj, sj, (1000,), jnp.float32)))


def test_compress_tree_error_feedback_matches_jax_bitwise():
    rng = np.random.default_rng(2)
    ej = et = None
    for _ in range(3):
        g = {"x": rng.standard_normal((300,)).astype(np.float32) * 1e-3,
             "y": {"z": rng.standard_normal((4, 70)).astype(np.float32)}}
        pj, ej = jgc.compress_tree(jax.tree.map(jnp.asarray, g), ej)
        pt, et = tgc.compress_tree(jax.tree.map(torch.tensor, g), et)
        for (qa, sa), (qb, sb) in zip([pt["x"], pt["y"]["z"]], [pj["x"], pj["y"]["z"]]):
            np.testing.assert_array_equal(qa.numpy(), np.asarray(qb))
            np.testing.assert_array_equal(sa.numpy(), np.asarray(sb))
        for a, b in zip(tree_leaves(et), jax.tree.leaves(ej)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        dj = jgc.decompress_tree(pj, jax.tree.map(jnp.asarray, g))
        dt = tgc.decompress_tree(pt, jax.tree.map(torch.tensor, g))
        for a, b in zip(tree_leaves(dt), jax.tree.leaves(dj)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_error_feedback_accumulates():
    """With error feedback, the quantization bias vanishes over steps."""
    g_true = torch.from_numpy(np.random.default_rng(1).standard_normal((512,))
                              .astype(np.float32)) * 1e-3
    tree, errors, total = {"g": g_true}, None, torch.zeros(512)
    for _ in range(50):
        payload, errors = tgc.compress_tree(tree, errors)
        total += tgc.decompress_tree(payload, tree)["g"]
    np.testing.assert_allclose((total / 50).numpy(), g_true.numpy(), atol=2e-4)


def test_compressed_psum_one_rank_gloo(tmp_path):
    """On a one-rank gloo group (a FileStore in tmp_path: no network) the
    mean is the dequantized tree, as with no group at all."""
    g = {"a": torch.from_numpy(np.random.default_rng(3).standard_normal((600,))
                               .astype(np.float32))}
    want, want_e = tgc.compressed_psum(g)
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        got, got_e = tgc.compressed_psum(g)
        grp = dist.new_group([0])
        got2, _ = tgc.compressed_psum(g, group=grp)
    finally:
        dist.destroy_process_group()
    pj, _ = jgc.compress_tree({"a": jnp.asarray(g["a"].numpy())})
    deq = np.asarray(jgc.decompress_tree(pj, {"a": jnp.asarray(g["a"].numpy())})["a"])
    for out in (want, got, got2):
        np.testing.assert_array_equal(out["a"].numpy(), deq)
    np.testing.assert_array_equal(got_e["a"].numpy(), want_e["a"].numpy())
