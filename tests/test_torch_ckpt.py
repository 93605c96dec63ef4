"""The port's checkpoints (``repro_torch.checkpoint.ckpt``) on the CPU
against the JAX package's: JAX's four checkpoint tests restated (roundtrip,
partial write ignored, checksum catches corruption, cleanup); a JAX
``TrainState`` (a smoke model's params with one bf16 leaf, AdamW state after
two updates) restores in the port bitwise and the port's save of it
restores in JAX bitwise, with byte-identical leaf files; and the serving
example with a training checkpoint: JAX's ``examples/serve_decode.py``
hands ``params`` as ``like`` and raises on the leaf count, the port's
``serve_decode --ckpt`` restores the params of either package's checkpoint.
"""
import functools
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.checkpoint.ckpt as jckpt
import repro.configs as jconfigs
from repro.launch.train import TrainState as JTrainState
from repro.models import build_model as jbuild
from repro.optim.adamw import AdamW as JAdamW
from repro_torch import serve_decode
from repro_torch.checkpoint import ckpt
from repro_torch.launch.train import TrainState
from repro_torch.models import weights
from repro_torch.models.spec import tree_leaves, tree_map
from repro_torch.optim.adamw import AdamW, AdamWState
from torch_training import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_ckpt_roundtrip(tmp_path):
    tree = {"a": torch.arange(10.0), "b": {"c": torch.ones((3, 4), dtype=torch.bfloat16)}}
    ckpt.save(str(tmp_path), 5, tree)
    assert ckpt.latest_step(str(tmp_path)) == 5
    like = tree_map(torch.zeros_like, tree)
    out = ckpt.restore(str(tmp_path), 5, like, "cpu")
    assert torch.equal(out["a"], torch.arange(10.0))
    assert out["b"]["c"].dtype == torch.bfloat16 and torch.equal(out["b"]["c"], tree["b"]["c"])


def test_ckpt_partial_write_ignored(tmp_path):
    """A crash mid-write must not corrupt resume (atomic publish)."""
    ckpt.save(str(tmp_path), 1, {"a": torch.ones(4)})
    os.makedirs(tmp_path / "step_00000002")  # a torn step: no manifest
    os.makedirs(tmp_path / "step_00000003.tmp")
    assert ckpt.latest_step(str(tmp_path)) == 1


def test_ckpt_checksum_detects_corruption(tmp_path):
    tree = {"a": torch.ones(64)}
    d = ckpt.save(str(tmp_path), 3, tree)
    with open(os.path.join(d, "arr_00000.npy"), "r+b") as fh:
        fh.seek(-4, 2)
        fh.write(b"\xde\xad\xbe\xef")
    with pytest.raises(IOError):
        ckpt.restore(str(tmp_path), 3, tree, "cpu")


def test_ckpt_cleanup(tmp_path):
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, {"a": torch.ones(2)})
    ckpt.cleanup(str(tmp_path), keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 5
    assert not os.path.exists(tmp_path / "step_00000001")
    assert sorted(os.listdir(tmp_path)) == ["step_00000004", "step_00000005"]


def test_ckpt_restore_checks_structure(tmp_path):
    ckpt.save(str(tmp_path), 1, {"a": torch.ones(4), "b": torch.ones(2)})
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(str(tmp_path), 1, {"a": torch.ones(4)}, "cpu")
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), 1, {"a": torch.ones(4), "b": torch.ones(3)}, "cpu")


@functools.lru_cache(maxsize=1)
def _jax_train_state():
    """stablelm's smoke params (final_ln in bf16) and AdamW state after two
    updates, as the JAX package's train.py would checkpoint them."""
    cfg = jconfigs.get_config("stablelm_1_6b", smoke=True)
    params = jbuild(cfg).init(jax.random.PRNGKey(0))
    params["final_ln"] = params["final_ln"].astype(jnp.bfloat16) + 0.5
    opt = JAdamW(lr=1e-2)
    state = opt.init(params)
    rng = np.random.default_rng(0)
    update = jax.jit(opt.update)
    for _ in range(2):
        grads = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape), p.dtype), params)
        params, state = update(grads, state, params)
    return JTrainState(params, state)


def _port_like(jstate):
    p = weights.params_from_numpy(jax.tree.map(np.asarray, jstate.params), "cpu")
    return TrainState(p, AdamW().init(p))


def _assert_state_equal(tstate, jstate):
    lt = tree_leaves(tstate.params) + [tstate.opt.step] + tree_leaves(tstate.opt.m) \
        + tree_leaves(tstate.opt.v)
    lj = jax.tree.leaves(jstate)
    assert len(lt) == len(lj)
    for t, j in zip(lt, lj):
        j = np.asarray(j)
        assert str(t.dtype).replace("torch.", "") == str(j.dtype)
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(t.view(torch.int16).numpy(), j.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), j)


def test_jax_train_state_restores_in_the_port_bitwise(tmp_path):
    jstate = _jax_train_state()
    jckpt.save(str(tmp_path), 2, jstate)
    got = ckpt.restore(str(tmp_path), 2, _port_like(jstate), "cpu")
    assert isinstance(got, TrainState) and isinstance(got.opt, AdamWState)
    assert got.params["final_ln"].dtype == torch.bfloat16
    assert got.opt.step.dtype == torch.int32 and int(got.opt.step) == 2
    _assert_state_equal(got, jstate)


def test_port_save_restores_in_jax_bitwise_with_identical_files(tmp_path):
    jstate = _jax_train_state()
    tstate = ckpt.restore(*_saved_by_jax(tmp_path / "jax", jstate), _port_like(jstate), "cpu")
    d_port = ckpt.save(str(tmp_path / "port"), 2, tstate)
    back = jckpt.restore(str(tmp_path / "port"), 2, jstate)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a).reshape(-1).view(np.uint8),
                                      np.asarray(b).reshape(-1).view(np.uint8))
    with open(os.path.join(str(tmp_path / "jax"), "step_00000002", "manifest.json")) as f:
        mj = json.load(f)
    with open(os.path.join(d_port, "manifest.json")) as f:
        mt = json.load(f)
    assert mt["treedef"].startswith("repro_torch:") and mj["n_leaves"] == mt["n_leaves"]
    for a, b in zip(mt["leaves"], mj["leaves"]):
        assert (a["file"], a["shape"], a["dtype"], a["crc32"]) == \
            (b["file"], b["shape"], b["dtype"], b["crc32"])


def _saved_by_jax(d, jstate):
    jckpt.save(str(d), 2, jstate)
    return str(d), 2


def _run_jax_serve_decode(argv):
    spec = importlib.util.spec_from_file_location(
        "jax_serve_decode", os.path.join(ROOT, "examples", "serve_decode.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main(argv)


def test_jax_serve_decode_rejects_a_train_checkpoint(tmp_path):
    """JAX's example passes ``params`` as ``like`` to a TrainState
    checkpoint: restore raises on the leaf count."""
    jckpt.save(str(tmp_path), 2, _jax_train_state())
    with pytest.raises(ValueError, match="leaves"):
        _run_jax_serve_decode(["--ckpt", str(tmp_path), "--requests", "1", "--max-new", "1"])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_serve_decode_restores_the_params_of_a_train_checkpoint(tmp_path, writer):
    jstate = _jax_train_state()
    jstate = JTrainState(jax.tree.map(lambda a: a.astype(jnp.float32), jstate.params),
                         jstate.opt)
    if writer == "jax":
        jckpt.save(str(tmp_path), 2, jstate)
    else:
        ckpt.save(str(tmp_path), 2, ckpt.restore(*_saved_by_jax(tmp_path / "j", jstate),
                                                 _port_like(jstate), "cpu"))
    out = serve_decode.main(["--ckpt", str(tmp_path), "--device", "cpu", "--requests", "2",
                             "--max-new", "3"])
    assert len(out["done"]) == 2 and all(len(o) == 3 for _, o in out["done"])
    for t, j in zip(tree_leaves(out["params"]), jax.tree.leaves(jstate.params)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
