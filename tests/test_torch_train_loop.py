"""The port's training driver (``repro_torch.launch.train``) and MoE example
(``repro_torch.train_moe_sparse``) on the CPU: four float32 steps
of ``make_train_step`` from JAX's stablelm smoke params against the body of
JAX's ``step_fn`` (``value_and_grad`` + ``AdamW.update``, without its
mesh-sharded ``jit``); ``main`` checkpointing at step 4 and resuming to 6
with the uninterrupted run's losses bitwise; the flags that must raise; and
the MoE example's dispatch pick and loss."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs as jconfigs
import repro.data.pipeline as jpipe
from repro.models import build_model as jbuild
from repro.optim.adamw import AdamW as JAdamW
from repro_torch import configs as tconfigs
from repro_torch import train_moe_sparse
from repro_torch.launch import train
from repro_torch.models import build_model, weights
from repro_torch.models.spec import tree_leaves
from repro_torch.optim.adamw import AdamW
from torch_training import one_torch_thread  # noqa: F401 (autouse)

# Losses: |diff| <= STEP_REL * |jax| at every step. Final params: per leaf
# ||diff||_2 <= STEP_REL * ||jax||_2. Not elementwise: AdamW divides by
# sqrt(v), so an element whose gradient is at the float32 noise of the
# gradients' sums moves by up to lr one way or the other; after 4 steps 4
# of stablelm smoke's 130k elements differ by up to 7e-5 * max|p|, while
# the worst leaf differs by 2.0e-6 in norm.
STEP_REL = 1e-5
SMOKE = ["--arch", "stablelm_1_6b", "--smoke", "--batch", "4", "--seq", "32",
         "--device", "cpu", "--log-every", "1"]


def test_four_train_steps_match_jax_step_body():
    arch, kw = "stablelm_1_6b", dict(lr=3e-3, total_steps=4, warmup_steps=1)
    jcfg = dataclasses.replace(jconfigs.get_config(arch, smoke=True), dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get_config(arch, smoke=True), dtype="float32")
    jm = jbuild(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    src = jpipe.SyntheticLM(jcfg.vocab, 32, 4, seed=0)
    jopt = JAdamW(**kw)

    @jax.jit
    def jstep(params, opt, batch):
        loss, grads = jax.value_and_grad(
            lambda p: jm.loss(p, batch, q_chunk=32, kv_chunk=32))(params)
        params, opt = jopt.update(grads, opt, params)
        return params, opt, loss

    tparams = train.trainable(weights.params_from_numpy(jax.tree.map(np.asarray, params), "cpu"))
    topt = AdamW(**kw)
    step_fn = train.make_train_step(build_model(tcfg), topt,
                                    "cpu", q_chunk=32, kv_chunk=32)
    state = train.TrainState(tparams, topt.init(tparams))
    jo = jopt.init(params)
    for step in range(4):
        batch = src.batch_at(step)
        params, jo, jloss = jstep(params, jo, jax.tree.map(jnp.asarray, batch))
        state, loss = step_fn(state, batch)
        assert abs(float(loss) - float(jloss)) <= STEP_REL * abs(float(jloss)), step
    assert state.params is tparams and int(state.opt.step) == 4
    for t, j in zip(tree_leaves(state.params), jax.tree.leaves(params)):
        j = np.asarray(j)
        assert t.grad is None and t.requires_grad
        assert np.linalg.norm(t.detach().numpy() - j) <= STEP_REL * np.linalg.norm(j)


def test_main_resumes_bitwise(tmp_path, capsys):
    d = str(tmp_path / "ck")
    full = train.main(SMOKE + ["--steps", "6", "--ckpt-dir", d, "--ckpt-every", "4"])
    first = capsys.readouterr().out
    assert "[ckpt] step 4 -> " in first and "final loss:" in first
    assert [s for s, _ in full["losses"]] == list(range(6))
    resumed = train.main(SMOKE + ["--steps", "6", "--ckpt-dir", d, "--resume"])
    out = capsys.readouterr().out
    assert "[resume] restoring step 4" in out
    assert resumed["losses"] == full["losses"][4:]  # bitwise: the same floats
    for a, b in zip(tree_leaves(resumed["state"].params), tree_leaves(full["state"].params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("flag", [["--mesh", "production"], ["--multi-pod"]])
def test_production_mesh_raises(flag):
    """A production mesh needs 256 ranks (512 multi-pod); one process of the
    port drives one device, so the launcher prints the layout and raises."""
    ranks = 512 if "--multi-pod" in flag else 256
    with pytest.raises(ValueError, match=f"needs {ranks} ranks"):
        train.main(SMOKE + ["--steps", "1"] + flag)


def test_no_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    argv = [a for a in SMOKE if a not in ("--device", "cpu")] + ["--steps", "1"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(argv)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_moe_sparse.main(["--steps", "1"])


def test_train_moe_sparse_picks_a_dispatch_and_trains(capsys):
    out = train_moe_sparse.main(["--steps", "3", "--batch", "2", "--seq", "64",
                                 "--log-every", "1", "--device", "cpu"])
    text = capsys.readouterr().out
    assert out["dispatch"] in ("dense", "sort", "coo") and set(out["times"]) == {
        "dense", "sort", "coo"}
    assert f"-> selected '{out['dispatch']}'" in text
    assert "step    2 loss " in text and np.isfinite(out["last"])
