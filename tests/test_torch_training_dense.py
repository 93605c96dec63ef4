"""Training of the port's dense decoder on the CPU against the JAX package:
``Model.loss`` and every gradient leaf against ``jax.value_and_grad`` at the
smoke configs in float32 (MHA, GQA, the qkv bias), remat on against off,
backward with no in-place error in both dtypes, and the chunked CE
(``tests/torch_training.py`` has the bounds)."""
import pytest

import torch_training as tt
from torch_training import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("arch,seed", [("stablelm_1_6b", 0), ("minitron_8b", 1),
                                       ("qwen1_5_32b", 2)])
def test_dense_loss_and_grads_match_jax(arch, seed):
    tt.check_family(arch, 16, seed)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_dense_backward_has_no_inplace_error(dtype_name):
    tt.check_no_inplace_error("stablelm_1_6b", dtype_name, 16)


@pytest.mark.parametrize("seed", [0, 1])
def test_lm_loss_chunked_matches_jax_and_lm_loss(seed):
    tt.check_lm_loss_chunked(seed)
