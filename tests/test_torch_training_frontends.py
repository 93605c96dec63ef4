"""Training of the port's vlm and audio families on the CPU against the JAX
package: ``Model.loss`` and every gradient leaf against
``jax.value_and_grad`` at internvl2-26b's (patches through ``frontend.proj``
before the tokens) and hubert-xlarge's (frames, non-causal encoder) smoke
configs in float32, remat on against off, backward with no in-place error
(``tests/torch_training.py`` has the bounds)."""
import pytest

import torch_training as tt
from torch_training import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("arch,seed", [("internvl2_26b", 7), ("hubert_xlarge", 8)])
def test_frontend_loss_and_grads_match_jax(arch, seed):
    tt.check_family(arch, 16, seed)


@pytest.mark.parametrize("arch", ["internvl2_26b", "hubert_xlarge"])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_frontend_backward_has_no_inplace_error(arch, dtype_name):
    tt.check_no_inplace_error(arch, dtype_name, 16)
