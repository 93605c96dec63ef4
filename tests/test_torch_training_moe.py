"""Training of the port's MoE family on the CPU against the JAX package:
``Model.loss`` and every gradient leaf against ``jax.value_and_grad`` at
deepseek-moe-16b's and llama4-scout's smoke configs in float32, through each
dispatch (``dense``, ``sort``, ``coo``: the gradient reaches x and the gates
through ``spmm`` on COO), remat on against off, and backward with no
in-place error (``tests/torch_training.py`` has the bounds)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.core.formats as jf
import repro.core.ops as jops
import repro_torch.core.formats as tf
import repro_torch.core.ops as tops
import torch_training as tt
from torch_training import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("dispatch", ["dense", "sort", "coo"])
def test_moe_loss_and_grads_match_jax(dispatch):
    tt.check_family("deepseek_moe_16b", 16, 3, moe_dispatch=dispatch)


def test_llama4_loss_and_grads_match_jax():
    tt.check_family("llama4_scout_17b_a16e", 16, 4)


@pytest.mark.parametrize("dispatch", ["dense", "sort", "coo"])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_moe_backward_has_no_inplace_error(dtype_name, dispatch):
    tt.check_no_inplace_error("deepseek_moe_16b", dtype_name, 16)


def test_coo_spmm_grads_match_jax_with_a_stored_zero():
    """spmm(COO, B)'s gradients w.r.t. B and the stored values, with a stored
    zero, a duplicate entry and an empty row, against ``jax.grad`` of JAX's
    ``spmm(backend="ref")``: a stored zero's value gradient is dY[row].B[col]."""
    rng = np.random.default_rng(7)
    row = np.array([0, 0, 2, 3, 3, 1], np.int32)
    col = np.array([1, 4, 0, 2, 2, 3], np.int32)
    data = rng.standard_normal(6).astype(np.float32)
    data[1] = 0.0
    b = rng.standard_normal((5, 3)).astype(np.float32)
    w = rng.standard_normal((5, 3)).astype(np.float32)  # cotangent of Y (5 rows: 4 is empty)

    def jloss(d, bb):
        A = jf.COO(row=jnp.asarray(row), col=jnp.asarray(col), data=d, shape=(5, 5), nnz=6)
        return jnp.sum(jops.spmm(A, bb, backend="ref") * w)

    gd_j, gb_j = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(data), jnp.asarray(b))
    d_t, b_t = (torch.tensor(a, requires_grad=True) for a in (data, b))
    A = tf.COO(row=torch.from_numpy(row), col=torch.from_numpy(col), data=d_t, shape=(5, 5),
               nnz=6)
    (tops.spmm(A, b_t) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(d_t.grad.numpy(), np.asarray(gd_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(b_t.grad.numpy(), np.asarray(gb_j), rtol=1e-6, atol=1e-6)
    assert d_t.grad[1] != 0
    # a second graph over the same container backpropagates too (nothing cached
    # holds the first graph)
    d_t.grad = None
    (tops.spmm(A, b_t) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(d_t.grad.numpy(), np.asarray(gd_j), rtol=1e-6, atol=1e-6)
