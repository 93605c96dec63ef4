"""Training of the port's ssm and hybrid families on the CPU against the
JAX package: ``Model.loss`` and every gradient leaf against
``jax.value_and_grad`` at mamba2-2.7b's and zamba2-2.7b's smoke configs in
float32 over two SSD chunks, remat on against off, backward with no
in-place error (``tests/torch_training.py`` has the bounds); and the SSD
decay, masked before ``exp``: its forward is bitwise the unmasked form's,
its gradient equals JAX's at chunks 32 and 64, and at chunks 128 and 256,
where JAX's float32 gradient is NaN (its mask comes after an ``exp`` that
overflows), it is finite and agrees with JAX's float64 gradient.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.models.mamba2 as jm2
from repro_torch.models import mamba2 as tm2
import torch_training as tt
from torch_training import one_torch_thread  # noqa: F401 (autouse)

SSD_REL = 1e-5  # dt-gradient: max|diff| <= SSD_REL * max|g_ref|


@pytest.mark.parametrize("arch,seed", [("mamba2_2_7b", 5), ("zamba2_2_7b", 6)])
def test_recurrent_loss_and_grads_match_jax(arch, seed):
    tt.check_family(arch, 64, seed)


@pytest.mark.parametrize("arch", ["mamba2_2_7b", "zamba2_2_7b"])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_recurrent_backward_has_no_inplace_error(arch, dtype_name):
    tt.check_no_inplace_error(arch, dtype_name, 64)


def _segsum_unmasked_exp(dA):
    """The decay as the JAX package and the port before it computed it:
    ``where(tril, exp(diff), 0)``."""
    q = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool))
    return torch.where(mask, torch.exp(diff), torch.zeros((), dtype=dA.dtype))


@pytest.mark.parametrize("q", [16, 64, 256])
def test_segsum_decay_forward_is_unchanged(q):
    rng = np.random.default_rng(q)
    dA = -np.logaddexp(rng.standard_normal((2, 4, q)), 0).astype(np.float32)
    got = tm2._segsum_decay(torch.from_numpy(dA))
    assert torch.equal(got, _segsum_unmasked_exp(torch.from_numpy(dA)))
    # JAX's cumsum and exp round differently from torch's in the last bits:
    # an ulp of the cumulative sums moves exp(diff) by that much, relative
    want = np.asarray(jm2._segsum_decay(jnp.asarray(dA)))
    ulps = 8 * np.finfo(np.float32).eps * np.abs(np.cumsum(dA, axis=-1)).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=ulps, atol=1e-30)  # subnormals
    assert (got.numpy()[..., ~np.tril(np.ones((q, q), bool))] == 0).all()


def _ssd_inputs():
    """(b, T, H, P, N) = (1, 512, 4, 8, 16), float32, A = -1 (A_log's zero
    init), dt = softplus(N(0, 1)), numpy seed 0."""
    b, t, h, p, n = 1, 512, 4, 8, 16
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, t, h, p)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, t, h)), 0).astype(np.float32)
    B = rng.standard_normal((b, t, n)).astype(np.float32)
    C = rng.standard_normal((b, t, n)).astype(np.float32)
    w = rng.standard_normal((b, t, h, p)).astype(np.float32)  # cotangent of y
    return x, dt, -np.ones(h, np.float32), B, C, w


def _port_dt_grad(chunk):
    x, dt, A, B, C, w = _ssd_inputs()
    d = torch.tensor(dt, requires_grad=True)
    y, _ = tm2.ssd_chunked(torch.from_numpy(x), d, torch.from_numpy(A), torch.from_numpy(B),
                           torch.from_numpy(C), chunk)
    (y * torch.from_numpy(w)).sum().backward()
    return d.grad.numpy()


def _jax_dt_grad(chunk, dtype):
    x, dt, A, B, C, w = (jnp.asarray(a, dtype) for a in _ssd_inputs())
    # unroll: JAX's scan carries a float32 state, which a float64 step breaks
    f = lambda d: jnp.sum(jm2.ssd_chunked(x, d, A, B, C, chunk, unroll=True)[0] * w)
    return np.asarray(jax.jit(jax.grad(f))(dt), np.float64)


@pytest.mark.parametrize("chunk", [32, 64])
def test_ssd_grad_matches_jax_at_short_chunks(chunk):
    got, want = _port_dt_grad(chunk), _jax_dt_grad(chunk, jnp.float32)
    assert np.abs(got - want).max() <= SSD_REL * np.abs(want).max()


@pytest.mark.parametrize("chunk", [128, 256])
def test_ssd_grad_finite_where_jax_float32_is_nan(chunk):
    got = _port_dt_grad(chunk)
    assert np.isnan(_jax_dt_grad(chunk, jnp.float32)).all()
    assert np.isfinite(got).all()
    with jax.enable_x64(True):
        want = _jax_dt_grad(chunk, jnp.float64)
    assert np.isfinite(want).all()
    assert np.abs(got - want).max() <= SSD_REL * np.abs(want).max()
