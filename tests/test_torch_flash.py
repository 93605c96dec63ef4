"""The port's flash attention (``repro_torch.models.flash``, forward) on the
CPU against the JAX package's, at the chunk pairs of ``tests/test_flash.py``,
causal and not, GQA (8 heads over 4 kv heads) and MHA, float32 and
bfloat16. Inputs are numpy arrays from a fixed seed; tolerances are
``torch_parity.tol`` (float32 1e-4, bfloat16 2e-2).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.models.flash as jflash
from repro_torch.models import flash as tflash
from torch_parity import tol
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(x: np.ndarray, dtype_name: str):
    jd, td = DTYPES[dtype_name]
    return jnp.asarray(x, jd), torch.from_numpy(np.asarray(x, np.float32)).to(td)




@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", [(8, 4), (4, 4)], ids=["gqa", "mha"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("qc,kc", [(32, 64), (128, 128), (64, 32), (16, 16)])
def test_flash_attention(qc, kc, causal, heads, dtype_name):
    h, kvh = heads
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 128, h, 32)).astype(np.float32)
    k = rng.standard_normal((2, 128, kvh, 32)).astype(np.float32)
    v = rng.standard_normal((2, 128, kvh, 32)).astype(np.float32)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype_name) for a in (q, k, v))
    out_t = tflash.flash_attention(qt, kt, vt, causal, qc, kc, False)
    assert out_t.dtype == qt.dtype and out_t.shape == qt.shape
    jflash_jit = jax.jit(jflash.flash_attention, static_argnums=(3, 4, 5, 6))
    np.testing.assert_allclose(out_t.float().numpy(),
                               np.asarray(jflash_jit(qj, kj, vj, causal, qc, kc, False),
                                          np.float32), **tol(dtype_name))
    # unroll changes nothing
    assert torch.equal(out_t, tflash.flash_attention(qt, kt, vt, causal, qc, kc, True))
