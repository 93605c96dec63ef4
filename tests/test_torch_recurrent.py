"""The port's ssm and hybrid families (``repro_torch.models``) on the CPU against
the JAX package: mamba2-2.7b and zamba2-2.7b at their smoke configs.

``forward`` in float32 and bfloat16, a ``decode_step`` chain from an empty
float32 cache against JAX's (every step's logits and the final conv, ssm
and k/v), and decode against the port's own forward at every position.
Inputs and checks are ``tests/torch_families.py``'s; tolerances are
``torch_parity.tol``. The engine on these families is in
``tests/test_torch_ssm.py``.
"""
import pytest
import torch

from repro_torch.models import build_model
from repro_torch.models import weights
from torch_families import (DEV, DTYPES, cfg_pair, check_decode_chain,
                            check_decode_matches_forward, check_forward, compute_refs)
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

ARCHS = ["mamba2_2_7b", "zamba2_2_7b"]


@pytest.fixture(scope="module")
def refs():
    return compute_refs(ARCHS, ARCHS)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(refs, arch, dtype_name):
    check_forward(refs, arch, dtype_name)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_chain_matches_jax(refs, arch):
    check_decode_chain(refs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(refs, arch):
    check_decode_matches_forward(refs, arch)


def test_collect_kv_raises_for_recurrent_families(refs):
    for arch in ("mamba2_2_7b", "zamba2_2_7b"):
        _, tcfg = cfg_pair(arch)
        tp = weights.params_from_numpy(refs[arch]["p"], DEV)
        with pytest.raises(ValueError, match="has no kv cache"):
            build_model(tcfg).forward(tp, {"tokens": torch.zeros((1, 4), dtype=torch.int32)},
                                      collect_kv=True)
