"""The port's moe, vlm and audio families (``repro_torch.models``) on the CPU
against the JAX package: deepseek-moe-16b and llama4-scout (moe),
internvl2-26b (vlm) and hubert-xlarge (audio), at their smoke configs; and
every architecture's full-size specs and decode cache.

JAX's initialised weights cross with ``weights.params_from_numpy``; inputs
are numpy arrays from fixed seeds (``tests/torch_families.py``).
``forward`` is held in float32 and bfloat16, a ``decode_step`` chain in
float32 with float32 caches (the audio encoder has no decode cache in
either package). Tolerances are ``torch_parity.tol``. The ssm and hybrid
families are in ``tests/test_torch_recurrent.py``, the serving engine on
these families in ``tests/test_torch_family_engines.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax

import repro.configs as jconfigs
from repro.models import build_model as jbuild
from repro_torch import configs as tconfigs
from repro_torch.models import build_model
from repro_torch.models import weights
from repro_torch.models.spec import tree_leaves
from torch_families import (ALL_ARCHS, B, DEV, DTYPES, S, batch_to_torch, cfg_pair,
                            check_decode_chain, check_decode_matches_forward, check_forward,
                            compute_refs, make_batch)
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

ARCHS = ["deepseek_moe_16b", "llama4_scout_17b_a16e", "internvl2_26b", "hubert_xlarge"]
DECODE_ARCHS = ARCHS[:-1]
# full-size parameter counts of the families served on the card: (the specs'
# count, what init allocates; the config's analytic n_params(), which leaves
# out the Mamba2 blocks' conv_b, norm_w and in_proj's B/C share of the
# count the specs give, and hubert's unembed)
FULL_PARAMS = {"deepseek_moe_16b": (16_879_568_896, 16_879_568_896),
               "mamba2_2_7b": (2_832_074_240, 2_831_566_336),
               "zamba2_2_7b": (2_422_670_240, 2_422_248_608),
               "internvl2_26b": (19_869_014_016, 19_869_014_016),
               "hubert_xlarge": (945_450_240, 945_143_040)}


@pytest.fixture(scope="module")
def refs():
    return compute_refs(ARCHS, DECODE_ARCHS)


def test_build_model_accepts_every_architecture():
    for arch in tconfigs.list_archs():
        for smoke in (False, True):
            cfg = tconfigs.get_config(arch, smoke=smoke)
            m = build_model(cfg)
            assert m.n_params() > 0 and set(m.specs()) >= {"blocks", "final_ln"}, arch


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_full_size_specs_and_caches_match_jax(arch):
    """At full width: n_params() = JAX's spec count (and the counts stated);
    abstract params are meta tensors of JAX's shapes and axes; the decode
    cache has JAX's keys, shapes and dtypes (audio has none in either)."""
    cfg = tconfigs.get_config(arch)
    jm = jbuild(jconfigs.get_config(arch))
    m = build_model(cfg)
    assert m.n_params() == jm.n_params()
    assert cfg.n_params() == jconfigs.get_config(arch).n_params()
    if arch in FULL_PARAMS:
        assert (m.n_params(), cfg.n_params()) == FULL_PARAMS[arch]
    abstract = m.abstract_params(torch.bfloat16)
    leaves = tree_leaves(abstract)
    assert all(t.is_meta and t.dtype == torch.bfloat16 for t in leaves)
    assert [tuple(t.shape) for t in leaves] == \
        [tuple(s.shape) for s in jax.tree.leaves(jm.abstract_params())]
    jaxes = jax.tree.leaves(jm.logical_axes(), is_leaf=lambda x: isinstance(x, tuple))
    assert tree_leaves(m.logical_axes()) == list(jaxes)
    if cfg.family == "audio":
        with pytest.raises(ValueError, match="no decode cache"):
            jm.cache_specs(4, 256)
        with pytest.raises(ValueError, match="no decode cache"):
            m.cache_specs(4, 256)
        return
    cache = m.cache_specs(4, 256)
    jcache = jm.cache_specs(4, 256)
    assert {k: (tuple(t.shape), str(t.dtype).replace("torch.", "")) for k, t in cache.items()} \
        == {k: (tuple(s.shape), str(s.dtype)) for k, s in jcache.items()}
    assert all(t.is_meta for t in cache.values())


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(refs, arch, dtype_name):
    check_forward(refs, arch, dtype_name)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_chain_matches_jax(refs, arch):
    check_decode_chain(refs, arch)


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "llama4_scout_17b_a16e"])
def test_decode_matches_forward(refs, arch):
    check_decode_matches_forward(refs, arch)


def test_audio_has_no_decode_path(refs):
    _, tcfg = cfg_pair("hubert_xlarge")
    tm = build_model(tcfg)
    assert "embed" not in tm.specs() and "unembed" in tm.specs()
    with pytest.raises(ValueError, match="no decode cache"):
        tm.init_cache(2, 8, device=DEV)
    with pytest.raises(ValueError, match="no decode cache"):
        tm.decode_step(weights.params_from_numpy(refs["hubert_xlarge"]["p"], DEV), {},
                       torch.zeros(2, dtype=torch.int32), torch.zeros(2, dtype=torch.int32))
    assert not tm.supports_prefill_cache()


def test_encoder_is_not_causal(refs):
    """hubert attends both ways: changing the last frame moves the first
    position's logits (a causal stack would leave them bitwise)."""
    _, tcfg = cfg_pair("hubert_xlarge")
    tm = build_model(tcfg)
    tp = weights.params_from_numpy(refs["hubert_xlarge"]["p"], DEV)
    frames = torch.from_numpy(refs["hubert_xlarge"]["batch"]["frames"])
    a, _ = tm.forward(tp, {"frames": frames})
    frames2 = frames.clone()
    frames2[:, -1] += 1.0
    b, _ = tm.forward(tp, {"frames": frames2})
    assert not torch.equal(a[:, 0], b[:, 0])


def test_loss_is_not_ported_yet():
    """Training is ported now: the MoE loss runs and carries 0.01 * the
    load-balance aux of every layer (the gradients are held against JAX
    in tests/test_torch_training_moe.py)."""
    from repro_torch.models.model import lm_loss
    cfg = dataclasses.replace(tconfigs.get_config("deepseek_moe_16b", smoke=True),
                              dtype="float32")
    m = build_model(cfg)
    params = m.init(0, device=DEV)
    batch = batch_to_torch(make_batch(cfg, 4), torch.float32)
    labels = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab, (B, S)))
    logits, aux = m.forward(params, batch)
    loss = m.loss(params, dict(batch, labels=labels))
    assert float(aux) > 0 and torch.isfinite(loss)
    assert torch.equal(loss, lm_loss(logits, labels, cfg.padded_vocab) + 0.01 * aux)
