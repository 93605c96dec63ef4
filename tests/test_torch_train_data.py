"""The port's data pipeline (``repro_torch.data.pipeline``) on the CPU
against the JAX package's: every source's batches are bitwise equal for
seeds 0 and 3 at steps 0, 1 and 7 (the memmap file written in
``tmp_path``), ``make_source`` picks the same source, and ``to_device``
keeps dtypes and values."""
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.data.pipeline as jpipe
from repro_torch import configs as tconfigs
from repro_torch.data import pipeline as tpipe


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("step", [0, 1, 7])
def test_synthetic_sources_bitwise(seed, step):
    _equal(tpipe.SyntheticLM(100, 16, 4, seed).batch_at(step),
           jpipe.SyntheticLM(100, 16, 4, seed).batch_at(step))
    _equal(tpipe.SyntheticFrames(8, 10, 12, 3, seed).batch_at(step),
           jpipe.SyntheticFrames(8, 10, 12, 3, seed).batch_at(step))


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("step", [0, 1, 7])
def test_memmap_source_bitwise(tmp_path, seed, step):
    path = tmp_path / "toks.bin"
    np.random.default_rng(11).integers(0, 5000, 10000).astype(np.int32).tofile(path)
    src = tpipe.MemmapTokens(str(path), seq_len=32, global_batch=2, seed=seed)
    assert src.n_tokens == 10000
    _equal(src.batch_at(step), jpipe.MemmapTokens(str(path), 32, 2, seed).batch_at(step))


@pytest.mark.parametrize("arch", ["stablelm_1_6b", "hubert_xlarge", "internvl2_26b"])
def test_make_source_matches_jax(arch, tmp_path):
    j = jpipe.make_source(jconfigs.get_config(arch, smoke=True), 16, 2, seed=3)
    t = tpipe.make_source(tconfigs.get_config(arch, smoke=True), 16, 2, seed=3)
    assert type(t).__name__ == type(j).__name__
    _equal(t.batch_at(5), j.batch_at(5))
    path = tmp_path / "toks.bin"
    np.arange(1000, dtype=np.int32).tofile(path)
    t = tpipe.make_source(tconfigs.get_config(arch, smoke=True), 16, 2, path=str(path))
    assert isinstance(t, tpipe.MemmapTokens)


def test_to_device_keeps_dtypes_and_values():
    batch = tpipe.SyntheticFrames(8, 10, 12, 3, 0).batch_at(2)
    out = tpipe.to_device(batch, "cpu")
    for k, v in batch.items():
        assert isinstance(out[k], torch.Tensor) and out[k].device.type == "cpu"
        np.testing.assert_array_equal(out[k].numpy(), v)
    assert out["labels"].dtype == torch.int32 and out["frames"].dtype == torch.float32
