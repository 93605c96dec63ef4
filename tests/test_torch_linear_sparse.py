"""The port's ``LinearSparse`` (sparse-weight serving) on the CPU against the
JAX package.

Mirrors ``tests/test_linear_sparse.py`` and the three ``LinearSparse`` tests
of ``tests/test_serve.py`` on the port with ``device="cpu"``, and holds the
two packages together: the same numpy weight gives the same
``prune_magnitude`` output and a bit-identical weight container, the
pattern-only picks agree, and a JAX layer carried across with
``LinearSparse.from_numpy`` computes the same ``layer(x)``. Weights and
inputs are made with numpy from fixed seeds; tolerance 1e-4 in float32
(the JAX layers run their jnp reference path, ``backend="ref"``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.models.linear_sparse as jls
from repro.core import Format as JFormat
from repro_torch.core.formats import Format
from repro_torch.core.ops import spmm
from repro_torch.models import WEIGHT_CANDIDATES, LinearSparse, prune_magnitude
from repro_torch.models import linear_sparse as tls
from repro_torch.obs import metrics
from torch_parity import assert_same_container, jax_fields, static_of, tol

RNG = np.random.default_rng(0)
DEV = "cpu"


@pytest.fixture(autouse=True)
def _private_selection_cache(tmp_path, monkeypatch):
    """The JAX policy opens a selection cache; keep it off the user's."""
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "selections.json"))


def _w(d_in, d_out, density, seed):
    rng = np.random.default_rng(seed)
    return prune_magnitude(rng.standard_normal((d_in, d_out)).astype(np.float32), density)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_prune_density():
    w = RNG.standard_normal((64, 96)).astype(np.float32)
    wp = prune_magnitude(w, 0.25)
    density = (wp != 0).mean()
    assert 0.2 < density <= 0.3
    keep = wp != 0
    np.testing.assert_array_equal(wp[keep], w[keep])  # survivors unchanged


@pytest.mark.parametrize("density", [0.25, 0.3, 0.5])
def test_prune_magnitude_is_bit_identical_to_jax(density):
    w = np.random.default_rng(1).standard_normal((48, 80)).astype(np.float32)
    a, b = prune_magnitude(w, density), jls.prune_magnitude(w, density)
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("fmt", [Format.CSR, Format.ELL, Format.HYB, Format.COO, Format.SELL],
                         ids=lambda f: f.name)
def test_linear_sparse_matches_dense(fmt):
    w = _w(48, 80, 0.3, 2)
    b = _x(80, 3)
    layer = LinearSparse.from_dense(w, fmt=fmt, bias=b, device=DEV)
    x = _x((4, 7, 48), 4)
    y = layer(torch.from_numpy(x))
    assert y.shape == (4, 7, 80) and layer.format == fmt
    np.testing.assert_allclose(y.numpy(), x.astype(np.float64) @ w + b, **tol("float32"))


def test_linear_sparse_autotune_and_switch():
    w = _w(64, 64, 0.2, 5)
    layer = LinearSparse.from_dense(w, device=DEV)  # analytic pick
    assert layer.format in WEIGHT_CANDIDATES
    x = torch.ones(3, 64)
    y1 = layer(x)
    switched = layer.activate(Format.COO)
    assert switched.format == Format.COO and layer.format != Format.DENSE
    torch.testing.assert_close(y1, switched(x), **tol("float32"))


@pytest.mark.parametrize("fmt", [Format.CSR, Format.ELL, Format.HYB, Format.COO],
                         ids=lambda f: f.name)
def test_call_matches_old_double_transpose_path(fmt):
    """The transposed-rhs path replaced ``spmm(W, x.T).T``; the two must stay
    interchangeable for every weight format (on the CPU ELL and HYB SpMM run
    the reference; on the card their SpMM kernels are still to be ported)."""
    w = _w(40, 56, 0.3, 6)
    layer = LinearSparse.from_dense(w, fmt=fmt, device=DEV)
    x = torch.from_numpy(_x((6, 40), 7))
    y_old = spmm(layer.weight, x.T, backend="ref").T
    torch.testing.assert_close(layer(x), y_old, **tol("float32"))


def test_from_dense_width_aware_profile():
    """ncols reaches the profiling tuner: a width-stated build succeeds and
    the layer computes correctly at that width."""
    w = _w(32, 48, 0.2, 8)
    layer = LinearSparse.from_dense(w, tune="profile", ncols=16, device=DEV)
    assert layer.format in WEIGHT_CANDIDATES
    x = _x((16, 32), 9)
    np.testing.assert_allclose(layer(torch.from_numpy(x)).numpy(),
                               x.astype(np.float64) @ w, **tol("float32"))


def test_retune_counters_track_switch_vs_keep():
    """serve.retune counts every re-selection; serve.format_switch only the
    ones that changed the container."""
    w = _w(48, 48, 0.2, 10)
    layer = LinearSparse.from_dense(w, fmt=Format.COO, device=DEV)
    with metrics.scope() as s:
        retuned = layer.retune(ncols=64, tune="analytic")
        assert s.delta("serve.retune") == 1
        expected = 1 if retuned.format != layer.format else 0
        assert s.delta("serve.format_switch") == expected == 1  # analytic leaves COO
        again = retuned.retune(ncols=64, tune="analytic")
        assert s.delta("serve.retune") == 2 and s.delta("serve.format_switch") == 1
        assert again is retuned


def test_format_switch_between_decode_steps_parity():
    """activate() between steps is numerically invisible: a decode-shaped
    loop whose layer hops CSR -> ELL -> HYB -> COO -> SELL matches the
    fixed-format run."""
    w = _w(32, 32, 0.3, 11)
    layer = LinearSparse.from_dense(w, fmt=Format.CSR, device=DEV)
    x0 = torch.from_numpy(_x((1, 32), 12))

    def roll(layers):
        x, outs = x0, []
        for L in layers:
            x = torch.tanh(L(x))
            outs.append(x)
        return outs

    base = roll([layer] * 5)
    hops = [layer] + [layer.activate(f) for f in (Format.ELL, Format.HYB, Format.COO,
                                                  Format.SELL)]
    for step, (a, b) in enumerate(zip(base, roll(hops))):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, msg=f"switch at step {step}")


def test_retune_under_decode_parity():
    """retune(ncols) may switch the stored format but never the numbers."""
    w = _w(48, 48, 0.2, 13)
    layer = LinearSparse.from_dense(w, fmt=Format.COO, device=DEV)
    x1, x64 = torch.from_numpy(_x((1, 48), 14)), torch.from_numpy(_x((64, 48), 15))
    wide = layer.retune(ncols=64, tune="analytic")
    torch.testing.assert_close(layer(x1), wide(x1), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(layer(x64), wide(x64), rtol=1e-5, atol=1e-5)


def _jax_layer(w, fmt, bias=None):
    return jls.LinearSparse.from_dense(w, fmt=JFormat(int(fmt)), bias=bias, backend="ref")


@pytest.mark.parametrize("fmt", WEIGHT_CANDIDATES, ids=lambda f: f.name)
def test_same_weight_container_as_jax(fmt):
    w = _w(40, 72, 0.25, 16)
    assert_same_container(_jax_layer(w, fmt).weight.concrete,
                          LinearSparse.from_dense(w, fmt=fmt, device=DEV).weight.concrete)


@pytest.mark.parametrize("tune", ["analytic", "ml"])
def test_pattern_only_picks_match_jax(tune):
    for seed, density in ((17, 0.25), (18, 0.1), (19, 0.5)):
        w = _w(64, 48, density, seed)
        pj = jls.LinearSparse.from_dense(w, tune=tune, ncols=8, backend="ref").format
        pt = LinearSparse.from_dense(w, tune=tune, ncols=8, device=DEV).format
        assert int(pt) == int(pj)


@pytest.mark.parametrize("fmt", WEIGHT_CANDIDATES, ids=lambda f: f.name)
def test_from_numpy_carries_a_jax_layer_across(fmt):
    w = _w(40, 72, 0.25, 20)
    b = _x(72, 21)
    jl = _jax_layer(w, fmt, bias=jnp.asarray(b))
    A = jl.weight.concrete
    tl = LinearSparse.from_numpy(jax_fields(A), int(A.format), A.shape, A.nnz,
                                 bias=np.asarray(jl.bias), device=DEV, **static_of(A))
    assert tl.format == fmt
    assert_same_container(A, tl.weight.concrete)
    for t in (1, 5):
        x = _x((t, 40), 22 + t)
        np.testing.assert_allclose(tl(torch.from_numpy(x)).numpy(),
                                   np.asarray(jl(jnp.asarray(x))), **tol("float32"))


def test_layer_is_a_module_with_a_bias_buffer_and_no_parameters():
    w = _w(16, 24, 0.5, 24)
    layer = LinearSparse.from_dense(w, fmt=Format.ELL, bias=np.ones(24, np.float32),
                                    device=DEV)
    assert isinstance(layer, torch.nn.Module) and not list(layer.parameters())
    assert [n for n, _ in layer.named_buffers()] == ["bias"]
    assert "ELL" in repr(layer)
    assert LinearSparse.from_dense(w, fmt=Format.CSR, device=DEV).bias is None


def test_default_device_is_the_card(monkeypatch):
    """``device=None`` means CUDA; without a card the build raises rather
    than carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LinearSparse.from_dense(_w(8, 8, 0.5, 25), fmt=Format.CSR)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LinearSparse.from_numpy({}, Format.CSR, (8, 8), 0)
    assert tls.WEIGHT_CANDIDATES == tuple(Format(int(f)) for f in jls.WEIGHT_CANDIDATES)
