"""SELL's slice schedule on the CPU: the launch plan and the plain route.

``repro_torch.kernels.sell_spmm.slice_plan`` decides the slice kernel's
launch (``csrc/sell_spmm.cu``: threads a block, the rhs staged in shared
memory or gathered through L1, slices split over a cluster, slices a
block) from host ints; it is pinned here at both minitron-8b MLP weights'
shapes on an H100's limits and at the edges (one slice, C = 1024, a rhs
past the shared-memory limit, many short slices). The kernel itself runs
only on a card (``tests/test_torch_cuda.py``); here the wrappers' CPU
route, the plain version the card is held to, is held against JAX's jnp
SELL reference on a slice-starved matrix of long rows (the shape that
takes the split path on the card). Tolerances: 1e-4 in float32, 2e-2 in
bfloat16.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core.formats as jf
import repro.core.ops as jops
import repro_torch.core  # noqa: F401  (before the kernels: they import the core package)
from repro_torch.kernels import sell_spmm as ksm
from repro_torch.kernels.ref import sell_spmm_ref, sell_spmm_t_ref
from torch_parity import coo_pair, jconv, port_from_jax, tol
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

# An H100 SXM: SMs, opt-in shared memory a block, shared memory an SM
# (cudaDevAttrMultiProcessorCount, ...PerBlockOptin, ...PerMultiprocessor).
H100 = dict(sms=132, optin=232448, smem_per_sm=233472)
# minitron-8b's MLP weights stored (d_out, d_in) at density 0.25 in SELL
# C = 32: 512 slices of ~1024 planes (up), 128 slices of ~4096 (down).
WEIGHTS = {"up": (512, 1024, 4096), "down": (128, 4096, 16384)}
ES = {"float32": 4, "bfloat16": 2}

# (weight, dtype, tt) -> (threads, stage, split, per, blocks)
PINNED = {
    ("up", "float32", 1): (512, True, 1, 1, 512),
    ("up", "float32", 2): (512, True, 1, 1, 512),
    ("up", "float32", 4): (512, True, 1, 1, 512),
    ("up", "float32", 8): (1024, True, 1, 1, 512),  # 128 KB of X: one block an SM
    ("up", "bfloat16", 1): (512, True, 1, 1, 512),
    ("up", "bfloat16", 8): (512, True, 1, 1, 512),
    ("down", "float32", 1): (512, True, 2, 1, 256),  # 128 slices for 132 SMs: split
    ("down", "float32", 2): (1024, True, 2, 1, 256),
    ("down", "float32", 4): (512, False, 2, 1, 256),  # 256 KB of X does not fit
    ("down", "float32", 8): (512, False, 2, 1, 256),
    ("down", "bfloat16", 1): (512, True, 2, 1, 256),
    ("down", "bfloat16", 4): (1024, True, 2, 1, 256),
    ("down", "bfloat16", 8): (512, False, 2, 1, 256),
}


def _weight_plan(name, dtype_name, tt, tiles=1):
    nslices, planes, n = WEIGHTS[name]
    es = ES[dtype_name]
    total = nslices * planes
    return ksm.slice_plan(nslices, 32, total, tt, tt * n * es, tiles, total * 32 * (4 + es),
                          **H100)


@pytest.mark.parametrize("key", sorted(PINNED), ids=lambda k: "-".join(map(str, k)))
def test_plan_at_the_minitron_weights(key):
    plan = _weight_plan(*key)
    assert (plan.threads, plan.stage, plan.split, plan.per, plan.blocks) == PINNED[key]
    groups = plan.threads // 32
    sums = groups * 32 * key[2] * 4 + 32 * key[2] * 4
    rhs = key[2] * WEIGHTS[key[0]][2] * ES[key[1]]
    assert plan.smem == sums + (rhs if plan.stage else 0)
    assert plan.smem <= H100["optin"]
    assert plan.blocks >= H100["sms"]  # every SM has a block: the down weight is split


@pytest.mark.parametrize("dtype_name", sorted(ES))
def test_down_weight_fills_the_card_only_when_split(dtype_name):
    plan = _weight_plan("down", dtype_name, 1)
    assert plan.split == 2 and plan.blocks == 2 * 128 > H100["sms"] > 128
    # the same slices on a card of 128 SMs or fewer are not split
    small = ksm.slice_plan(128, 32, 128 * 4096, 1, 16384 * ES[dtype_name], 1,
                           128 * 4096 * 32 * 8, 128, H100["optin"], H100["smem_per_sm"])
    assert small.split == 1 and small.blocks == 128


@pytest.mark.parametrize("tiles", [2, 4, 8])
def test_token_tiles_count_as_units_of_the_split(tiles):
    """Below T = 64 sell_spmm_t runs tt = 8 over T / 8 tiles: 128 slices x 2
    tiles already give every SM a block."""
    plan = _weight_plan("down", "float32", 8, tiles)
    assert plan.split == 1 and plan.blocks == 128 * tiles and not plan.stage


def test_one_slice_splits_four_ways():
    plan = ksm.slice_plan(1, 32, 3000, 1, 4096 * 4, 1, 3000 * 32 * 8, **H100)
    assert (plan.threads, plan.stage, plan.split, plan.per, plan.blocks) == (512, True, 4, 1, 4)


def test_one_short_slice_is_not_split():
    """A rank needs one full trip of its plane groups (16 groups x 4 planes)."""
    plan = ksm.slice_plan(1, 32, 100, 1, 4096 * 4, 1, 100 * 32 * 8, **H100)
    assert plan.split == 1 and plan.blocks == 1


def test_c_1024_takes_a_block_of_1024_threads():
    plan = ksm.slice_plan(16, 1024, 16 * 2000, 1, 4096 * 4, 1, 16 * 2000 * 1024 * 8, **H100)
    assert plan.threads == 1024 and plan.split == 4 and plan.blocks == 64
    assert plan.smem == 1024 * 4 + 1024 * 4 + 4096 * 4  # one group: partials = sums
    assert plan.slots == H100["sms"]


@pytest.mark.parametrize("dtype_name", sorted(ES))
@pytest.mark.parametrize("tt", [1, 8])
def test_rhs_past_the_shared_memory_limit_is_gathered(dtype_name, tt):
    n = 131072  # 512 KB of f32, 256 KB of bf16 a row: past 227 KB
    plan = ksm.slice_plan(512, 32, 512 * 1024, tt, tt * n * ES[dtype_name], 1,
                          512 * 1024 * 32 * 8, **H100)
    assert not plan.stage and plan.threads == 512
    assert plan.smem == 16 * 32 * tt * 4 + 32 * tt * 4 and plan.slots == 2 * H100["sms"]


def test_rhs_whose_copies_outweigh_the_weight_is_gathered():
    """600 slices of 2 planes (150 KB of weight in f32) and a 16384-wide x:
    600 blocks would copy 38 MB of x to stream 150 KB of weight; a 64-wide
    x (256 B a copy) is staged."""
    nslices, weight = 600, 600 * 2 * 32 * 8
    plan = ksm.slice_plan(nslices, 32, nslices * 2, 1, 16384 * 4, 1, weight, **H100)
    assert not plan.stage and plan.split == 1 and plan.per == 1 and plan.blocks == 600
    assert ksm.slice_plan(nslices, 32, nslices * 2, 1, 64 * 4, 1, weight, **H100).stage


def test_many_short_slices_share_a_block():
    """HPCG-like rows of 27 entries: 35152 slices, about four blocks a
    resident slot, each block walking 34 slices on one copy of x."""
    nslices = 35152
    plan = ksm.slice_plan(nslices, 32, nslices * 27, 1, 16384 * 4, 1, nslices * 27 * 32 * 8,
                          **H100)
    assert plan.stage and plan.split == 1 and plan.slots == 264
    assert plan.per == 34 and plan.blocks == 1034


def test_plan_is_a_pure_function_of_its_ints():
    a = _weight_plan("down", "bfloat16", 2)
    assert a == _weight_plan("down", "bfloat16", 2) and hash(a) == hash(
        _weight_plan("down", "bfloat16", 2))
    assert "split 2" in a.describe() and "staged" in a.describe()


def _starved_pair(rng, m, n):
    """A slice-starved matrix: ``m`` rows of thousands of entries (a few
    empty), in both packages' SELL C = 32 (fewer slices than any card's SMs)."""
    a = np.zeros((m, n), np.float32)
    for i in range(m):
        if i % 7:
            ln = int(rng.integers(n // 3, 4 * n // 5))
            a[i, rng.choice(n, ln, replace=False)] = rng.standard_normal(ln)
    Jc, _ = coo_pair(a, capacity=None)
    Sj = jconv.convert(Jc, jf.Format.SELL, c=32, sigma=64)
    return a, Sj, port_from_jax(Sj)


def _widened(Sj, dtype_name):
    """JAX's container with its values rounded to the working type and
    widened to f32 (JAX's jnp reference would sum bf16 in bf16)."""
    vals = torch.from_numpy(np.array(Sj.data, np.float32)).to(
        torch.bfloat16 if dtype_name == "bfloat16" else torch.float32).float().numpy()
    return dataclasses.replace(Sj, data=jnp.asarray(vals))


@pytest.mark.parametrize("dtype_name", sorted(ES))
def test_cpu_route_matches_jax_on_a_slice_starved_matrix(dtype_name):
    rng = np.random.default_rng(70)
    m, n = 90, 2400
    a, Sj, S = _starved_pair(rng, m, n)
    assert S.nslices == 3 and int(S.perm.max()) == m  # ghost lanes
    dt = torch.bfloat16 if dtype_name == "bfloat16" else torch.float32
    args = (S.slice_ptrs, S.cols, S.data.to(dt), S.perm)
    Sw = _widened(Sj, dtype_name)
    before = (ksm.launches, ksm.launches_t, ksm.last_plan)
    for w in (1, 2, 3, 8, 20):
        B = torch.from_numpy(rng.standard_normal((n, w)).astype(np.float32)).to(dt)
        X = B.T.contiguous()
        y = ksm.sell_spmm(*args, B, m, 32)
        y_t = ksm.sell_spmm_t(*args, X, m, 32)
        assert torch.equal(y, sell_spmm_ref(*args, B, m, 32))  # CPU: the plain version
        assert torch.equal(y_t, sell_spmm_t_ref(*args, X, m, 32))
        assert y.shape == (m, w) and y.dtype == dt and bool(torch.isfinite(y).all())
        yj = np.asarray(jops.spmm(Sw, jnp.asarray(B.float().numpy()), backend="ref"))
        yj_t = np.asarray(jops.spmm_t(Sw, jnp.asarray(X.float().numpy()), backend="ref"))
        np.testing.assert_allclose(y.float().numpy(), yj, **tol(dtype_name))
        np.testing.assert_allclose(y_t.float().numpy(), yj_t, **tol(dtype_name))
        assert not bool(y[::7].any())  # empty rows write zeros
    assert (ksm.launches, ksm.launches_t, ksm.last_plan) == before  # no launch, no plan
