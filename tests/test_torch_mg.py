"""The port's multigrid pieces against the JAX package's ``repro.mg``:
coarsening tables and transfers, the color split and the color blocks in
every format, the smoothers, and the batched selection that picks the
blocks' formats (``batch_features``, ``FormatPolicy.select_batch``).

Inputs are HPCG grids and numpy vectors from fixed seeds; JAX runs on the
CPU through its jnp reference (``backend="ref"``), the port on its CPU
path. Tables and containers must be identical; sums within the tolerance
each test names. Few JAX shapes are used: its eager ops compile per shape.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core.hpcg as jhpcg
import repro.mg as jmg
from repro.tuning import FormatPolicy as JPolicy
from repro.tuning import features as jfeat
from repro_torch import mg
from repro_torch.core import hpcg
from repro_torch.core.convert import planned_pulls_scope
from repro_torch.core.formats import COO, Format
from repro_torch.core.ops import spmv
from repro_torch.tuning import FormatPolicy, PatternFeatures, SelectionCache
from repro_torch.tuning.features import batch_features
from torch_parity import DEV, assert_same_container, jax_fields
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

BLOCK_DIMS = [(4, 4, 4), (5, 3, 4), (8, 8, 2)]  # even, uneven (padded lanes), flat


@pytest.fixture(autouse=True)
def _private_selection_cache(tmp_path, monkeypatch):
    """The policies open a selection cache; keep it off the user's."""
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "selections.json"))


def _coo(dims):
    prob = hpcg.generate_problem(*dims)
    return prob, jhpcg.to_coo(jhpcg.generate_problem(*dims)), hpcg.to_coo(prob, device=DEV)


def _np(t):
    return t.cpu().numpy()


# ---------------------------------------------------------------------------
# Coarsening
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("args,kwargs", [
    ((3, 4, 4), {}), ((4, 4, 0), {}), ((4, 4, 4), {"coarse_op": "galerkin"}),
    ((4, 4, 4), {"prolong": "cubic"}), ((4, 4, 4), {"coarse_op": "lumped"}),
])
def test_plan_coarsen_raises_where_jax_raises(args, kwargs):
    with pytest.raises(ValueError) as ej:
        jmg.plan_coarsen(*args, **kwargs)
    with pytest.raises(ValueError) as et:
        mg.plan_coarsen(*args, **kwargs)
    assert str(et.value) == str(ej.value)


def test_plan_coarsen_fields_equal_jax():
    pj = jmg.plan_coarsen(4, 6, 8, prolong="trilinear", coarse_op="galerkin")
    pt = mg.plan_coarsen(4, 6, 8, prolong="trilinear", coarse_op="galerkin")
    assert (pt.fine, pt.coarse, pt.prolong, pt.coarse_op, pt.nf, pt.nc) == \
        (pj.fine, pj.coarse, pj.prolong, pj.coarse_op, pj.nf, pj.nc)


@pytest.mark.parametrize("dims", [(4, 4, 4), (4, 6, 4)])
def test_f2c_and_trilinear_tables_equal_jax(dims):
    pj, pt = jmg.plan_coarsen(*dims), mg.plan_coarsen(*dims)
    np.testing.assert_array_equal(_np(mg.f2c_map(pt, DEV)), np.asarray(jmg.f2c_map(pj)))
    cj, wj = jmg.trilinear_corners(pj)
    ct, wt = mg.trilinear_corners(pt, DEV)
    np.testing.assert_array_equal(_np(ct), np.asarray(cj))
    assert wt.dtype == torch.float32
    np.testing.assert_array_equal(_np(wt), np.asarray(wj))


def test_stencil27_coo_bit_identical_to_jax():
    Cj = jmg.stencil27_coo(3, 4, 2)
    Ct = mg.stencil27_coo(3, 4, 2, device=DEV)
    assert Ct.shape == Cj.shape and Ct.nnz == Cj.nnz == 27 * 24
    assert_same_container(Cj, Ct)
    # and the same matrix as the host problem generator
    prob = hpcg.generate_problem(3, 4, 2)
    dense = np.zeros(prob.shape, np.float32)
    np.add.at(dense, (_np(Ct.row), _np(Ct.col)), _np(Ct.data))
    want = np.zeros(prob.shape, np.float32)
    want[prob.row, prob.col] = prob.val
    np.testing.assert_array_equal(dense, want)


def _dense_transfers(c, nf, nc):
    """(R, P) of a port Coarsening, column by column from unit vectors."""
    R = torch.stack([mg.restrict(c, e) for e in torch.eye(nf)], dim=1).numpy()
    P = torch.stack([mg.prolong(c, e) for e in torch.eye(nc)], dim=1).numpy()
    return R, P


@pytest.mark.parametrize("dims,kind,tol,scale", [
    ((4, 4, 4), "injection", 1e-6, 1.0), ((4, 6, 4), "trilinear", 1e-5, 8.0)])
def test_restrict_prolong_match_jax_and_p_is_r_transposed(dims, kind, tol, scale):
    pj = jmg.plan_coarsen(*dims, prolong=kind)
    pt = mg.plan_coarsen(*dims, prolong=kind)
    cj, ct = jmg.coarsen_execute(pj), mg.coarsen_execute(pt, device=DEV)
    rng = np.random.default_rng(0)
    rf = rng.standard_normal(pt.nf).astype(np.float32)
    xc = rng.standard_normal(pt.nc).astype(np.float32)
    np.testing.assert_allclose(_np(mg.restrict(ct, torch.from_numpy(rf))),
                               np.asarray(jmg.restrict(cj, jnp.asarray(rf))), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(mg.prolong(ct, torch.from_numpy(xc))),
                               np.asarray(jmg.prolong(cj, jnp.asarray(xc))), rtol=tol, atol=tol)
    R, P = _dense_transfers(ct, pt.nf, pt.nc)
    np.testing.assert_allclose(P, scale * R.T, rtol=0, atol=1e-7)


def test_coarsen_execute_rediscretizes_on_the_device():
    plan = mg.plan_coarsen(4, 4, 6)
    c = mg.coarsen_execute(plan, device=DEV)
    assert c.tri_cols is None and c.f2c.device.type == "cpu"
    assert_same_container(jmg.stencil27_coo(2, 2, 3), c.Ac)
    with pytest.raises(ValueError, match="needs the fine operator"):
        mg.coarsen_execute(mg.plan_coarsen(4, 4, 4, prolong="trilinear",
                                           coarse_op="galerkin"), device=DEV)


def test_galerkin_coarse_matches_jax():
    prob, Cj, Ct = _coo((4, 4, 4))
    pj = jmg.plan_coarsen(4, 4, 4, prolong="trilinear", coarse_op="galerkin")
    pt = mg.plan_coarsen(4, 4, 4, prolong="trilinear", coarse_op="galerkin")
    Aj = jmg.galerkin_coarse(Cj, pj)
    At = mg.galerkin_coarse(Ct, pt)
    assert_same_container(Aj, At)
    Ac = mg.coarsen_execute(pt, Af=Ct).Ac
    np.testing.assert_array_equal(_np(Ac.data), np.asarray(Aj.data))
    cp = mg.coarse_problem(prob)
    assert (cp.nx, cp.ny, cp.nz) == (2, 2, 2) and cp.shape == (8, 8)


# ---------------------------------------------------------------------------
# Coloring
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dims", BLOCK_DIMS)
def test_color_tables_and_split_identical_to_jax(dims):
    prob, Cj, Ct = _coo(dims)
    colors = mg.color_grid(*dims)
    np.testing.assert_array_equal(colors, jmg.color_grid(*dims))
    np.testing.assert_array_equal(mg.color_ranks(colors), jmg.smoothers.color_ranks(colors))
    counts = np.bincount(colors, minlength=mg.NCOLORS)
    rmax = int(counts.max())
    np.testing.assert_array_equal(mg.color_rows_padded(colors, prob.shape[0], rmax),
                                  jmg.smoothers.color_rows_padded(colors, prob.shape[0], rmax))
    cap = 27 * rmax
    Sj = jmg.smoothers.split_colors_stacked(Cj, colors, rmax, cap)
    St = mg.split_colors_stacked(Ct, colors, rmax, cap)
    assert St.shape == Sj.shape and St.nnz == Sj.nnz and St.row.shape == (8, cap)
    for name, a in jax_fields(Sj).items():
        np.testing.assert_array_equal(_np(getattr(St, name)), a, err_msg=name)


@pytest.mark.parametrize("fmt", ["CSR", "ELL", "DIA", "SELL", "COO"])
@pytest.mark.parametrize("dims", BLOCK_DIMS)
def test_build_colored_blocks_identical_to_jax(dims, fmt):
    _, Cj, Ct = _coo(dims)
    csj = jmg.build_colored(Cj, dims=dims, fmt=Format[fmt])
    cst = mg.build_colored(Ct, dims=dims, fmt=Format[fmt], check=True)
    assert [f.name for f in cst.formats] == [f.name for f in csj.formats] == [fmt] * 8
    for bj, bt in zip(csj.blocks, cst.blocks):
        assert_same_container(bj, bt)
    n = Ct.shape[0]
    for rj, rt, k in zip(csj.rows, cst.rows, cst.counts):
        np.testing.assert_array_equal(_np(rt), np.asarray(rj))
        assert k == int((np.asarray(rj) < n).sum())
    np.testing.assert_array_equal(_np(cst.diag), np.asarray(csj.diag))


def test_check_coloring_rejects_improper():
    _, _, Ct = _coo((4, 4, 4))
    with pytest.raises(ValueError, match="improper coloring"):
        mg.check_coloring(Ct, np.zeros(Ct.shape[0], np.int32))
    with pytest.raises(ValueError, match="improper coloring"):
        mg.build_colored(Ct, colors=np.arange(64, dtype=np.int32) % 2, check=True)
    mg.check_coloring(Ct, mg.color_grid(4, 4, 4))  # the grid coloring is proper


# ---------------------------------------------------------------------------
# Smoothers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dims", BLOCK_DIMS)
def test_symgs_matches_jax_and_the_sequential_oracle(dims):
    """As tests/test_mg.py::test_colored_symgs_matches_sequential_gs holds
    JAX: 2e-5 against the sequential numpy Gauss-Seidel."""
    prob, Cj, Ct = _coo(dims)
    rng = np.random.default_rng(0)
    n = prob.shape[0]
    b = rng.standard_normal(n).astype(np.float32)
    x0 = rng.standard_normal(n).astype(np.float32)
    csj = jmg.build_colored(Cj, dims=dims, fmt=Format.CSR)
    cst = mg.build_colored(Ct, dims=dims, fmt=Format.CSR)
    x0_t = torch.from_numpy(x0)
    got = mg.symgs(cst, torch.from_numpy(b), x0_t, sweeps=2)
    np.testing.assert_array_equal(x0_t.numpy(), x0)  # the input is not modified
    want = jmg.symgs(csj, jnp.asarray(b), jnp.asarray(x0), sweeps=2, backend="ref")
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-5, atol=2e-5)
    oracle = mg.symgs_reference_np(prob.row, prob.col, prob.val, mg.color_grid(*dims),
                                   b, x0, sweeps=2)
    np.testing.assert_allclose(_np(got), oracle, rtol=2e-5, atol=2e-5)
    fwd = mg.gs_sweep(cst, torch.from_numpy(b), x0_t, forward=False)
    np.testing.assert_allclose(
        _np(fwd), np.asarray(jmg.gs_sweep(csj, jnp.asarray(b), jnp.asarray(x0),
                                          forward=False, backend="ref")),
        rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("fmt", ["ELL", "SELL", "DIA", "COO"])
def test_symgs_with_padded_lanes_matches_the_oracle_at_13_cubed(fmt):
    """13^3: the colors hold 343 down to 216 rows, so every block but one
    carries padded lanes, in every block format."""
    dims = (13, 13, 13)
    prob = hpcg.generate_problem(*dims)
    cs = mg.build_colored(hpcg.to_coo(prob, device=DEV), dims=dims, fmt=Format[fmt])
    assert sorted(set(cs.counts)) == [216, 252, 294, 343]
    rng = np.random.default_rng(1)
    b = rng.standard_normal(prob.shape[0]).astype(np.float32)
    got = mg.symgs(cs, torch.from_numpy(b))
    want = mg.symgs_reference_np(prob.row, prob.col, prob.val, mg.color_grid(*dims),
                                 b, np.zeros_like(b))
    np.testing.assert_allclose(_np(got), want, rtol=2e-5, atol=2e-5)


def test_jacobi_matches_jax():
    prob, Cj, Ct = _coo((5, 3, 4))
    rng = np.random.default_rng(2)
    b = rng.standard_normal(prob.shape[0]).astype(np.float32)
    from repro.core import ops as jops
    dj = jops.extract_diagonal(Cj)
    dt = mg.build_colored(Ct, dims=(5, 3, 4)).diag
    for x0, sweeps in ((None, 3), (b, 2)):
        want = jmg.jacobi(dj, lambda v: jops.spmv(Cj, v, backend="ref"), jnp.asarray(b),
                          None if x0 is None else jnp.asarray(x0), sweeps=sweeps)
        got = mg.jacobi(dt, lambda v: spmv(Ct, v), torch.from_numpy(b),
                        None if x0 is None else torch.from_numpy(x0), sweeps=sweeps)
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# The batched selection of the color blocks' formats
# ---------------------------------------------------------------------------


def _stacked(dims):
    prob, Cj, Ct = _coo(dims)
    colors = mg.color_grid(*dims)
    rmax = int(np.bincount(colors).max())
    cap = 27 * rmax
    return (jmg.smoothers.split_colors_stacked(Cj, colors, rmax, cap),
            mg.split_colors_stacked(Ct, colors, rmax, cap))


def _part(S, i):
    return COO(S.row[i], S.col[i], S.data[i], S.shape, S.nnz)


@pytest.mark.parametrize("dims", [(8, 8, 2), (5, 3, 4)])
def test_batch_features_equal_jax_and_from_coo(dims):
    Sj, St = _stacked(dims)
    with planned_pulls_scope() as s:
        ft = batch_features(St)
    assert s.count == 1  # one (P, 7) statistics pull for the whole batch
    fj = jfeat.batch_features(Sj)
    assert len(ft) == len(fj) == 8
    ints = ("m", "n", "nnz", "itemsize", "row_nnz_max", "ndiag", "bandwidth")
    for i, (a, b) in enumerate(zip(ft, fj)):
        assert [getattr(a, k) for k in ints] == [getattr(b, k) for k in ints]
        np.testing.assert_allclose(a.vector(), b.vector(), rtol=1e-6, atol=0)
        one = PatternFeatures.from_coo(_part(St, i))
        assert [getattr(a, k) for k in ints] == [getattr(one, k) for k in ints]
        np.testing.assert_allclose(a.vector(), one.vector(), rtol=1e-6, atol=0)
    with pytest.raises(TypeError, match="stacked COO"):
        batch_features(_part(St, 0))


def test_batch_features_of_an_empty_part():
    St = _stacked((5, 3, 4))[1]
    data = St.data.clone()
    data[3] = 0
    f = batch_features(COO(St.row, St.col, data, St.shape, St.nnz))[3]
    assert (f.nnz, f.row_nnz_max, f.ndiag, f.row_nnz_mean) == (0, 1, 1, 0.0)


@pytest.mark.parametrize("mode", ["ml", "analytic"])
@pytest.mark.parametrize("dims", [(8, 8, 2), (5, 3, 4)])
def test_select_batch_ids_equal_jax(dims, mode):
    Sj, St = _stacked(dims)
    ids = FormatPolicy(mode).select_batch(St)
    assert ids.dtype == np.int32 and ids.shape == (8,)
    np.testing.assert_array_equal(ids, JPolicy(mode).select_batch(Sj))
    per_part = [FormatPolicy(mode).candidates.index(FormatPolicy(mode).select(_part(St, i)).best)
                for i in range(8)]
    np.testing.assert_array_equal(ids, per_part)


def test_select_batch_profile_runs_select_per_part():
    St = _stacked((5, 3, 4))[1]
    pol = FormatPolicy("profile", candidates=(Format.CSR, Format.ELL), profile_iters=1)
    ids = pol.select_batch(St)
    assert ids.shape == (8,) and set(ids.tolist()) <= {0, 1}


def test_select_batch_cached_writes_the_store_once(tmp_path, monkeypatch):
    St = _stacked((5, 3, 4))[1]
    writes = []
    flush = SelectionCache.flush
    monkeypatch.setattr(SelectionCache, "flush",
                        lambda self: (writes.append(1), flush(self))[1])
    path = str(tmp_path / "batch.json")
    pol = FormatPolicy("cached", cache=path)
    ids = pol.select_batch(St)
    assert len(writes) == 1 and pol.cache.autoflush
    np.testing.assert_array_equal(ids, FormatPolicy("ml").select_batch(St))
    # a warm store answers every part from the file, writing nothing
    again = FormatPolicy("cached", cache=path).select_batch(St)
    assert len(writes) == 1
    np.testing.assert_array_equal(again, ids)
    # each key is the one select() writes for the part
    feats = batch_features(St)
    key = SelectionCache.key(feats[0], pol.candidates, "cpu", "cpu")
    assert SelectionCache(path).get(key) == pol.candidates[int(ids[0])]


def test_build_colored_with_a_policy_picks_per_color():
    dims = (5, 3, 4)
    _, Cj, Ct = _coo(dims)
    cst = mg.build_colored(Ct, dims=dims, policy=FormatPolicy("ml"))
    csj = jmg.build_colored(Cj, dims=dims, policy=JPolicy("ml"))
    assert [f.name for f in cst.formats] == [f.name for f in csj.formats]
    for bj, bt in zip(csj.blocks, cst.blocks):
        assert_same_container(bj, bt)

