"""The port's format selection against the JAX package.

The port ships its own copy of ``default_tree.json``, byte-identical to the
JAX one. On stencil, banded, random and power-law patterns made in numpy,
the feature vectors agree to rtol 1e-6 (the port reduces on the device, in
another order), the decision paths through the tree are equal, and the
``ml`` and ``analytic`` picks are equal.
"""
import numpy as np
import pytest
import torch

from repro.core import Format as JFormat
from repro.tuning import FormatPolicy as JPolicy
from repro.tuning import engines as jeng
from repro.tuning import features as jfeat
from repro.tuning import tree as jtree
from repro_torch.core.convert import planned_pulls_scope
from repro_torch.core.dynamic import DynamicMatrix, SwitchDynamicMatrix
from repro_torch.core.formats import Format
from repro_torch.core.ops import spmv
from repro_torch.tuning import (DEFAULT_TREE_PATH, DecisionTree, FormatPolicy,
                                PatternFeatures, PatternStats, analytic_select,
                                load_default_tree, predicted_bytes)
from torch_parity import PATTERNS, coo_pair
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

PATTERN_NAMES = sorted(PATTERNS)


@pytest.fixture(autouse=True)
def _private_selection_cache(tmp_path, monkeypatch):
    """The JAX policy opens a selection cache; keep it off the user's."""
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "selections.json"))


def test_default_tree_is_a_byte_identical_copy():
    with open(jtree.DEFAULT_TREE_PATH, "rb") as f:
        jax_bytes = f.read()
    with open(DEFAULT_TREE_PATH, "rb") as f:
        assert f.read() == jax_bytes
    assert "repro_torch" in DEFAULT_TREE_PATH.replace("\\", "/")
    t, tj = load_default_tree(), jtree.load_default_tree()
    assert t.n_nodes == tj.n_nodes and t.feature_names == tj.feature_names
    for name in ("classes_", "feature", "thresh", "left", "right", "value"):
        np.testing.assert_array_equal(getattr(t, name), getattr(tj, name))


@pytest.mark.parametrize("pattern", PATTERN_NAMES)
def test_features_and_decision_path_match_jax(pattern):
    Aj, At = coo_pair(PATTERNS[pattern]())
    fj = jfeat.PatternFeatures.from_coo(Aj)
    with planned_pulls_scope() as s:
        ft = PatternFeatures.from_coo(At)
    assert s.count == 1  # one small statistics vector crosses to the host
    np.testing.assert_allclose(ft.vector(), fj.vector(), rtol=1e-6, atol=0)
    assert (ft.nnz, ft.row_nnz_max, ft.ndiag, ft.bandwidth) == \
        (fj.nnz, fj.row_nnz_max, fj.ndiag, fj.bandwidth)
    t, tj = load_default_tree(), jtree.load_default_tree()
    assert t.decision_path(ft.vector()) == tj.decision_path(fj.vector())
    assert t.predict_one(ft.vector()) == tj.predict_one(fj.vector())


@pytest.mark.parametrize("pattern", PATTERN_NAMES)
def test_pattern_stats_and_analytic_model_match_jax(pattern):
    Aj, At = coo_pair(PATTERNS[pattern]())
    sj, st = jfeat.PatternStats.from_coo(Aj), PatternStats.from_coo(At)
    assert (st.m, st.n, st.nnz, st.max_row_nnz, st.ndiag, st.itemsize) == \
        (sj.m, sj.n, sj.nnz, sj.max_row_nnz, sj.ndiag, sj.itemsize)
    np.testing.assert_allclose(st.row_cv, sj.row_cv, rtol=1e-6)
    for fmt in Format:
        assert predicted_bytes(st, fmt) == pytest.approx(
            jeng.predicted_bytes(sj, JFormat(int(fmt))), rel=1e-9)
    rj = jeng.analytic_select(sj)
    rt = analytic_select(st)
    assert int(rt.best) == int(rj.best)
    assert rt.mode == "analytic" and set(map(int, rt.times)) == set(map(int, rj.times))


@pytest.mark.parametrize("mode", ["ml", "analytic"])
@pytest.mark.parametrize("pattern", PATTERN_NAMES)
def test_policy_pick_matches_jax(pattern, mode):
    Aj, At = coo_pair(PATTERNS[pattern]())
    pick_j = JPolicy(mode).select(Aj).best
    rep = FormatPolicy(mode).select(At)
    assert int(rep.best) == int(pick_j) and rep.mode == mode
    plan_j = JPolicy(mode).plan_for(Aj)
    assert FormatPolicy(mode).plan_for(At).to_json() == plan_j.to_json()


def test_ml_falls_back_to_analytic_outside_candidates():
    """The tree picks DIA on the stencil; with DIA excluded both packages
    fall back to the analytic model over the remaining candidates."""
    Aj, At = coo_pair(PATTERNS["stencil"]())
    cands = (Format.CSR, Format.ELL, Format.SELL)
    rj = JPolicy("ml", candidates=[JFormat(int(c)) for c in cands]).select(Aj)
    rt = FormatPolicy("ml", candidates=cands).select(At)
    assert rt.mode == "analytic" == rj.mode and int(rt.best) == int(rj.best)
    assert rt.best in cands


def test_ml_pick_on_hpcg_is_dia_through_dynamic_matrix():
    Aj, At = coo_pair(PATTERNS["stencil"]())
    M = DynamicMatrix.auto(At, "ml")
    assert M.active == Format.DIA == Format(int(JPolicy("ml").select(Aj).best))
    S = SwitchDynamicMatrix.auto(At, policy="ml")
    assert S.active == Format.DIA and S.candidates[S.active_id] == Format.DIA


def test_tree_round_trips_and_predicts_like_jax(tmp_path):
    tj = jtree.load_default_tree()
    path = tmp_path / "tree.json"
    tj.save(str(path))
    t = DecisionTree.load(str(path))
    X = np.stack([jfeat.PatternFeatures.from_coo(coo_pair(PATTERNS[p]())[0]).vector()
                  for p in PATTERN_NAMES])
    np.testing.assert_array_equal(t.predict(X), tj.predict(X))
    assert FormatPolicy("ml", tree=str(path)).tree.n_nodes == tj.n_nodes


def test_unported_modes_raise(tmp_path):
    """Every mode is ported now: ``cached`` builds and keeps its store,
    ``backend="auto"`` routes a CPU tensor to the reference; only an
    unknown mode raises."""
    pol = FormatPolicy("cached", cache=str(tmp_path / "sel.json"))
    assert pol.cache.path == str(tmp_path / "sel.json")
    assert FormatPolicy("profile", profile_iters=3).profile_iters == 3
    _, At = coo_pair(PATTERNS["stencil"]())
    x = torch.ones(At.shape[1])
    assert torch.equal(spmv(At, x, backend="auto"), spmv(At, x, backend="ref"))
    with pytest.raises(ValueError, match="not in"):
        FormatPolicy("fastest")


def test_empty_matrix_features_match_jax():
    Aj, At = coo_pair(np.zeros((6, 9), np.float32), capacity=3)
    np.testing.assert_array_equal(PatternFeatures.from_coo(At).vector(),
                                  jfeat.PatternFeatures.from_coo(Aj).vector())
    st, sj = PatternStats.from_coo(At), jfeat.PatternStats.from_coo(Aj)
    assert (st.nnz, st.max_row_nnz, st.ndiag) == (sj.nnz, sj.max_row_nnz, sj.ndiag)


@pytest.mark.parametrize("op,ncols", [("spmm_t", 1), ("spmm_t", 256), ("spmm", 8)])
@pytest.mark.parametrize("mode", ["ml", "analytic"])
def test_pattern_only_modes_ignore_the_op_as_jax_does(mode, op, ncols):
    """``ml`` and ``analytic`` read the pattern only: the pick for an SpMM
    of any width is the SpMV pick, in both packages."""
    cands = (Format.CSR, Format.ELL, Format.HYB, Format.SELL, Format.COO)
    for pattern in ("powerlaw", "random"):
        Aj, At = coo_pair(PATTERNS[pattern]())
        pj = JPolicy(mode, candidates=[JFormat(int(c)) for c in cands]).select(
            Aj, op=op, ncols=ncols).best
        rep = FormatPolicy(mode, candidates=cands).select(At, op=op, ncols=ncols)
        assert int(rep.best) == int(pj) and rep.best == FormatPolicy(
            mode, candidates=cands).select(At).best
        assert FormatPolicy(mode, candidates=cands).plan_for(At, op=op, ncols=ncols).to_json() \
            == FormatPolicy(mode, candidates=cands).plan_for(At).to_json()
