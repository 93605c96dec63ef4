"""The port's tuning leftovers against the JAX package's: the training
corpus (``repro_torch.tuning.corpus``), the tree trainer
(``DecisionTree.fit``), ``random_coo`` and the calibrated gather penalty.

``make_matrix`` gives JAX's matrices entry for entry from one seed for every
family (``random`` too: the JAX package's int-seeded ``random_coo`` draws
from numpy); the datasets agree within the rounding of the device
reductions; ``fit`` on one ``(X, y)`` gives a JSON-identical tree; the
label's tie rule picks what JAX's picks from the same times; a short
``main`` trains a tree into a temporary file and leaves the shipped
``default_tree.json`` byte-identical.
"""
import hashlib
import json

import numpy as np
import pytest
import torch

import repro.core.formats as jf
from repro.tuning import corpus as jcorpus
from repro.tuning import engines as jengines
from repro.tuning import tree as jtree
from repro.tuning.features import PatternFeatures as JFeatures
from repro_torch.core.formats import Format, random_coo
from repro_torch.tuning import (DEFAULT_TREE_PATH, DecisionTree, PatternFeatures,
                                analytic_select, calibrate_gather_penalty, corpus, engines,
                                predicted_bytes)

BITWISE = ("stencil27", "stencil7", "banded", "powerlaw", "block")


@pytest.fixture(autouse=True)
def _private_selection_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "selections.json"))


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _fields(A):
    return [np.asarray(getattr(A, f)) if not torch.is_tensor(getattr(A, f))
            else getattr(A, f).numpy() for f in ("row", "col", "data")]


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("family", BITWISE)
def test_make_matrix_bitwise_equals_jax(family, seed):
    A = corpus.make_matrix(family, np.random.default_rng(seed), device="cpu")
    Aj = jcorpus.make_matrix(family, np.random.default_rng(seed))
    assert tuple(A.shape) == tuple(Aj.shape) and A.nnz == Aj.nnz
    for got, want in zip(_fields(A), _fields(Aj)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_make_matrix_random_shape_density_and_stream(seed):
    rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
    A = corpus.make_matrix("random", rng, device="cpu")
    Aj = jcorpus.make_matrix("random", jrng)
    m, n = A.shape
    assert m == n and 128 <= m <= 1024
    assert 1 <= A.nnz and 10 ** -3 - 1e-9 <= A.nnz / (m * n) <= 10 ** -0.9 + 1e-9
    live = A.data != 0
    assert int(live.sum()) == A.nnz  # no zero values among the entries
    # the seed is one rng.integers draw: the stream stays aligned with JAX's
    assert rng.integers(0, 1 << 30) == jrng.integers(0, 1 << 30)
    for got, want in zip(_fields(A), _fields(Aj)):
        np.testing.assert_array_equal(got, want)


def test_random_coo_seeds_and_generators():
    A = random_coo(11, (40, 30), 0.1, device="cpu")
    Aj = jf.random_coo(11, (40, 30), 0.1)
    for got, want in zip(_fields(A), _fields(Aj)):
        np.testing.assert_array_equal(got, want)
    B = random_coo(np.random.default_rng(11), (40, 30), 0.1, device="cpu")
    assert B.nnz == A.nnz == 120
    g1, g2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    C1, C2 = (random_coo(g, (16, 16), 0.25, capacity=80, device="cpu") for g in (g1, g2))
    assert C1.capacity == 80 and C1.nnz == 64 and torch.equal(C1.row, C2.row)


def test_generate_corpus_and_dataset_equal_jax():
    mats, fams = corpus.generate_corpus(12, seed=0, device="cpu")
    jmats, jfams = jcorpus.generate_corpus(12, seed=0)
    assert fams == jfams == [corpus.FAMILIES[i % 6] for i in range(12)]
    assert corpus.FAMILIES == jcorpus.FAMILIES
    for A, Aj in zip(mats, jmats):
        for got, want in zip(_fields(A), _fields(Aj)):
            np.testing.assert_array_equal(got, want)
    X, XJ = corpus.build_dataset(mats), jcorpus.build_dataset(jmats)
    assert X.shape == XJ.shape == (12, len(PatternFeatures.from_coo(mats[0]).vector()))
    np.testing.assert_allclose(X, XJ, rtol=1e-9, atol=1e-12)


def _xy(seed, n=160, nfeat=6):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, nfeat))
    X[:, 2] = np.round(X[:, 2], 1)  # ties among feature values
    y = np.where(X[:, 0] + 0.5 * X[:, 2] > 0, int(Format.DIA), int(Format.CSR))
    y[rng.random(n) < 0.2] = int(Format.SELL)
    return X, y


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_gives_a_json_identical_tree(tmp_path, seed):
    X, y = _xy(seed)
    names = [f"f{i}" for i in range(X.shape[1])]
    for kw in ({}, {"max_depth": 3, "min_samples_leaf": 5}):
        t = DecisionTree(names).fit(X, y, **kw)
        tj = jtree.DecisionTree(names).fit(X, y, **kw)
        assert json.dumps(t.to_dict()) == json.dumps(tj.to_dict())
        assert t.n_nodes == tj.n_nodes > 1
        assert t.score(X, y) == tj.score(X, y)
    t.save(str(tmp_path / "port.json"))
    tj.save(str(tmp_path / "jax.json"))
    assert _sha(tmp_path / "port.json") == _sha(tmp_path / "jax.json")
    back = DecisionTree.load(str(tmp_path / "jax.json"))
    np.testing.assert_array_equal(back.predict(X), tj.predict(X))
    with pytest.raises(ValueError, match="bad training set"):
        DecisionTree().fit(np.zeros((3, 2)), np.zeros(2))


def test_train_tree_on_the_corpus_dataset_equals_jax():
    mats, _ = corpus.generate_corpus(12, seed=3, device="cpu")
    X = corpus.build_dataset(mats)
    y = np.asarray([int(Format.DIA), int(Format.CSR), int(Format.ELL)] * 4)
    t, tj = corpus.train_tree(X, y), jcorpus.train_tree(X, y)
    assert json.dumps(t.to_dict()) == json.dumps(tj.to_dict())


def _fake_profile(times):
    def fake(A, x, candidates=(), iters=0, inner=0, **kw):
        ts = {Format(int(f)): times[Format(int(f)).name] for f in candidates}
        best = min(ts, key=ts.get)
        return engines.TuneReport(best, ts, "profile")
    return fake


def _fake_jprofile(times):
    def fake(A, x, candidates=(), iters=0, inner=0, **kw):
        ts = {jf.Format(int(f)): times[jf.Format(int(f)).name] for f in candidates}
        best = min(ts, key=ts.get)
        return jengines.TuneReport(best, ts, "profile")
    return fake


@pytest.mark.parametrize("times", [
    {"COO": 3.0, "CSR": 1.0, "DIA": 9.0, "ELL": 2.0, "SELL": 2.4},   # near ties
    {"COO": 9.0, "CSR": 1.0, "DIA": 9.0, "ELL": 9.0, "SELL": 9.0},   # a clear winner
    {"COO": 1.0, "CSR": 1.1, "DIA": 1.2, "ELL": 1.3, "SELL": 1.4},   # all tied
])
def test_label_tie_rule_equals_jax(monkeypatch, times):
    monkeypatch.setattr(corpus, "profile_select", _fake_profile(times))
    monkeypatch.setattr(jcorpus, "profile_select", _fake_jprofile(times))
    mats, _ = corpus.generate_corpus(6, seed=1, device="cpu")
    jmats, _ = jcorpus.generate_corpus(6, seed=1)
    got = corpus.label_corpus(mats)
    np.testing.assert_array_equal(got, jcorpus.label_corpus(jmats))
    assert set(got) <= {int(f) for f in corpus.DEFAULT_CANDIDATES}


def test_label_matrix_profiles_on_the_cpu():
    A = corpus.make_matrix("stencil7", np.random.default_rng(2), device="cpu")
    assert corpus.label_matrix(A, iters=1, inner=1) in corpus.DEFAULT_CANDIDATES


def test_main_trains_into_out_and_keeps_the_shipped_tree(tmp_path, capsys):
    before = _sha(DEFAULT_TREE_PATH)
    out = str(tmp_path / "tree.json")
    assert corpus.main(["--samples", "4", "--iters", "1", "--holdout", "0.25",
                        "--device", "cpu", "--out", out]) == 0
    text = capsys.readouterr().out
    assert "label distribution" in text and f"saved -> {out}" in text
    t = DecisionTree.load(out)
    X = corpus.build_dataset(corpus.generate_corpus(4, seed=0, device="cpu")[0])
    assert set(t.predict(X)) <= {int(f) for f in corpus.DEFAULT_CANDIDATES}
    assert _sha(DEFAULT_TREE_PATH) == before


def test_calibrated_penalty_is_measured_once_per_device(monkeypatch):
    monkeypatch.setattr(engines, "_CALIBRATED_PENALTY", {})
    calls = []

    def fake_time(fn, *args, **kw):
        calls.append(len(args))
        return 6e-6 if len(args) == 2 else 2e-6  # gather (x, idx) vs stream (x)
    monkeypatch.setattr(engines, "time_fn", fake_time)
    assert calibrate_gather_penalty(n=64, device="cpu") == pytest.approx(3.0)
    assert calibrate_gather_penalty(n=64, device="cpu") == pytest.approx(3.0)
    assert calls == [1, 2] and list(engines._CALIBRATED_PENALTY) == [("cpu", "cpu")]
    stats = PatternFeatures.from_coo(
        corpus.make_matrix("powerlaw", np.random.default_rng(0), device="cpu")).to_stats()
    rep = analytic_select(stats, calibrate=True, device="cpu")
    assert rep.mode == "analytic-calibrated" and len(calls) == 2
    for f, t in rep.times.items():
        assert t == pytest.approx(predicted_bytes(stats, f, 3.0) / engines.HBM_BW)
    assert analytic_select(stats).mode == "analytic"  # the default is unchanged
    assert analytic_select(stats, hbm_bw=1.0).times[Format.CSR] == predicted_bytes(
        stats, Format.CSR)
    # the same penalty gives the JAX package's predicted bytes
    jstats = JFeatures.from_coo(
        jcorpus.make_matrix("powerlaw", np.random.default_rng(0))).to_stats()
    for f in corpus.DEFAULT_CANDIDATES:
        for pen in (None, 1.0, 3.0):
            assert predicted_bytes(stats, f, pen) == pytest.approx(
                jengines.predicted_bytes(jstats, jf.Format(int(f)), pen), rel=1e-9)


def test_calibrate_gather_penalty_measures_the_cpu(monkeypatch):
    monkeypatch.setattr(engines, "_CALIBRATED_PENALTY", {})
    pen = calibrate_gather_penalty(n=1 << 12, iters=2, device="cpu")
    assert pen >= 1.0 and engines._CALIBRATED_PENALTY[("cpu", "cpu")] == pen
