"""The port's profiling tuner against the JAX package.

``time_fn``, ``profile_select``, ``FormatPolicy("profile")``, ``autotune``
and the ``profile`` route through ``DynamicMatrix.auto`` and
``hpcg_solve --tune profile``, on the CPU. Real timings pick whichever
format is fastest on this host, so the tests that compare picks with JAX
replace ``time_fn`` in both packages by one deterministic table of times:
given the same times, both tuners must make the same pick.
"""
import weakref

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.tuning.engines as jeng
from repro.core import Format as JFormat
from repro.core.autotune import autotune as jautotune
from repro.tuning import FormatPolicy as JPolicy
from repro_torch import hpcg_solve
from repro_torch.core import autotune
from repro_torch.core.dynamic import DEFAULT_CANDIDATES, DynamicMatrix, SwitchDynamicMatrix
from repro_torch.core.formats import Format
from repro_torch.tuning import FormatPolicy, engines, profile_select, time_fn
from torch_parity import PATTERNS, coo_pair

# One table of fake seconds per test case; each makes another format win.
FAKE_TIMES = {
    "csr": {"COO": 5.0, "CSR": 1.0, "DIA": 3.0, "ELL": 2.0, "SELL": 4.0},
    "dia": {"COO": 5.0, "CSR": 4.0, "DIA": 1.0, "ELL": 2.0, "SELL": 3.0},
    "ell": {"COO": 3.0, "CSR": 4.0, "DIA": 5.0, "ELL": 1.0, "SELL": 2.0},
    "sell": {"COO": 2.0, "CSR": 3.0, "DIA": 4.0, "ELL": 5.0, "SELL": 1.0},
    "coo": {"COO": 1.0, "CSR": 2.0, "DIA": 3.0, "ELL": 4.0, "SELL": 5.0},
}


@pytest.fixture(autouse=True)
def _private_selection_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "selections.json"))


def _fake_timer(table, seen=None):
    """A ``time_fn`` stand-in: the time of the candidate container it is
    handed (its first argument), from ``table``; never calls ``fn``."""
    def fake(fn, A, x, **kwargs):
        if seen is not None:
            seen.append(x)
        return table[Format(int(A.format)).name]
    return fake


@pytest.fixture
def fake_times(monkeypatch):
    """Install one table in both packages' tuners."""
    def install(name, seen=None):
        monkeypatch.setattr(engines, "time_fn", _fake_timer(FAKE_TIMES[name], seen))
        monkeypatch.setattr(jeng, "time_fn", _fake_timer(FAKE_TIMES[name]))
    return install


def _x(n):
    x = np.random.default_rng(3).standard_normal(n).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def test_time_fn_on_the_cpu_is_best_of_iters_per_call():
    calls = []

    def fn(v):
        calls.append(1)
        return v + 1

    t = time_fn(fn, torch.ones(8), iters=3, warmup=2, inner=4)
    assert isinstance(t, float) and 0 < t < 1
    assert len(calls) == 2 + 3 * 4


@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_profile_picks_from_the_candidates_with_a_time_for_each(pattern):
    _, At = coo_pair(PATTERNS[pattern]())
    rep = FormatPolicy("profile", profile_iters=2).select(At)
    assert rep.mode == "profile" and rep.best in DEFAULT_CANDIDATES
    assert set(rep.times) == set(DEFAULT_CANDIDATES)
    assert all(t > 0 for t in rep.times.values()) and rep.best == min(rep.times,
                                                                      key=rep.times.get)
    assert rep.backend is None


def test_profile_skips_candidates_that_do_not_convert():
    """BSR at the default 128-block edge does not divide a 64 x 48 matrix:
    skipped, as in JAX; the others are timed."""
    _, At = coo_pair(PATTERNS["random"]())
    cands = (Format.CSR, Format.BSR, Format.ELL)
    rep = profile_select(At, torch.ones(At.shape[1]), candidates=cands, iters=2)
    assert set(rep.times) == {Format.CSR, Format.ELL}
    with pytest.raises(ValueError, match="every candidate"):
        profile_select(At, torch.ones(At.shape[1]), candidates=(Format.BSR,), iters=1)


@pytest.mark.parametrize("winner", sorted(FAKE_TIMES))
@pytest.mark.parametrize("pattern", ["stencil", "powerlaw"])
def test_profile_pick_matches_jax_given_the_same_times(pattern, winner, fake_times):
    fake_times(winner)
    Aj, At = coo_pair(PATTERNS[pattern]())
    xj, xt = _x(At.shape[1])
    rj = jeng.profile_select(Aj, xj)
    rt = profile_select(At, xt)
    assert rt.best.name == rj.best.name == winner.upper()
    assert {f.name: t for f, t in rt.times.items()} == \
        {JFormat(f).name: t for f, t in rj.times.items()}
    pj = JPolicy("profile").select(Aj, x=xj)
    assert FormatPolicy("profile").select(At, x=xt).best.name == pj.best.name


def test_profile_policy_makes_ones_when_x_is_absent(fake_times):
    seen = []
    fake_times("ell", seen)
    _, At = coo_pair(PATTERNS["stencil"]())
    assert FormatPolicy("profile").select(At).best == Format.ELL
    assert seen and all(torch.equal(x, torch.ones(At.shape[1])) for x in seen)


def test_profile_backends_search_format_backend_pairs():
    """``backends`` names the winning pair's backend; on the CPU only the
    reference can run, and ``"cuda"`` refuses CPU tensors."""
    _, At = coo_pair(PATTERNS["banded"]())
    x = torch.ones(At.shape[1])
    rep = profile_select(At, x, candidates=(Format.CSR, Format.DIA), iters=2,
                         backends=("ref",))
    assert rep.backend == "ref" and set(rep.times) == {Format.CSR, Format.DIA}
    # COO has no kernel: "cuda" is not timed for it, so it never raises
    rep = profile_select(At, x, candidates=(Format.COO,), iters=1, backends=("ref", "cuda"))
    assert rep.best == Format.COO and rep.backend == "ref"
    with pytest.raises(ValueError, match="CUDA tensors"):
        profile_select(At, x, candidates=(Format.CSR,), iters=1, backends=("ref", "cuda"))


def test_profile_frees_each_candidate_before_the_next(monkeypatch):
    """Peak memory stays at A plus one candidate: when a conversion starts,
    no earlier candidate is still alive (the COO candidate is ``A`` itself)."""
    built = []
    real = engines.convert_execute

    def tracked(A, plan):
        assert all(ref() is None for ref in built), "an earlier candidate is alive"
        out = real(A, plan)
        if out is not A:
            built.append(weakref.ref(out))
        return out

    monkeypatch.setattr(engines, "convert_execute", tracked)
    _, At = coo_pair(PATTERNS["powerlaw"]())
    rep = profile_select(At, torch.ones(At.shape[1]), iters=1, inner=1)
    assert len(built) == len(DEFAULT_CANDIDATES) - 1 and len(rep.times) == len(built) + 1


@pytest.mark.parametrize("winner", ["dia", "sell"])
def test_dynamic_matrices_forward_x_to_the_profile_policy(winner, fake_times):
    seen = []
    fake_times(winner, seen)
    _, At = coo_pair(PATTERNS["stencil"]())
    x = torch.full((At.shape[1],), 2.0)
    M = DynamicMatrix.auto(At, "profile", x=x)
    assert M.active == Format[winner.upper()] and all(v is x for v in seen)
    S = SwitchDynamicMatrix.auto(At, policy="profile", x=x)
    assert S.active == Format[winner.upper()] and S.candidates == DEFAULT_CANDIDATES


@pytest.mark.parametrize("mode", ["profile", "analytic", "ml"])
def test_autotune_matches_jax(mode, fake_times):
    fake_times("sell")
    Aj, At = coo_pair(PATTERNS["powerlaw"]())
    xj, xt = _x(At.shape[1])
    rj = jautotune(Aj, xj, mode=mode)
    rt = autotune(At, xt, mode=mode)
    assert rt.best.name == rj.best.name and rt.mode == rj.mode


def test_autotune_refuses_what_it_cannot_do(tmp_path):
    """``cached`` now selects: the ml pick on a miss, the stored pick on a
    hit; only an unknown mode or profile without x refuses."""
    _, At = coo_pair(PATTERNS["stencil"]())
    with pytest.raises(ValueError, match="requires x"):
        autotune(At, mode="profile")
    path = str(tmp_path / "sel.json")
    cold = autotune(At, mode="cached", cache=path)
    warm = autotune(At, mode="cached", cache=path)
    assert cold.best == warm.best == autotune(At, mode="ml").best
    assert (cold.mode, warm.mode) == ("cached-miss:ml", "cached")
    with pytest.raises(ValueError, match="unknown mode"):
        autotune(At, mode="fastest")


def test_hpcg_solve_tune_profile(capsys, fake_times):
    fake_times("csr")
    assert hpcg_solve.main(["--grid", "8", "8", "8", "--device", "cpu",
                            "--tune", "profile"]) == 0
    out = capsys.readouterr().out
    assert "format: CSR (profile pick" in out and "-> PASS" in out
    r = hpcg_solve.run((8, 8, 8), "auto", device="cpu", tune="analytic")
    assert r["format"] == "DIA" and r["passed"]
    for flags, fmt in ((["--format", "HYB", "--ell-k", "18"], "HYB"),
                       (["--format", "BSR", "--block-size", "4"], "BSR")):
        assert hpcg_solve.main(["--grid", "8", "8", "8", "--device", "cpu", *flags]) == 0
        out = capsys.readouterr().out
        assert f"format: {fmt} (named" in out and "-> PASS" in out


# Width-aware selection (op="spmm" / "spmm_t"): the times depend on the op
# and the rhs width, so the pick is made for the computation that will run.
WEIGHT_CANDS = (Format.CSR, Format.ELL, Format.HYB, Format.SELL, Format.COO)
OP_TIMES = {"csr": {"CSR": 1.0, "ELL": 2.0, "HYB": 3.0, "SELL": 4.0, "COO": 5.0},
            "hyb": {"CSR": 4.0, "ELL": 3.0, "HYB": 1.0, "SELL": 2.0, "COO": 5.0}}


def _op_timer(table, seen):
    """A ``time_fn`` stand-in that runs the timed op once (so the route and
    the shapes are real) and returns the candidate's time from ``table``."""
    def fake(fn, A, x, **kwargs):
        seen.append((Format(int(A.format)), tuple(x.shape), tuple(fn(A, x).shape)))
        return table[Format(int(A.format)).name]
    return fake


@pytest.mark.parametrize("op", ["spmm_t", "spmm"])
@pytest.mark.parametrize("winner", sorted(OP_TIMES))
def test_profile_op_pick_matches_jax_given_the_same_times(op, winner, monkeypatch):
    seen = []
    monkeypatch.setattr(engines, "time_fn", _op_timer(OP_TIMES[winner], seen))
    monkeypatch.setattr(jeng, "time_fn", _op_timer(OP_TIMES[winner], []))
    Aj, At = coo_pair(PATTERNS["powerlaw"]())
    m, n = At.shape
    xn = np.ones((5, n) if op == "spmm_t" else (n, 5), np.float32)
    jc = [JFormat(int(f)) for f in WEIGHT_CANDS]
    rj = jeng.profile_select(Aj, jnp.asarray(xn), candidates=jc, op=op)
    rt = profile_select(At, torch.from_numpy(xn), candidates=WEIGHT_CANDS, op=op)
    assert rt.best.name == rj.best.name == winner.upper()
    assert {f.name: t for f, t in rt.times.items()} == \
        {JFormat(f).name: t for f, t in rj.times.items()}
    out = (5, m) if op == "spmm_t" else (m, 5)
    assert {f for f, _, _ in seen} == set(WEIGHT_CANDS)
    assert all(xs == xn.shape and ys == out for _, xs, ys in seen)
    pj = JPolicy("profile", candidates=jc).select(Aj, op=op, ncols=5)
    pt = FormatPolicy("profile", candidates=WEIGHT_CANDS).select(At, op=op, ncols=5)
    assert pt.best.name == pj.best.name == winner.upper()


@pytest.mark.parametrize("op,shape", [("spmv", (64,)), ("spmm", (64, 7)),
                                      ("spmm_t", (7, 64)), ("spmm_t", (1, 64))])
def test_profile_policy_makes_ones_of_the_op_shape(op, shape, monkeypatch):
    seen = []
    monkeypatch.setattr(engines, "time_fn", _op_timer(OP_TIMES["csr"], seen))
    _, At = coo_pair(PATTERNS["stencil"]())
    ncols = shape[1] if op == "spmm" else (shape[0] if op == "spmm_t" else None)
    rep = FormatPolicy("profile", candidates=WEIGHT_CANDS).select(At, op=op, ncols=ncols)
    assert rep.best == Format.CSR
    assert seen and all(xs == shape for _, xs, _ in seen)
    plan = FormatPolicy("profile", candidates=WEIGHT_CANDS).plan_for(At, op=op, ncols=ncols)
    assert Format(plan.target) == Format.CSR


def test_profile_spmm_t_times_real_runs_on_the_cpu():
    """Real host timings: every weight candidate gets a time, through the
    reference route of a CPU tensor; "cuda" refuses CPU tensors."""
    _, At = coo_pair(PATTERNS["random"]())
    X = torch.ones(4, At.shape[1])
    rep = profile_select(At, X, candidates=WEIGHT_CANDS, iters=2, inner=1, op="spmm_t")
    assert set(rep.times) == set(WEIGHT_CANDS) and all(t > 0 for t in rep.times.values())
    rep = profile_select(At, X.T.contiguous(), candidates=(Format.COO,), iters=1,
                         backends=("ref", "cuda"), op="spmm")
    assert rep.best == Format.COO and rep.backend == "ref"
    with pytest.raises(ValueError, match="CUDA tensors"):
        profile_select(At, X, candidates=(Format.ELL,), iters=1, backends=("ref", "cuda"),
                       op="spmm_t")
    # ELL has its SpMM kernel now: "cuda" is timed for it and refuses too
    with pytest.raises(ValueError, match="CUDA tensors"):
        profile_select(At, X.T.contiguous(), candidates=(Format.ELL,), iters=1,
                       backends=("ref", "cuda"), op="spmm")
