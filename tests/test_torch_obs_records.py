"""The port's decision records against the JAX package's, on the CPU.

For the same numpy triplets, ``FormatPolicy`` in ``ml``, ``analytic`` and
``cached`` mode writes ``format.select``, ``format.select_batch`` and
``plan.switch`` records whose chosen format, tier, tree path, scores and
cache fields equal JAX's; the SELL/ELL/HYB plans observe the same
``padding_waste`` values. A ledger dump of either package renders in the
other's ``explain`` as in its own. ``kernel_route`` records a decision once
per container, op and width bucket, and again after the tuning store
changed (the port routes on every call). A 4^3 traced build and solve has
the phases and parentage that ``tests/test_obs.py`` asks of the JAX one,
and ``hpcg_solve`` prints and exports its trace.
"""
import io
import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core.formats as jf
from repro.core import Format as JFormat
from repro.core.ops import kernel_route as jkernel_route
from repro.obs import explain as jexplain
from repro.obs import ledger as jledger
from repro.obs import metrics as jmetrics
from repro.tuning import FormatPolicy as JPolicy
from repro.tuning.cache import SelectionCache as JCache
from repro.tuning.engines import HBM_BW as JHBM_BW
from repro_torch import hpcg_solve
from repro_torch.core import hpcg
from repro_torch.core.distributed import build_dist_matrix
from repro_torch.core.formats import COO, Format
from repro_torch.core.ops import kernel_route, spmm, spmv
from repro_torch.core.solvers import cg, operator
from repro_torch.obs import explain, ledger, metrics, report, trace
from repro_torch.tuning import HBM_BW, SelectionCache
from repro_torch.tuning.policy import FormatPolicy
from torch_parity import CAP, PATTERNS, coo_pair, jconv, tconv
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

SQUARE = ("stencil", "banded", "powerlaw")  # the 64 x 64 patterns
WASTE = ("ell.padding_waste", "hyb.padding_waste", "sell.padding_waste")


@pytest.fixture(autouse=True)
def _ledgers_on(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "selections.json"))
    was, jwas = ledger.enabled(), jledger.enabled()
    ledger.set_enabled(True)
    jledger.set_enabled(True)
    ledger.clear()
    jledger.clear()
    trace.clear()
    yield
    ledger.clear()
    jledger.clear()
    trace.clear()
    ledger.set_enabled(was)
    jledger.set_enabled(jwas)


def _strip(rec):
    return {k: v for k, v in rec.items() if k not in ("seq", "ts")}


def _same_path(path, jpath):
    assert len(path) == len(jpath)
    for s, js in zip(path, jpath):
        assert s.keys() == js.keys()
        for k in s:
            if k == "value":
                assert s[k] == pytest.approx(js[k], rel=1e-9, abs=1e-12)
            else:
                assert s[k] == js[k], (k, s, js)


def _same_select(rec, jrec):
    """Equal records, features within rounding (the port reduces the
    pattern on the device, in another order), and scores that are the same
    predicted bytes (each package divides them by its own card's HBM rate)."""
    assert rec.keys() == jrec.keys()
    for k in rec:
        if k == "tree_path":
            _same_path(rec[k], jrec[k])
        elif k in ("features", "scores"):
            assert rec[k].keys() == jrec[k].keys()
            bw, jbw = (HBM_BW, JHBM_BW) if k == "scores" else (1.0, 1.0)
            for name in rec[k]:
                assert rec[k][name] * bw == pytest.approx(jrec[k][name] * jbw, rel=1e-9,
                                                          abs=1e-12)
        else:
            assert rec[k] == jrec[k], (k, rec[k], jrec[k])


@pytest.mark.parametrize("mode", ["ml", "analytic", "cached"])
@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_format_select_records_equal_jax(tmp_path, mode, pattern):
    Cj, Ct = coo_pair(PATTERNS[pattern]())
    pol = FormatPolicy(mode, cache=str(tmp_path / "port.json"))
    jpol = JPolicy(mode, cache=JCache(str(tmp_path / "jax.json")))
    for _ in range(2):  # cached: a miss, then a hit
        pol.select(Ct)
        jpol.select(Cj)
    recs = [_strip(r) for r in ledger.records(kind="format.select")]
    jrecs = [_strip(r) for r in jledger.records(kind="format.select")]
    assert len(recs) == len(jrecs) == 2
    for rec, jrec in zip(recs, jrecs):
        _same_select(rec, jrec)
    if mode == "cached":
        assert [r["cache"] for r in recs] == ["miss", "hit"]
        assert recs[0]["tier"].startswith("cached-miss:") and recs[1]["tier"] == "cached"
        assert "no tuned kernel record" in recs[0]["kernel_veto"]
    if mode == "analytic":
        assert set(recs[0]["scores"]) == {f.name for f in pol.candidates}
    if mode != "analytic":
        assert recs[0]["tree_path"][-1]["predict_name"] in Format.__members__


@pytest.mark.parametrize("mode", ["ml", "analytic", "cached"])
def test_select_batch_records_equal_jax(tmp_path, mode):
    pairs = [coo_pair(PATTERNS[p]()) for p in SQUARE]

    def stack(parts, lib):
        return [lib(np.stack([np.asarray(getattr(c, f)) for c in parts]))
                for f in ("row", "col", "data")]
    Sj = jf.COO(*stack([j for j, _ in pairs], jnp.asarray), (64, 64), CAP)
    St = COO(*stack([t for _, t in pairs], torch.from_numpy), (64, 64), CAP)
    ids = FormatPolicy(mode, cache=str(tmp_path / "p.json")).select_batch(St)
    jids = JPolicy(mode, cache=JCache(str(tmp_path / "j.json"))).select_batch(Sj)
    np.testing.assert_array_equal(ids, np.asarray(jids))
    rec, = ledger.records(kind="format.select_batch")
    jrec, = jledger.records(kind="format.select_batch")
    assert _strip(rec) == _strip(jrec) and rec["parts"] == 3


def test_plan_switch_records_equal_jax(tmp_path):
    Cj, Ct = coo_pair(PATTERNS["powerlaw"]())
    pol = FormatPolicy("ml", cache=str(tmp_path / "p.json"))
    jpol = JPolicy("ml", cache=JCache(str(tmp_path / "j.json")))
    for fmt, hints in ((Format.ELL, {}), (Format.HYB, {"k": 3}), (Format.SELL, {}),
                       (None, {})):
        jfmt = None if fmt is None else JFormat(int(fmt))
        plan = pol.plan_for(Ct, fmt=fmt, **hints)
        jplan = jpol.plan_for(Cj, fmt=jfmt, **hints)
        assert plan.to_json() == jplan.to_json()
    recs = [_strip(r) for r in ledger.records(kind="plan.switch")]
    jrecs = [_strip(r) for r in jledger.records(kind="plan.switch")]
    assert recs == jrecs and len(recs) == 4
    assert recs[1]["geometry_source"] == "caller hints" and recs[1]["hints"] == {"k": 3}
    assert len(ledger.records(kind="format.select")) == 1  # plan_for(fmt=None) selects


@pytest.mark.parametrize("pattern", SQUARE)
def test_padding_waste_observations_equal_jax(pattern):
    Cj, Ct = coo_pair(PATTERNS[pattern]())
    metrics.reset(WASTE)
    jmetrics.reset(WASTE)
    for fmt in (Format.ELL, Format.HYB, Format.SELL):
        tconv.convert(Ct, fmt)
        jconv.convert(Cj, JFormat(int(fmt)))
    hist, jhist = metrics.snapshot()["histograms"], jmetrics.snapshot()["histograms"]
    for name in WASTE:
        assert hist[name]["count"] == 1 and 0.0 <= hist[name]["max"] <= 1.0
        assert hist[name] == pytest.approx(jhist[name], rel=1e-12)


def _trail(policy_cls, cache_cls, coo, route, tmp_path, tag):
    """One operand through the decision stack: cached select (miss), plan,
    route on an empty store, cached select (hit)."""
    store = str(tmp_path / f"{tag}.json")
    pol = policy_cls("cached", cache=cache_cls(store))
    fmt = pol.select(coo).best
    A = (tconv if tag == "port" else jconv).convert_execute(coo, pol.plan_for(coo, fmt=fmt))
    route(A, cache=cache_cls(str(tmp_path / f"{tag}-empty.json")))
    pol.select(coo)


def _cli(main, path, *extra):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main([path, *extra]) == 0
    return out.getvalue()


def test_ledger_dumps_render_identically_in_both_explains(tmp_path):
    Cj, Ct = coo_pair(PATTERNS["banded"]())
    _trail(JPolicy, JCache, Cj, jkernel_route, tmp_path, "jax")
    _trail(FormatPolicy, SelectionCache, Ct, kernel_route, tmp_path, "port")
    jdump = jledger.dump_json(str(tmp_path / "jax-ledger.json"))
    dump = ledger.dump_json(str(tmp_path / "port-ledger.json"))
    for path in (jdump, dump):
        recs = ledger.load_json(path)["records"]
        assert [r["kind"] for r in recs] == ["format.select", "plan.switch",
                                             "kernel.route", "format.select"]
        text = explain.render(recs)
        assert text == jexplain.render(jledger.load_json(path)["records"])
        assert "cache: miss" in text and "cache: hit" in text and "reason:" in text
        for extra in ((), ("--kind", "format.select", "--last", "1"), ("--json",),
                      ("--quiet",)):
            assert _cli(explain.main, path, *extra) == _cli(jexplain.main, path, *extra)
    route = ledger.load_json(dump)["records"][2]
    assert route["route"] == "ref" and "off the card" in route["reason"]
    assert route["bucket"].startswith("kernel:v1|spmv|") and "cpu-plain" in route["bucket"]


def test_run_demo_on_the_cpu_fills_the_trail():
    explain.run_demo("powerlaw", seed=7, device="cpu")
    kinds = [r["kind"] for r in ledger.records()]
    assert kinds == ["format.select", "plan.switch", "kernel.route", "format.select"]
    text = explain.render(ledger.records())
    assert "CART path" in text and "cache: hit" in text and "kernel.route" in text


def test_kernel_route_records_once_per_container_op_and_bucket(tmp_path):
    A = tconv.convert(coo_pair(PATTERNS["random"]())[1], Format.CSR)
    x = torch.ones(A.shape[1])
    with metrics.scope() as s, trace.tracing("full"):
        for _ in range(5):
            spmv(A, x, backend="auto")
        assert s.delta("kernel.route.ref") == 5
        assert len([e for e in trace.events() if e["name"] == "kernel.route"]) == 5
    assert len(ledger.records(kind="kernel.route")) == 1
    for ncols in (4, 5, 16):  # spmm widths: buckets b2, b2, b4
        spmm(A, torch.ones(A.shape[1], ncols), backend="auto")
    assert len(ledger.records(kind="kernel.route")) == 3
    spmv(tconv.convert(A, Format.ELL), x, backend="auto")  # another container
    assert len(ledger.records(kind="kernel.route")) == 4
    store = SelectionCache(str(tmp_path / "other.json"))
    store.put_raw("unrelated", "1")  # the tuning store changed: record again
    spmv(A, x, backend="auto")
    spmv(A, x, backend="auto")
    recs = ledger.records(kind="kernel.route")
    assert len(recs) == 5 and {r["op"] for r in recs} == {"spmv", "spmm"}
    ledger.set_enabled(False)
    spmv(tconv.convert(A, Format.SELL), x, backend="auto")
    assert len(ledger.records(kind="kernel.route")) == 5


def test_traced_hpcg_build_and_solve_has_phases_and_sane_parentage():
    """The port's counterpart of tests/test_obs.py's HPCG trace: build +
    multiformat selection + an auto-routed solve, at 4^3 on one shard."""
    prob = hpcg.generate_problem(4, 4, 4)
    with trace.tracing("full"):
        A = build_dist_matrix(prob.row, prob.col, prob.val, prob.shape, 1, device="cpu",
                              mode="multiformat", tune="analytic")
        b = torch.from_numpy(hpcg.rhs_for_ones(prob))
        res = cg(operator(A, backend="auto"), b, tol=1e-6, maxiter=50)
        evs = trace.events()
    assert float(res.resnorm) < 1e-3
    phases = {report.phase_of(e["name"]) for e in evs}
    assert {"select", "plan", "convert", "kernel", "build", "exchange"} <= phases, phases
    by_id = {e["id"]: e for e in evs}
    for e in evs:
        if e["parent"] is not None:
            parent = by_id[e["parent"]]  # every parent is a recorded span
            assert e["ts"] >= parent["ts"] - 1e-3, (e, parent)
    build_ids = {e["id"] for e in evs if e["name"] == "build.dist"}
    assert any(e["parent"] in build_ids for e in evs
               if e["name"].startswith(("plan.", "select.", "convert.")))
    assert len(ledger.records(kind="kernel.route")) <= 2  # one container a part


def test_hpcg_solve_prints_and_exports_its_trace(tmp_path, monkeypatch, capsys):
    out = str(tmp_path / "trace.json")
    monkeypatch.setenv("REPRO_TRACE_EXPORT", out)
    with trace.tracing("full"):
        assert hpcg_solve.main(["--grid", "8", "8", "8", "--device", "cpu", "--backend",
                                "ref", "--precond", "mg"]) == 0
    text = capsys.readouterr().out
    assert "# trace summary (REPRO_TRACE=full)" in text and "trace exported" in text
    names = {e["name"] for e in report.load_trace(out)}
    assert {"build.problem", "build.optimize", "solver.solve", "mg.vcycle",
            "build.mg_level", "select.policy"} <= names
    r = hpcg_solve.run((8, 8, 8), device="cpu", backend="auto")
    assert r["passed"] and r["backend"] == "auto"
    with pytest.raises(ValueError, match="backend"):
        hpcg_solve.run((8, 8, 8), device="cpu", backend="pallas")


def test_distributed_and_multigrid_sites_use_jax_names(tmp_path):
    """The JAX package's span and event names at the distributed and
    multigrid sites: the partition plan, a persisted plan's cache hit, a
    replan for a changed pattern, the build phases, the exchange, and the
    single-device and distributed V-cycles."""
    from repro_torch.mg import build_dist_hierarchy, build_hierarchy
    prob = hpcg.generate_problem(8, 8, 16)
    row, col, val, shape = prob.row, prob.col, prob.val, prob.shape
    store = SelectionCache(str(tmp_path / "plans.json"))
    with trace.tracing("full"):
        A = build_dist_matrix(row, col, val, shape, 4, device="cpu", mode="multiformat",
                              tune="analytic", plan_cache=store)
        build_dist_matrix(row, col, val, shape, 4, device="cpu", mode="multiformat",
                          tune="analytic", plan_cache=store)
        val2 = val.copy()
        val2[(row != col) & (row % 7 == 0)] = 0  # same caps, another live pattern
        build_dist_matrix(row, col, val2, shape, 4, device="cpu", mode="multiformat",
                          tune="analytic", plan=A.plan)
        x = torch.ones(shape[0])
        operator(A)(x)
        build_dist_hierarchy(prob, 2, device="cpu", nlevels=2).apply_M()(x)
        build_hierarchy(prob, nlevels=2, device="cpu").apply_M()(x)
        names = {e["name"] for e in trace.events()}
    assert {"plan.partition", "plan.cache_hit", "plan.replan", "plan.dist_formats",
            "plan.switch_batch", "select.batch", "build.dist", "build.partition_execute",
            "build.split_execute", "build.mg_dist_level", "build.mg_level",
            "exchange.issue", "exchange.dist_spmv", "mg.vcycle", "mg.vcycle_dist",
            "plan.switch", "convert.execute"} <= names, names
