"""The port's observability modules against the JAX package's (``repro.obs``).

Metrics: the same numpy-seeded observations give the same quantiles (1e-12)
and the same snapshot entries. Trace: off mode records nothing and never
synchronizes; a span that registered CUDA tensors synchronizes their device
once, at its close; the Chrome export has JAX's schema, and one exported
trace gives the same attribution rows in both packages' reports. Regress:
both gates give identical findings on the repo's JAX ``BENCH_*.json``
against ``results/baseline.json``, and the port's ``bless`` never writes
the JAX package's gate state. Provenance: ``env_info`` carries the keys the
gate compares.
"""
import hashlib
import json
import os
import warnings

import numpy as np
import pytest
import torch

from repro.obs import metrics as jmetrics
from repro.obs import regress as jregress
from repro.obs import report as jreport
from repro.obs import trace as jtrace
from repro_torch.obs import metrics, regress, report, trace
from repro_torch.obs.provenance import env_info

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE = os.path.join(REPO, "results", "baseline.json")


@pytest.fixture(autouse=True)
def _clean_traces():
    trace.clear()
    jtrace.clear()
    yield
    trace.clear()
    jtrace.clear()


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

HISTS = {"t.parity.lat": None, "t.parity.waste": (0.01, 0.05, 0.1, 0.25, 0.5, 0.75, 1.0)}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_quantiles_and_snapshot_equal_jax(seed):
    rng = np.random.default_rng(seed)
    draws = {"t.parity.lat": rng.lognormal(3.0, 1.5, 500),
             "t.parity.waste": rng.uniform(0.0, 1.0, 200)}
    names = list(HISTS) + ["t.parity.count", "t.parity.gauge"]
    for mod in (metrics, jmetrics):
        mod.reset(names)
        for name, buckets in HISTS.items():
            if buckets is not None and name not in mod._BOUNDS:
                mod.define_histogram(name, buckets)
            for v in draws[name]:
                mod.observe(name, v)
        mod.inc("t.parity.count", 3)
        mod.set_gauge("t.parity.gauge", 7.5)
    qs = (0.0, 0.01, 0.25, 0.5, 0.9, 0.95, 0.99, 1.0)
    for name in HISTS:
        for q in qs:
            got, want = metrics.quantile(name, q), jmetrics.quantile(name, q)
            assert got == pytest.approx(want, rel=1e-12, abs=1e-12), (name, q)
        assert metrics.quantiles(name).keys() == jmetrics.quantiles(name).keys()
    snap, jsnap = metrics.snapshot(), jmetrics.snapshot()
    assert snap.keys() == jsnap.keys()
    for name in HISTS:
        assert snap["histograms"][name] == pytest.approx(jsnap["histograms"][name],
                                                         rel=1e-12)
    assert snap["counters"]["t.parity.count"] == jsnap["counters"]["t.parity.count"]
    assert metrics.gauge("t.parity.gauge") == jmetrics.gauge("t.parity.gauge") == 7.5
    assert metrics.DEFAULT_BUCKETS == jmetrics.DEFAULT_BUCKETS


def test_metrics_scope_reset_and_edge_cases():
    metrics.reset(["t.m.a", "t.m.h"])
    assert metrics.quantile("t.m.h", 0.5) is None
    with metrics.scope() as s:
        metrics.inc("t.m.a", 2)
        metrics.observe("t.m.h", 4.0)
        assert s.delta("t.m.a") == 2 and s.deltas() == {"t.m.a": 2}
    assert metrics.quantile("t.m.h", 0.0) == metrics.quantile("t.m.h", 1.0) == 4.0
    with pytest.raises(ValueError):
        metrics.quantile("t.m.h", 1.5)
    with pytest.raises(ValueError):
        metrics.define_histogram("t.m.h", (1.0, 2.0))  # already has observations
    metrics.reset(["t.m.a", "t.m.h"])
    assert metrics.value("t.m.a") == 0 and "t.m.h" not in metrics.snapshot()["histograms"]


# ---------------------------------------------------------------------------
# Trace
# ---------------------------------------------------------------------------


class _CardTensor:
    """Stands in for a CUDA tensor where there is no card."""

    is_cuda = True
    device = torch.device("cuda", 0)


def test_off_mode_emits_nothing_and_never_synchronizes(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: calls.append(a))
    trace.set_mode("off")
    with trace.span("kernel.anything", x=1) as sp:
        sp.sync(_CardTensor(), torch.ones(3))
        sp.set(a=2)
    trace.event("kernel.evt")
    assert trace.events() == [] and trace.aggregate() == {} and calls == []
    assert trace.span("a") is trace.span("b")  # one shared no-op span


def test_span_syncs_registered_card_tensors_once_at_close(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: calls.append(a))
    for m in ("summary", "full"):
        calls.clear()
        with trace.tracing(m):
            with trace.span("solver.solve") as sp:
                sp.sync(torch.ones(2), _CardTensor(), _CardTensor())
                assert calls == []  # never inside the span body
            assert calls == [(torch.device("cuda", 0),)]
            with trace.span("solver.cpu") as sp:  # CPU tensors: nothing to wait for
                sp.sync(torch.ones(2))
            with trace.span("solver.none"):
                pass
            assert len(calls) == 1


def test_spans_nest_events_parent_and_summary_mode():
    with trace.tracing("full"):
        with trace.span("build.outer", kind="t") as outer:
            with trace.span("plan.inner") as inner:
                pass
            trace.event("kernel.route", route="ref")
    evs = {e["name"]: e for e in trace.events()}
    assert evs["build.outer"]["parent"] is None
    assert evs["plan.inner"]["parent"] == evs["kernel.route"]["parent"] == outer.id
    assert inner.id != outer.id and evs["build.outer"]["dur"] >= evs["plan.inner"]["dur"]
    trace.clear()
    with trace.tracing("summary"):
        for _ in range(3):
            with trace.span("select.policy"):
                pass
    assert trace.events() == [] and trace.aggregate()["select.policy"]["count"] == 3
    assert "select.policy" in trace.summary()


def test_ring_drops_count_and_warn_once(tmp_path, monkeypatch):
    monkeypatch.setattr(trace, "RING_CAPACITY", 8)
    with metrics.scope() as s, trace.tracing("full"):
        for i in range(12):
            trace.event("kernel.route", i=i)
        assert trace.dropped() == 4 and s.delta("trace.dropped_events") == 4
        assert [e["args"]["i"] for e in trace.events()] == list(range(4, 12))
        with pytest.warns(RuntimeWarning, match="truncated"):
            trace.export_chrome(str(tmp_path / "t1.json"))
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            trace.export_chrome(str(tmp_path / "t2.json"))
    assert json.load(open(tmp_path / "t1.json"))["otherData"]["dropped_events"] == 4


def _same_spans(mod):
    with mod.tracing("full"):
        with mod.span("build.dist", mode="multiformat") as sp:
            with mod.span("plan.partition", p=4):
                pass
            with mod.span("convert.execute", target="ELL"):
                mod.event("kernel.route", op="spmv", route="ref", fmt="ELL")
            sp.set(p=4)
        with mod.span("solver.solve", precond="none"):
            with mod.span("exchange.dist_spmv", p=4, halo="neighbor"):
                pass


def _shape_of(doc):
    """The export's schema: keys, field types, names, categories, args
    (ids replaced by their parent's position)."""
    evs = doc["traceEvents"]
    pos = {e["args"]["span_id"]: i for i, e in enumerate(evs)}
    out = {"top": sorted(doc), "other": doc["otherData"], "unit": doc["displayTimeUnit"]}
    out["events"] = [
        (sorted(e), e["name"], e["ph"], e["cat"], e["pid"],
         {k: v for k, v in e["args"].items() if k not in ("span_id", "parent_id")},
         pos.get(e["args"]["parent_id"]), type(e["ts"]).__name__, type(e["dur"]).__name__)
        for e in evs]
    return out


def test_chrome_export_schema_equals_jax(tmp_path):
    _same_spans(trace)
    _same_spans(jtrace)
    mine = json.load(open(trace.export_chrome(str(tmp_path / "port.json"))))
    theirs = json.load(open(jtrace.export_chrome(str(tmp_path / "jax.json"))))
    assert _shape_of(mine) == _shape_of(theirs)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_one_trace_file_same_attribution_in_both_reports(tmp_path, writer):
    mod = trace if writer == "port" else jtrace
    _same_spans(mod)
    path = mod.export_chrome(str(tmp_path / "trace.json"))
    rows, jrows = report.attribution(report.load_trace(path)), jreport.attribution(
        jreport.load_trace(path))
    assert rows == jrows
    assert {r["phase"] for r in rows} == {"build", "plan", "convert", "kernel", "solver",
                                          "exchange"}
    assert report.render_attribution(rows) == jreport.render_attribution(jrows)


def test_report_cli_renders_attribution(tmp_path, capsys):
    _same_spans(trace)
    path = trace.export_chrome(str(tmp_path / "t.json"))
    assert report.main([path]) == 0
    out = capsys.readouterr().out
    assert "phase attribution" in out and "solver" in out and "exchange" in out
    assert report.main([path, "--json"]) == 0
    assert json.loads(capsys.readouterr().out)[0]["phase"] in report.PHASES
    doc = json.load(open(os.path.join(REPO, "BENCH_obs.json")))
    assert report.overlap_rows(doc) == jreport.overlap_rows(doc)


# ---------------------------------------------------------------------------
# Regress
# ---------------------------------------------------------------------------


def test_regress_findings_equal_jax_on_the_repo_artifacts():
    baseline = jregress.load_baseline(BASELINE)
    want = jregress.compare(baseline, json_dir=REPO)
    got = regress.compare(regress.load_baseline(BASELINE), json_dir=REPO,
                          artifacts=jregress.ARTIFACTS)
    assert want and got == want
    assert regress.render_markdown(got, BASELINE) == jregress.render_markdown(want, BASELINE)
    row = next(f["name"] for f in want if f["cls"] == "time")
    inj = {row: 3.0}
    got = regress.compare(baseline, json_dir=REPO, inject=inj, artifacts=jregress.ARTIFACTS)
    assert got == jregress.compare(baseline, json_dir=REPO, inject=inj)
    assert any(f["status"] == "regression" and f["name"] == row for f in got)


def test_regress_cli_exit_codes_equal_jax(capsys):
    args = ["--json-dir", REPO, "--baseline", BASELINE, "--json"]
    arts = ["--artifacts", *jregress.ARTIFACTS]
    for extra in ([], ["--inject-slowdown", "format_CSR_n512:2.0"]):
        assert regress.main(args + arts + extra) == jregress.main(args + extra)
    capsys.readouterr()
    assert regress.ARTIFACTS == tuple(f"BENCH_torch_{s}" for s in regress.SUITES)
    assert regress.DEFAULT_BASELINE == os.path.join("results", "baseline_torch.json")


def test_bless_writes_only_under_tmp_path(tmp_path):
    before = {p: _sha(os.path.join(REPO, p)) for p in
              ["results/baseline.json", "results/history/trajectory.jsonl"]
              + [f"{a}.json" for a in jregress.ARTIFACTS]}
    out = tmp_path / "baseline_torch.json"
    doc = regress.bless(REPO, str(out), artifacts=jregress.ARTIFACTS)
    assert out.exists() and set(doc["artifacts"]) == set(jregress.ARTIFACTS)
    # a bless then a compare of the same artifacts finds no regression
    got = regress.compare(regress.load_baseline(str(out)), json_dir=REPO,
                          artifacts=jregress.ARTIFACTS)
    assert not [f for f in got if f["status"] == "regression"]
    # the JAX package's gate state is refused, wherever it lies
    for root in (REPO, str(tmp_path)):
        with pytest.raises(ValueError, match="gate state"):
            regress.bless(REPO, os.path.join(root, "results", "baseline.json"),
                          artifacts=jregress.ARTIFACTS)
    with pytest.raises(ValueError, match="gate state"):
        regress.append_history("BENCH_torch_spmv", [], {},
                               history_dir=str(tmp_path / "results" / "history"))
    assert not (tmp_path / "results").exists()
    with pytest.raises(SystemExit):  # the port's own artifacts do not exist yet
        regress.bless(REPO, str(tmp_path / "none.json"))
    assert {p: _sha(os.path.join(REPO, p)) for p in before} == before


def test_history_lines_cross_both_ways(tmp_path):
    meta = {"env": env_info()}
    regress.append_history("BENCH_torch_hpcg", [("hpcg_cg", 12.5, "iters=131")], meta,
                           history_dir=str(tmp_path))
    jregress.append_history("BENCH_hpcg", [("hpcg_cg", 13.0, "")], meta,
                            history_dir=str(tmp_path))
    mine, theirs = regress.load_history(str(tmp_path)), jregress.load_history(str(tmp_path))
    assert mine == theirs and [e["artifact"] for e in mine] == ["BENCH_torch_hpcg",
                                                                "BENCH_hpcg"]
    assert set(mine[0]["env"]) == set(regress.ENV_COMPARE_KEYS)


def test_env_info_carries_the_compared_keys():
    info = env_info()
    json.dumps(info)
    assert set(jregress.ENV_COMPARE_KEYS) <= set(info)
    assert regress.ENV_COMPARE_KEYS == jregress.ENV_COMPARE_KEYS
    assert info["interpret_mode"] is False and info["torch_version"] == torch.__version__
    assert info["backend"] == ("cuda" if torch.cuda.is_available() else "cpu")
    assert "jax_version" not in info and "power_limit" in info
