"""``BENCHMARK.json`` against the contract's shape, and the harness finding
every configuration, mix, check and reader by name, a new one included."""
import json
import re
import shutil

import pytest
import torch

from conftest import BENCH, ROOT, small_checkout
from harness import cell
from harness.spec import Spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
D = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_command():
    assert set(D) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert D["command"] == ["python3", "bench/run.py"] and D["paths"] == ["bench"]
    assert 1 <= D["run_seconds"] <= 51
    # a full check of 24 cells fits its 43200 s
    assert 2 + 14 * 24 * (D["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_keys():
    names = set()
    for c in D["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("bench/")
        assert all(NAME.match(k) for k in c["reduced"])
        assert (ROOT / c["file"]).is_file()
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert all(k in cfg for k in c["reduced"])
    for w in D["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in D["end_to_end"] + D["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        assert m["name"] not in names
        names.add(m["name"])
        if "_roofline" in m["name"]:
            assert m["unit"] == "%"
    for m in D["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in D["end_to_end"])
    for m in D["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}


@pytest.mark.parametrize("w", D["workloads"], ids=lambda w: w["name"])
def test_every_cell_finds_its_files(w):
    spec = Spec(ROOT)
    assert spec.config(w["config"])["name"] == w["config"]
    assert spec.traffic(w["traffic"])["solver"] in ("cg", "pcg_mg")
    assert spec.checks(w["name"])["limits"]
    e2e = {m["name"] for m in spec.metrics(w["name"], "end_to_end")}
    layer = spec.metrics(w["name"], "per_layer")
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for m in layer:  # each per-layer metric moves an end-to-end metric the cell reports
        assert m["moves"] in e2e, (w["name"], m["name"])
    for m in spec.metrics(w["name"], "end_to_end") + layer:
        assert callable(spec.reader(m["name"]))


def test_a_new_mix_metric_and_cell_are_found_without_an_edit(tmp_path, one_thread):
    """A later change adds files only: a traffic mix, a check, a reader and
    entries of ``BENCHMARK.json``; the harness runs the new cell."""
    root = small_checkout(tmp_path / "root", (8, 8, 8))
    bench = tmp_path / "bench"
    for sub in ("traffic", "checks", "metrics"):
        shutil.copytree(BENCH / sub, bench / sub)
    loose = json.loads((BENCH / "traffic" / "cg_tol.json").read_text())
    loose.update(tol=1e-4)
    (bench / "traffic" / "cg_loose.json").write_text(json.dumps(loose))
    (bench / "checks" / "hpcg192-cg.loose.json").write_text(json.dumps(
        {"hist_iters": 10, "floor": 1e-4, "limits": {"rres": 1e-3, "iters_gap": 20}}))
    (bench / "metrics" / "cg.max_iters.py").write_text(
        "def read(ctx):\n    return max(s['iters'] for s in ctx['window']['solves'])\n")
    d = json.loads((root / "BENCHMARK.json").read_text())
    d["workloads"].append({"name": "hpcg192-cg.loose", "config": "hpcg192-cg",
                           "traffic": "cg_loose", "chips": 1, "why": "a looser tolerance"})
    d["per_layer"].append({"name": "cg.max_iters", "unit": "iters", "better": "lower",
                           "source": "program_counter", "layer": "solver",
                           "moves": "solve_ms", "workloads": ["hpcg192-cg.loose"]})
    d["end_to_end"][1]["workloads"].append("hpcg192-cg.loose")
    (root / "BENCHMARK.json").write_text(json.dumps(d))
    spec = Spec(root, bench)
    r = cell.run(spec, "hpcg192-cg.loose", 11, 0.2, True, torch.device("cpu"), 0.0, "cpu")
    assert r["correct"] and set(r["checks"]) == {"rres", "iters_gap"}
    tight = cell.run(spec, "hpcg192-cg.solve", 11, 0.2, True, torch.device("cpu"), 0.0, "cpu")
    assert 0 < r["metrics"]["cg.max_iters"]["value"] < tight["metrics"]["cg.iters"]["value"]
    assert "cg.max_iters" not in tight["metrics"]
