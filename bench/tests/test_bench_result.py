"""The result's last line: its keys, their order and their types, from a
whole run of each cell at 8^3 on the CPU (the look for a card skipped)."""
import io
import json

import pytest
import torch

from conftest import small_checkout
from harness import cell
from harness.spec import Spec

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", ["hpcg192-cg.solve", "hpcg192-mgpcg.set50"])
def test_last_line_schema(tmp_path, one_thread, workload, trace):
    import run

    spec = Spec(small_checkout(tmp_path, (8, 8, 8)))
    result = cell.run(spec, workload, 2**31 + 9, 0.2, bool(trace), torch.device("cpu"),
                      0.0, "cpu")
    out, err = io.StringIO(), io.StringIO()
    run.emit(result, out, err)
    line = json.loads(out.getvalue().splitlines()[-1])
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in spec.metrics(workload, kind)}
    assert set(line["metrics"]) <= names and line["metrics"]
    for v in line["metrics"].values():
        assert set(v) == {"value", "unit"} and isinstance(v["value"], float)
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    tail = err.getvalue().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") and t.endswith(" ok") for t in tail)
    if not trace:
        assert {"setup_s"} < set(line["metrics"])
