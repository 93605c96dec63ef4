"""On the card only: each cell's whole run for a short window, through
``bench/run.py``, as the benchmark runs a cell (``-m cuda``)."""
import json
import subprocess
import sys

import pytest

from conftest import ROOT


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", ["hpcg192-cg.solve", "hpcg192-mgpcg.set50"])
def test_cell_on_card(card, workload, trace):
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", workload,
                          "--seed", str(2**31 + 21), "--seconds", "3", "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
