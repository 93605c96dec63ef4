"""The solver layer's readers of the port's per-solve record
(``harness/loops.py``, ``metrics/cg.*_ms``, ``metrics/*.device_allocs``)
on the CPU: a whole traced run at 16^3, and what they read where the
program keeps no record or too few."""
import collections

import pytest
import torch

from conftest import ROOT
from harness import cell, loops
from harness.spec import Spec

CG_NEW = ("cg.preamble_ms", "cg.eager_ms", "cg.capture_ms", "cg.device_allocs")


def test_traced_cpu_run_reads_the_host_phases_and_no_capture(checkout16, one_thread):
    spec = Spec(checkout16)
    result = cell.run(spec, "hpcg192-cg.solve", 2**31 + 11, 0.3, True, torch.device("cpu"),
                      0.0, "cpu")
    got = result["metrics"]
    assert result["correct"] and result["attempted"] >= 1
    for name in ("cg.preamble_ms", "cg.eager_ms"):
        assert isinstance(got[name]["value"], float) and got[name]["value"] > 0
        assert got[name]["unit"] == "ms"
    assert "cg.capture_ms" not in got and "cg.device_allocs" not in got


def _ctx(solves, traced=None, peaks=None):
    return {"window": {"solves": [{}] * solves},
            "trace": None if traced is None else {"solves": [{}] * traced},
            "peaks": peaks}


def test_readers_take_the_window_untraced_records(monkeypatch):
    from repro_torch.core import solvers

    rec = solvers.LoopStats(8, 1, True, 2, 3, 20, 1.0, 2.0, 3.0, 4.0, 5.0, 2)
    recs = [rec._replace(preamble_ms=float(i), device_allocs=i) for i in range(6)]
    monkeypatch.setattr(solvers, "loops", collections.deque(recs, maxlen=16))
    # the window: the last 4 records, of which the first is traced
    assert loops.untraced(_ctx(4, traced=1)) == recs[3:]
    assert loops.mean(_ctx(4, traced=1), "preamble_ms") == 4.0
    assert loops.mean(_ctx(2), "device_allocs", card_only=True) is None
    assert loops.mean(_ctx(2, peaks={"hbm_Bps": 1.0}), "device_allocs", card_only=True) == 4.5
    assert loops.untraced(_ctx(7)) is None  # fewer records than solves
    assert loops.untraced(_ctx(2, traced=2)) is None  # every solve traced


@pytest.mark.parametrize("name", CG_NEW)
def test_readers_read_nothing_from_a_program_without_records(monkeypatch, name):
    from repro_torch.core import solvers

    monkeypatch.delattr(solvers, "loops")
    assert Spec(ROOT).reader(name)(_ctx(3, peaks={"hbm_Bps": 1.0})) is None
