"""Find a cell's files by the names in ``BENCHMARK.json``.

A configuration is ``BENCHMARK.json``'s ``file``; a traffic mix is
``<bench>/traffic/<traffic>.json``; a cell's correctness checks are
``<bench>/checks/<workload>.json``; a per-layer metric's reader is
``<bench>/metrics/<metric>.py``, a module with ``read(ctx)``. Adding a
cell, a mix or a metric adds files and edits none.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]


class Spec:
    """``BENCHMARK.json`` at ``root`` and the files it names; ``bench`` is
    the directory that holds the traffic, checks and metric readers."""

    def __init__(self, root: Path, bench: Path = BENCH):
        self.root = Path(root)
        self.bench = Path(bench)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.bench / "traffic" / f"{name}.json").read_text())

    def checks(self, workload: str) -> dict:
        return json.loads((self.bench / "checks" / f"{workload}.json").read_text())

    def metrics(self, workload: str, kind: str) -> List[dict]:
        """The ``end_to_end`` or ``per_layer`` entries that ``workload``
        reports: those without a ``workloads`` key, or that list it."""
        return [m for m in self.data[kind]
                if "workloads" not in m or workload in m["workloads"]]

    def reader(self, metric: str) -> Callable[[dict], Optional[float]]:
        return load_reader(self.bench / "metrics" / f"{metric}.py")


def load_reader(path: Path) -> Callable[[dict], Optional[float]]:
    """``read`` of the reader module at ``path``."""
    mod_name = "bench_metric_" + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(f"no metric reader at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_all(spec: Spec, workload: str, kind: str, ctx: dict) -> Dict[str, dict]:
    """``{name: {"value", "unit"}}`` of the readers that find something."""
    out = {}
    for m in spec.metrics(workload, kind):
        v = spec.reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out
