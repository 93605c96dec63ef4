"""The benchmark's own CPU tests: ``python -m pytest bench/tests`` from the
root of the repository. They put ``bench/`` (the harness, the reference)
and ``src/`` (the program) on the path, and build small checkouts in
temporary directories."""
import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (BENCH, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def small_checkout(tmp: Path, grid, bench: Path = BENCH) -> Path:
    """A root with the real ``BENCHMARK.json`` whose configurations are cut
    to ``grid``; traffic, checks and readers stay ``bench``'s."""
    d = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in d["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg["grid"] = list(grid)
        f = tmp / c["file"]
        f.parent.mkdir(parents=True, exist_ok=True)
        f.write_text(json.dumps(cfg))
    (tmp / "BENCHMARK.json").write_text(json.dumps(d))
    return tmp


@pytest.fixture
def checkout16(tmp_path):
    return small_checkout(tmp_path, (16, 16, 16))


@pytest.fixture(scope="module")
def one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
