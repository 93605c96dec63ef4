"""The import check and the refusal to run without a card."""
import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT
from harness import guard


def test_whole_top_level_names_are_compared():
    mods = ["repro_torch", "repro_torch.core.solvers", "reproducible", "torch", "numpy"]
    assert guard.forbidden_loaded(mods) == []
    assert guard.forbidden_loaded(mods + ["repro.core"]) == ["repro.core"]
    assert guard.forbidden_loaded(["jax", "jaxlib.xla_client", "flax.linen"]) == [
        "flax.linen", "jax", "jaxlib.xla_client"]
    assert guard.forbidden_loaded(["repro_torch.mg"], guard.REFERENCE_FORBIDDEN) == [
        "repro_torch.mg"]


def test_the_harness_and_the_program_load_no_jax():
    code = ("import sys; sys.path[:0] = ['bench', 'src']; "
            "from harness import cell, drive, system, devtrace, readers; "
            "from reference import compare; "
            "import repro_torch.core.solvers, repro_torch.mg, repro_torch.tuning.policy; "
            "from harness import guard; print(guard.forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_card_no_result(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the run without one")
    env = dict(os.environ, HOME=str(tmp_path), TMPDIR=str(tmp_path))
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", "hpcg192-cg.solve",
                          "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    for line in out.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_without_the_program_no_result(tmp_path):
    """A checkout of ``BENCHMARK.json`` and ``bench/`` alone fails."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", "hpcg192-cg.solve",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and not out.stdout.strip()
