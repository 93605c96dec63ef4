"""The yardstick's counts against hand counts, and the table of peaks."""
import json

import pytest

from conftest import ROOT
from harness import yardstick


def test_stencil_nnz_by_hand():
    assert yardstick.stencil_nnz((8, 8, 8)) == 10648  # 22^3
    assert yardstick.stencil_nnz((192, 192, 192)) == 189119224  # 574^3
    assert [nnz for _, nnz in yardstick.levels((192, 192, 192), 4)] == [
        189119224, 23393656, 2863288, 343000]


def _config(name):
    return json.loads((ROOT / "bench" / "configs" / f"{name}.json").read_text())


def test_cg_bytes_by_hand():
    n, nnz = 192 ** 3, 189119224
    w = yardstick.work(_config("hpcg192-cg"))["bytes"]
    assert w["spmv"] == 4 * nnz + 8 * n == 813100000
    assert w["solver_vec"] == 28 * n
    assert w["iter"] == w["spmv"] + w["solver_vec"]


def test_mgpcg_counts_by_hand():
    (n0, z0), (n1, z1), (n2, z2), (n3, z3) = yardstick.levels((192, 192, 192), 4)
    w = yardstick.work(_config("hpcg192-mgpcg"))
    # HPCG 3.1 ReportResults.cpp: SpMV 2 nnz, 3 dots + 3 WAXPBYs 12 n; a
    # fine level (1 pre, 1 post sweep) 4 + 2 + 4 nnz; the coarsest 4 nnz
    flops = 2 * z0 + 12 * n0 + 10 * (z0 + z1 + z2) + 4 * z3
    assert w["flops"]["iter"] == flops
    assert w["flops"]["per_set"] == 2 * z0 + 4 * n0
    assert abs(50 * flops + w["flops"]["per_set"] - 131.32e9) < 0.01e9
    fine = lambda n, z, nn: 20 * z + 68 * n + 12 * nn  # noqa: E731
    bts = (4 * z0 + 40 * n0 + fine(n0, z0, n1) + fine(n1, z1, n2) + fine(n2, z2, n3)
           + 8 * z3 + 24 * n3)
    assert w["bytes"]["iter"] == bts


def test_peaks_by_card_name():
    assert yardstick.peaks_for("NVIDIA H100 80GB HBM3")["hbm_Bps"] == 3.35e12
    assert yardstick.peaks_for("NVIDIA H100 PCIe")["hbm_Bps"] == 2.0e12
    with pytest.raises(KeyError):
        yardstick.peaks_for("cpu")
