"""Reading a profiler trace: busy time, time by kernel, the idle gaps and
what the host did in them, on hand-made events and on a real CPU trace."""
import pytest
import torch

from harness import devtrace


def test_short_names():
    assert devtrace.short_name(
        "void (anonymous namespace)::dia_spmv_kernel<float, 4>(int const*, float*)"
    ) == "dia_spmv_kernel"
    assert devtrace.short_name("update_kernel<float>") == "update_kernel"
    assert devtrace.short_name("Memset (Device)") == "Memset"


def test_busy_gaps_and_names():
    ms = 1_000_000
    evs = [("dia_spmv_kernel<float>", 0, 4 * ms, True),
           ("dot_kernel<float>", 3 * ms, 5 * ms, True),   # overlaps the first
           ("dia_spmv_kernel<float>", 8 * ms, 9 * ms, True),
           ("cudaGraphInstantiate", 5 * ms + 10, 8 * ms - 10, False),
           ("aten::zeros", 6 * ms, 6 * ms + 100, False),   # not at the gap's middle
           ("bench.solve", 0, 10 * ms, False)]
    s = devtrace.summarise(evs, 0.010)
    assert s["busy_s"] == pytest.approx(0.006)
    assert s["by_name"]["dia_spmv_kernel"] == {"seconds": pytest.approx(0.005), "launches": 2}
    assert s["ops"][0] == ["dia_spmv_kernel", pytest.approx(0.005)]
    assert s["gaps"][0] == ["cudaGraphInstantiate", pytest.approx(0.003)]
    assert s["gaps"][1] == ["bench.solve", pytest.approx(0.001)]  # the tail, 9..10 ms


def test_events_of_a_real_profile():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as p:
        torch.ones(1000).mul(2).sum()
    evs = devtrace.events(p)
    assert any(name == "aten::mul" and not dev for name, _, _, dev in evs)
    s = devtrace.summarise(evs, 0.1)
    assert s["busy_s"] == 0 and s["gaps"] == []
