"""The check fails what it must: a run of each cell at 16^3 on the CPU,
the harness's look for a card skipped, with the timed path broken under
it, and with the program in bfloat16 (the control). The sound run passes."""
import pytest
import torch

from harness import cell
from harness.spec import Spec

CELLS = ["hpcg192-cg.solve", "hpcg192-mgpcg.set50"]
SEED = 2**31 + 77


def _run(root, workload, **kw):
    return cell.run(Spec(root), workload, SEED, 0.3, False, torch.device("cpu"), 0.0, "cpu",
                    **kw)


def _state_unchanged(mp):
    """The solver's loop returns its state as it found it (x0, no step)."""
    from repro_torch.core import solvers

    mp.setattr(solvers, "_run", lambda loop, k_block, nblocks=None: 0)


def _half_rows(mp):
    """Each SpMV leaves out the second half of its rows."""
    from repro_torch.core import solvers

    real = solvers.operator

    def operator(A, backend=None, cfg=None):
        f = real(A, backend, cfg)

        def half(v):
            y = f(v).clone()
            y[y.shape[0] // 2:] = 0
            return y
        return half
    mp.setattr(solvers, "operator", operator)


def _answer_altered(mp):
    """The solve's answer is altered where it is produced."""
    from repro_torch.core import solvers

    real = solvers._Loop.result

    def result(self, iters):
        res = real(self, iters)
        res.x[0] += 1.0
        return res
    mp.setattr(solvers._Loop, "result", result)


def _vcycle_identity(mp):
    """The V-cycle returns its input: the preconditioner is left out."""
    from repro_torch.mg import cycle

    mp.setattr(cycle, "v_cycle", lambda hier, r, level=0: r.clone())


FAULTS = {"state_unchanged": _state_unchanged, "half_rows": _half_rows,
          "answer_altered": _answer_altered, "vcycle_identity": _vcycle_identity}


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(checkout16, one_thread, workload):
    r = _run(checkout16, workload)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks" and r["failed"] == 0 and r["attempted"] >= 1


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_fault_is_not_correct(checkout16, one_thread, monkeypatch, workload, fault):
    if fault == "vcycle_identity" and "mgpcg" not in workload:
        pytest.skip("the CG cell has no V-cycle")
    FAULTS[fault](monkeypatch)
    r = _run(checkout16, workload)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_in_bfloat16_is_not_correct(checkout16, one_thread, workload):
    r = _run(checkout16, workload, program_dtype="bfloat16")
    assert not r["correct"], r["checks"]
