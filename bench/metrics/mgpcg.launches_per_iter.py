"""The port's kernel launches in the window per active MG-PCG iteration
(``kernels.ops.launch_counts`` and ``solver_vec.launches``, replays of a
captured graph counted; the V-cycle's PyTorch operations are not among
them)."""
from harness.readers import launches_per_iter as read  # noqa: F401
