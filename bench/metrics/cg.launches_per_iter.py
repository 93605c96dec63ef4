"""The port's kernel launches in the window per active CG iteration
(``kernels.ops.launch_counts`` and ``solver_vec.launches``, replays of a
captured graph counted)."""
from harness.readers import launches_per_iter as read  # noqa: F401
