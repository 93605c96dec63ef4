"""Percent of the HBM roofline over the whole window: the active CG
iterations, each at the configuration's bytes an iteration (4 nnz + 36 n),
at the card's HBM rate, over the window's wall time. It bounds a gain
whatever a later change fuses or removes."""
from harness.readers import iter_roofline as read  # noqa: F401
