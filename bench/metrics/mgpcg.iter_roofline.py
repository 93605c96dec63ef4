"""Percent of the HBM roofline over the whole window: the active MG-PCG
iterations, each at the configuration's bytes an iteration (the CG
iteration's and every V-cycle level's), at the card's HBM rate, over the
window's wall time."""
from harness.readers import iter_roofline as read  # noqa: F401
