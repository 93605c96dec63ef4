"""repro_torch.obs — observability. This slice ports only the counter
registry (:mod:`repro_torch.obs.metrics`); tracing, the decision ledger and
histograms come with the observability slice."""
from repro_torch.obs import metrics

__all__ = ["metrics"]
