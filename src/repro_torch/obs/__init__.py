"""repro_torch.obs — observability (port of ``repro.obs``): tracing,
metrics, decisions.

* :mod:`repro_torch.obs.trace`   — ``span()``/``event()`` tracer gated by
  ``REPRO_TRACE=off|summary|full``, Chrome/Perfetto export, ``summary()``.
* :mod:`repro_torch.obs.metrics` — named counters, gauges and fixed-bucket
  histograms (p50/p95/p99 via :func:`metrics.quantile`) with
  ``snapshot()``/``reset()`` and order-independent ``scope()`` deltas.
* :mod:`repro_torch.obs.ledger`  — bounded ring of structured decision
  records (format selections with CART paths, kernel-route vetoes, switch
  plans), gated by ``REPRO_LEDGER`` (on by default).
* :mod:`repro_torch.obs.explain` — replays the ledger as a decision trail.
  CLI: ``python -m repro_torch.obs.explain``.
* :mod:`repro_torch.obs.regress` — bench-trajectory store and noise-aware
  baseline gate. CLI: ``python -m repro_torch.obs.regress``.
* :mod:`repro_torch.obs.report`  — per-phase attribution tables from a live
  or exported trace. CLI: ``python -m repro_torch.obs.report``.

:func:`repro_torch.obs.provenance.env_info` records run provenance (torch
and CUDA versions, backend, card, power limit, git rev). Spans, records
and documents have the JAX package's names and schemas, so each package's
tools read the other's artifacts.
"""
from repro_torch.obs import ledger
from repro_torch.obs import metrics
from repro_torch.obs import trace
from repro_torch.obs.provenance import env_info
from repro_torch.obs.trace import event, span, tracing

__all__ = ["ledger", "metrics", "trace", "span", "event", "tracing",
           "env_info"]
