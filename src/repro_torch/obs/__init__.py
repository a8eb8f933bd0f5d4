"""repro_torch.obs — observability: metrics, trace spans, flight recorder.

A copy of the stdlib-only ``repro.obs`` layers, kept in the port so it
imports nothing of the JAX package:

* :mod:`repro_torch.obs.metrics` — counters / gauges / bounded-reservoir
  histograms in a :class:`Registry` (process-global default +
  injectable instances).
* :mod:`repro_torch.obs.export` — Prometheus text + JSON exporters and the
  ``http.server`` scrape endpoint (``launch.serve --metrics-port``).
* :mod:`repro_torch.obs.trace` — per-request span events, the
  :class:`FlightRecorder` ring of recent requests, JSONL +
  ``chrome://tracing`` dumps, and the single TTFT definition every
  serve path derives ``Result.prefill_ms`` from.

The quality probe (``repro.obs.quality``) is not ported yet.

An :class:`Observability` bundle (registry + flight recorder) is what
the serve engine carries; the default constructs fresh instances so
engines never share state unless a caller wires them to the global
registry (as ``launch.serve`` does for its scrape endpoint).

Metric catalogue, span schema and usage: docs/observability.md.
"""
from __future__ import annotations

from typing import Optional

from . import export, metrics, trace  # noqa: F401
from .export import (  # noqa: F401
    MetricsServer,
    parse_prometheus,
    start_metrics_server,
    to_json,
    to_prometheus,
)
from .metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    Registry,
    Ring,
    get_registry,
    set_registry,
)
from .trace import FlightRecorder, RequestTrace  # noqa: F401


class Observability:
    """Registry + flight recorder, as one injectable unit."""

    def __init__(self, registry: Optional[Registry] = None,
                 recorder: Optional[FlightRecorder] = None,
                 flight_capacity: int = 256):
        self.registry = registry if registry is not None else Registry()
        self.recorder = (recorder if recorder is not None
                         else FlightRecorder(capacity=flight_capacity))

    def reset(self) -> None:
        """Zero metrics and drop traces (bench warmup)."""
        self.registry.reset()
        self.recorder.clear()
