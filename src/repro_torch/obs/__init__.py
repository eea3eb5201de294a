"""Observability layer: metrics, stage tracing, exposition (stdlib only).

- :mod:`repro_torch.obs.metrics` -- a thread-safe :class:`MetricsRegistry`
  of typed Counter/Gauge/Histogram instruments with Prometheus text-format
  rendering (names follow ``repro_<subsystem>_<name>_<unit>``).
- :mod:`repro_torch.obs.tracing` -- span-based stage tracing, disabled by
  default; while a ``torch.profiler`` session records, each span is
  also a ``repro.<stage>`` ``record_function`` range in the profiler's
  trace, and ``Tracer.annotate`` opens such a range alone.
- :mod:`repro_torch.obs.exposition` -- a minimal asyncio HTTP endpoint
  serving ``GET /metrics`` (Prometheus text 0.0.4) and ``GET /events``
  (the JSON span log), plus a text-format parser for tests.
"""

from .exposition import MetricsExposition, parse_prometheus_text
from .metrics import (
    BPE_BUCKETS,
    LATENCY_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
    render_registries,
    validate_name,
)
from .tracing import Tracer, configure_tracing, span, tracer

__all__ = [
    "BPE_BUCKETS",
    "LATENCY_BUCKETS",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsExposition",
    "MetricsRegistry",
    "Tracer",
    "configure_tracing",
    "default_registry",
    "parse_prometheus_text",
    "render_registries",
    "span",
    "tracer",
    "validate_name",
]
