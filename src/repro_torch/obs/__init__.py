"""Observability layer: metrics and stage tracing (stdlib only).

- :mod:`repro_torch.obs.metrics` -- a thread-safe :class:`MetricsRegistry`
  of typed Counter/Gauge/Histogram instruments with Prometheus text-format
  rendering (names follow ``repro_<subsystem>_<name>_<unit>``).
- :mod:`repro_torch.obs.tracing` -- span-based stage tracing, disabled by
  default; optionally wraps the fused-encode dispatch in
  ``torch.profiler.record_function``.
"""

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
    "MetricsRegistry",
    "Tracer",
    "configure_tracing",
    "default_registry",
    "render_registries",
    "span",
    "tracer",
    "validate_name",
]
