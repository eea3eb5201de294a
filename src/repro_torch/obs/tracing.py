"""Span-based stage tracing for the split-inference tick pipeline.

A :class:`Tracer` hands out context-manager spans named after pipeline
stages (``calibrate``, ``fused_launch``, ``device_to_host``,
``host_unpack``, ``entropy_encode``, ``entropy_decode``, ``dequantize``,
``framing``, ``socket_write``, ``tick_drain``, ``tail``, ...).  Parent
links propagate through :mod:`contextvars`, so spans nest correctly
across the async server and worker threads.

Tracing is **off by default**: ``span()`` then returns a shared no-op
context manager, so instrumented hot paths pay only an attribute check
(the disabled-overhead benchmark gate in bench_transport.py holds this
to ~0%).  When enabled, each closed span

- appends a structured event ``{span_id, parent_id, stage, t_start,
  dur_s, **attrs}`` to a bounded in-memory deque (optionally mirrored to
  a JSONL file), and
- feeds ``repro_pipeline_stage_latency_seconds{stage=...}`` in the
  default metrics registry.

A tracer may be given a ``sync`` callable, which each span calls as it
opens and as it closes, before it reads the clock: with
``torch.cuda.synchronize`` a span times the device work issued inside
it, not only its dispatch (the split runtime's step parts are timed so).

While a ``torch.profiler`` session records the calling thread, each
span also opens a ``torch.profiler.record_function`` range named
``repro.<stage>`` (after its opening sync; it closes after the closing
one), so the program's spans lie in the profiler's trace on the
profiler's clock.  :meth:`Tracer.annotate` is the light form: such a
range alone, with no sync and no event, for places too fine for a span
(a layer's attention or FFN, the codec's pass).  Neither imports torch;
with tracing off neither checks for a profiler.

``REPRO_OBS_TRACE=1`` enables tracing at import.
"""

from __future__ import annotations

import contextvars
import itertools
import json
import os
import sys
import threading
import time
from collections import deque

from .metrics import default_registry

__all__ = ["Span", "Tracer", "configure_tracing", "span", "tracer"]

_STAGE_HIST = "repro_pipeline_stage_latency_seconds"

_current_span: contextvars.ContextVar = contextvars.ContextVar(
    "repro_obs_current_span", default=None)


class _NullSpan:
    """Shared no-op span: the disabled-path cost is one enabled check."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_NULL_SPAN = _NullSpan()


def _profiler_range(name: str):
    """``record_function(name)``, not yet entered, where a
    ``torch.profiler`` session records this thread, else None (torch is
    never imported here: without it no profiler runs)."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd._profiler_enabled():
        return None
    return torch.autograd.profiler.record_function(name)


class Span:
    __slots__ = ("stage", "attrs", "span_id", "parent_id", "t_start",
                 "dur_s", "_tracer", "_token", "_t0", "_range")

    def __init__(self, tracer: "Tracer", stage: str, attrs: dict):
        self.stage = stage
        self.attrs = attrs
        self.span_id = next(tracer._ids)
        self.parent_id = None
        self.t_start = 0.0
        self.dur_s = 0.0
        self._tracer = tracer
        self._token = None
        self._t0 = 0.0
        self._range = None

    def set(self, **attrs):
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        parent = _current_span.get()
        self.parent_id = parent.span_id if parent is not None else None
        self._token = _current_span.set(self)
        if self._tracer.sync is not None:
            self._tracer.sync()
        self._range = _profiler_range("repro." + self.stage)
        if self._range is not None:
            self._range.__enter__()
        self.t_start = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._tracer.sync is not None and exc_type is None:
            self._tracer.sync()
        self.dur_s = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
            self._range = None
        if self._token is not None:
            _current_span.reset(self._token)
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        self._tracer._finish(self)
        return False


class Tracer:
    """Per-process tracer; use the module-level :func:`tracer` singleton."""

    def __init__(self, registry=None, max_events: int = 65536):
        self.enabled = False
        self.sync = None
        self.events: deque[dict] = deque(maxlen=max_events)
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._event_path: str | None = None
        self._registry = registry or default_registry()
        self._hist = None

    # configuration ----------------------------------------------------
    def configure(self, enabled: bool | None = None,
                  event_log_path: str | None | type(...) = ...,
                  sync=...) -> "Tracer":
        if enabled is not None:
            self.enabled = bool(enabled)
        if event_log_path is not ...:
            self._event_path = event_log_path
        if sync is not ...:
            self.sync = sync
        if self.enabled and self._hist is None:
            self._hist = self._registry.histogram(
                _STAGE_HIST, "wall time per pipeline stage span",
                labelnames=("stage",))
        return self

    def reset(self) -> None:
        with self._lock:
            self.events.clear()

    # span API ---------------------------------------------------------
    def span(self, stage: str, **attrs):
        if not self.enabled:
            return _NULL_SPAN
        return Span(self, stage, attrs)

    def _finish(self, sp: Span) -> None:
        event = {"span_id": sp.span_id, "parent_id": sp.parent_id,
                 "stage": sp.stage, "t_start": sp.t_start,
                 "dur_s": sp.dur_s}
        if sp.attrs:
            event.update(sp.attrs)
        with self._lock:
            self.events.append(event)
            if self._event_path:
                try:
                    with open(self._event_path, "a") as fh:
                        fh.write(json.dumps(event) + "\n")
                except OSError:
                    self._event_path = None  # stop retrying a dead path
        if self._hist is not None:
            self._hist.observe(sp.dur_s, stage=sp.stage)

    # torch.profiler ranges -------------------------------------------
    def annotate(self, name: str):
        """A ``record_function(name)`` range where tracing is on and a
        ``torch.profiler`` session records this thread; else the shared
        no-op.  No sync, no event: it only marks the trace."""
        if not self.enabled:
            return _NULL_SPAN
        rf = _profiler_range(name)
        return _NULL_SPAN if rf is None else rf

    # analysis helpers -------------------------------------------------
    def snapshot_events(self) -> list[dict]:
        with self._lock:
            return list(self.events)

    def stage_totals(self, stages=None) -> dict[str, float]:
        """Summed duration per stage (optionally restricted to `stages`)."""
        totals: dict[str, float] = {}
        for ev in self.snapshot_events():
            st = ev["stage"]
            if stages is not None and st not in stages:
                continue
            totals[st] = totals.get(st, 0.0) + ev["dur_s"]
        return totals

    def dump_events(self, path: str) -> int:
        events = self.snapshot_events()
        with open(path, "w") as fh:
            json.dump({"events": events}, fh, indent=1)
        return len(events)


_TRACER = Tracer()
if os.environ.get("REPRO_OBS_TRACE", "") not in ("", "0"):
    _TRACER.configure(enabled=True)


def tracer() -> Tracer:
    return _TRACER


def span(stage: str, **attrs):
    """Module-level convenience: ``with span("entropy_encode"): ...``."""
    return _TRACER.span(stage, **attrs)


def configure_tracing(enabled: bool | None = None,
                      event_log_path: str | None | type(...) = ...,
                      sync=...) -> Tracer:
    return _TRACER.configure(enabled, event_log_path, sync)
