"""Typed metrics instruments and a thread-safe registry.

Instruments are Counter (monotone), Gauge (settable, series removable)
and Histogram (fixed buckets, cumulative exposition).  Every instrument
lives in a :class:`MetricsRegistry`; components create their own
registry (so tests see isolated counters) while worker-level state (the
stage-latency histogram fed by tracing, the shared codec-bank cache)
lands in the process-wide :func:`default_registry`.

Naming convention -- enforced at registration time:

    repro_<subsystem>_<name>_<unit>

lowercase ``[a-z0-9_]`` tokens; the last token must be a recognized
unit (``total`` for counters, ``seconds``/``bytes``/... otherwise) so
names stay scrape-stable across PRs (see tests/test_obs_naming.py).
"""

from __future__ import annotations

import bisect
import math
import re
import threading

__all__ = [
    "ALLOWED_UNITS",
    "BPE_BUCKETS",
    "LATENCY_BUCKETS",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "default_registry",
    "render_registries",
    "validate_name",
]

# log-spaced 100us .. 10s: covers a no-op span through a full serve run
LATENCY_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                   0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)
# bits/element of the coded split stream: 0.25 .. 16 (bf16 passthrough)
BPE_BUCKETS = (0.25, 0.5, 0.75, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0, 8.0,
               12.0, 16.0)

# last name token must be one of these (counters additionally must end
# in _total, the Prometheus convention for monotone series)
ALLOWED_UNITS = frozenset({
    "total", "seconds", "bytes", "bits", "elements", "chunks", "count",
    "bpe", "ratio", "info",
})

_NAME_RE = re.compile(r"^repro(_[a-z][a-z0-9]*)+$")
_LABEL_RE = re.compile(r"^[a-z][a-z0-9_]*$")


def validate_name(name: str, kind: str) -> None:
    """Raise ValueError unless ``name`` follows the naming convention."""
    if not _NAME_RE.match(name):
        raise ValueError(
            f"instrument name {name!r} violates repro_<subsystem>_<name>_"
            f"<unit> (lowercase, underscore-separated, 'repro_' prefix)")
    tokens = name.split("_")
    if len(tokens) < 3:
        raise ValueError(f"instrument name {name!r} needs at least "
                         "repro_<subsystem>_<unit>")
    unit = tokens[-1]
    if unit not in ALLOWED_UNITS:
        raise ValueError(f"instrument name {name!r} ends in unknown unit "
                         f"{unit!r}; allowed: {sorted(ALLOWED_UNITS)}")
    if kind == "counter" and unit != "total":
        raise ValueError(f"counter {name!r} must end in _total")
    if kind != "counter" and unit == "total":
        raise ValueError(f"{kind} {name!r} must not end in _total "
                         "(reserved for counters)")


def _escape_label(value: str) -> str:
    return (value.replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _escape_help(text: str) -> str:
    return text.replace("\\", r"\\").replace("\n", r"\n")


def _fmt(value: float) -> str:
    if value == math.inf:
        return "+Inf"
    if value == -math.inf:
        return "-Inf"
    f = float(value)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


class _Instrument:
    """Base: a named family of label series sharing one lock."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: tuple[str, ...] = ()):
        validate_name(name, self.kind)
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"bad label name {ln!r} on {name}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._series: dict[tuple[str, ...], object] = {}

    def _key(self, labels: dict[str, object]) -> tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: got labels {sorted(labels)}, "
                f"declared {sorted(self.labelnames)}")
        return tuple(str(labels[ln]) for ln in self.labelnames)

    def remove(self, **labels) -> bool:
        """Drop one label series (e.g. on session eviction)."""
        with self._lock:
            return self._series.pop(self._key(labels), None) is not None

    def clear(self) -> None:
        with self._lock:
            self._series.clear()

    def series(self) -> dict[tuple[str, ...], object]:
        with self._lock:
            return dict(self._series)

    # exposition -------------------------------------------------------
    def _render_series(self, out: list[str]) -> None:
        raise NotImplementedError

    def render(self) -> str:
        out = [f"# HELP {self.name} {_escape_help(self.help)}",
               f"# TYPE {self.name} {self.kind}"]
        self._render_series(out)
        return "\n".join(out)

    def _labelstr(self, key: tuple[str, ...],
                  extra: tuple[tuple[str, str], ...] = ()) -> str:
        pairs = [f'{ln}="{_escape_label(lv)}"'
                 for ln, lv in zip(self.labelnames, key)]
        pairs += [f'{ln}="{_escape_label(lv)}"' for ln, lv in extra]
        return "{" + ",".join(pairs) + "}" if pairs else ""


class Counter(_Instrument):
    kind = "counter"

    def inc(self, amount: float = 1, **labels) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up")
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(self._key(labels), 0.0))

    def total(self) -> float:
        with self._lock:
            return float(sum(self._series.values()))

    def _render_series(self, out: list[str]) -> None:
        for key, val in sorted(self.series().items()):
            out.append(f"{self.name}{self._labelstr(key)} {_fmt(val)}")

    def snapshot(self) -> list[dict]:
        return [{"labels": dict(zip(self.labelnames, k)), "value": v}
                for k, v in sorted(self.series().items())]


class Gauge(_Instrument):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._series[self._key(labels)] = float(value)

    def inc(self, amount: float = 1, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def dec(self, amount: float = 1, **labels) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(self._key(labels), 0.0))

    def _render_series(self, out: list[str]) -> None:
        for key, val in sorted(self.series().items()):
            out.append(f"{self.name}{self._labelstr(key)} {_fmt(val)}")

    def snapshot(self) -> list[dict]:
        return [{"labels": dict(zip(self.labelnames, k)), "value": v}
                for k, v in sorted(self.series().items())]


class Histogram(_Instrument):
    """Fixed-bucket histogram; exposition uses cumulative ``le`` buckets."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: tuple[str, ...] = (),
                 buckets: tuple[float, ...] = LATENCY_BUCKETS):
        super().__init__(name, help, labelnames)
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError(f"{name}: needs at least one bucket bound")
        self.buckets = bounds

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        idx = bisect.bisect_left(self.buckets, float(value))
        with self._lock:
            state = self._series.get(key)
            if state is None:
                state = [[0] * (len(self.buckets) + 1), 0.0, 0]
                self._series[key] = state
            state[0][idx] += 1
            state[1] += float(value)
            state[2] += 1

    def count(self, **labels) -> int:
        with self._lock:
            state = self._series.get(self._key(labels))
            return int(state[2]) if state else 0

    def sum(self, **labels) -> float:
        with self._lock:
            state = self._series.get(self._key(labels))
            return float(state[1]) if state else 0.0

    def quantile(self, q: float, **labels) -> float:
        """Bucket-midpoint estimate of the q-quantile (0 <= q <= 1)."""
        with self._lock:
            state = self._series.get(self._key(labels))
            if not state or state[2] == 0:
                return 0.0
            counts, _, n = state
            rank = q * n
            seen = 0
            for i, c in enumerate(counts):
                seen += c
                if seen >= rank and c:
                    lo = self.buckets[i - 1] if i else 0.0
                    hi = (self.buckets[i] if i < len(self.buckets)
                          else self.buckets[-1])
                    return 0.5 * (lo + hi)
            return self.buckets[-1]

    def _render_series(self, out: list[str]) -> None:
        for key, state in sorted(self.series().items()):
            counts, total, n = state
            cum = 0
            for bound, c in zip(self.buckets, counts):
                cum += c
                ls = self._labelstr(key, (("le", _fmt(bound)),))
                out.append(f"{self.name}_bucket{ls} {cum}")
            cum += counts[-1]
            ls = self._labelstr(key, (("le", "+Inf"),))
            out.append(f"{self.name}_bucket{ls} {cum}")
            out.append(f"{self.name}_sum{self._labelstr(key)} {_fmt(total)}")
            out.append(f"{self.name}_count{self._labelstr(key)} {n}")

    def snapshot(self) -> list[dict]:
        return [{"labels": dict(zip(self.labelnames, k)),
                 "count": s[2], "sum": s[1],
                 "buckets": dict(zip(map(_fmt, self.buckets), s[0]))}
                for k, s in sorted(self.series().items())]


class MetricsRegistry:
    """Get-or-create instrument store; thread-safe; renders Prometheus text."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: dict[str, _Instrument] = {}

    def _get_or_create(self, cls, name, help, labelnames, **kw):
        labelnames = tuple(labelnames)
        with self._lock:
            inst = self._instruments.get(name)
            if inst is not None:
                if not isinstance(inst, cls):
                    raise ValueError(f"{name} already registered as "
                                     f"{inst.kind}, not {cls.kind}")
                if inst.labelnames != labelnames:
                    raise ValueError(f"{name} already registered with labels "
                                     f"{inst.labelnames}, not {labelnames}")
                return inst
            inst = cls(name, help, labelnames, **kw)
            self._instruments[name] = inst
            return inst

    def counter(self, name: str, help: str = "",
                labelnames: tuple[str, ...] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: tuple[str, ...] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: tuple[str, ...] = (),
                  buckets: tuple[float, ...] = LATENCY_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def get(self, name: str) -> _Instrument | None:
        with self._lock:
            return self._instruments.get(name)

    def instruments(self) -> list[_Instrument]:
        with self._lock:
            return sorted(self._instruments.values(), key=lambda i: i.name)

    def clear_values(self) -> None:
        """Reset every series (tests / clear_bank_cache); names stay."""
        for inst in self.instruments():
            inst.clear()

    def render(self) -> str:
        parts = [inst.render() for inst in self.instruments()]
        return "\n".join(parts) + ("\n" if parts else "")

    def snapshot(self) -> dict:
        return {inst.name: {"type": inst.kind, "help": inst.help,
                            "series": inst.snapshot()}
                for inst in self.instruments()}


def render_registries(registries) -> str:
    """Concatenate several registries, skipping duplicate family names."""
    seen: set[str] = set()
    parts = []
    for reg in registries:
        for inst in reg.instruments():
            if inst.name in seen:
                continue
            seen.add(inst.name)
            parts.append(inst.render())
    return "\n".join(parts) + ("\n" if parts else "")


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """Process-wide registry for worker-level instruments."""
    return _DEFAULT
