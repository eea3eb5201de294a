"""Read a ``torch.profiler`` trace of the traced window.

The profiler's Chrome trace is parsed into device operations (kernels,
copies, fills, with their launch's correlation id), host launch calls
(the CUDA launch calls, with the same ids), host operations and the
harness's ``record_function`` ranges.  Times are microseconds on the
trace's clock.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}
HOST_CATS = {"cpu_op", "user_annotation", "python_function"}


@dataclasses.dataclass
class Trace:
    device: list        # (name, start, dur, correlation)
    launches: list      # (start, correlation)
    host: list          # (name, start, dur, tid)
    ranges: list        # (name, start, dur): the harness's annotations


def parse(events: list[dict]) -> Trace:
    device, launches, host, ranges = [], [], [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, args = ev.get("cat", ""), ev.get("args") or {}
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append((ev["name"], ts, dur, args.get("correlation")))
        elif cat in LAUNCH_CATS:
            launches.append((ts, args.get("correlation")))
        elif cat in HOST_CATS:
            if cat == "user_annotation" and ev["name"].startswith("bench."):
                ranges.append((ev["name"], ts, dur))
            else:
                host.append((ev["name"], ts, dur, ev.get("tid")))
    device.sort(key=lambda e: e[1])
    return Trace(device, launches, host, ranges)


def from_profiler(prof) -> Trace:
    """Export ``prof``'s trace to a file under the temporary directory,
    parse it and delete the file."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            return parse(json.load(fh)["traceEvents"])
    finally:
        os.remove(path)


def window(trace: Trace, name: str = "bench.codec.decode"):
    """(start, end): the second to the last decode boundary traced (the
    profiler's start stalls the step after the first)."""
    starts = sorted(s for n, s, _ in trace.ranges if n == name)
    if len(starts) < 3:
        return None
    return starts[1], starts[-1]


def busy_intervals(trace: Trace, t0: float, t1: float) -> list:
    """The union of the device operations' intervals within [t0, t1]."""
    merged = []
    for _, s, d, _ in trace.device:
        a, b = max(s, t0), min(s + d, t1)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def busy_us(trace: Trace, t0: float, t1: float) -> float:
    return sum(b - a for a, b in busy_intervals(trace, t0, t1))


def launched_in(trace: Trace, name: str) -> tuple[float, int]:
    """Device microseconds of the operations launched inside the ranges
    called ``name``, and the number of those ranges."""
    spans = sorted((s, s + d) for n, s, d in trace.ranges if n == name)
    if not spans:
        return 0.0, 0
    corr, i = set(), 0
    for t, c in sorted(trace.launches, key=lambda e: e[0]):
        while i < len(spans) and spans[i][1] < t:
            i += 1
        if i == len(spans):
            break
        if spans[i][0] <= t <= spans[i][1] and c is not None:
            corr.add(c)
    dev = sum(d for _, _, d, c in trace.device if c in corr)
    return dev, len(spans)


def top_device_ops(trace: Trace, t0: float, t1: float, n: int = 10):
    totals: dict[str, float] = {}
    for name, s, d, _ in trace.device:
        if t0 <= s <= t1:
            totals[name] = totals.get(name, 0.0) + d * 1e-6
    return sorted(totals.items(), key=lambda kv: -kv[1])[:n]


def idle_gaps(trace: Trace, t0: float, t1: float, n: int = 10):
    """The device's idle time within [t0, t1], summed by the innermost
    host operation of the busiest host thread running at each gap's
    middle ("host: no operation" where none was), largest first."""
    busy = busy_intervals(trace, t0, t1)
    edges = [t0] + [x for ab in busy for x in ab] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    counts: dict = {}
    for e in trace.host:
        counts[e[3]] = counts.get(e[3], 0) + 1
    tid = max(counts, key=counts.get) if counts else None
    host = sorted((e for e in trace.host if e[3] == tid), key=lambda e: e[1])
    totals: dict[str, float] = {}
    stack, j = [], 0
    # operations on one thread nest, so after dropping those that ended
    # the stack holds the ones running at ``mid``, the innermost on top
    for a, b in gaps:
        mid = (a + b) / 2
        while j < len(host) and host[j][1] <= mid:
            while stack and stack[-1][1] + stack[-1][2] < host[j][1]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][1] + stack[-1][2] < mid:
            stack.pop()
        key = stack[-1][0] if stack else "host: no operation"
        totals[key] = totals.get(key, 0.0) + (b - a) * 1e-6
    return sorted(totals.items(), key=lambda kv: -kv[1])[:n]
