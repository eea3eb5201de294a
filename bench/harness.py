"""Run one cell once: set-up, the measured window, the check.

The entry is the port's serving engine, ``ServeEngine.generate``, with
the cell's codec installed through the engine's ``codec_fn`` hookup (a
wrapper of ``FeatureCodec.apply_with_rate``, what ``codec=`` installs on
one rank).  The wrapper sees every boundary: a decode boundary holds one
position a row.  The window opens at the first decode boundary, after
the opening full-batch prefill, and closes at the first decode boundary
``seconds`` later, where the wrapper raises :class:`WindowClosed`.

The requests are :class:`Tracked`: each tells the recorder when the
engine admits it, and the next prefill boundary gives its padded length,
so the check can rebuild what each row computed.
"""

from __future__ import annotations

import contextlib
import gc
import statistics
import sys
import time

import numpy as np
import torch

from . import check as CHK
from . import roofline as RL
from . import trace as TR
from . import traffic
from . import weights as W
from .spec import Cell, metric_reader, model_config

# the modules whose presence after the window refuses a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACE_SECONDS = 2.0     # the traced run profiles the window's last seconds
KEEP_DECODE = 16        # boundary calls the quantizer check keeps
KEEP_PREFILL = 4


class WindowClosed(Exception):
    """Raised by the recorder at the boundary that closes the window."""


def _tracked_class():
    from repro_torch.serving import Request

    class Tracked(Request):
        """A request that tells its recorder when the engine admits it."""

        def __setattr__(self, name, value):
            super().__setattr__(name, value)
            if name == "t_admit" and value is not None:
                self.recorder.admit(self)
    return Tracked


class Recorder:
    """The ``codec_fn`` of the measured engine: times each boundary,
    opens and closes the window, keeps a sample of boundary calls for
    the quantizer check and drives the profiler in a traced run."""

    def __init__(self, codec, seconds: float, rng: np.random.Generator,
                 trace: bool):
        self.codec, self.seconds, self.rng = codec, seconds, rng
        self.trace = trace
        self.pending: list = []
        self.admitted: list = []
        self.boundaries: list[float] = []
        self.t_open = self.t_end = self.t_close = None
        self.wall_open = self.wall_end = None
        self.traced: list[float] = []
        self.decode_values = 0
        self.kept = {True: [], False: []}
        self.seen = {True: 0, False: 0}
        self.prof = None

    def admit(self, r) -> None:
        self.pending.append(r)

    def __call__(self, x):
        t = time.perf_counter()
        decode = x.shape[1] == 1
        if not decode:
            for r in self.pending:
                r.padded_len = int(x.shape[1])
            self.admitted.extend(self.pending)
            self.pending.clear()
        elif self.t_open is None:
            self._open(t, x)
        elif t - self.t_open >= self.seconds and self._traced_enough(t):
            self._close(t)
            raise WindowClosed
        if decode:
            self.boundaries.append(t)
            if self.prof is not None:
                self.traced.append(t)
            elif self.trace and t - self.t_open >= self.seconds \
                    - TRACE_SECONDS:
                self._start_trace(t)
        with self._range(decode):
            y, rate = self.codec.apply_with_rate(x)
        if self.t_open is not None:
            self._keep(decode, x, y)
        return y, rate

    def _traced_enough(self, t: float) -> bool:
        """A traced run profiles ``TRACE_SECONDS`` from its second traced
        boundary: the profiler's start stalls the first."""
        return not self.trace or (len(self.traced) >= 2
                                  and t - self.traced[1] >= TRACE_SECONDS)

    def _start_trace(self, t: float) -> None:
        """End the host-clock part of a traced run and start the
        profiler: the per-layer metrics read off the host clock and the
        spans cover the window up to here."""
        self._mark_end(t)
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self.traced.append(t)

    def _range(self, decode: bool):
        if self.prof is None:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function("bench.codec.decode" if decode
                               else "bench.codec.prefill")

    def _keep(self, decode: bool, x, y) -> None:
        """Reservoir sample of the window's boundary calls."""
        cap = KEEP_DECODE if decode else KEEP_PREFILL
        self.seen[decode] += 1
        kept = self.kept[decode]
        if len(kept) < cap:
            kept.append((x, y))
        else:
            j = int(self.rng.integers(self.seen[decode]))
            if j < cap:
                kept[j] = (x, y)

    def _open(self, t: float, x) -> None:
        self.t_open, self.wall_open = t, time.time()
        self.decode_values = int(x.numel())
        for r in self.admitted:
            r.n_open = len(r.out_tokens)

    def _mark_end(self, t: float) -> None:
        """The end of what the host-clock metrics read."""
        self.t_end, self.wall_end = t, time.time()
        for r in self.admitted:
            r.n_end = len(r.out_tokens)

    def _close(self, t: float) -> None:
        self.t_close = t
        if self.prof is None:
            self._mark_end(t)
        else:
            torch.cuda.synchronize()
            self.prof.stop()

    # -- what the window served ---------------------------------------------

    @property
    def window_s(self) -> float:
        """Seconds the host-clock metrics cover: the whole window, or
        in a traced run its part before the profiler."""
        return self.t_end - self.t_open

    def tokens(self) -> int:
        return sum(r.n_end - r.n_open for r in self.admitted
                   if r.n_end is not None)

    def gaps_ms(self) -> list[float]:
        ts = [t for t in self.boundaries if t < self.t_end] + [self.t_end]
        return [(b - a) * 1e3 for a, b in zip(ts, ts[1:])]

    def flops(self, model: dict) -> int:
        """Useful operations of the window: the prefills of the requests
        admitted in it (their prompts, not the padding) and every token
        decoded in it, over each request's real context."""
        tokens = ctx = 0
        for r in self.admitted:
            if r.n_end is None:
                continue
            plen, first = len(r.prompt), r.n_open
            if r.t_admit >= self.t_open:
                tokens += plen
                ctx += RL.prefill_context_sum(plen)
                first = 1
            for j in range(max(first, 1), r.n_end):
                tokens += 1
                ctx += plen + j
        return RL.forward_flops(model, tokens, ctx)


class Clock:
    """Seconds of each phase of a run, on the host clock."""

    def __init__(self, t_start: float):
        self.last, self.laps = t_start, {}

    def lap(self, name: str, dev) -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        self.laps[name] = now - self.last
        self.last = now


def percentile(values: list[float], q: int) -> float:
    """The ``q``-th percentile (inclusive method) of ``values``."""
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


class Context:
    """What the per-layer metric readers read (``bench/metrics``)."""

    def __init__(self, rec: Recorder, model: dict, spans: list,
                 trace: TR.Trace | None):
        self.rec, self.model, self.spans, self.trace = rec, model, spans, trace
        self.window_s = rec.window_s
        self.trace_window = TR.window(trace) if trace is not None else None


def _requests(specs: list, rec: Recorder) -> list:
    tracked = _tracked_class()
    out = []
    for prompt, m in specs:
        r = tracked(prompt, max_new_tokens=m)
        r.recorder, r.padded_len, r.n_open, r.n_end = rec, None, 0, None
        out.append(r)
    return out


def _calibrate(cfg, params, mix: dict, seed: int, device, backend):
    """The port's codec, calibrated on its own boundary activations of
    the seed's calibration batch, and those samples."""
    from repro_torch.core import CodecConfig, calibrate
    from repro_torch.models import forward_head
    c = mix["codec"]
    tokens = traffic.calibration_tokens(mix, cfg.vocab_size, seed)
    with torch.inference_mode():
        x = forward_head(cfg, params, torch.as_tensor(tokens, device=device))
    samples = x.to(torch.float32).cpu().numpy().reshape(-1)
    return calibrate(CodecConfig(
        n_levels=c["n_levels"], clip_mode=c["clip_mode"],
        constrain_cmin_zero=c["constrain_cmin_zero"],
        kappa=c["kappa"], leaky_slope=c["leaky_slope"],
        granularity="tensor", backend=backend), samples=samples), samples


def _engine(cfg, params, mix: dict, codec_fn, device):
    from repro_torch.serving import ServeEngine
    return ServeEngine(cfg, params, slots=mix["slots"],
                       max_seq=mix["max_seq"], codec_fn=codec_fn,
                       refill_align=mix["refill_align"], device=device)


def _warm_up(cfg, params, mix: dict, codec, device) -> None:
    """One short run at the cell's shapes: a full-batch prefill, decode
    steps of every slot, and a batch-1 refill."""
    from repro_torch.serving import Request
    plen = mix["prompt_len"]["min"]
    reqs = [Request(np.ones(plen, np.int32), max_new_tokens=2)
            for _ in range(mix["slots"] + 1)]
    _engine(cfg, params, mix, codec.apply_with_rate, device).generate(reqs)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device, t_start: float, control: bool = False) -> dict:
    """One run of ``cell``.  Returns the result's fields (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device`` and, traced,
    ``breakdown``), ``checks`` (each compared number with its limit),
    and the ``readings`` they came from; ``control`` adds the control's
    (``check.readings``)."""
    from repro_torch.obs.tracing import configure_tracing, tracer
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    model, mix = cell.config["model"], cell.mix
    if CHK.drops(model):
        raise NotImplementedError(
            "an expert layer that drops assignments couples the rows of a "
            "batch; the check compares requests one by one")
    cfg = model_config(cell.config)
    clock = Clock(t_start)
    params = W.params(model, seed, dev)
    clock.lap("weights", dev)
    specs = traffic.requests(mix, cfg.vocab_size, seed)
    clock.lap("traffic", dev)
    codec, samples = _calibrate(cfg, params, mix, seed, dev,
                                "cuda" if on_card else "torch")
    clock.lap("calibrate", dev)
    _warm_up(cfg, params, mix, codec, dev)
    clock.lap("warm_up", dev)

    rec = Recorder(codec, seconds, np.random.Generator(
        np.random.PCG64([seed, 2])), trace and on_card)
    engine = _engine(cfg, params, mix, rec, dev)
    requests = _requests(specs, rec)
    if trace:
        tracer().reset()
        configure_tracing(enabled=True,
                          sync=torch.cuda.synchronize if on_card else None)
    try:
        engine.generate(requests)
    except WindowClosed:
        pass
    else:
        raise RuntimeError("the queue ran dry before the window closed: "
                           "the mix needs more requests")
    finally:
        if trace:
            configure_tracing(enabled=False, sync=None)
    if on_card:
        torch.cuda.synchronize()
    setup_s = rec.t_open - t_start
    clock.laps["opening_prefill"] = rec.t_open - clock.last
    clock.laps["window"] = time.perf_counter() - rec.t_open
    clock.last = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules of JAX or the JAX package loaded: "
                           f"{found}")
    out = {"attempted": len(rec.admitted), "failed": 0,
           "device": _device(dev, peak, cell.chips)}
    if trace:
        spans = [e for e in tracer().snapshot_events()
                 if rec.wall_open <= e["t_start"] <= rec.wall_end]
        tr = TR.from_profiler(rec.prof) if rec.prof is not None else None
        clock.lap("trace_export", dev)
        ctx = Context(rec, model, spans, tr)
        out["metrics"] = _read(cell.per_layer, ctx)
        if ctx.trace_window is not None:
            t0, t1 = ctx.trace_window
            out["device"]["busy_s"] = TR.busy_us(tr, t0, t1) * 1e-6
            out["device"]["window_s"] = (t1 - t0) * 1e-6
            out["breakdown"] = {
                "device_ops": [list(x) for x in
                               TR.top_device_ops(tr, t0, t1)],
                "idle_gaps": [list(x) for x in TR.idle_gaps(tr, t0, t1)]}
        del ctx, tr
    else:
        gaps = rec.gaps_ms()
        values = {"tokens_per_s": rec.tokens() / rec.window_s,
                  "itl_p95_ms": percentile(gaps, 95),
                  "setup_s": setup_s}
        out["metrics"] = {m["name"]: {"value": values[m["name"]],
                                      "unit": m["unit"]}
                          for m in cell.end_to_end}
    out["window"] = {"seconds": rec.window_s, "tokens": rec.tokens(),
                     "decode_steps": len(rec.boundaries),
                     "requests_done": sum(r.done for r in rec.admitted),
                     "reserved_peak": (torch.cuda.max_memory_reserved(dev)
                                       if on_card else 0)}

    kept = rec.kept[True] + rec.kept[False]
    served = CHK.served(rec.admitted)
    qrange = (float(codec.cmin), float(codec.cmax))
    quant = CHK.quantizer_mismatches(kept, *qrange, mix["codec"]["n_levels"])
    # the requests and the recorder hold each other
    rec.admitted.clear()
    del engine, params, codec, rec, kept, requests
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        out["window"]["left_on_card"] = torch.cuda.memory_allocated(dev)
    readings = CHK.readings(cell, seed, dev, served, qrange, quant, samples,
                            control)
    out["checks"] = CHK.judge(readings, cell.limits)
    out["correct"] = all(c["value"] <= c["limit"]
                         for c in out["checks"].values())
    out["readings"] = readings
    clock.lap("check", dev)
    out["timings"] = clock.laps
    return out


def _read(metrics: list, ctx: Context) -> dict:
    out = {}
    for m in metrics:
        value = metric_reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def _device(dev, peak: int, chips: int) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": chips, "memory_peak_bytes": int(peak)}
