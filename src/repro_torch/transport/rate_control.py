"""Bandwidth-adaptive rate control for streamed split-layer tensors.

The self-describing bitstream header makes every tensor independently
decodable, so the edge is free to re-pick the quantizer *per request*.
:class:`RateController` chooses a :class:`Rung` of a calibrated codec
ladder (:class:`CodecBank`) so that

  * the *running average* bits/element tracks a target budget (a leaky
    bucket over coded bits: if the stream has been running hot the next
    tensor is coded coarser, and vice versa -- this is what keeps the
    long-run rate within a few percent of the budget even though the
    ladder is discrete), and
  * sustained link pressure (send queue building up, or measured
    throughput falling below what the current rate needs) steps the rung
    down ahead of the bucket, so a bandwidth drop degrades quantization
    instead of stalling the pipeline.

A rung is no longer just ``n_levels``: it spans ``(n_levels,
granularity, channel_group_size, spatial_block_size)``, so the ladder can
trade level count against tile granularity -- e.g. step from per-tensor
N=8 to per-channel N=4 (similar rate, lower MSE on channel-biased
features) before dropping to per-tensor N=4.  Plain ints in a ladder are
accepted and mean per-tensor rungs, so existing configs keep working.

Per-rung bits/element is learned online from the actual coded sizes
(EWMA per rung, log2-scaled estimates for unvisited rungs), so the
controller needs no a-priori rate model of the feature distribution.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..obs.metrics import BPE_BUCKETS, MetricsRegistry, default_registry


@dataclasses.dataclass(frozen=True, order=True)
class Rung:
    """One codec operating point on the rate-control ladder.

    ``granularity="base"`` (what a bare int normalizes to) means "inherit
    the CodecBank's base config" -- only ``n_levels`` is overridden, so
    int ladders keep their pre-Rung semantics whatever granularity the
    bank was built with.  ``spatial_block_hw=(bh, bw)`` makes a "tile"
    rung a 2-D (row x column) split of the conv feature map's spatial
    grid (v4 streams); ``(0, 0)`` keeps the 1-D flat-run split of
    ``spatial_block_size``.
    """

    n_levels: int
    granularity: str = "base"
    channel_group_size: int = 1
    spatial_block_size: int = 0
    spatial_block_hw: tuple[int, int] = (0, 0)

    def __str__(self) -> str:
        if self.granularity in ("base", "tensor"):
            return f"N{self.n_levels}"
        tag = f"N{self.n_levels}/{self.granularity}" \
              f"@g{self.channel_group_size}"
        if self.spatial_block_hw != (0, 0):
            tag += f"s{self.spatial_block_hw[0]}x{self.spatial_block_hw[1]}"
        elif self.spatial_block_size:
            tag += f"s{self.spatial_block_size}"
        return tag


def as_rung(r) -> Rung:
    """Normalize a ladder entry: ints are base-granularity rungs."""
    if isinstance(r, Rung):
        return r
    return Rung(n_levels=int(r))


def rung_of_codec(codec) -> Rung:
    """The rung a calibrated codec actually operates at (for attributing
    measured rates to the right ladder entry)."""
    cfg = codec.config
    bhw = getattr(cfg, "spatial_block_hw", None)
    return Rung(n_levels=cfg.n_levels, granularity=cfg.granularity,
                channel_group_size=max(1, cfg.channel_group_size),
                spatial_block_size=cfg.spatial_block_size,
                spatial_block_hw=(0, 0) if bhw is None
                else (int(bhw[0]), int(bhw[1])))


DEFAULT_LADDER = (2, 3, 4, 6, 8, 12, 16, 24, 32)


@dataclasses.dataclass
class RateControlConfig:
    target_bpe: float                     # budget, bits per element on the wire
    ladder: tuple = DEFAULT_LADDER        # ints and/or Rungs
    ewma: float = 0.4                     # per-rung bpe measurement smoothing
    window_elems: int = 1 << 22           # leaky-bucket horizon (elements)
    queue_high: int = 8                   # frames queued => link pressure
    throughput_ewma: float = 0.3


class RateController:
    def __init__(self, cfg: RateControlConfig) -> None:
        if cfg.target_bpe <= 0:
            raise ValueError("target_bpe must be positive")
        self.cfg = cfg
        self.ladder = tuple(sorted(set(as_rung(r) for r in cfg.ladder)))
        self._bpe = {}                    # Rung -> EWMA measured bits/elem
        self._seeded = set()              # rungs whose _bpe is an estimate
        self._bucket_bits = 0.0           # leaky bucket: coded bits
        self._bucket_elems = 0.0
        self._queue_depth = 0
        self._throughput = None           # EWMA bytes/s of the link
        self._last_rung: Rung | None = None
        self.history: list[dict] = []
        self._m = None                    # see bind_metrics

    def bind_metrics(self, registry: MetricsRegistry) -> None:
        """Register RD-telemetry instruments: the paper's central
        trade-off (measured bits/element vs. the budget), per-tensor rate
        distribution, rung occupancy, and the learned link state."""
        m = {
            "target": registry.gauge("repro_rate_target_bpe",
                                     "bits/element budget"),
            "measured": registry.gauge(
                "repro_rate_measured_bpe",
                "leaky-bucket running average of coded bits/element"),
            "tensor_bpe": registry.histogram(
                "repro_rate_tensor_rate_bpe",
                "coded bits/element per tensor", labelnames=("rung",),
                buckets=BPE_BUCKETS),
            "rung_picks": registry.counter(
                "repro_rate_rung_picks_total",
                "next_rung decisions per ladder rung",
                labelnames=("rung",)),
            "throughput": registry.gauge(
                "repro_rate_link_throughput_bytes",
                "EWMA link throughput (bytes per second)"),
            "queue": registry.gauge("repro_rate_queue_depth_count",
                                    "last observed send-queue depth"),
        }
        m["target"].set(self.cfg.target_bpe)
        self._m = m

    def _resolve(self, rung) -> Rung:
        """Accept a Rung or a bare n_levels int (legacy callers).

        Int resolution mirrors :meth:`CodecBank._resolve` exactly
        (base/tensor rung first, then ladder order): a legacy
        ``next_levels() -> bank.get(n) -> on_tensor(n)`` loop therefore
        attributes its measurement to the same rung whose codec the bank
        actually handed out, even on a mixed-granularity ladder.
        """
        if isinstance(rung, Rung):
            return rung
        matches = [r for r in self.ladder if r.n_levels == rung]
        if matches:
            plain = [r for r in matches
                     if r.granularity in ("base", "tensor")]
            return plain[0] if plain else matches[0]
        return Rung(n_levels=int(rung))

    # -- measurements ---------------------------------------------------------

    def on_tensor(self, rung, coded_bytes: int, n_elems: int,
                  send_seconds: float | None = None) -> None:
        """Record one coded tensor (and optionally its send time)."""
        if n_elems <= 0:
            return
        rung = self._resolve(rung)
        bpe = 8.0 * coded_bytes / n_elems
        # a seeded value is an estimate, not a measurement: the first
        # real coded size replaces it outright instead of blending
        prev = None if rung in self._seeded else self._bpe.get(rung)
        self._seeded.discard(rung)
        a = self.cfg.ewma
        self._bpe[rung] = bpe if prev is None else a * bpe + (1 - a) * prev
        self._bucket_bits += 8.0 * coded_bytes
        self._bucket_elems += n_elems
        # leak so that only ~window_elems of history steers the bucket
        if self._bucket_elems > self.cfg.window_elems:
            scale = self.cfg.window_elems / self._bucket_elems
            self._bucket_bits *= scale
            self._bucket_elems *= scale
        if send_seconds and send_seconds > 0:
            tput = coded_bytes / send_seconds
            t = self.cfg.throughput_ewma
            self._throughput = tput if self._throughput is None \
                else t * tput + (1 - t) * self._throughput
        self.history.append({"rung": str(rung), "n_levels": rung.n_levels,
                             "bpe": bpe, "cum_bpe": self.measured_bpe,
                             "queue_depth": self._queue_depth})
        if self._m is not None:
            self._m["measured"].set(self.measured_bpe)
            self._m["tensor_bpe"].observe(bpe, rung=str(rung))
            if self._throughput is not None:
                self._m["throughput"].set(self._throughput)

    def seed_estimate(self, rung, bpe: float) -> None:
        """Prime a rung's expected rate with an *estimate* (e.g. the
        in-graph tile-aware entropy estimate from one fused quantization
        pass over calibration features).  Only fills rungs with no
        measurement yet: real coded sizes always win, estimates just let
        the very first ladder walks order tiled rungs correctly instead
        of falling back to the log2(N) scaling."""
        rung = self._resolve(rung)
        if rung not in self._bpe and bpe > 0:
            self._bpe[rung] = float(bpe)
            self._seeded.add(rung)

    def on_queue_depth(self, depth: int) -> None:
        self._queue_depth = int(depth)
        if self._m is not None:
            self._m["queue"].set(self._queue_depth)

    def on_feedback(self, recv_bytes_per_s: float, queue_depth: int) -> None:
        """Cloud-side FEEDBACK frame: receiver-measured link throughput."""
        if recv_bytes_per_s > 0:
            t = self.cfg.throughput_ewma
            self._throughput = recv_bytes_per_s if self._throughput is None \
                else t * recv_bytes_per_s + (1 - t) * self._throughput
        self._queue_depth = max(self._queue_depth, int(queue_depth))

    # -- decisions ------------------------------------------------------------

    @property
    def measured_bpe(self) -> float:
        if self._bucket_elems <= 0:
            return 0.0
        return self._bucket_bits / self._bucket_elems

    @property
    def link_bytes_per_s(self) -> float | None:
        return self._throughput

    def estimate_bpe(self, rung) -> float:
        """Expected coded bits/element at a rung: measured EWMA when the
        rung has been used, else scaled from the nearest measured rung by
        the log2(N) ratio (exact for uniform indices, adequate to order
        the ladder), else the TU-coded upper bound log2(N)."""
        rung = self._resolve(rung)
        if rung in self._bpe:
            return self._bpe[rung]
        n_levels = rung.n_levels
        if self._bpe:
            ref = min(self._bpe,
                      key=lambda r: abs(math.log2(r.n_levels / n_levels)))
            return self._bpe[ref] * math.log2(n_levels) \
                / math.log2(ref.n_levels)
        return math.log2(n_levels)

    def next_rung(self) -> Rung:
        """Rung for the next tensor against the budget + link state.

        The ladder is walked in ascending *estimated-rate* order (not
        n_levels order: a per-channel rung often codes cheaper than a
        per-tensor rung one level count up), taking the most expensive
        rung still under the bucket's desired rate.
        """
        # leaky bucket: aim the next tensor at 2*target - running average,
        # so rate errors are actively paid back instead of persisting
        desired = 2 * self.cfg.target_bpe - self.measured_bpe \
            if self._bucket_elems > 0 else self.cfg.target_bpe
        desired = float(np.clip(desired, 0.25 * self.cfg.target_bpe,
                                2.0 * self.cfg.target_bpe))
        by_rate = sorted(self.ladder, key=self.estimate_bpe)
        choice = by_rate[0]
        for r in by_rate:
            if self.estimate_bpe(r) <= desired:
                choice = r
        if self._queue_depth >= self.cfg.queue_high \
                and self._last_rung is not None:
            # sustained backpressure: step below the last rung regardless
            last = self.estimate_bpe(self._last_rung)
            below = [r for r in by_rate if self.estimate_bpe(r) < last]
            if below:
                cheaper = min(choice, below[-1],
                              key=self.estimate_bpe)
                choice = cheaper
        self._last_rung = choice
        if self._m is not None:
            self._m["rung_picks"].inc(rung=str(choice))
        return choice

    def next_levels(self) -> int:
        """Legacy view of :meth:`next_rung` (the chosen level count)."""
        return self.next_rung().n_levels


class CodecBank:
    """Calibrated codecs at every ladder rung, sharing one sample set.

    Calibration is per-rung because the optimal clipping range depends on
    N and on the tile granularity (coarser quantizers clip tighter);
    codecs are built lazily and cached, so switching rungs mid-stream
    costs nothing after first use.  Tiled rungs need ``samples`` to carry
    the channel axis (pass the calibration activations un-flattened).
    """

    def __init__(self, base_config, samples: np.ndarray,
                 ladder: tuple = DEFAULT_LADDER) -> None:
        from ..core.codec import calibrate
        self._calibrate = calibrate
        self.base_config = base_config
        self.samples = np.asarray(samples, np.float32)
        self.ladder = tuple(sorted(set(as_rung(r) for r in ladder)))
        self._codecs = {}

    def _resolve(self, rung) -> Rung:
        if isinstance(rung, Rung):
            if rung not in self.ladder:
                raise KeyError(f"{rung} not in ladder {self.ladder}")
            return rung
        matches = [r for r in self.ladder if r.n_levels == rung]
        if not matches:
            raise KeyError(f"{rung} not in ladder {self.ladder}")
        # legacy int lookups prefer the base-config rung over explicitly
        # tiled rungs at the same level count
        plain = [r for r in matches if r.granularity in ("base", "tensor")]
        return plain[0] if plain else matches[0]

    def rung_for(self, codec) -> Rung | None:
        """The ladder rung whose cached codec *is* ``codec`` (identity),
        else None.  Lets a caller that was handed a bank codec attribute
        its rate measurements to the exact ladder key -- including
        'base'-granularity rungs, which :func:`rung_of_codec` cannot name
        (it only sees the codec's resolved config)."""
        for r, c in self._codecs.items():
            if c is codec:
                return r
        return None

    def get(self, rung):
        """Codec for a :class:`Rung` (or a bare n_levels int)."""
        rung = self._resolve(rung)
        if rung not in self._codecs:
            if rung.granularity == "base":
                cfg = dataclasses.replace(self.base_config,
                                          n_levels=rung.n_levels)
            else:
                cfg = dataclasses.replace(
                    self.base_config, n_levels=rung.n_levels,
                    granularity=rung.granularity,
                    channel_group_size=rung.channel_group_size,
                    spatial_block_size=rung.spatial_block_size,
                    spatial_block_hw=None
                    if rung.spatial_block_hw == (0, 0)
                    else rung.spatial_block_hw)
            self._codecs[rung] = self._calibrate(cfg, samples=self.samples)
        return self._codecs[rung]

    def prime_controller(self, controller: RateController,
                         x: np.ndarray | None = None) -> None:
        """Seed every ladder rung's expected bits/element from the
        in-graph entropy estimate of one quantization pass over ``x``
        (default: the calibration samples).

        Tiled rungs estimate per tile and sum (the tile histograms the
        fused encode pass emits), so a mixed-granularity ladder is
        rate-ordered correctly from the very first
        :meth:`RateController.next_rung` call -- no coded tensors, no
        host round trip, no log2(N) guessing.
        """
        feats = self.samples if x is None else np.asarray(x, np.float32)
        for rung in self.ladder:
            codec = self.get(rung)
            controller.seed_estimate(rung, float(codec.estimate_rate(
                codec._device_tensor(feats))))


# -- worker-level bank sharing ------------------------------------------------

_BANKS: dict[tuple, CodecBank] = {}
# worker-level instruments: bank reuse is per-process, so these live in
# the process-wide default registry (scraped alongside every server)
_BANK_HITS = default_registry().counter(
    "repro_bank_cache_hits_total", "shared_bank cache hits")
_BANK_MISSES = default_registry().counter(
    "repro_bank_cache_misses_total",
    "shared_bank cache misses (fresh calibration)")
_BANK_ENTRIES = default_registry().gauge(
    "repro_bank_cache_entries_count", "distinct cached codec banks")


def _bank_key(base_config, samples: np.ndarray, ladder: tuple) -> tuple:
    import hashlib
    return (dataclasses.astuple(base_config), samples.shape,
            hashlib.sha1(np.ascontiguousarray(samples).tobytes()).hexdigest(),
            tuple(sorted(set(as_rung(r) for r in ladder))))


def shared_bank(base_config, samples: np.ndarray,
                ladder: tuple = DEFAULT_LADDER) -> CodecBank:
    """Worker-level :class:`CodecBank` cache.

    Rung calibration tables are immutable, so every session of one
    worker with the same (config, calibration samples, ladder) can share
    one bank -- calibration runs once per worker instead of once per
    session.  Keyed by config fields + samples content hash, so a
    *different* calibration set still gets its own bank.  Hit/miss
    counts via :func:`bank_cache_stats`.
    """
    samples = np.asarray(samples, np.float32)
    key = _bank_key(base_config, samples, ladder)
    bank = _BANKS.get(key)
    if bank is not None:
        _BANK_HITS.inc()
        return bank
    _BANK_MISSES.inc()
    bank = _BANKS[key] = CodecBank(base_config, samples, ladder)
    _BANK_ENTRIES.set(len(_BANKS))
    return bank


def bank_cache_stats() -> dict:
    """Legacy dict view of the ``repro_bank_cache_*`` instruments."""
    return {"hits": int(_BANK_HITS.value()),
            "misses": int(_BANK_MISSES.value()),
            "entries": len(_BANKS)}


def clear_bank_cache() -> None:
    """Tests only: drop cached banks and zero the counters."""
    _BANKS.clear()
    _BANK_HITS.clear()
    _BANK_MISSES.clear()
    _BANK_ENTRIES.set(0)
