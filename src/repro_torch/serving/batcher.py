"""Cross-session batching: one megakernel launch + one entropy call per
serving tick.

A cloud worker serving many concurrent edge sessions pays per-request
dispatch on today's per-session path: every boundary tensor is its own
``backend.encode_fused`` launch and its own entropy-coder call.  The
batched primitives underneath (``rans.encode_planes_batch``,
``cabac.encode_indices_batch``/``decode_indices_batch``, the fused
encode megakernel) all amortize per-call overhead across inputs -- this
module is the session-crossing layer that feeds them whole *ticks*
instead of single tensors:

    gather   -- concurrent sessions' tensors queue up for one tick
                (bounded by ``TickConfig.max_wait_s`` / ``max_batch``,
                so single-session latency degrades gracefully);
    group    -- tensors are keyed by (codec, shape): every group shares
                one TilePlan geometry, so the stacked launch has one
                layout and tile tables extend by pure replication;
    launch   -- each group stacks into one ``encode_fused`` call
                (``<= ceil(sessions / max_batch)`` launches per tick),
                and ALL groups' chunk segments share ONE batched entropy
                call (per-segment n_levels: mixed rungs coexist);
    scatter  -- per-session payload lists come back byte-identical to
                ``FeatureCodec.encode_stream`` (the v1-v4 conformance
                gate), so nothing on the wire changes.

The decode mirror (:class:`DecodeBatcher` + ``codec.flush_decoders``)
accumulates arrived chunks across sessions in deferred-mode
:class:`~repro_torch.core.codec.ChunkStreamDecoder` instances and drains
them through one batched entropy pass per tick.

**Why byte-identity holds for stacked launches.**  Quantization is
elementwise with per-tile ranges, so stacking K same-shape tensors on a
new leading axis quantizes bit-exactly iff every element lands in a
stacked tile carrying its original tile's tables.  Build the stack from
channel-last views ``moveaxis(x, axis, -1)`` -- the coded-order spatial
enumeration of each tensor is preserved -- and extend the plan along the
spatial extent:

  * per-tensor (no plan): flat concatenation; any shapes mix;
  * "channel" (one spatial block): stacked (K, M, C) under an
    extent-free plan -- tiles are channel groups, tables unchanged;
  * 1-D tile: stackable iff ``M % block_size == 0`` (stacked blocks then
    never straddle tensors); tables tile K-fold along the block axis;
  * 2-D tile: stackable iff ``H % bh == 0`` (stacked row-blocks never
    straddle tensors) under a ``(K*H, W)`` grid; tables tile K-fold.

In every stacked case tensor k's spatial positions get block ids
``k * n_sblocks + s`` with ``s`` its per-tensor id, so the stable
coded-order sort keeps tensor k's elements contiguous and in per-tensor
order: the coded stack reshapes to (C, K, M) and session k's coded
indices are exactly ``[:, k, :]``.  Non-stackable groups (ragged tile
blocks) fall back to per-session launches but still join the tick's
single entropy call.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import struct
import time

import numpy as np

from ..core import cabac
from ..core.backend import QuantSpec
from ..core.codec import _STREAM_META_FMT, FeatureCodec, flush_decoders
from ..core.tiling import TileECSQ, TilePlan
from ..obs.metrics import MetricsRegistry
from ..obs.tracing import span

# transport's DEFAULT_CHUNK_ELEMS without importing transport (serving
# must not depend on the wire layer); the value is asserted equal in
# tests/test_batcher.py
DEFAULT_CHUNK_ELEMS = 1 << 18


@contextlib.contextmanager
def device_entropy():
    """The ``REPRO_ENTROPY_DEVICE`` opt-in for the duration of the block:
    a tick whose ``TickConfig.device_entropy`` is None entropy-codes on
    the device (coder id 4)."""
    prev = os.environ.get("REPRO_ENTROPY_DEVICE")
    os.environ["REPRO_ENTROPY_DEVICE"] = "1"
    try:
        yield
    finally:
        if prev is None:
            del os.environ["REPRO_ENTROPY_DEVICE"]
        else:
            os.environ["REPRO_ENTROPY_DEVICE"] = prev


@dataclasses.dataclass(frozen=True)
class TickConfig:
    """Bounds of one batching tick.

    ``max_wait_s`` caps how long the first tensor of a tick waits for
    company (the single-session latency floor); ``max_batch`` caps how
    many sessions stack into one fused launch (device-memory bound);
    ``max_chunks`` is the decode-side drain trigger (a tick drains early
    once this many chunks pend across sessions).
    """

    max_wait_s: float = 0.002
    max_batch: int = 16
    max_chunks: int = 512
    chunk_elems: int = DEFAULT_CHUNK_ELEMS
    coder_mode: str = "auto"
    # device-resident entropy (coder id 4): None defers to the
    # REPRO_ENTROPY_DEVICE env opt-in (only with coder_mode "auto")
    device_entropy: bool | None = None

    def __post_init__(self):
        if self.max_wait_s < 0:
            raise ValueError("max_wait_s must be >= 0")
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.max_chunks < 1:
            raise ValueError("max_chunks must be >= 1")


@dataclasses.dataclass
class TickStats:
    """What one encode tick actually dispatched (observability + the
    launch-count acceptance gate)."""

    sessions: int = 0
    groups: int = 0
    fused_launches: int = 0
    entropy_calls: int = 0
    stacked_sessions: int = 0      # sessions that shared a stacked launch
    elems: int = 0
    coded_bytes: int = 0
    encode_s: float = 0.0


# -- stacked-launch construction ---------------------------------------------


def _tile_table_k(table: np.ndarray, k: int) -> np.ndarray:
    """(G, S) per-tile table -> (G, k*S): stacked block ``k*S + s``
    carries the tables of per-tensor block ``s``."""
    g = table.shape[0]
    return np.tile(table[:, None, :], (1, k, 1)).reshape(g, -1)


def _tile_ecsq_k(rows: np.ndarray, plan: TilePlan, k: int) -> np.ndarray:
    """(n_tiles, N) per-tile ECSQ rows -> stacked flat tile order
    (stacked tile ``g * k*S + (k'*S + s)`` = per-tensor tile
    ``g * S + s``)."""
    g, s = plan.n_cgroups, plan.n_sblocks
    a = np.asarray(rows).reshape(g, s, -1)
    return np.tile(a[:, None], (1, k, 1, 1)).reshape(g * k * s, -1)


def stack_group(codec: FeatureCodec, xs: list[np.ndarray]):
    """Build the one-launch view of ``len(xs)`` same-shape tensors.

    Returns ``(stacked_input, stacked_spec)`` quantizing bit-exactly like
    per-tensor passes (see module docstring), or ``None`` when the plan
    geometry cannot stack (ragged tile blocks) -- the caller then falls
    back to per-session launches.
    """
    plan = codec.plan
    k = len(xs)
    if plan is None:
        flat = np.concatenate([np.asarray(x).reshape(-1) for x in xs])
        return flat, codec.spec()
    shape = xs[0].shape
    axis, c, m = plan.resolve(shape)
    views = [np.moveaxis(np.asarray(x), axis, -1) for x in xs]
    if plan.is_2d:
        h, w = plan.spatial_hw
        bh, _ = plan.spatial_block_hw
        if h % bh:
            return None
        stacked = np.stack([v.reshape(h, w, c) for v in views])
        splan = TilePlan(channel_axis=-1,
                         channel_group_size=plan.channel_group_size,
                         spatial_block_size=0, n_channels=c,
                         spatial_extent=k * m, spatial_hw=(k * h, w),
                         spatial_block_hw=plan.spatial_block_hw)
        reps = k
    elif plan.spatial_block_size > 0:
        if m % plan.spatial_block_size:
            return None
        stacked = np.stack([v.reshape(m, c) for v in views])
        splan = TilePlan(channel_axis=-1,
                         channel_group_size=plan.channel_group_size,
                         spatial_block_size=plan.spatial_block_size,
                         n_channels=c, spatial_extent=k * m)
        reps = k
    else:   # "channel": one extent-free spatial block, tiles = ch groups
        stacked = np.stack([v.reshape(m, c) for v in views])
        splan = TilePlan(channel_axis=-1,
                         channel_group_size=plan.channel_group_size,
                         spatial_block_size=0, n_channels=c)
        reps = 1
    lo, hi = codec.tile_tables()
    if reps > 1:
        lo, hi = _tile_table_k(lo, reps), _tile_table_k(hi, reps)
    ecsq = codec.tile_ecsq
    if ecsq is not None and reps > 1:
        ecsq = TileECSQ(_tile_ecsq_k(ecsq.levels, plan, reps),
                        _tile_ecsq_k(ecsq.thresholds, plan, reps))
    return stacked, QuantSpec(lo, hi, codec.config.n_levels, -1, ecsq,
                              splan)


def split_coded(codec: FeatureCodec, coded: np.ndarray,
                xs: list[np.ndarray]) -> list[np.ndarray]:
    """Per-session coded-order indices out of a stacked launch's output
    (each slice byte-feeds the entropy stage identically to a per-tensor
    ``codec._fused_indices`` run)."""
    plan = codec.plan
    if plan is None:
        bounds = np.cumsum([0] + [int(np.asarray(x).size) for x in xs])
        return [coded[bounds[i]:bounds[i + 1]] for i in range(len(xs))]
    _, c, m = plan.resolve(xs[0].shape)
    rows = np.asarray(coded).reshape(c, len(xs), m)
    return [np.ascontiguousarray(rows[:, i, :]).reshape(-1)
            for i in range(len(xs))]


def split_coded_device(codec: FeatureCodec, coded,
                       xs: list[np.ndarray]) -> list:
    """:func:`split_coded` staying on the device: slices of a stacked
    launch's coded-order tensor, never moved to the host (the
    device-entropy tick path)."""
    plan = codec.plan
    if plan is None:
        bounds = np.cumsum([0] + [int(np.asarray(x).size) for x in xs])
        return [coded[int(bounds[i]):int(bounds[i + 1])]
                for i in range(len(xs))]
    _, c, m = plan.resolve(xs[0].shape)
    rows = coded.reshape(c, len(xs), m)
    return [rows[:, i, :].reshape(-1) for i in range(len(xs))]


# -- encode tick -------------------------------------------------------------


def encode_tick(items, cfg: TickConfig = TickConfig()
                ) -> tuple[list[list[bytes]], TickStats]:
    """Encode one tick of ``(codec, tensor)`` pairs.

    Returns one payload list per item, each byte-identical to
    ``list(codec.encode_stream(x, chunk_elems=cfg.chunk_elems,
    coder_mode=cfg.coder_mode))``, plus the tick's dispatch stats.
    Same-(codec, shape) items share stacked ``encode_fused`` launches of
    up to ``cfg.max_batch`` sessions; every chunk of every item is
    entropy-coded in ONE :func:`cabac.encode_indices_batch` call.
    """
    t0 = time.perf_counter()
    stats = TickStats(sessions=len(items))
    items = [(codec, np.asarray(x, np.float32)) for codec, x in items]
    coded: list = [None] * len(items)
    dev = cfg.device_entropy if cfg.device_entropy is not None else (
        cfg.coder_mode == "auto"
        and os.environ.get("REPRO_ENTROPY_DEVICE") == "1")

    groups: dict[tuple, list[int]] = {}
    for i, (codec, x) in enumerate(items):
        # per-tensor codecs concatenate flat, so any shapes mix; plans
        # are positional and need one geometry per group
        key = (id(codec),) if codec.plan is None else (id(codec), x.shape)
        groups.setdefault(key, []).append(i)
    stats.groups = len(groups)

    for members in groups.values():
        codec = items[members[0]][0]
        for b0 in range(0, len(members), cfg.max_batch):
            batch = members[b0:b0 + cfg.max_batch]
            xs = [items[i][1] for i in batch]
            with span("stack_scatter", sessions=len(batch)):
                stacked = stack_group(codec, xs) if len(batch) > 1 else None
            if stacked is None:
                for i in batch:
                    if dev:
                        coded[i] = codec.backend.coded_indices_device(
                            codec._device_tensor(items[i][1]), codec.spec(),
                            codec.bits_per_index())
                    else:
                        coded[i] = codec._fused_indices(items[i][1])[0]
                    stats.fused_launches += 1
                continue
            x_s, spec_s = stacked
            if dev:
                out = codec.backend.coded_indices_device(
                    codec._device_tensor(x_s), spec_s,
                    codec.bits_per_index())
            else:
                out = codec.backend.encode_fused(codec._device_tensor(x_s),
                                                 spec_s,
                                                 codec.bits_per_index())[0]
            stats.fused_launches += 1
            stats.stacked_sessions += len(batch)
            with span("stack_scatter", sessions=len(batch)):
                split = split_coded_device if dev else split_coded
                for i, part in zip(batch, split(codec, out, xs)):
                    coded[i] = part

    # every chunk segment of the tick through one batched entropy call;
    # payloads are per-segment independent, so this is byte-identical to
    # encode_stream's per-stream batches.  The device-entropy path keeps
    # the same shape as one dispatch-all + finalize-all pass: every
    # session's chunk stages launch before any payload's (bytes-only)
    # D2H drains, so each transfer overlaps the next chunk's step loops.
    segments: list[np.ndarray] = []
    seg_levels: list[int] = []
    seg_owner: list[int] = []
    headers: list[bytes] = []
    chunking: list[tuple[int, int]] = []      # (chunk_elems, n_chunks)
    bounds_per: list[list[tuple[int, int]]] = []
    with span("framing", sessions=len(items)):
        for i, (codec, x) in enumerate(items):
            chunk_elems = cfg.chunk_elems
            if codec.plan is not None:
                chunk_elems = codec.plan.align_chunk_elems(chunk_elems,
                                                           x.shape)
            n = int(x.size)
            n_chunks = max(1, -(-n // chunk_elems))
            header, _ = codec._header(x)
            meta = struct.pack(_STREAM_META_FMT, chunk_elems, n_chunks,
                               x.ndim)
            meta += np.asarray(x.shape, "<u4").tobytes()
            headers.append(meta + header)
            chunking.append((chunk_elems, n_chunks))
            if dev:
                bounds_per.append(
                    [(c * chunk_elems, min((c + 1) * chunk_elems, n))
                     for c in range(n_chunks)])
            else:
                idx = coded[i]
                for c in range(n_chunks):
                    segments.append(
                        idx[c * chunk_elems:(c + 1) * chunk_elems])
                    seg_levels.append(codec.config.n_levels)
                    seg_owner.append(i)
            stats.elems += n
    if dev:
        from ..kernels import rans_coder
        with span("entropy_encode",
                  chunks=sum(len(b) for b in bounds_per)):
            # the coded tensor's device picks the route: the step-loop
            # kernel on the card, its plain version on the CPU
            pend = [rans_coder.dispatch_index_chunks(
                coded[i], codec.config.n_levels, bounds_per[i])
                for i, (codec, _) in enumerate(items)]
            blobs = [b for p in pend
                     for b in rans_coder.finalize_index_chunks(p)]
        seg_owner = [i for i, bl in enumerate(bounds_per) for _ in bl]
    else:
        with span("entropy_encode", chunks=len(segments)):
            blobs = cabac.encode_indices_batch(segments, seg_levels,
                                               mode=cfg.coder_mode)
    stats.entropy_calls = 1

    with span("framing", sessions=len(items)):
        payloads: list[list[bytes]] = [[h] for h in headers]
        next_cid = [0] * len(items)
        for owner, blob in zip(seg_owner, blobs):
            cid = next_cid[owner]
            next_cid[owner] += 1
            payloads[owner].append(struct.pack("<I", cid) + blob)
        stats.coded_bytes = sum(len(p) for pl in payloads for p in pl)
    stats.encode_s = time.perf_counter() - t0
    return payloads, stats


# -- decode tick -------------------------------------------------------------


class DecodeBatcher:
    """Cross-session decode coordinator (transport-agnostic).

    Deferred-mode :class:`ChunkStreamDecoder` instances register here as
    chunks arrive; :meth:`drain` runs ONE batched entropy pass over every
    pending chunk of every session (``codec.flush_decoders``) and
    reports per-decoder failures so one corrupt session never poisons a
    tick.  The event-loop scheduling around it (max-wait timers,
    max-chunk triggers) lives with the transport; this class only owns
    the registry and the counters.
    """

    def __init__(self, metrics: MetricsRegistry | None = None) -> None:
        self._decoders: dict[int, object] = {}
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        m = self.metrics
        self._m_ticks = m.counter(
            "repro_decode_ticks_total", "batched decode drains")
        self._m_calls = m.counter(
            "repro_decode_entropy_calls_total",
            "batched entropy-decode calls (one per non-empty drain)")
        self._m_chunks = m.counter(
            "repro_decode_chunks_total", "entropy-decoded chunks")
        self._m_sessions = m.counter(
            "repro_decode_sessions_total", "sessions drained")
        self._m_elems = m.counter(
            "repro_decode_elements_total", "elements entropy-decoded")
        self._m_entropy_s = m.counter(
            "repro_decode_entropy_seconds_total",
            "wall time inside batched entropy decode")

    @property
    def counters(self) -> dict:
        """Legacy dict view of the registry instruments."""
        return {"ticks": int(self._m_ticks.value()),
                "entropy_calls": int(self._m_calls.value()),
                "chunks": int(self._m_chunks.value()),
                "sessions": int(self._m_sessions.value()),
                "elems": int(self._m_elems.value()),
                "entropy_s": self._m_entropy_s.value()}

    def note(self, decoder) -> None:
        """Register a decoder that has pending (undrained) chunks."""
        if decoder.pending_chunks:
            self._decoders[id(decoder)] = decoder

    def discard(self, decoder) -> None:
        """Forget a decoder (session disconnected mid-tick); the others
        are untouched."""
        self._decoders.pop(id(decoder), None)

    @property
    def pending_chunks(self) -> int:
        return sum(d.pending_chunks for d in self._decoders.values())

    @property
    def pending_sessions(self) -> int:
        return len(self._decoders)

    def drain(self) -> list:
        """One batched entropy pass over all registered decoders.
        Returns ``(decoder, exception)`` pairs for failed sessions."""
        decs = [d for d in self._decoders.values() if d.pending_chunks]
        self._decoders.clear()
        if not decs:
            return []
        t0 = time.perf_counter()
        n_chunks, n_elems, failures = flush_decoders(decs)
        self._m_ticks.inc()
        self._m_calls.inc()
        self._m_chunks.inc(n_chunks)
        self._m_sessions.inc(len(decs))
        self._m_elems.inc(n_elems)
        self._m_entropy_s.inc(time.perf_counter() - t0)
        return failures
