"""FeatureCodec: the paper's lightweight compression pipeline as a
first-class framework feature.

    clip -> coarse scalar quantize (uniform eq.1 or modified ECSQ Alg.1)
         -> truncated-unary binarization -> entropy coding

Deployment modes:
  * in-graph fake-quant (quantize+dequantize) at a split layer, with an
    on-device entropy rate estimate -- used inside the serving steps;
  * host bitstream encode/decode (exact entropy-coder round trip) -- used
    by the split-inference example and codec benchmarks;
  * packed integer transport -- indices packed to uint8 (2x4bit / 8x1bit)
    for real inter-pod bandwidth reduction in the split runtime.

All quantization primitives route through a
:mod:`repro_torch.core.backend` ``QuantBackend``: the hand-written CUDA
kernels on the card, the plain torch reference on the CPU -- one code
path for in-graph, host, and kernel execution.  Bitstream methods take
and return numpy arrays; in-graph methods take tensors.

Granularity is a :class:`~repro_torch.core.tiling.TilePlan` (companion-paper
channel mosaic, arXiv 2105.06002, plus the spatial structure of
arXiv 1804.09963): per-tensor mode uses one (c_min, c_max); "channel" and
"tile" granularities calibrate a range -- and optionally an ECSQ table --
per (channel-group x spatial-block) tile and record the tile geometry +
tables in a self-describing header (v3 for 1-D flat spatial runs, v4 for
the 2-D ``spatial_block_hw`` row x column split of conv feature maps),
so heterogeneous channels and spatially drifting feature maps neither
waste levels nor blow up the coded rate.  Tiled streams serialize
indices in tile-major (channel-major) order -- 2-D plans additionally
permute each channel row so every row x column tile is one contiguous
run -- so consecutive coded symbols share a tile and streaming chunk
boundaries align to tiles.

Side information (header): c_min, c_max, N, flags, element count --
16 bytes for classification-style payloads, matching the paper's
accounting.  Flags extend the header with the ECSQ reconstruction table
and/or the tile extension (geometry + per-tile range/level tables) so a
receiver decodes with *no* shared calibration state; see DESIGN.md for
the layout.  Legacy v2 per-channel and v1 seed streams still decode.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Literal

import numpy as np
import torch

from ..obs.tracing import span, tracer
from . import aciq, cabac, clipping
from .backend import (QuantSpec, get_backend, host_tensor, packs_in_quantizer,
                      spec_from_numpy)
from .distributions import FeatureModel
from .ecsq import ECSQQuantizer, design_ecsq
from .rate_model import estimated_bits_from_hist, estimated_bits_from_tile_hists
from .stats import RunningStats
from .tiling import TileECSQ, TilePlan, plan_from_config

ClipMode = Literal["model", "empirical", "aciq", "manual", "minmax"]
Granularity = Literal["tensor", "channel", "tile"]

_HEADER_FMT = "<ffHHI"  # cmin, cmax, n_levels, flags, n_elems  (16 bytes)
_CHANNEL_EXT_FMT = "<BBHH"  # ndim, channel_axis, group_size, n_groups
# v3 tile ext: ndim, channel_axis, tile flags, pad, channel_group_size,
# n_cgroups, spatial_block_size, n_sblocks (then dims + range tables)
_TILE_EXT_FMT = "<BBBBHHII"
# v4 2-D tile ext: ndim, channel_axis, tile flags, pad,
# channel_group_size, n_cgroups, block_rows (bh), block_cols (bw),
# spatial_rows (H), spatial_cols (W)  (then dims + range tables, exactly
# like v3 -- n_sblocks = ceil(H/bh) * ceil(W/bw) is derived)
_TILE2D_EXT_FMT = "<BBBBHHHHII"
_STREAM_META_FMT = "<IIB"  # chunk_elems, n_chunks, ndim (then ndim u32 dims)

FLAG_ECSQ = 1      # per-tensor ECSQ; v2 streams append the level table
FLAG_CHANNEL = 2   # legacy v2 per-channel granularity (decode-only)
FLAG_V2 = 4        # payload starts with a coder-id byte (serial | rans)
FLAG_TILE = 8      # v3 tile extension (geometry + per-tile tables)
FLAG_TILE2D = 16   # v4 2-D (row x column) tile extension

TFLAG_ECSQ = 1     # tile ext carries per-tile ECSQ level tables

# chunk payloads of one streamed tensor are entropy-coded in batches of
# this many: big enough to amortize the per-chunk python dispatch through
# the batched rANS loop, small enough to keep the encode->wire pipeline
# fine-grained (first frame on the socket after one batch, not the tensor)
STREAM_CHUNK_BATCH = 8


@dataclasses.dataclass
class CodecConfig:
    n_levels: int = 4
    clip_mode: ClipMode = "model"
    kappa: float = 0.5
    leaky_slope: float = 0.1
    constrain_cmin_zero: bool = True
    use_ecsq: bool = False
    ecsq_lagrangian: float = 0.05
    ecsq_pin_boundaries: bool = True
    manual_cmin: float = 0.0
    manual_cmax: float = 1.0
    granularity: Granularity = "tensor"
    channel_axis: int = -1
    channel_group_size: int = 1
    # 'tile' granularity: elements per spatial block of the channel-major
    # (C, M) view; 0 = one block spanning M (pure per-channel tiling)
    spatial_block_size: int = 0
    # 'tile' granularity, 2-D mode: (bh, bw) row x column blocks over the
    # (H, W) spatial grid of a conv feature map (W = innermost non-channel
    # dim).  Mutually exclusive with spatial_block_size; streams carry the
    # v4 header.
    spatial_block_hw: tuple[int, int] | None = None
    backend: str | None = None   # None = the CUDA kernels; "torch" = CPU
    # calibration-sample budget per clip-range fit (0 = use everything).
    # Scenario sweeps calibrate hundreds of (rung x clip-mode x tile)
    # combinations from the same activation batch; an evenly-strided,
    # deterministic subsample keeps the empirical grid searches O(cap)
    # without a randomness source that would make sweeps unrepeatable.
    calib_sample_cap: int = 0


@dataclasses.dataclass
class ParsedHeader:
    """Decoded self-describing bitstream header (see DESIGN.md layout)."""

    cmin: float
    cmax: float
    n_levels: int
    flags: int
    n_elems: int
    levels: np.ndarray | None = None   # ECSQ reconstruction table (v2)
    dims: tuple[int, ...] | None = None
    spec: QuantSpec | None = None      # per-channel / per-tile dequant spec
    plan: TilePlan | None = None       # v3 tile geometry
    tile_levels: np.ndarray | None = None  # (n_tiles, N) per-tile ECSQ
    payload_off: int = 0               # byte offset of the entropy payload


def parse_header(data: bytes) -> ParsedHeader:
    """Parse the self-describing header shared by one-shot and streamed
    bitstreams.  ``payload_off`` points at the entropy-coder payload."""
    cmin, cmax, n_levels, flags, n_elems = struct.unpack_from(
        _HEADER_FMT, data)
    off = struct.calcsize(_HEADER_FMT)
    levels = None
    if flags & FLAG_ECSQ and flags & FLAG_V2:
        levels = np.frombuffer(data, "<f4", n_levels, off)
        off += 4 * n_levels
    dims = None
    spec = None
    plan = None
    tile_levels = None
    if flags & (FLAG_TILE | FLAG_TILE2D):
        if flags & FLAG_TILE2D:
            ndim, axis, tflags, _, gsize, ngroups, bh, bw, sh, sw = \
                struct.unpack_from(_TILE2D_EXT_FMT, data, off)
            off += struct.calcsize(_TILE2D_EXT_FMT)
        else:
            ndim, axis, tflags, _, gsize, ngroups, sblock, nsblocks = \
                struct.unpack_from(_TILE_EXT_FMT, data, off)
            off += struct.calcsize(_TILE_EXT_FMT)
        dims = tuple(int(d) for d in np.frombuffer(data, "<u4", ndim, off))
        off += 4 * ndim
        c = dims[axis]
        m = int(np.prod(dims)) // max(c, 1)
        if flags & FLAG_TILE2D:
            if sh * sw != m:
                raise ValueError("2-D tile header spatial grid does not "
                                 "match the tensor dims")
            plan = TilePlan(channel_axis=axis, channel_group_size=gsize,
                            spatial_block_size=0, n_channels=c,
                            spatial_extent=m, spatial_hw=(sh, sw),
                            spatial_block_hw=(bh, bw))
            if plan.n_cgroups != ngroups:
                raise ValueError("tile header geometry is inconsistent")
        else:
            plan = TilePlan(channel_axis=axis, channel_group_size=gsize,
                            spatial_block_size=sblock, n_channels=c,
                            spatial_extent=m if sblock else None)
            if (plan.n_cgroups, plan.n_sblocks) != (ngroups, nsblocks):
                raise ValueError("tile header geometry is inconsistent")
        n_tiles = plan.n_tiles
        table = np.frombuffer(data, "<f4", 2 * n_tiles, off) \
            .reshape(plan.n_cgroups, plan.n_sblocks, 2)
        off += 8 * n_tiles
        ecsq = None
        if tflags & TFLAG_ECSQ:
            tile_levels = np.frombuffer(
                data, "<f4", n_tiles * n_levels, off) \
                .reshape(n_tiles, n_levels)
            off += 4 * n_tiles * n_levels
        spec = QuantSpec(np.ascontiguousarray(table[..., 0]),
                         np.ascontiguousarray(table[..., 1]),
                         int(n_levels), int(axis), ecsq, plan)
    elif flags & FLAG_CHANNEL:  # legacy v2 per-channel stream
        ndim, axis, gsize, ngroups = struct.unpack_from(
            _CHANNEL_EXT_FMT, data, off)
        off += struct.calcsize(_CHANNEL_EXT_FMT)
        dims = tuple(int(d) for d in np.frombuffer(data, "<u4", ndim, off))
        off += 4 * ndim
        table = np.frombuffer(data, "<f4", 2 * ngroups, off) \
            .reshape(ngroups, 2)
        off += 8 * ngroups
        lo = np.repeat(table[:, 0], gsize)[:dims[axis]]
        hi = np.repeat(table[:, 1], gsize)[:dims[axis]]
        spec = spec_from_numpy(lo, hi, n_levels, axis)
    return ParsedHeader(cmin=float(cmin), cmax=float(cmax),
                        n_levels=int(n_levels), flags=int(flags),
                        n_elems=int(n_elems), levels=levels, dims=dims,
                        spec=spec, plan=plan, tile_levels=tile_levels,
                        payload_off=off)


def reconstruct_indices(idx: np.ndarray, hdr: ParsedHeader, *,
                        backend=None, ecsq: ECSQQuantizer | None = None,
                        shape=None) -> np.ndarray:
    """Dequantize decoded indices per the stream header.

    The single reconstruction path shared by :meth:`FeatureCodec.decode`
    and the chunked/stream decoders, so both are bit-exact by
    construction.  ``backend``/``ecsq`` default to the auto backend and no
    legacy-ECSQ fallback (a self-describing v2/v3 stream needs neither).
    v3 tiled payloads arrive in tile-major coded order and are restored to
    the tensor layout here.
    """
    backend = backend if backend is not None else get_backend(None)

    def deq(arr, spec):
        t = host_tensor(arr, device=backend.device)
        return backend.dequantize(t, spec).cpu().numpy()

    if hdr.plan is not None:
        idx_full = hdr.plan.from_coded_order(idx.reshape(-1), hdr.dims)
        if hdr.tile_levels is not None:
            tid = hdr.plan.tile_ids(hdr.dims)
            out = hdr.tile_levels.astype(np.float32)[tid, idx_full]
        else:
            out = deq(idx_full, hdr.spec)
    elif hdr.levels is not None:
        out = hdr.levels[idx].astype(np.float32)
    elif hdr.flags & FLAG_ECSQ:  # legacy ECSQ stream without a level table
        if ecsq is None:
            raise ValueError("legacy ECSQ stream needs a calibrated codec")
        out = np.asarray(ecsq.levels, np.float32)[idx]
    elif hdr.spec is not None:
        out = deq(idx.reshape(hdr.dims), hdr.spec)
    else:
        out = deq(idx, QuantSpec(hdr.cmin, hdr.cmax, hdr.n_levels))
    if shape is not None:
        return out.reshape(shape)
    return out.reshape(hdr.dims) if hdr.dims is not None else out


class HeaderCache:
    """Worker-level cache of parsed stream headers, keyed by the exact
    header bytes.

    Concurrent sessions of one serving worker overwhelmingly share a few
    (shape, rung) combinations, and same-rung same-shape tensors produce
    byte-identical headers -- so the parse (including the QuantSpec /
    TilePlan construction and the per-tile table views inside it) runs
    once per distinct header instead of once per session.  Sharing is
    safe because every consumer treats :class:`ParsedHeader` as
    immutable (``reconstruct_indices`` only reads it) and the numpy views
    reference the immutable key bytes.  ``hits``/``misses`` feed the
    server's counters dict.
    """

    def __init__(self, maxsize: int = 256) -> None:
        from collections import OrderedDict
        self._entries: "OrderedDict[bytes, ParsedHeader]" = OrderedDict()
        self.maxsize = max(1, maxsize)
        self.hits = 0
        self.misses = 0

    def parse(self, data: bytes) -> ParsedHeader:
        hdr = self._entries.get(data)
        if hdr is not None:
            self.hits += 1
            self._entries.move_to_end(data)
            return hdr
        self.misses += 1
        hdr = parse_header(data)
        self._entries[data] = hdr
        if len(self._entries) > self.maxsize:
            self._entries.popitem(last=False)
        return hdr

    @property
    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "entries": len(self._entries)}


class ChunkStreamDecoder:
    """Incremental decoder for :meth:`FeatureCodec.encode_stream` payloads.

    Chunks are entropy-decoded in *batches* of ``chunk_batch`` as they
    arrive (one batched rANS step loop per batch -- the receive-side
    mirror of the batched chunk encoder; that is the expensive stage, and
    what streaming overlaps with the transfer); any remainder decodes in
    :meth:`finish` together with the one-off dequantize.  Results are
    bit-exact with per-chunk decoding (``decode_indices_batch`` is
    result-identical to per-payload ``decode_indices``).  Chunks may
    arrive in any order -- each payload carries its chunk id --
    and ``chunk_batch=1`` restores strict decode-on-arrival.

    ``chunk_batch=0`` defers entropy decode entirely: chunks only
    accumulate, and either :meth:`finish` or a cross-session
    :func:`flush_decoders` pass drains them -- the mode the serving
    tick loop uses to collapse many sessions' chunks into one batched
    entropy call.  ``header_cache`` shares parsed headers across the
    sessions of a worker (see :class:`HeaderCache`).
    """

    def __init__(self, header_payload: bytes, *, backend=None,
                 ecsq: ECSQQuantizer | None = None,
                 chunk_batch: int = STREAM_CHUNK_BATCH,
                 header_cache: HeaderCache | None = None) -> None:
        self.chunk_elems, self.n_chunks, ndim = struct.unpack_from(
            _STREAM_META_FMT, header_payload)
        meta = struct.calcsize(_STREAM_META_FMT)
        self.shape = tuple(
            int(d) for d in np.frombuffer(header_payload, "<u4", ndim, meta))
        meta += 4 * ndim
        hdr_bytes = header_payload[meta:]
        self.header = header_cache.parse(hdr_bytes) if header_cache \
            is not None else parse_header(hdr_bytes)
        if self.header.payload_off != len(header_payload) - meta:
            raise ValueError("trailing bytes after stream header")
        self._backend = backend
        self._ecsq = ecsq
        self._idx = np.zeros(self.header.n_elems, dtype=np.int32)
        self._seen = np.zeros(self.n_chunks, dtype=bool)
        self._batch = max(0, chunk_batch)
        self._pending: list[tuple[int, bytes]] = []

    def _bounds(self, cid: int) -> tuple[int, int]:
        start = cid * self.chunk_elems
        return start, min(start + self.chunk_elems, self.header.n_elems)

    def _flush(self) -> None:
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        bounds = [self._bounds(cid) for cid, _ in pending]
        try:
            with span("entropy_decode", chunks=len(pending)):
                decoded = cabac.decode_indices_batch(
                    [blob for _, blob in pending],
                    [b - a for a, b in bounds], self.header.n_levels)
        except Exception:
            # un-see the whole batch so the caller can re-request the
            # bad chunk(s) -- a corrupt payload must not poison the
            # stream (re-feeding a corrected copy is not a duplicate)
            for cid, _ in pending:
                self._seen[cid] = False
            raise
        for (a, b), arr in zip(bounds, decoded):
            self._idx[a:b] = arr

    def add_chunk(self, payload: bytes) -> int:
        """Accept one chunk payload (entropy-decoded with its batch);
        returns its chunk id."""
        (cid,) = struct.unpack_from("<I", payload)
        if cid >= self.n_chunks:
            raise ValueError(f"chunk id {cid} out of range")
        if self._seen[cid]:
            raise ValueError(f"duplicate chunk {cid}")
        self._seen[cid] = True
        self._pending.append((cid, payload[4:]))
        if self._batch and len(self._pending) >= self._batch:
            self._flush()
        return cid

    @property
    def pending_chunks(self) -> int:
        """Chunks accumulated but not yet entropy-decoded."""
        return len(self._pending)

    @property
    def complete(self) -> bool:
        return bool(self._seen.all())

    def finish(self, shape=None) -> np.ndarray:
        if not self.complete:
            missing = int((~self._seen).sum())
            raise ValueError(f"stream incomplete: {missing} chunks missing")
        self._flush()
        with span("dequantize", n_elems=self.header.n_elems):
            return reconstruct_indices(self._idx, self.header,
                                       backend=self._backend,
                                       ecsq=self._ecsq,
                                       shape=self.shape if shape is None
                                       else shape)


def flush_decoders(decoders) -> tuple[int, int, list]:
    """Entropy-decode the pending chunks of *many* stream decoders in one
    batched call -- the cross-session drain of the serving tick loop.

    Where per-session decoding runs one ``decode_indices_batch`` per
    stream, this gathers every decoder's pending payloads (each knows its
    own element counts and quantizer level count -- mixed shapes and
    rungs coexist in one call) into a single
    :func:`cabac.decode_indices_batch` pass, so all sessions of a tick
    share one python dispatch and one batched rANS step loop per TU
    plane round.  Results are scattered back into each decoder's index
    buffer, bit-exact with per-decoder :meth:`ChunkStreamDecoder._flush`.

    Isolation: when the combined batch fails (one corrupt session must
    not poison a tick), every decoder falls back to its own per-decoder
    flush; failing decoders un-see their chunks (re-feeding a corrected
    copy is not a duplicate) and are reported rather than raised, so the
    caller can error out only the affected sessions.

    Returns ``(n_chunks_decoded, n_elems_decoded, failures)`` with
    ``failures`` a list of ``(decoder, exception)`` pairs.
    """
    work = []
    for dec in decoders:
        if dec._pending:
            pend, dec._pending = dec._pending, []
            work.append((dec, pend))
    if not work:
        return 0, 0, []
    payloads, counts, levels, owners = [], [], [], []
    for dec, pend in work:
        for cid, blob in pend:
            a, b = dec._bounds(cid)
            payloads.append(blob)
            counts.append(b - a)
            levels.append(dec.header.n_levels)
            owners.append((dec, a, b))
    try:
        with span("entropy_decode", chunks=len(payloads),
                  sessions=len(work)):
            decoded = cabac.decode_indices_batch(payloads, counts, levels)
    except Exception:
        failures = []
        n_chunks = n_elems = 0
        for dec, pend in work:
            dec._pending = pend
            try:
                dec._flush()
            except Exception as e:     # noqa: BLE001 -- reported, not raised
                failures.append((dec, e))
            else:
                n_chunks += len(pend)
                n_elems += sum(b - a for a, b in
                               (dec._bounds(cid) for cid, _ in pend))
        return n_chunks, n_elems, failures
    for (dec, a, b), arr in zip(owners, decoded):
        dec._idx[a:b] = arr
    return len(payloads), sum(counts), []


@dataclasses.dataclass
class FeatureCodec:
    """Calibrated codec instance.  Build with :func:`calibrate`.

    Per-tensor mode: ``cmin``/``cmax`` are floats.  Tiled modes carry a
    :class:`TilePlan` in ``plan`` and per-tile range tables in
    ``cmin``/``cmax``: a (n_cgroups,) float32 vector for "channel"
    granularity (one spatial block) or a (n_cgroups, n_sblocks) table for
    "tile"; ``n_channels`` records the calibrated channel count and
    ``tile_ecsq`` the optional per-tile quantizer tables.
    """

    config: CodecConfig
    cmin: float | np.ndarray
    cmax: float | np.ndarray
    model: FeatureModel | None = None
    ecsq: ECSQQuantizer | None = None
    n_channels: int | None = None
    plan: TilePlan | None = None
    tile_ecsq: TileECSQ | None = None

    # -- backend routing --------------------------------------------------------

    @property
    def backend(self):
        return get_backend(self.config.backend)

    @property
    def per_channel(self) -> bool:
        return self.n_channels is not None

    def tile_tables(self) -> tuple[np.ndarray, np.ndarray]:
        """Per-tile (lo, hi) range tables, (n_cgroups, n_sblocks)."""
        if self.plan is None:
            raise ValueError("per-tensor codec has no tile tables")
        shape = (self.plan.n_cgroups, self.plan.n_sblocks)
        return (np.asarray(self.cmin, np.float32).reshape(shape),
                np.asarray(self.cmax, np.float32).reshape(shape))

    def channel_ranges(self) -> tuple[np.ndarray, np.ndarray]:
        """Per-channel (cmin, cmax) vectors, group table expanded
        ("channel" granularity -- one spatial block -- only)."""
        if self.plan is None or self.plan.n_sblocks != 1:
            raise ValueError("codec has no per-channel range vectors")
        gs = max(1, self.config.channel_group_size)
        lo = np.repeat(np.asarray(self.cmin, np.float32).ravel(),
                       gs)[:self.n_channels]
        hi = np.repeat(np.asarray(self.cmax, np.float32).ravel(),
                       gs)[:self.n_channels]
        return lo, hi

    def spec(self) -> QuantSpec:
        """The backend-facing view of this codec's quantizer."""
        if self.plan is None:
            return spec_from_numpy(self.cmin, self.cmax,
                                   self.config.n_levels, None, self.ecsq)
        lo, hi = self.tile_tables()
        return QuantSpec(lo, hi, self.config.n_levels,
                         self.config.channel_axis, self.tile_ecsq,
                         self.plan)

    # -- in-graph ops ---------------------------------------------------------

    def quantize(self, x):
        """x -> int32 indices (backend-dispatched: CUDA kernel or CPU torch)."""
        return self.backend.quantize(x, self.spec())

    def dequantize(self, idx, dtype=torch.float32):
        return self.backend.dequantize(idx, self.spec(), dtype=dtype)

    def apply(self, x):
        """Fake-quant pass-through preserving dtype (the split-layer op).

        Uses the fused quantize+dequantize primitive: a single kernel pass
        on the CUDA path.
        """
        return self.backend.quantize_dequantize(x, self.spec())[1]

    def estimate_rate(self, x):
        """Bits/element the entropy stage would need (in-graph bound)."""
        return self.quantize_with_rate(x)[2]

    def quantize_with_rate(self, x, want_deq: bool = False):
        """(indices, reconstruction or None, rate bits/element) from one
        quantization pass.  Per-tensor codecs, uniform or ECSQ, and
        uniform codecs per channel group with channels last and groups of
        8-256 count the indices in the quantizer's own launch on the card
        (``backend.quantize_with_histogram``); the others histogram them
        after it (:meth:`index_counts`).  The same counts give the same
        rate either way.  The pass is a ``repro.codec`` range in a
        profiler's trace (``Tracer.annotate``)."""
        with tracer().annotate("repro.codec"):
            idx, deq, hist = self.quantize_with_counts(x, want_deq)
            return idx, deq, self.rate_from_counts(hist, np.shape(x))

    def quantize_with_counts(self, x, want_deq: bool = False):
        """(indices, reconstruction or None, index counts): the pass of
        :meth:`quantize_with_rate` before its rate, the counts as
        :meth:`rate_from_counts` takes them."""
        idx, deq, hist = self.backend.quantize_with_histogram(
            x, self.spec(), want_deq)
        return idx, deq, self.index_counts(idx) if hist is None else hist

    def packs_in_quantizer(self) -> bool:
        """Whether :meth:`quantize_packed_with_counts` takes this codec: a
        1/2/4-bit wire width, and per tensor (uniform or ECSQ) or uniform
        per channel group with channels last and groups of 8-256."""
        return packs_in_quantizer(self.spec(), self.bits_per_index())

    def quantize_packed_with_counts(self, x):
        """(packed uint8 wire bytes of the flat indices -- the bytes of
        ``pack(quantize(x))`` -- and the index counts) from one
        quantization pass that packs and counts its indices: one launch
        of the clip+quant or, for an ECSQ codec, the ECSQ kernel on the
        card.  The counts are :meth:`quantize_with_counts`'s, so
        :meth:`rate_from_counts` gives the same rate from either.  Raises
        unless :meth:`packs_in_quantizer`."""
        return self.backend.quantize_packed_with_histogram(
            x, self.spec(), self.bits_per_index())

    def rate_from_indices(self, idx, shape):
        """Bits/element estimate from indices (in-graph).

        Tiled codecs estimate per tile and sum: the chunked entropy stage
        codes tile-aligned runs with tile-local statistics, so the sum of
        per-tile entropies (never above the global-histogram bound, by
        conditioning) is the tighter model of what it actually spends.
        """
        return self.rate_from_counts(self.index_counts(idx), shape)

    def tiles_span_rows(self) -> bool:
        """Whether a tile of this codec spans rows of the tensor: a tiled
        codec pinned to its calibrated spatial extent
        (``plan.spatial_extent`` set).  Such a codec quantizes a whole
        tensor only, never a block of its rows, so its counts do not
        add up over row blocks."""
        return self.plan is not None and self.plan.spatial_extent is not None

    def index_counts(self, idx):
        """Index counts: (N,) for a per-tensor codec, per tile
        (n_cgroups, n_sblocks, N) for a tiled one.  Counts of disjoint
        parts of a tensor sum to the whole tensor's, for a tiled codec
        where its tiles do not depend on the tensor's extent
        (``plan.spatial_extent`` None)."""
        if self.plan is not None:
            return self.backend.tile_histogram(idx, self.spec())
        return self.backend.histogram(idx, self.config.n_levels)

    def rate_from_counts(self, hist, shape):
        """Bits/element of a tensor of ``shape`` from its index counts
        (:meth:`index_counts`)."""
        n = max(int(np.prod(shape)), 1)
        if self.plan is not None:
            return estimated_bits_from_tile_hists(
                hist, self.config.n_levels) / n
        return estimated_bits_from_hist(hist, self.config.n_levels) / n

    def tile_rate_bits(self, x):
        """(n_cgroups, n_sblocks) per-tile entropy-bits estimates from
        one quantization pass.  The per-tile view of the same in-graph
        signal :meth:`estimate_rate` sums (and the controller seeding in
        ``CodecBank.prime_controller`` consumes); exposed for callers
        that weigh individual tiles -- e.g. spatially selective rungs or
        per-tile drop decisions -- without a host round trip."""
        if self.plan is None:
            raise ValueError("per-tensor codec has no tile rates")
        idx = self.quantize(x)
        hists = self.backend.tile_histogram(idx, self.spec())
        return estimated_bits_from_tile_hists(
            hists, self.config.n_levels, per_tile=True)

    def apply_with_rate(self, x):
        """(fake-quant x, rate bits/element) from one quantization pass.

        The split-layer serving hook: quantizes once (one fused kernel on
        the CUDA path, which for the codecs :meth:`quantize_with_rate`
        names also counts the indices) and derives both the pass-through
        activations and the rate estimate from it.
        """
        _, deq, rate = self.quantize_with_rate(x, want_deq=True)
        return deq, rate

    # -- packed transport (inter-pod) ------------------------------------------

    def bits_per_index(self) -> int:
        n = self.config.n_levels
        return max(1, int(np.ceil(np.log2(n))))

    def pack(self, idx):
        """Pack int32 indices into uint8 lanes (4x2b / 2x4b / 8x1b per
        byte), backend-dispatched: the CUDA pack kernel on the card (only
        wire-width bytes leave the quantizer), the torch formula on the
        CPU -- both share one bit layout (little-end-first lanes), so
        packed streams are backend-portable.  Sizes that do not fill the
        last byte are zero-padded; ``unpack`` truncates back to the
        element count.
        """
        return self.backend.pack_indices(idx, self.bits_per_index())

    def unpack(self, packed, n_elems: int):
        bits = self.bits_per_index()
        per = 8 // bits if bits in (1, 2, 4) else 1
        if per == 1:
            return packed.to(torch.int32)
        shifts = torch.arange(per, device=packed.device) * bits
        vals = (packed[..., None].to(torch.int32) >> shifts) \
            & ((1 << bits) - 1)
        return vals.reshape(-1)[:n_elems].to(torch.int32)

    # -- host bitstream ---------------------------------------------------------

    def _header(self, x: np.ndarray) -> tuple[bytes, int]:
        """Self-describing header for ``x``; returns (bytes, flags).

        Tiled codecs write the v3 tile extension (geometry, per-tile
        ranges, optional per-tile ECSQ level tables); per-tensor codecs
        keep the seed's 16-byte accounting (plus the v2 ECSQ table).
        """
        flags = FLAG_V2
        ext = b""
        if self.plan is not None:
            axis, _, _ = self.plan.resolve(x.shape)
            lo, hi = self.tile_tables()
            tflags = TFLAG_ECSQ if self.tile_ecsq is not None else 0
            if self.plan.is_2d:
                flags |= FLAG_TILE2D
                ext += struct.pack(_TILE2D_EXT_FMT, x.ndim, axis, tflags, 0,
                                   self.plan.channel_group_size,
                                   self.plan.n_cgroups,
                                   self.plan.spatial_block_hw[0],
                                   self.plan.spatial_block_hw[1],
                                   self.plan.spatial_hw[0],
                                   self.plan.spatial_hw[1])
            else:
                flags |= FLAG_TILE
                ext += struct.pack(_TILE_EXT_FMT, x.ndim, axis, tflags, 0,
                                   self.plan.channel_group_size,
                                   self.plan.n_cgroups,
                                   self.plan.spatial_block_size,
                                   self.plan.n_sblocks)
            ext += np.asarray(x.shape, "<u4").tobytes()
            ext += np.stack([lo, hi], axis=-1).astype("<f4").tobytes()
            if self.tile_ecsq is not None:
                ext += np.asarray(self.tile_ecsq.levels, "<f4").tobytes()
            head_lo, head_hi = float(lo.min()), float(hi.max())
        elif self.ecsq is not None:
            flags |= FLAG_ECSQ
            ext += np.asarray(self.ecsq.levels, "<f4").tobytes()
            head_lo, head_hi = float(self.cmin), float(self.cmax)
        else:
            head_lo, head_hi = float(self.cmin), float(self.cmax)
        base = struct.pack(_HEADER_FMT, head_lo, head_hi,
                           self.config.n_levels, flags, int(np.prod(x.shape)))
        return base + ext, flags

    def _coded_indices(self, x: np.ndarray) -> np.ndarray:
        """Quantize ``x`` and ravel the indices in coded order (tile-major
        for tiled codecs -- consecutive coded symbols share a tile).

        The *unfused reference path*: a full int32 index tensor crosses
        from the device.  :meth:`_fused_indices` is the hot path; the two
        are bit-identical.
        """
        idx = self.quantize(self._device_tensor(x)).cpu().numpy()
        if self.plan is not None:
            return self.plan.to_coded_order(idx)
        return idx.ravel()

    def _fused_indices(self, x: np.ndarray,
                       want_hist: bool = False):
        """Coded-order indices (and optionally per-tile histograms) via
        the backend's single-pass fused encode: on the kernel backend one
        megakernel pass whose packed bytes + tile histograms are the only
        device->host transfer."""
        return self.backend.encode_fused(self._device_tensor(x), self.spec(),
                                         self.bits_per_index(),
                                         want_hist=want_hist)

    def _device_tensor(self, x: np.ndarray) -> torch.Tensor:
        """Host array -> tensor on the backend's device."""
        return host_tensor(x, device=self.backend.device)

    def _device_entropy(self, device_entropy, coder_mode: str) -> bool:
        """Resolve the device-resident entropy opt-in: an explicit
        argument wins; otherwise ``REPRO_ENTROPY_DEVICE=1`` turns it on
        whenever the coder choice is ours (``coder_mode == "auto"``) --
        pinned coder modes keep their exact wire bytes."""
        if device_entropy is not None:
            return bool(device_entropy)
        return coder_mode == "auto" \
            and os.environ.get("REPRO_ENTROPY_DEVICE") == "1"

    def encode(self, x: np.ndarray, coder_mode: str = "auto",
               fused: bool = True, device_entropy: bool | None = None
               ) -> bytes:
        """Full host encode: clip+quantize+TU+entropy coding with header.

        ``fused=True`` (default) runs the single-pass fused device encode;
        ``fused=False`` forces the unfused reference path.  Both produce
        byte-identical streams -- the entropy payload is a pure function
        of the coded-order indices, which the two paths share bit-exactly.

        ``device_entropy=True`` (default: the ``REPRO_ENTROPY_DEVICE``
        env opt-in, only with ``coder_mode="auto"``) keeps the entropy
        stage on device too (``encode_fused(emit_wire=True)``): the
        payload is a coder-id-4 stream and only wire bytes cross to the
        host.
        """
        x = np.asarray(x, np.float32)
        header, _ = self._header(x)
        if fused and self._device_entropy(device_entropy, coder_mode):
            payload, _ = self.backend.encode_fused(
                self._device_tensor(x), self.spec(), self.bits_per_index(),
                emit_wire=True)
            return header + payload
        coded = self._fused_indices(x)[0] if fused \
            else self._coded_indices(x)
        with span("entropy_encode", n_elems=int(coded.size)):
            payload = cabac.encode_indices(coded, self.config.n_levels,
                                           mode=coder_mode)
        return header + payload

    def decode(self, data: bytes, shape=None) -> np.ndarray:
        """Decode a bitstream using *its own header* for dequantization.

        A receiver-side codec needs no matching calibration state: the
        clipping range(s), level count, ECSQ table, and channel layout all
        come from the stream.  (Exception: legacy seed streams with the
        ECSQ flag predate the level table and fall back to this instance's
        designed quantizer.)
        """
        hdr = parse_header(data)
        if hdr.flags & FLAG_V2:
            idx = cabac.decode_indices(data[hdr.payload_off:],
                                       hdr.n_elems, hdr.n_levels)
        else:  # seed stream: bare serial-CABAC payload
            idx = cabac.decode_indices_serial(data[hdr.payload_off:],
                                              hdr.n_elems, hdr.n_levels)
        return reconstruct_indices(idx, hdr, backend=self.backend,
                                   ecsq=self.ecsq, shape=shape)

    def compressed_bits_per_element(self, x: np.ndarray) -> float:
        data = self.encode(x)
        return 8.0 * len(data) / np.asarray(x).size

    # -- chunked (streaming) bitstream ------------------------------------------

    def encode_stream(self, x: np.ndarray, chunk_elems: int = 1 << 18,
                      coder_mode: str = "auto",
                      chunk_batch: int = STREAM_CHUNK_BATCH,
                      device_entropy: bool | None = None):
        """Chunked encode: yields the header payload, then chunk payloads.

        The first payload is the stream header: ``<II>`` (chunk_elems,
        n_chunks) followed by the same self-describing tensor header
        :meth:`encode` writes.  Every following payload is ``<I>``
        (chunk id) + an independently flushed :func:`cabac.encode_indices`
        stream over that chunk's coded-order indices, so a receiver
        entropy-decodes each chunk the moment it arrives and only the
        final dequantize waits for the last chunk.  Reconstruction is
        bit-exact with the one-shot path (same quantize, same coded order,
        same dequantize).

        Tiled codecs round ``chunk_elems`` up so chunk boundaries align to
        tile runs in coded order (:meth:`TilePlan.align_chunk_elems`) --
        no chunk splits a tile's contiguous segment, and each chunk's
        chunk-static entropy probabilities see tile-homogeneous index
        statistics.  Chunks are entropy-coded ``chunk_batch`` at a time
        through the batched rANS loop (one python step loop per batch, not
        per chunk); framing for the wire (session ids, CRC, end-of-tensor)
        belongs to the transport layer.

        ``device_entropy`` (see :meth:`encode`) swaps the host entropy
        batches for one device emit_wire pass producing every chunk's
        coder-id-4 payload -- same chunk boundaries, and each payload's
        rANS blob is byte-identical to the host coder id 2 single-shard
        stream past the id byte.
        """
        if chunk_elems <= 0:
            raise ValueError("chunk_elems must be positive")
        x = np.asarray(x, np.float32)
        if self.plan is not None:
            chunk_elems = self.plan.align_chunk_elems(chunk_elems, x.shape)
        if self._device_entropy(device_entropy, coder_mode):
            # device-resident entropy: one emit_wire pass yields every
            # chunk's coder-id-4 payload; no index tensor ever crosses
            n = int(x.size)
            n_chunks = max(1, -(-n // chunk_elems))
            header, _ = self._header(x)
            meta = struct.pack(_STREAM_META_FMT, chunk_elems, n_chunks,
                               x.ndim)
            meta += np.asarray(x.shape, "<u4").tobytes()
            yield meta + header
            bounds = [(c * chunk_elems, min((c + 1) * chunk_elems, n))
                      for c in range(n_chunks)]
            blobs, _ = self.backend.encode_fused(
                self._device_tensor(x), self.spec(), self.bits_per_index(),
                emit_wire=True, chunk_bounds=bounds)
            for c, blob in enumerate(blobs):
                yield struct.pack("<I", c) + blob
            return
        idx = self._fused_indices(x)[0]
        header, _ = self._header(x)
        n_chunks = max(1, -(-idx.size // chunk_elems))
        # the stream meta carries the tensor shape (the one-shot header only
        # does for tiled streams): a cloud receiver reshapes before
        # running the tail network
        meta = struct.pack(_STREAM_META_FMT, chunk_elems, n_chunks, x.ndim)
        meta += np.asarray(x.shape, "<u4").tobytes()
        yield meta + header
        batch = max(1, chunk_batch)
        for c0 in range(0, n_chunks, batch):
            ids = range(c0, min(c0 + batch, n_chunks))
            with span("entropy_encode", chunks=len(ids)):
                blobs = cabac.encode_indices_batch(
                    [idx[c * chunk_elems:(c + 1) * chunk_elems]
                     for c in ids],
                    self.config.n_levels, mode=coder_mode)
            for c, blob in zip(ids, blobs):
                yield struct.pack("<I", c) + blob

    def decode_stream(self, payloads, shape=None) -> np.ndarray:
        """Inverse of :meth:`encode_stream` over an iterable of payloads."""
        dec = None
        for p in payloads:
            if dec is None:
                dec = ChunkStreamDecoder(p, backend=self.backend,
                                         ecsq=self.ecsq)
            else:
                dec.add_chunk(p)
        if dec is None:
            raise ValueError("empty payload stream")
        return dec.finish(shape)


def _calibrate_range(cfg: CodecConfig,
                     samples: np.ndarray | None = None,
                     stats: RunningStats | None = None,
                     sample_mean: float | None = None,
                     sample_var: float | None = None):
    """One (cmin, cmax, model) from calibration data -- the scalar core
    reused per channel group in per-channel mode."""
    if samples is not None:
        s = np.asarray(samples)
        if s.size == 0:
            raise ValueError(
                "calibration samples are empty (a tile plan that slices "
                "to zero elements, or an empty calibration batch)")
        if cfg.calib_sample_cap and s.size > cfg.calib_sample_cap:
            # deterministic even-stride subsample: repeatable sweeps, no
            # RNG, and the extremes of a sorted-ish activation layout
            # still land in the sample
            stride = -(-s.size // cfg.calib_sample_cap)
            samples = s.ravel()[::stride]
    model = None
    if cfg.clip_mode == "manual":
        cmin, cmax = cfg.manual_cmin, cfg.manual_cmax
    elif cfg.clip_mode == "model":
        if sample_mean is None:
            if stats is None:
                if samples is None:
                    raise ValueError("model mode needs samples or stats")
                stats = RunningStats().update(np.asarray(samples))
            sample_mean, sample_var = stats.mean, stats.var
        model = FeatureModel.fit(sample_mean, sample_var, cfg.kappa,
                                 cfg.leaky_slope)
        if cfg.constrain_cmin_zero:
            cmin, cmax = 0.0, clipping.optimal_cmax(model, cfg.n_levels)
        else:
            cmin, cmax = clipping.optimal_range(model, cfg.n_levels)
    elif cfg.clip_mode == "aciq":
        if samples is None:
            raise ValueError("aciq mode needs samples")
        cmin = 0.0
        cmax = aciq.aciq_cmax_from_samples(np.asarray(samples), cfg.n_levels)
    elif cfg.clip_mode == "empirical":
        if samples is None:
            raise ValueError("empirical mode needs samples")
        if cfg.constrain_cmin_zero:
            cmin = 0.0
            cmax = clipping.empirical_optimal_cmax(np.asarray(samples),
                                                   cfg.n_levels)
        else:
            cmin, cmax = clipping.empirical_optimal_range(np.asarray(samples),
                                                          cfg.n_levels)
    elif cfg.clip_mode == "minmax":
        if samples is None:
            raise ValueError("minmax mode needs samples")
        s = np.asarray(samples)
        cmax = float(s.max())
        # pin cmin to 0 only when the data actually lives above it; an
        # all-negative channel would otherwise degenerate to [0, ~0]
        cmin = 0.0 if cfg.constrain_cmin_zero and cmax > 0.0 \
            else float(s.min())
    else:
        raise ValueError(f"unknown clip mode {cfg.clip_mode}")
    # NaN compares False against everything, so it would sail through the
    # degenerate-range lift below and poison the step size -- fail loudly
    if not (np.isfinite(cmin) and np.isfinite(cmax)):
        raise ValueError(
            f"non-finite clip range ({cmin}, {cmax}) from "
            f"clip_mode={cfg.clip_mode!r}; calibration samples likely "
            "contain NaN/Inf")
    if cmax <= cmin:
        cmax = cmin + 1e-6
    return float(cmin), float(cmax), model


def calibrate(config: CodecConfig,
              samples: np.ndarray | None = None,
              stats: RunningStats | None = None,
              sample_mean: float | None = None,
              sample_var: float | None = None) -> FeatureCodec:
    """Build a codec from calibration data or pre-computed stats (see
    :func:`_calibrate_impl` for the modes); traced as one ``calibrate``
    pipeline span."""
    with span("calibrate", granularity=config.granularity,
              n_levels=config.n_levels, clip_mode=config.clip_mode):
        return _calibrate_impl(config, samples, stats, sample_mean,
                               sample_var)


def _calibrate_impl(config: CodecConfig,
                    samples: np.ndarray | None = None,
                    stats: RunningStats | None = None,
                    sample_mean: float | None = None,
                    sample_var: float | None = None) -> FeatureCodec:
    """Build a codec from calibration data or pre-computed stats.

    ``model`` / ``aciq`` modes need only (mean, var) / samples respectively;
    ``empirical`` grid-searches measured MSRE like the paper's empirical
    columns; ``minmax`` uses the sample extremes; ECSQ additionally runs
    Algorithm 1 on the samples.

    "channel" / "tile" granularities calibrate every tile of the
    :class:`TilePlan` independently (``samples`` must then carry the
    channel axis; "tile" additionally pins the spatial extent) and return
    per-tile range tables in ``cmin``/``cmax``.  ``use_ecsq`` with a
    tiled granularity designs one quantizer *per tile* (per-channel /
    per-group ECSQ is the one-spatial-block case).
    """
    cfg = config
    if cfg.spatial_block_hw is not None and cfg.granularity != "tile":
        raise ValueError(
            "spatial_block_hw is a 'tile'-granularity setting; "
            f"granularity={cfg.granularity!r} would silently ignore it")
    if cfg.granularity in ("channel", "tile"):
        if samples is None:
            raise ValueError(f"{cfg.granularity} granularity needs "
                             "calibration samples with the channel axis "
                             "present")
        arr = np.asarray(samples)
        plan = plan_from_config(cfg, arr.shape)
        axis = cfg.channel_axis % arr.ndim
        n_channels = arr.shape[axis]
        per_ch = np.moveaxis(arr, axis, 0).reshape(n_channels, -1)
        lo = np.empty((plan.n_cgroups, plan.n_sblocks), np.float32)
        hi = np.empty_like(lo)
        tile_q = None
        if cfg.use_ecsq:
            tile_q = (np.empty((plan.n_tiles, cfg.n_levels), np.float32),
                      np.empty((plan.n_tiles, cfg.n_levels - 1), np.float32))
        for t, cs, ss in plan.tile_slices(n_channels, per_ch.shape[1]):
            seg = per_ch[cs, ss].ravel()
            cmin_t, cmax_t, _ = _calibrate_range(cfg, seg)
            lo[t // plan.n_sblocks, t % plan.n_sblocks] = cmin_t
            hi[t // plan.n_sblocks, t % plan.n_sblocks] = cmax_t
            if tile_q is not None:
                q = design_ecsq(seg, cfg.n_levels, cfg.ecsq_lagrangian,
                                cmin_t, cmax_t,
                                pin_boundaries=cfg.ecsq_pin_boundaries)
                tile_q[0][t] = q.levels
                tile_q[1][t] = q.thresholds
        tile_ecsq = TileECSQ(*tile_q) if tile_q is not None else None
        # "channel" keeps the historical 1-D group-vector storage
        table_lo = lo.ravel() if plan.n_sblocks == 1 else lo
        table_hi = hi.ravel() if plan.n_sblocks == 1 else hi
        return FeatureCodec(config=cfg, cmin=table_lo, cmax=table_hi,
                            n_channels=n_channels, plan=plan,
                            tile_ecsq=tile_ecsq)

    cmin, cmax, model = _calibrate_range(cfg, samples, stats,
                                         sample_mean, sample_var)
    ecsq_q = None
    if cfg.use_ecsq:
        if samples is None:
            raise ValueError("ECSQ design needs calibration samples")
        ecsq_q = design_ecsq(np.asarray(samples), cfg.n_levels,
                             cfg.ecsq_lagrangian, cmin, cmax,
                             pin_boundaries=cfg.ecsq_pin_boundaries)
    return FeatureCodec(config=cfg, cmin=cmin, cmax=cmax,
                        model=model, ecsq=ecsq_q)
