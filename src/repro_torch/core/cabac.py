"""Entropy coding of TU bit planes (paper Sec. III-D).

Two interchangeable host coders sit behind :func:`encode_indices` /
:func:`decode_indices`:

  * the seed *serial* coder: a carry-less binary range coder (Subbotin
    style) with an exponentially-adapting probability state per TU bit
    position -- functionally the HEVC m-coder without the LPS tables.
    Bit-serial Python, so it only stays on the hot path for small
    payloads (< ``_SERIAL_CUTOFF_BITS`` TU bits) where its 4-byte flush
    beats the vectorized coder's per-lane overhead;
  * the *vectorized* coder (``repro_torch.core.rans``): numpy-batched
    interleaved binary rANS over the same planes with chunk-static
    probabilities.  Same plane structure, same exact round trip, and
    far fewer python iterations on full activation tensors.

A one-byte coder id prefixes the payload so the decoder self-selects.
Streams written by the seed (no id byte) are still readable through
:func:`decode_indices_serial`, which ``FeatureCodec.decode`` uses for
legacy headers.  See DESIGN.md for the layout.
"""

from __future__ import annotations

import struct

import numpy as np

from . import rans

_TOP = 1 << 24
_BOT = 1 << 16
_MASK = 0xFFFFFFFF
_PROB_BITS = 16
_PROB_ONE = 1 << _PROB_BITS
_ADAPT_SHIFT = 5
_P_MIN, _P_MAX = 64, _PROB_ONE - 64


class _Context:
    __slots__ = ("p1",)

    def __init__(self) -> None:
        self.p1 = _PROB_ONE // 2

    def update(self, bit: int) -> None:
        if bit:
            self.p1 += (_PROB_ONE - self.p1) >> _ADAPT_SHIFT
        else:
            self.p1 -= self.p1 >> _ADAPT_SHIFT
        self.p1 = min(max(self.p1, _P_MIN), _P_MAX)


class BinaryArithmeticEncoder:
    def __init__(self, n_contexts: int) -> None:
        self.ctx = [_Context() for _ in range(n_contexts)]
        self.low = 0
        self.rng = _MASK
        self.out = bytearray()

    def _normalize(self) -> None:
        while True:
            if (self.low ^ (self.low + self.rng)) & _MASK < _TOP:
                pass
            elif self.rng < _BOT:
                self.rng = (-self.low) & (_BOT - 1)
            else:
                break
            self.out.append((self.low >> 24) & 0xFF)
            self.low = (self.low << 8) & _MASK
            self.rng = (self.rng << 8) & _MASK

    def encode(self, bit: int, ctx_id: int) -> None:
        c = self.ctx[ctx_id]
        r1 = (self.rng >> _PROB_BITS) * c.p1
        r1 = min(max(r1, 1), self.rng - 1)
        if bit:
            self.rng = r1
        else:
            self.low = (self.low + r1) & _MASK
            self.rng -= r1
        c.update(bit)
        self._normalize()

    def encode_plane(self, bits: np.ndarray, ctx_id: int) -> None:
        for b in np.asarray(bits, dtype=np.uint8):
            self.encode(int(b), ctx_id)

    def finish(self) -> bytes:
        for _ in range(4):
            self.out.append((self.low >> 24) & 0xFF)
            self.low = (self.low << 8) & _MASK
        return bytes(self.out)


class BinaryArithmeticDecoder:
    def __init__(self, data: bytes, n_contexts: int) -> None:
        self.ctx = [_Context() for _ in range(n_contexts)]
        self.data = data
        self.pos = 0
        self.low = 0
        self.rng = _MASK
        self.code = 0
        for _ in range(4):
            self.code = ((self.code << 8) | self._byte()) & _MASK

    def _byte(self) -> int:
        b = self.data[self.pos] if self.pos < len(self.data) else 0
        self.pos += 1
        return b

    def _normalize(self) -> None:
        while True:
            if (self.low ^ (self.low + self.rng)) & _MASK < _TOP:
                pass
            elif self.rng < _BOT:
                self.rng = (-self.low) & (_BOT - 1)
            else:
                break
            self.code = ((self.code << 8) | self._byte()) & _MASK
            self.low = (self.low << 8) & _MASK
            self.rng = (self.rng << 8) & _MASK

    def decode(self, ctx_id: int) -> int:
        c = self.ctx[ctx_id]
        r1 = (self.rng >> _PROB_BITS) * c.p1
        r1 = min(max(r1, 1), self.rng - 1)
        if ((self.code - self.low) & _MASK) < r1:
            bit = 1
            self.rng = r1
        else:
            bit = 0
            self.low = (self.low + r1) & _MASK
            self.rng -= r1
        c.update(bit)
        self._normalize()
        return bit

    def decode_plane(self, n_bits: int, ctx_id: int) -> np.ndarray:
        return np.fromiter((self.decode(ctx_id) for _ in range(n_bits)),
                           dtype=np.uint8, count=n_bits)


_CODER_SERIAL = 0
_CODER_RANS = 1
_CODER_RANS_SHARDED = 2
_CODER_RANS_PROC = 3    # same shard layout as 2, coded on a process pool
_CODER_RANS_DEVICE = 4  # single-shard coder-2 layout, coded on device
# Below this many TU bits the serial coder's 4-byte flush undercuts the
# vectorized coder's per-lane state overhead, and the python loop is cheap.
_SERIAL_CUTOFF_BITS = 1 << 16
# Above this many TU bits "auto" shards the payload across the rANS thread
# or process pool (multi-MB activation tensors); below it the per-shard
# state/table duplication and pool dispatch are not worth it.
_SHARD_MIN_BITS = 1 << 21


def encode_indices_serial(idx: np.ndarray, n_levels: int) -> bytes:
    """Seed bit-serial CABAC encode (no coder-id byte): the baseline path."""
    from .binarization import index_to_context_bits
    enc = BinaryArithmeticEncoder(n_contexts=max(n_levels - 1, 1))
    for j, plane in enumerate(index_to_context_bits(idx, n_levels)):
        enc.encode_plane(plane, j)
    return enc.finish()


def decode_indices_serial(data: bytes, n_elems: int,
                          n_levels: int) -> np.ndarray:
    """Inverse of :func:`encode_indices_serial` (also reads seed streams)."""
    dec = BinaryArithmeticDecoder(data, n_contexts=max(n_levels - 1, 1))
    return _decode_planes(lambda n, j: dec.decode_plane(n, j),
                          n_elems, n_levels)


def _as_bool(bits: np.ndarray) -> np.ndarray:
    return bits.view(np.bool_) if bits.dtype == np.uint8 \
        else bits.astype(bool)


def _decode_planes(next_plane, n_elems: int, n_levels: int) -> np.ndarray:
    """Shared TU plane-to-index reconstruction loop.

    Tracks the alive set as a compacted position array (mirroring the
    encoder's plane compaction): each round's scatter/gather runs over
    the shrinking survivor count, not the full tensor.
    """
    idx = np.zeros(n_elems, dtype=np.int32)
    pos = np.arange(n_elems, dtype=np.int64)
    for j in range(n_levels - 1):
        if pos.size == 0:
            break
        bits = next_plane(pos.size, j)
        pos = pos[_as_bool(bits)]
        idx[pos] += 1
    return idx


def _shard_bounds(n_elems: int, n_shards: int) -> list[tuple[int, int]]:
    """Contiguous element ranges for sharded coding (last may be short)."""
    per = -(-n_elems // max(1, n_shards))
    return [(s * per, min((s + 1) * per, n_elems))
            for s in range(n_shards) if s * per < n_elems]


def _encode_shard_worker(args) -> bytes:
    """Encode one element shard to a standalone rANS stream (module-level
    so the process pool can pickle it)."""
    seg, n_levels = args
    from .binarization import index_to_context_bits
    return rans.encode_planes(index_to_context_bits(seg, n_levels))


def _decode_shard_worker(args) -> np.ndarray:
    """Decode one standalone shard stream (module-level, picklable)."""
    blob, count, n_levels = args
    d = rans.PlaneStreamDecoder(blob)
    return _decode_planes(lambda n, j: d.next_plane(n), count, n_levels)


def _shard_header(blobs: list[bytes]) -> bytes:
    head = struct.pack("<H", len(blobs))
    head += struct.pack(f"<{len(blobs)}I", *[len(b) for b in blobs])
    return head


def _split_shards(body: bytes, n_elems: int, n_levels: int) -> list:
    """Parse a sharded body into ``_decode_shard_worker`` jobs."""
    (n_shards,) = struct.unpack_from("<H", body)
    lens = struct.unpack_from(f"<{n_shards}I", body, 2)
    bounds = _shard_bounds(n_elems, n_shards)
    if len(bounds) != n_shards:
        raise ValueError("shard count does not match element count")
    off = 2 + 4 * n_shards
    jobs = []
    for (a, b), ln in zip(bounds, lens):
        jobs.append((body[off:off + ln], b - a, n_levels))
        off += ln
    return jobs


def wrap_device_blob(blob: bytes) -> bytes:
    """Coder-4 container for one device-coded (or host-fallback) rANS
    blob: the single-shard coder-2 layout under a distinct id byte, so
    device-coded streams are byte-identical to
    ``_encode_rans_sharded(idx, n_levels, n_shards=1)`` past the id.
    An empty ``blob`` means an empty stream (zero shards, like coder 2's
    empty payload)."""
    if not blob:
        return bytes([_CODER_RANS_DEVICE]) + struct.pack("<H", 0)
    return bytes([_CODER_RANS_DEVICE]) + _shard_header([blob]) + blob


def _encode_rans_sharded(idx: np.ndarray, n_levels: int, n_shards: int,
                         coder_id: int = _CODER_RANS_SHARDED) -> bytes:
    """Shard elements into independent rANS streams coded on the thread
    (coder id 2) or process (coder id 3) pool.  Layout: id byte |
    <H> n_shards | n_shards x <I> byte length | concatenated shard
    streams.  Each shard flushes its own coder state, so shards decode
    independently (and in parallel); both ids share one byte layout, so
    the shard bytes are identical whichever pool coded them."""
    bounds = _shard_bounds(idx.size, n_shards)
    jobs = [(idx[a:b], n_levels) for a, b in bounds]
    if coder_id == _CODER_RANS_PROC:
        blobs = rans.proc_map(_encode_shard_worker, jobs, n_shards)
    else:
        blobs = rans.parallel_map(_encode_shard_worker, jobs)
    return bytes([coder_id]) + _shard_header(blobs) + b"".join(blobs)


def _decode_rans_sharded(body: bytes, n_elems: int, n_levels: int,
                         use_procs: bool = False) -> np.ndarray:
    jobs = _split_shards(body, n_elems, n_levels)
    if not jobs:
        return np.zeros(n_elems, dtype=np.int32)
    if use_procs:
        # a proc-coded stream decodes on the pool when one is configured
        # (and in-process otherwise: ids are wire format, not policy)
        n = rans.proc_workers() or 1
        return np.concatenate(rans.proc_map(_decode_shard_worker, jobs, n))
    return np.concatenate(rans.parallel_map(_decode_shard_worker, jobs))


def encode_indices(idx: np.ndarray, n_levels: int, mode: str = "auto") -> bytes:
    """TU-binarize + entropy-code a flat index array (plane-major order).

    ``mode``: "auto" picks the serial coder below the size cutoff, the
    vectorized coder above it, and -- for multi-MB payloads -- the
    process-sharded coder when ``REPRO_RANS_PROCS`` configures workers,
    else the thread-sharded coder when the thread pool has more than one;
    "serial" / "rans" / "rans_sharded" / "rans_proc" force a coder.  The
    payload starts with a one-byte coder id; :func:`decode_indices`
    dispatches on it.
    """
    from .binarization import index_to_context_bits
    idx = np.asarray(idx).ravel()
    if mode == "auto":
        # every element codes at least one TU bit, so the exact bit count
        # (a full pass over the indices) is only needed when the element
        # count alone cannot settle the choice
        pooled = rans.proc_workers() > 1 or rans.rans_threads() > 1
        if idx.size >= _SERIAL_CUTOFF_BITS and not pooled:
            mode = "rans"
        else:
            from .binarization import total_tu_bits
            total = total_tu_bits(idx, n_levels)
            if total < _SERIAL_CUTOFF_BITS:
                mode = "serial"
            elif total >= _SHARD_MIN_BITS and rans.proc_workers() > 1:
                mode = "rans_proc"
            elif total >= _SHARD_MIN_BITS and rans.rans_threads() > 1:
                mode = "rans_sharded"
            else:
                mode = "rans"
    if mode == "serial":
        enc = BinaryArithmeticEncoder(n_contexts=max(n_levels - 1, 1))
        for j, plane in enumerate(index_to_context_bits(idx, n_levels)):
            enc.encode_plane(plane, j)
        return bytes([_CODER_SERIAL]) + enc.finish()
    if mode == "rans":
        return bytes([_CODER_RANS]) \
            + rans.encode_planes(index_to_context_bits(idx, n_levels))
    if mode == "rans_sharded":
        return _encode_rans_sharded(idx, n_levels, rans.rans_threads())
    if mode == "rans_proc":
        return _encode_rans_sharded(idx, n_levels,
                                    max(2, rans.proc_workers()),
                                    coder_id=_CODER_RANS_PROC)
    if mode == "rans_device":
        # in-graph coder (id 4); on host arrays this round-trips through
        # the device, so it is mainly the backends' emit_wire path that
        # reaches it with data already resident
        from ..kernels.rans_coder import encode_indices_device
        return encode_indices_device(idx, n_levels)
    raise ValueError(f"unknown coder mode {mode!r}")


def _levels_list(n_levels, count: int) -> list[int]:
    """Normalize an ``n_levels`` argument (scalar or per-item sequence)."""
    if np.ndim(n_levels) == 0:
        return [int(n_levels)] * count
    levels = [int(n) for n in n_levels]
    if len(levels) != count:
        raise ValueError(f"got {len(levels)} n_levels for {count} payloads")
    return levels


def encode_indices_batch(segments: list[np.ndarray], n_levels,
                         mode: str = "auto") -> list[bytes]:
    """Encode many independent index segments with shared dispatch.

    Payload-compatible with per-segment :func:`encode_indices` calls (each
    blob starts with its own coder-id byte and decodes in isolation), but
    all segments that land on the vectorized coder share one batched rANS
    step loop (:func:`repro_torch.core.rans.encode_planes_batch`) -- the
    chunked-stream encoder's per-chunk python dispatch collapses to one
    loop per batch.  ``auto`` keeps the serial coder for small segments;
    the thread-sharded coder is not used here (batching already amortizes
    the dispatch the pool would target).  ``n_levels`` may be a scalar or
    one value per segment (cross-session ticks mix quantizer rungs).
    """
    from .binarization import index_to_context_bits, total_tu_bits
    segments = [np.asarray(s).ravel() for s in segments]
    levels = _levels_list(n_levels, len(segments))
    out: list[bytes | None] = [None] * len(segments)
    rans_ids = []
    for i, seg in enumerate(segments):
        m = mode
        if m == "auto":
            m = "rans" if seg.size >= _SERIAL_CUTOFF_BITS else \
                ("serial" if total_tu_bits(seg, levels[i])
                 < _SERIAL_CUTOFF_BITS else "rans")
        if m == "rans":
            rans_ids.append(i)
        else:
            out[i] = encode_indices(seg, levels[i], mode=m)
    blobs = rans.encode_planes_batch(
        [index_to_context_bits(segments[i], levels[i]) for i in rans_ids])
    for i, blob in zip(rans_ids, blobs):
        out[i] = bytes([_CODER_RANS]) + blob
    return out


def decode_indices(data: bytes, n_elems: int, n_levels: int) -> np.ndarray:
    """Inverse of :func:`encode_indices` (reads the coder-id byte)."""
    if len(data) == 0:
        raise ValueError("empty bitstream")
    coder, body = data[0], data[1:]
    if coder == _CODER_SERIAL:
        return decode_indices_serial(body, n_elems, n_levels)
    if coder == _CODER_RANS:
        dec = rans.PlaneStreamDecoder(body)
        return _decode_planes(lambda n, j: dec.next_plane(n),
                              n_elems, n_levels)
    if coder in (_CODER_RANS_SHARDED, _CODER_RANS_DEVICE):
        return _decode_rans_sharded(body, n_elems, n_levels)
    if coder == _CODER_RANS_PROC:
        return _decode_rans_sharded(body, n_elems, n_levels, use_procs=True)
    raise ValueError(f"unknown coder id {coder}")


def decode_indices_batch(payloads: list[bytes], counts: list[int],
                         n_levels) -> list[np.ndarray]:
    """Decode many independent payloads with shared dispatch.

    Result-identical to per-payload :func:`decode_indices` calls, but all
    payloads coded by the vectorized coder with a common lane count share
    one batched step loop per TU plane round
    (:class:`repro_torch.core.rans.BatchPlaneDecoder`) -- the receive side's
    per-chunk python dispatch collapses the same way the batched encoder
    collapsed the send side's.  Serial and sharded payloads decode
    individually (they are small or already parallel).  ``n_levels`` may
    be a scalar or one value per payload: a cross-session drain mixes
    streams at different quantizer rungs in one call, and a stream whose
    TU planes are exhausted simply stops consuming plane rounds.
    """
    levels = _levels_list(n_levels, len(payloads))
    out: list[np.ndarray | None] = [None] * len(payloads)
    groups: dict[int, list[tuple[int, int]]] = {}
    for i, data in enumerate(payloads):
        # a device-coded payload is a single-shard container, so past
        # the 7-byte prefix it batches like a plain rANS blob
        off = 1 if len(data) > 1 and data[0] == _CODER_RANS else None
        if off is None and len(data) > 7 \
                and data[0] == _CODER_RANS_DEVICE \
                and struct.unpack_from("<H", data, 1)[0] == 1:
            off = 7
        if off is not None:
            (lanes,) = struct.unpack_from("<H", data, off)
            if lanes:
                groups.setdefault(lanes, []).append((i, off))
                continue
        out[i] = decode_indices(data, counts[i], levels[i])
    for lanes, members in groups.items():
        if len(members) == 1:
            i = members[0][0]
            out[i] = decode_indices(payloads[i], counts[i], levels[i])
            continue
        dec = rans.BatchPlaneDecoder([payloads[i][o:] for i, o in members])
        n = [counts[i] for i, _ in members]
        rounds = [levels[i] - 1 for i, _ in members]
        idxs = [np.zeros(c, dtype=np.int32) for c in n]
        poss = [np.arange(c, dtype=np.int64) for c in n]
        for r in range(max(rounds)):
            n_alive = [p.size if r < rounds[s] else 0
                       for s, p in enumerate(poss)]
            if not any(n_alive):
                break
            planes = dec.next_planes(n_alive)
            for s, bits in enumerate(planes):
                if n_alive[s] == 0:
                    continue
                poss[s] = poss[s][_as_bool(bits)]
                idxs[s][poss[s]] += 1
        for (i, _), idx in zip(members, idxs):
            out[i] = idx
    return out
