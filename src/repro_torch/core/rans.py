"""Vectorized entropy coder for TU bit planes (numpy batched rANS).

The seed CABAC (``cabac.BinaryArithmeticEncoder``) is bit-serial Python:
fine for correctness, orders of magnitude too slow for full activation
tensors.  This module codes the same position-major TU bit planes with an
*interleaved binary rANS* coder whose per-step state updates run batched
over numpy lanes, so host encode/decode cost is a short python loop over
``total_bits / lanes`` steps of vector ops instead of one python iteration
per bit.

Design (see DESIGN.md for the full layout):

  * One shared coder state of L lanes (L a power of two derived from the
    total bit count) codes the concatenation of all planes; bit i of the
    stream lives in lane ``i % L`` at step ``i // L``.
  * Each plane starts at a fresh step (planes are padded to a step
    boundary with their most-probable symbol) so a step never straddles
    two planes and the decoder -- which only learns plane j+1's length
    after decoding plane j -- always knows the active probability.
  * Probabilities are *chunk-static*: each plane is cut into spans of
    ``_CHUNK_STEPS`` steps; the encoder stores one 16-bit scaled
    probability per span (measured on the span's real bits).  This
    replaces CABAC's serial per-bit adaptation with side information of
    ~2 bytes per 256*L bits while coding at the span-local empirical
    entropy, which is what the adaptive coder converges to anyway.
  * rANS details: 32-bit states renormalized 16 bits at a time
    (``x in [2^16, 2^32)``), probability scale 2^14.  Encoding runs over
    steps in reverse with per-step emissions reversed lane-wise, so the
    byte-reversed word stream is exactly what the forward decoder
    consumes -- the standard interleaved-rANS construction, batched.

Round trips are exact for any bit content; the per-lane state flush at
the speed-tuned lane count (see :func:`lane_count`) is the deliberate
rate cost of a short host step loop.
"""

from __future__ import annotations

import os
import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np

_PROB_BITS = 14
_M = 1 << _PROB_BITS                   # probability scale (f0 + f1 = _M)
_STATE_LO = np.uint64(1 << 16)         # renormalized state lower bound
_CHUNK_STEPS = 256                     # steps per static-probability span
_HEADER_FMT = "<HI"                    # lanes, n_ftable_entries

_U16 = np.uint64(16)
_S64 = np.uint64(_PROB_BITS)
_EMIT_SHIFT = np.uint64(32 - _PROB_BITS)
_MASK_S = np.uint64(_M - 1)
_MASK_W = np.uint64(0xFFFF)


def rans_threads() -> int:
    """Worker count for sharded plane coding (``REPRO_RANS_THREADS``).

    Defaults to 1 (sharding off): the step loop is numpy-dispatch bound,
    and on CPython builds whose numpy holds the GIL through the small
    per-step ops a thread pool can be slower than serial.  Opt in on
    hosts with a GIL-releasing numpy / free-threaded interpreter, where
    the independent shards scale to ``min(threads, shards)`` cores.
    """
    env = os.environ.get("REPRO_RANS_THREADS", "").strip()
    if env:
        return max(1, int(env))
    return 1


_POOL: ThreadPoolExecutor | None = None
_POOL_SIZE = 0


def _get_pool(n: int) -> ThreadPoolExecutor:
    global _POOL, _POOL_SIZE
    if _POOL is None or _POOL_SIZE < n:
        if _POOL is not None:
            _POOL.shutdown(wait=False)
        _POOL = ThreadPoolExecutor(max_workers=n, thread_name_prefix="rans")
        _POOL_SIZE = n
    return _POOL


def parallel_map(fn, items, n_threads: int | None = None) -> list:
    """Map ``fn`` over ``items`` on the rANS thread pool (ordered results).

    Falls back to a plain loop for a single item or a single-thread
    configuration, so callers need no special casing.
    """
    items = list(items)
    n = rans_threads() if n_threads is None else n_threads
    n = min(n, len(items))
    if n <= 1:
        return [fn(it) for it in items]
    return list(_get_pool(n).map(fn, items))


def proc_workers() -> int:
    """Worker count for process-pool shard coding (``REPRO_RANS_PROCS``).

    Defaults to 0 (off): worker processes pay fork + pickle transfer per
    shard, which only wins for multi-MB payloads on hosts whose numpy
    holds the GIL through the step loop (where the thread pool loses to
    serial).  Opt in with
    ``REPRO_RANS_PROCS=<n>`` to code shards on ``n`` real cores.
    """
    env = os.environ.get("REPRO_RANS_PROCS", "").strip()
    if env:
        return max(0, int(env))
    return 0


_PROC_POOL = None
_PROC_SIZE = 0


def _shutdown_proc_pool() -> None:
    global _PROC_POOL, _PROC_SIZE
    if _PROC_POOL is not None:
        _PROC_POOL.shutdown(wait=False)
    _PROC_POOL, _PROC_SIZE = None, 0


def proc_map(fn, items, n_procs: int | None = None) -> list:
    """Map ``fn`` over ``items`` on the rANS process pool (ordered).

    ``fn`` must be a module-level (picklable) function.  Any pool
    failure -- a worker crash (BrokenProcessPool), fork/pickle errors --
    tears the pool down and recomputes *everything* serially in-process,
    so callers always get correct results: the pool is an optimization,
    never a correctness dependency.
    """
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    global _PROC_POOL, _PROC_SIZE
    items = list(items)
    n = proc_workers() if n_procs is None else n_procs
    n = min(n, len(items))
    if n <= 1:
        return [fn(it) for it in items]
    try:
        if _PROC_POOL is None or _PROC_SIZE < n:
            _shutdown_proc_pool()
            # spawn, not fork: the parent typically has torch's thread
            # pools running, and forking a multithreaded process can
            # deadlock; spawn pays a one-off worker import instead
            _PROC_POOL = ProcessPoolExecutor(
                max_workers=n, mp_context=multiprocessing.get_context(
                    "spawn"))
            _PROC_SIZE = n
        return list(_PROC_POOL.map(fn, items))
    except Exception:
        _shutdown_proc_pool()
        return [fn(it) for it in items]


def lane_count(total_bits: int) -> int:
    """Lanes used for a stream of ``total_bits`` (both sides derive this).

    The step loop runs ``total_bits / lanes`` python iterations whose
    per-step cost is nearly width-independent up to a few thousand lanes,
    so wall time is inversely proportional to the lane count while the
    fixed per-lane cost (4-byte state flush) grows linearly: ~640 bits
    per lane balances the two; clipped to [4, 4096].  Encode-side policy
    only: the blob header records the count, so retuning never breaks old
    streams.  The wire format depends on it, so it must equal the JAX
    package's rule exactly.
    """
    return int(min(4096, max(4, 1 << (total_bits // 640).bit_length())))


def _chunk_freqs(bits: np.ndarray, chunk_bits: int) -> np.ndarray:
    """Scaled P(bit=1) per chunk of ``chunk_bits``, measured on real bits."""
    n = bits.size
    nch = -(-n // chunk_bits)
    bounds = np.arange(nch, dtype=np.int64) * chunk_bits
    ones = np.add.reduceat(bits.astype(np.int64), bounds)
    sizes = np.minimum(bounds + chunk_bits, n) - bounds
    f1 = np.rint(ones / sizes * _M)
    return np.clip(f1, 1, _M - 1).astype(np.uint32)


def _plane_setup(planes: list[np.ndarray], lanes: int):
    """Pad/stack TU planes for a ``lanes``-wide coder.

    Returns (bits2d (n_steps, lanes) uint8, f1_steps (n_steps,) uint32,
    ftab uint16) -- the stream-independent setup shared by the serial and
    batched encode loops.
    """
    ftab = []          # per-chunk scaled probabilities, plane-major
    step_rows = []     # (steps_i, lanes) padded bit matrices
    step_f1 = []       # per-step probability (uint32)
    for p in planes:
        if p.size == 0:
            continue
        steps = -(-p.size // lanes)
        f1c = _chunk_freqs(p, _CHUNK_STEPS * lanes)
        ftab.append(f1c.astype(np.uint16))
        pad = steps * lanes - p.size
        if pad:
            mps = 1 if int(f1c[-1]) >= _M // 2 else 0
            p = np.concatenate([p, np.full(pad, mps, np.uint8)])
        step_rows.append(p.reshape(steps, lanes))
        step_f1.append(np.repeat(f1c, _CHUNK_STEPS)[:steps])
    return (np.concatenate(step_rows, axis=0),
            np.concatenate(step_f1),
            np.concatenate(ftab))


def _blob(lanes: int, ftab: np.ndarray, x: np.ndarray,
          words: np.ndarray) -> bytes:
    return (struct.pack(_HEADER_FMT, lanes, ftab.size)
            + ftab.astype("<u2").tobytes()
            + x.astype("<u4").tobytes()
            + words.astype("<u2").tobytes())


def encode_planes(planes: list[np.ndarray]) -> bytes:
    """Encode TU bit planes (uint8 0/1 arrays) into one rANS stream."""
    planes = [np.asarray(p, dtype=np.uint8).ravel() for p in planes]
    total_bits = int(sum(p.size for p in planes))
    if total_bits == 0:
        return struct.pack(_HEADER_FMT, 0, 0)
    lanes = lane_count(total_bits)
    bits2d, f1_steps, ftab = _plane_setup(planes, lanes)
    n_steps = bits2d.shape[0]

    # The loop carries only the sequential state update, built from the
    # step's scalar probabilities with bitwise mixes (f0 ^ (f0^f1)*bit)
    # rather than per-step np.where.  Word emission is deferred: each
    # step stores its pre-renorm low words and the emission mask, and
    # one boolean gather at the end collects the emitted words in
    # (step asc, lane asc) order -- exactly the order the old per-step
    # burst bookkeeping produced (bursts appended in reverse step order,
    # lane-reversed, then globally reversed), so the byte stream is
    # unchanged.
    bits_bool = bits2d.view(np.bool_)
    x = np.full(lanes, _STATE_LO, dtype=np.uint64)
    over_rows = np.empty((n_steps, lanes), np.bool_)
    w_rows = np.empty((n_steps, lanes), np.uint16)
    m64 = np.uint64(_M)
    for t in range(n_steps - 1, -1, -1):
        f1 = np.uint64(f1_steps[t])
        f0 = m64 - f1
        b = bits_bool[t]
        f = np.where(b, f1, f0)
        over = x >= (f << _EMIT_SHIFT)
        over_rows[t] = over
        w_rows[t] = x          # truncating uint16 store == x & 0xFFFF
        x >>= over * _U16                        # renorm emitting lanes
        q, r = np.divmod(x, f)
        x = (q << _S64) + r + f0 * b
    return _blob(lanes, ftab, x, w_rows[over_rows])


def _encode_group(lanes: int, setups: list) -> list[bytes]:
    """One batched step loop over S independent equal-lane-count streams.

    The streams are stacked on a leading axis, so every per-step state
    update runs as one (S, lanes) numpy op instead of S separate
    dispatches -- the per-step python cost no longer scales with the
    number of chunks.  Streams shorter than the longest are masked
    inactive for the leading (reverse-order) steps.  Output bytes are
    identical to :func:`encode_planes` per stream (asserted in tests).
    """
    s_count = len(setups)
    steps = np.array([b.shape[0] for b, _, _ in setups], dtype=np.int64)
    t_max = int(steps.max())
    bits = np.zeros((s_count, t_max, lanes), np.uint8)
    f1_all = np.ones((s_count, t_max), np.uint64)
    for s, (b2d, f1s, _) in enumerate(setups):
        bits[s, :b2d.shape[0]] = b2d
        f1_all[s, :f1s.size] = f1s.astype(np.uint64)

    x = np.full((s_count, lanes), _STATE_LO, dtype=np.uint64)
    em_words, em_stream, em_step, em_lane = [], [], [], []
    zero = np.uint64(0)
    m64 = np.uint64(_M)
    for t in range(t_max - 1, -1, -1):
        active = steps > t                      # (S,)
        f1 = f1_all[:, t][:, None]
        f0 = m64 - f1
        ones = bits[:, t, :] == 1
        f = np.where(ones, f1, f0)
        c = np.where(ones, f0, zero)
        over = (x >= (f << _EMIT_SHIFT)) & active[:, None]
        if over.any():
            sidx, lidx = np.nonzero(over)
            em_words.append((x[over] & _MASK_W).astype(np.uint16))
            em_stream.append(sidx)
            em_lane.append(lidx)
            em_step.append(np.full(sidx.size, t, np.int64))
            x[over] >>= _U16
        q = x // f
        x = np.where(active[:, None], (q << _S64) + (x - q * f) + c, x)

    # per-stream word order matching the serial coder: steps ascending,
    # lanes ascending within a step
    if em_words:
        w = np.concatenate(em_words)
        st = np.concatenate(em_stream)
        tt = np.concatenate(em_step)
        ln = np.concatenate(em_lane)
        order = np.lexsort((ln, tt, st))
        w, st = w[order], st[order]
        counts = np.bincount(st, minlength=s_count)
        offs = np.concatenate([[0], np.cumsum(counts)])
    else:
        w = np.empty(0, np.uint16)
        offs = np.zeros(s_count + 1, np.int64)
    return [_blob(lanes, setups[s][2], x[s], w[offs[s]:offs[s + 1]])
            for s in range(s_count)]


def encode_planes_batch(streams: list[list[np.ndarray]]) -> list[bytes]:
    """Encode many *independent* plane lists; one stream of bytes each.

    Byte-identical to ``[encode_planes(p) for p in streams]``, but
    streams with equal lane counts share one batched step loop --
    :meth:`FeatureCodec.encode_stream` uses this to cut the per-chunk
    python dispatch that otherwise dominates chunked encodes.
    """
    out: list[bytes | None] = [None] * len(streams)
    groups: dict[int, list] = {}
    for i, planes in enumerate(streams):
        planes = [np.asarray(p, dtype=np.uint8).ravel() for p in planes]
        total = int(sum(p.size for p in planes))
        if total == 0:
            out[i] = struct.pack(_HEADER_FMT, 0, 0)
            continue
        groups.setdefault(lane_count(total), []).append((i, planes))
    for lanes, members in groups.items():
        if len(members) == 1:
            i, planes = members[0]
            out[i] = encode_planes(planes)
            continue
        setups = [_plane_setup(planes, lanes) for _, planes in members]
        for (i, _), blob in zip(members, _encode_group(lanes, setups)):
            out[i] = blob
    return out


class PlaneStreamDecoder:
    """Forward decoder over a stream produced by :func:`encode_planes`.

    Planes are pulled one at a time with :meth:`next_plane`; the caller
    supplies each plane's bit count (the TU structure makes it computable
    from previously decoded planes, so it is not stored).
    """

    def __init__(self, data: bytes) -> None:
        lanes, n_ftab = struct.unpack_from(_HEADER_FMT, data)
        off = struct.calcsize(_HEADER_FMT)
        self.lanes = lanes
        self._ftab = np.frombuffer(data, "<u2", n_ftab, off)
        off += 2 * n_ftab
        self._fpos = 0
        if lanes:
            self._x = np.frombuffer(data, "<u4", lanes, off).astype(np.uint64)
            off += 4 * lanes
        self._words = np.frombuffer(data, "<u2", -1, off).astype(np.uint64)
        self._wpos = 0

    def next_plane(self, n_bits: int) -> np.ndarray:
        if n_bits == 0:
            return np.empty(0, dtype=np.uint8)
        if self.lanes == 0:
            raise ValueError("empty stream cannot hold a non-empty plane")
        lanes = self.lanes
        steps = -(-n_bits // lanes)
        nch = -(-steps // _CHUNK_STEPS)
        f1c = self._ftab[self._fpos:self._fpos + nch]
        if f1c.size != nch:
            raise ValueError("truncated probability table")
        self._fpos += nch

        x = self._x
        words, wpos = self._words, self._wpos
        out = np.empty((steps, lanes), dtype=np.uint8)
        for s0 in range(0, steps, _CHUNK_STEPS):
            # probabilities are chunk-static: hoist the span's scalars and
            # select f via a bitwise mix (f0 ^ (f0^f1)*bit) -- cheaper
            # than per-step np.where at these widths
            f1 = np.uint64(f1c[s0 // _CHUNK_STEPS])
            f0 = np.uint64(_M) - f1
            fx = f0 ^ f1
            for t in range(s0, min(s0 + _CHUNK_STEPS, steps)):
                xm = x & _MASK_S
                bit = xm >= f0
                f = f0 ^ (fx * bit)
                x = f * (x >> _S64) + (xm - f0 * bit)
                low = x < _STATE_LO
                k = int(low.sum())
                if k:
                    x[low] = (x[low] << _U16) | words[wpos:wpos + k]
                    wpos += k
                out[t] = bit
        self._x, self._wpos = x, wpos
        return out.reshape(-1)[:n_bits]


class BatchPlaneDecoder:
    """Forward decoder over S *independent* equal-lane-count streams.

    The decode-side mirror of :func:`_encode_group`: the S coder states
    are stacked on a leading axis so every per-step update runs as one
    (S, lanes) numpy op -- the per-stream python dispatch that dominates
    chunked decodes collapses into one step loop per plane round.
    Per-stream results are bit-identical to S separate
    :class:`PlaneStreamDecoder` walks (asserted in tests): streams
    shorter than the longest are masked inactive for the trailing steps
    and word refills are gathered per stream in lane order, exactly the
    serial consumption order.
    """

    def __init__(self, blobs: list[bytes]) -> None:
        self.n = len(blobs)
        lanes = None
        ftabs, states, words, woff = [], [], [], []
        for blob in blobs:
            ln, n_ftab = struct.unpack_from(_HEADER_FMT, blob)
            if lanes is None:
                lanes = ln
            elif ln != lanes:
                raise ValueError("batched streams must share a lane count")
            if ln == 0:
                raise ValueError("empty stream cannot join a batch")
            off = struct.calcsize(_HEADER_FMT)
            ftabs.append(np.frombuffer(blob, "<u2", n_ftab, off))
            off += 2 * n_ftab
            states.append(np.frombuffer(blob, "<u4", ln, off))
            off += 4 * ln
            w = np.frombuffer(blob, "<u2", -1, off)
            woff.append(sum(x.size for x in words))
            words.append(w)
        self.lanes = lanes
        self._ftabs = ftabs
        self._fpos = np.zeros(self.n, np.int64)
        self._x = np.stack(states).astype(np.uint64)       # (S, lanes)
        self._words = (np.concatenate(words).astype(np.uint64)
                       if words else np.empty(0, np.uint64))
        self._wpos = np.asarray(woff, np.int64)            # absolute
        self._wend = self._wpos + np.asarray(
            [w.size for w in words], np.int64)

    def next_planes(self, n_bits: list[int]) -> list[np.ndarray]:
        """Decode one plane from every stream (``n_bits[s]`` may be 0)."""
        lanes = self.lanes
        steps = np.asarray([-(-b // lanes) for b in n_bits], np.int64)
        t_max = int(steps.max()) if steps.size else 0
        if t_max == 0:
            return [np.empty(0, np.uint8) for _ in n_bits]
        f1_all = np.ones((self.n, t_max), np.uint64)
        for s, nb in enumerate(n_bits):
            if nb == 0:
                continue
            nch = -(-int(steps[s]) // _CHUNK_STEPS)
            f1c = self._ftabs[s][self._fpos[s]:self._fpos[s] + nch]
            if f1c.size != nch:
                raise ValueError("truncated probability table")
            self._fpos[s] += nch
            f1_all[s, :steps[s]] = \
                np.repeat(f1c.astype(np.uint64), _CHUNK_STEPS)[:steps[s]]

        x = self._x
        words, wpos = self._words, self._wpos.copy()
        out = np.empty((self.n, t_max, lanes), dtype=np.uint8)
        m64 = np.uint64(_M)
        zero = np.uint64(0)
        for t in range(t_max):
            active = steps > t                         # (S,)
            f1 = f1_all[:, t][:, None]
            f0 = m64 - f1
            xm = x & _MASK_S
            bit = xm >= f0
            f = np.where(bit, f1, f0)
            c = np.where(bit, f0, zero)
            x = np.where(active[:, None], f * (x >> _S64) + xm - c, x)
            low = (x < _STATE_LO) & active[:, None]
            if low.any():
                sidx, _ = np.nonzero(low)              # s asc, lane asc
                counts = np.bincount(sidx, minlength=self.n)
                if np.any(wpos + counts > self._wend):
                    # per-stream bound: a truncated member must raise
                    # (like the single-stream decoder), never silently
                    # consume its neighbour's words
                    raise ValueError("truncated word stream in batch")
                starts = np.cumsum(counts) - counts
                rank = np.arange(sidx.size) - starts[sidx]
                x[low] = (x[low] << _U16) | words[wpos[sidx] + rank]
                wpos += counts
            out[:, t, :] = bit
        self._x, self._wpos = x, wpos
        return [out[s, :steps[s]].reshape(-1)[:n_bits[s]]
                for s in range(self.n)]
