"""Device-resident interleaved-rANS entropy stage (entropy coder id 4).

The host coder (:mod:`repro_torch.core.rans`) runs the step loop in
numpy, so a host encode ships the full index tensor device->host before
a single wire byte exists.  This module keeps the entropy stage on the
tensor's device: TU bit-plane construction, the chunk-static probability
build and the lane-parallel rANS step loop all run there, and only the
coded bytes (plus the small probability table and per-lane state flush)
cross to the host.

Byte identity is the contract: for any coded-order index vector the blob
assembled here is identical to ``rans.encode_planes(
cabac.index_to_context_bits(idx, n_levels))``.  Every quirk of the host
coder is reproduced exactly:

  * planes are concatenated in TU order with empty planes skipped, each
    plane padded to a step boundary with its most-probable symbol;
  * per-chunk probabilities are ``rint(ones / size * 2^14)`` with
    float64 round-half-even semantics -- computed here in exact int64
    arithmetic;
  * the step loop runs in reverse with 32-bit states renormalized 16
    bits at a time, and emitted words are gathered in (step asc, lane
    asc) order.

A call codes a *batch* of independent streams -- the chunks of one
tensor -- together: one size pre-pass and one host sync for all of them,
a plane build whose compaction scatters by ranks into buffers the host
has already sized (no data-dependent sync), and one launch of the step
loop (:func:`rans_steps`) for every stream.  The step loop replaces the
Pallas kernel ``repro/kernels/rans_coder.py`` ``_rans_step_kernel``
(``_step_loop_pallas``).  Source: ``csrc/rans_coder.cu``
``repro_rans_step``.  On the card it is bound by the serial per-lane
chain; the kernel takes the loads off that chain (bits prefetched a
window ahead, probabilities once per 256-step segment) and replaces the
division by an exact reciprocal multiply (:func:`recip_div` is its
integer model).  Its plain torch version runs the same stream table one
stream at a time with int64 states (torch's uint32 support is thin).  A
CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.

Eager torch sizes every buffer exactly (the reference's power-of-two
buckets only bounded jit retraces); the bytes are the same.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np
import torch

from ..core import rans
from ..obs.metrics import default_registry
from ..obs.tracing import span
from . import _build

_PROB_BITS = 14
_M = 1 << _PROB_BITS
_CHUNK_STEPS = 256
_STATE_LO = 1 << 16
_HEADER_FMT = "<HI"
# stream table columns (csrc/rans_coder.cu): offset of the stream's
# (steps, lanes) matrices, offset and count of its probability segments,
# offset of its states, steps, lanes
TABLE_COLS = 6

# the device plane build keeps one cumulative count per TU plane; past
# this level count the host coder codes the stream inside the same
# coder-4 container (the wire format never depends on where it was coded)
MAX_DEVICE_LEVELS = 16
# entries of the size pre-pass's running counts at a time (int32): large
# streams take the thresholds a few at a time, small ones all at once
_COUNT_ELEMS = 1 << 24


def _d2h_counter():
    return default_registry().counter(
        "repro_codec_d2h_bytes_total",
        "bytes fetched device->host by the encode path (wire payloads, "
        "probability side info and state flushes on the device-entropy "
        "path; full packed-index tensors on the host-coder path)")


def device_supported(n: int, n_levels: int) -> bool:
    """Can the device stage code this stream (host coder otherwise)?"""
    return (2 <= n_levels <= MAX_DEVICE_LEVELS
            and n * (n_levels - 1) < (1 << 31) - 2)


# -- the exact reciprocal divide of the step loop -----------------------------

def recip_params(f: torch.Tensor):
    """(mh, ml): the 32-bit halves of ``m = ceil(2^63 / f)`` as int64,
    for integer ``f`` in [1, 2^14) (``f = 1`` gives m = 2^63)."""
    mm = torch.full_like(f, (1 << 63) - 1, dtype=torch.int64) \
        // f.to(torch.int64)                                     # m - 1
    ml = (mm & 0xFFFFFFFF) + 1
    return (mm >> 32) + (ml >> 32), ml & 0xFFFFFFFF


def _umulhi(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(a * b) >> 32`` of 32-bit unsigned values held in int64, with
    16-bit halves of ``a`` so no product leaves int64."""
    return ((a >> 16) * b + (((a & 0xFFFF) * b) >> 16)) >> 16


def recip_div(x: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """``x // f`` as the kernel computes it: ``(x * mh + umulhi(x, ml))
    >> 31`` with (mh, ml) from :func:`recip_params`, for 32-bit unsigned
    ``x`` and ``f`` in [1, 2^14).  It is ``floor(x * m / 2^63)``, exact
    because ``x * (f - 1) < 2^63``; every intermediate fits int64."""
    mh, ml = recip_params(f)
    x = x.to(torch.int64)
    return (x * mh + _umulhi(x, ml)) >> 31


# -- plain step loop ----------------------------------------------------------

def _round_half_even_div(ones: torch.Tensor,
                         sizes: torch.Tensor) -> torch.Tensor:
    """Exact ``rint(ones / sizes * 2^14)`` (float64 semantics) in int64.

    The quotient of the float path is at least 2^-21 away from any
    half-integer it is not exactly equal to (sizes <= 2^20), far beyond
    the float64 error, so exact rational rounding with ties to even is
    the same function."""
    t = ones.to(torch.int64) * _M
    s = sizes.to(torch.int64)
    q = t // s
    twice = 2 * (t - q * s)
    up = (twice > s) | ((twice == s) & ((q & 1) == 1))
    return q + up.to(torch.int64)


def rans_step_plain(bits2d: torch.Tensor, f1_steps: torch.Tensor,
                    lanes: int):
    """The reverse step loop of one stream with int64 states and a
    per-step probability.  Returns (states, overflow, words)."""
    n_steps = bits2d.shape[0]
    dev = bits2d.device
    x = torch.full((lanes,), _STATE_LO, dtype=torch.int64, device=dev)
    ov = torch.zeros((n_steps, lanes), dtype=torch.uint8, device=dev)
    w = torch.zeros((n_steps, lanes), dtype=torch.int64, device=dev)
    f1_all = f1_steps.to(torch.int64)
    for t in range(n_steps - 1, -1, -1):
        f1 = f1_all[t]
        f0 = _M - f1
        b = bits2d[t].to(torch.int64)
        f = torch.where(b == 1, f1, f0)
        over = x >= (f << (32 - _PROB_BITS))
        w[t] = x & 0xFFFF
        ov[t] = over
        x = torch.where(over, x >> 16, x)
        q = x // f
        x = (q << _PROB_BITS) + (x - q * f) + f0 * b
    return x, ov, w


def rans_steps_plain(bits: torch.Tensor, segs: torch.Tensor,
                     table: torch.Tensor, n_states: int, n_cells: int):
    """Plain torch version of :func:`rans_steps`: each stream of the
    table in turn through :func:`rans_step_plain`, its segments expanded
    to per-step probabilities.  States and words come back as int64
    values."""
    dev = bits.device
    x_all = torch.zeros(n_states, dtype=torch.int64, device=dev)
    ov_all = torch.zeros(n_cells, dtype=torch.uint8, device=dev)
    w_all = torch.zeros(n_cells, dtype=torch.int64, device=dev)
    segs_h = segs.cpu().to(torch.int64)
    for mat, s0, ns, st, steps, lanes in table.tolist():
        sg = segs_h[s0:s0 + ns]
        ends = torch.cat([sg[1:, 0], torch.tensor([steps])])
        f1_steps = torch.repeat_interleave(sg[:, 1], ends - sg[:, 0])
        cells = slice(mat, mat + steps * lanes)
        x, ov, w = rans_step_plain(bits[cells].reshape(steps, lanes),
                                   f1_steps.to(dev), lanes)
        x_all[st:st + lanes] = x
        ov_all[cells] = ov.reshape(-1)
        w_all[cells] = w.reshape(-1)
    return x_all, ov_all, w_all


# -- the kernel ---------------------------------------------------------------

def rans_steps(bits: torch.Tensor, segs: torch.Tensor, table: torch.Tensor,
               n_states: int, n_cells: int, max_lanes: int):
    """Reverse interleaved rANS over a batch of streams in one launch.

    ``bits``: uint8, the streams' (steps, lanes) bit matrices
    concatenated (row-major, at the table's offsets); ``segs``: int32
    (n_seg, 2), per probability segment its first step (within its
    stream) and its f1, ascending and non-empty within a stream;
    ``table``: int64 (n_streams, :data:`TABLE_COLS`).  ``n_states``,
    ``n_cells`` and ``max_lanes`` are the host's sizes of the outputs and
    the widest stream.

    Returns (states (n_states,), overflow (n_cells,) uint8, words
    (n_cells,)): final lane states, per-step renorm flags and every
    step's pre-renorm low 16 bits, in the matrices' layout.  The kernel
    returns states as int32 and words as int16 holding the uint32 /
    uint16 bit patterns (torch's unsigned types lack indexing ops); the
    plain version returns both as int64 values."""
    if bits.device.type == "cpu":
        return rans_steps_plain(bits, segs, table, n_states, n_cells)
    if bits.device.type != "cuda":
        raise ValueError(f"unsupported device {bits.device}")
    _build.check_cuda("bits", bits, (torch.uint8,), ndim=1)
    _build.check_cuda("segs", segs, (torch.int32,), ndim=2)
    _build.check_cuda("table", table, (torch.int64,), ndim=2)
    if segs.shape[1] != 2 or table.shape[1] != TABLE_COLS:
        raise ValueError("segs must be (n, 2) and table (n, "
                         f"{TABLE_COLS})")
    dev = bits.device
    states = torch.empty(n_states, dtype=torch.int32, device=dev)
    ov = torch.empty(n_cells, dtype=torch.uint8, device=dev)
    w = torch.empty(n_cells, dtype=torch.int16, device=dev)
    _build.launch("rans_step", "repro_rans_step", bits.data_ptr(),
                  segs.data_ptr(), table.data_ptr(), table.shape[0],
                  max_lanes, states.data_ptr(), ov.data_ptr(), w.data_ptr())
    return states, ov, w


def rans_step(bits2d: torch.Tensor, f1_steps: torch.Tensor, lanes: int):
    """One stream with a per-step probability: the one-stream case of
    :func:`rans_steps` (each step its own segment).  Returns (states
    (lanes,), overflow (steps, lanes), words (steps, lanes))."""
    n_steps = bits2d.shape[0]
    if bits2d.dim() != 2 or bits2d.shape[1] != lanes \
            or f1_steps.shape != (n_steps,):
        raise ValueError("step matrix, probabilities and lanes disagree")
    dev = bits2d.device
    segs = torch.stack([torch.arange(n_steps, device=dev),
                        f1_steps.to(device=dev, dtype=torch.int64)],
                       1).to(torch.int32)
    table = torch.tensor([[0, 0, n_steps, 0, n_steps, lanes]],
                         dtype=torch.int64, device=dev)
    x, ov, w = rans_steps(bits2d.reshape(-1), segs, table, lanes,
                          n_steps * lanes, lanes)
    return x, ov.reshape(n_steps, lanes), w.reshape(n_steps, lanes)


# -- host side of a batch -----------------------------------------------------

def _upload(arrays: dict, device) -> dict:
    """Host int64 arrays -> device tensors in one copy (pinned and
    asynchronous on the card, so it waits for nothing)."""
    flat = np.concatenate([np.asarray(a, np.int64).reshape(-1)
                           for a in arrays.values()])
    t = torch.from_numpy(flat)
    if torch.device(device).type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    out, at = {}, 0
    for k, a in arrays.items():
        a = np.asarray(a)
        out[k] = t[at:at + a.size].reshape(a.shape)
        at += a.size
    return out


def _plane_sizes_batch(cat: torch.Tensor, ends: list[int],
                       n_levels: int) -> list[list[int]]:
    """Plane sizes of every stream in one pass and one host sync.

    ``cat`` holds the streams' indices back to back, stream ``s`` ending
    at ``ends[s]``.  Returns ``sizes[s][j] = #{i in s : cat[i] >= j}`` for
    j < N-1, trailing empty planes dropped (the host coder skips them).
    The running counts of ``cat >= j`` are taken a few thresholds at a
    time, so they never hold more than :data:`_COUNT_ELEMS` entries."""
    dev = cat.device
    n = int(cat.shape[0])
    at = _upload({"ends": np.asarray(ends) - 1}, dev)["ends"]
    per = max(1, _COUNT_ELEMS // max(n, 1))
    tot = [torch.zeros((n_levels - 1, 1), dtype=torch.int32, device=dev)]
    for j0 in range(1, n_levels, per):
        jv = torch.arange(j0, min(j0 + per, n_levels), device=dev,
                          dtype=cat.dtype)
        tot.append(torch.cumsum(cat[None, :] >= jv[:, None], 1,
                                dtype=torch.int32)[:, at])
    tot = torch.cat([tot[0], torch.cat(tot[1:])], 1)
    above = torch.diff(tot, dim=1).T.tolist()          # (streams, N-1)
    starts = [0] + list(ends[:-1])
    sizes = []
    for s, row in enumerate(above):
        sz = [ends[s] - starts[s]] + row[:n_levels - 2]
        while sz and sz[-1] == 0:
            sz.pop()
        sizes.append(sz)
    return sizes


class _Layout(NamedTuple):
    """Host layout of one batch (see :func:`_layout`)."""

    table: np.ndarray         # the stream table (TABLE_COLS per stream)
    arrays: dict              # host int64 arrays to upload
    n_cells: int              # entries of the concatenated matrices
    n_segs: int
    n_planes: int             # planes of the deepest stream

    @property
    def lanes(self) -> list[int]:
        return self.table[:, 5].tolist()


def _layout(sizes: list[list[int]], lengths: list[int]) -> _Layout:
    """Offsets of every stream's matrices, segments and states, and the
    plane build's per-stream tables, from the plane sizes alone."""
    ns = len(sizes)
    n_planes = max(len(sz) for sz in sizes)
    lanes = [rans.lane_count(sum(sz)) for sz in sizes]
    table = np.zeros((ns, TABLE_COLS), np.int64)
    seg_start, csize = [], []
    delta = np.zeros((n_planes, ns), np.int64)
    bounds = [[] for _ in range(n_planes)]     # survivor ranks per entry
    entry = [[] for _ in range(n_planes)]      # their segment indices
    pad_pos, pad_seg = [], []
    before = [0] * n_planes                    # survivors of earlier streams
    mat = n_st = 0
    for s, sz in enumerate(sizes):
        ln = lanes[s]
        cb = _CHUNK_STEPS * ln
        s0 = len(seg_start)
        step = 0
        for j, size in enumerate(sz):
            steps = -(-size // ln)
            base = mat + step * ln
            # the survivor of global rank g (0-based) lands at base + g -
            # before[j]; the build adds delta to its 1-based running count
            delta[j, s] = base - before[j] - 1
            for k in range(-(-size // cb)):
                bounds[j].append(before[j] + k * cb)
                entry[j].append(len(seg_start))
                seg_start.append(step + k * _CHUNK_STEPS)
                csize.append(min(cb, size - k * cb))
            pad_pos.append(np.arange(base + size, base + steps * ln))
            pad_seg.append(np.full(steps * ln - size, len(seg_start) - 1))
            before[j] += size
            step += steps
        table[s] = (mat, s0, len(seg_start) - s0, n_st, step, ln)
        mat += step * ln
        n_st += ln
    arrays = {"table": table, "seg_start": seg_start, "csize": csize,
              "delta": delta, "lengths": lengths,
              "pad_pos": np.concatenate(pad_pos),
              "pad_seg": np.concatenate(pad_seg),
              # last cell of each stream: its word count's cumsum index
              "mat_last": table[:, 0] + table[:, 4] * table[:, 5] - 1}
    for j in range(n_planes):
        arrays[f"bounds{j}"] = bounds[j] + [before[j]]
        arrays[f"entry{j}"] = entry[j]
    return _Layout(table, arrays, mat, len(seg_start), n_planes)


class _Batch(NamedTuple):
    """The step loop's inputs for a batch of streams, and their layout."""

    bits: torch.Tensor        # uint8 matrices (+ one dump byte)
    segs: torch.Tensor        # int32 (n_seg, 2): first step, f1
    table: torch.Tensor       # int64 (n_streams, TABLE_COLS)
    mat_last: torch.Tensor    # int64 (n_streams,) last cell of each stream
    lay: _Layout


def _plane_batch(cat: torch.Tensor, lengths: list[int],
                 n_levels: int) -> _Batch:
    """Device mirror of ``index_to_context_bits`` + ``rans._plane_setup``
    for every stream of ``cat`` (indices back to back, ``lengths`` each,
    none empty) at once.

    Plane j keeps the indices ``>= j`` in order and codes ``idx > j``.
    With every stream's plane sizes known on the host after one sync, an
    index's place in its plane is its running survivor count plus a
    per-stream offset, so each plane is one scatter into a buffer of
    known size (the indices a plane drops all go to one dump byte past
    the matrices), and each segment's count of ones is a difference of
    running counts at host-known ranks.  The planes are built one at a
    time: plane j's running count of ones is plane j+1's survivor count,
    so the build holds two int32 running counts, not one per plane."""
    dev = cat.device
    n = int(cat.shape[0])
    sizes = _plane_sizes_batch(cat, np.cumsum(lengths).tolist(), n_levels)
    lay = _layout(sizes, lengths)
    d = _upload(lay.arrays, dev)
    cid = torch.repeat_interleave(
        torch.arange(len(lengths), device=dev, dtype=torch.int32),
        d["lengths"], output_size=n)
    bits = torch.empty(lay.n_cells + 1, dtype=torch.uint8, device=dev)
    ones = torch.zeros(lay.n_segs, dtype=torch.int64, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    alive = torch.arange(1, n + 1, dtype=torch.int32, device=dev)
    for j in range(lay.n_planes):
        one = cat > j
        run = torch.cumsum(one, 0, dtype=torch.int32)   # ones so far
        dest = d["delta"][j][cid]
        dest += alive
        if j > 0:
            dest.masked_fill_(cat < j, lay.n_cells)
        bits.scatter_(0, dest, one.view(torch.uint8))
        # ones among the first g survivors, at every segment bound g
        g = d[f"bounds{j}"]
        at = torch.searchsorted(alive, g.to(torch.int32)).clamp_(max=n - 1)
        c1 = torch.where(g == 0, zero, run[at].to(torch.int64))
        ones[d[f"entry{j}"]] = torch.diff(c1)
        alive = run
    f1 = torch.clamp(_round_half_even_div(ones, d["csize"]), 1, _M - 1)
    bits[d["pad_pos"]] = (f1[d["pad_seg"]] >= _M // 2).to(torch.uint8)
    segs = torch.stack([d["seg_start"], f1], 1).to(torch.int32)
    return _Batch(bits, segs, d["table"], d["mat_last"], lay)


class _Pending(NamedTuple):
    """A launched batch: per chunk its stream (None: empty chunk)."""

    streams: list
    batch: _Batch | None
    out: tuple | None         # (states, overflow, words)


def _dispatch(coded: torch.Tensor, n_levels: int, bounds) -> _Pending:
    """Size pre-pass, plane build and one step-loop launch for every
    non-empty chunk range of ``coded``."""
    spans = [(s, e) for s, e in bounds if e > s]
    it = iter(range(len(spans)))
    streams = [next(it) if e > s else None for s, e in bounds]
    if not spans:
        return _Pending(streams, None, None)
    if all(spans[i][1] == spans[i + 1][0] for i in range(len(spans) - 1)):
        cat = coded[spans[0][0]:spans[-1][1]]
    else:
        cat = torch.cat([coded[s:e] for s, e in spans])
    batch = _plane_batch(cat, [e - s for s, e in spans], n_levels)
    lay = batch.lay
    out = rans_steps(batch.bits, batch.segs, batch.table, sum(lay.lanes),
                     lay.n_cells, max(lay.lanes))
    # the bit matrices are not read past the launch: let the allocator
    # reuse them (stream-ordered) while the batch waits to be finalized
    return _Pending(streams, batch._replace(bits=None), out)


def _finalize(p: _Pending) -> list[bytes]:
    """Compact the words, fetch, assemble one blob per chunk (the empty
    stream's blob for an empty chunk)."""
    empty = struct.pack(_HEADER_FMT, 0, 0)
    if p.batch is None:
        return [empty for _ in p.streams]
    lay = p.batch.lay
    x, ov, w = p.out
    with span("wire_d2h", streams=len(lay.table)):
        # the cells that emitted a word, in (step asc, lane asc) order
        # within each stream, the streams back to back -- the host coder's
        # w_rows[over_rows]; a stream's words end at its last cell's rank
        at = torch.nonzero(ov).squeeze(1)
        ends = torch.searchsorted(at, p.batch.mat_last, right=True)
        host = torch.cat([p.batch.segs[:, 1].to(torch.int64),
                          x.to(torch.int64), ends]).cpu().numpy()
        words_h = w[at].cpu().numpy()
    n_st = int(lay.table[:, 5].sum())
    ftab_h = host[:lay.n_segs]
    x_h = host[lay.n_segs:lay.n_segs + n_st]
    w_end = host[lay.n_segs + n_st:]
    blobs = []
    for s, (_, s0, ns_, st, _, lanes) in enumerate(lay.table.tolist()):
        # astype wraps the signed bit-pattern containers to their unsigned
        # values, and is exact for the plain version's int64 values
        blob = (struct.pack(_HEADER_FMT, lanes, ns_)
                + ftab_h[s0:s0 + ns_].astype("<u2").tobytes()
                + x_h[st:st + lanes].astype("<u4").tobytes()
                + words_h[w_end[s - 1] if s else 0:w_end[s]]
                .astype("<u2").tobytes())
        _d2h_counter().inc(len(blob))
        blobs.append(blob)
    return [empty if s is None else blobs[s] for s in p.streams]


def _flat_indices(coded) -> torch.Tensor:
    if not isinstance(coded, torch.Tensor):
        from ..core.backend import host_tensor
        coded = host_tensor(coded)
    return coded.reshape(-1).to(torch.int32)


def encode_planes_device(coded, n_levels: int) -> bytes:
    """Device-coded rANS blob, byte-identical to
    ``rans.encode_planes(index_to_context_bits(coded, n_levels))``."""
    coded = _flat_indices(coded)
    n = int(coded.shape[0])
    with span("device_entropy", n_elems=n):
        pending = _dispatch(coded, n_levels, [(0, n)])
    return _finalize(pending)[0]


def _host_blob(host: np.ndarray, n_levels: int) -> bytes:
    from ..core.binarization import index_to_context_bits
    return rans.encode_planes(index_to_context_bits(host, n_levels))


def encode_indices_device(coded, n_levels: int) -> bytes:
    """Full coder-id-4 payload for one coded-order index vector.

    Container bytes match host coder id 2 at one shard past the id
    byte; shapes the device stage does not take are host-coded into the
    same container, so the wire format never depends on where the blob
    was coded.
    """
    coded = _flat_indices(coded)
    return encode_index_chunks_device(coded, n_levels,
                                      [(0, int(coded.shape[0]))])[0]


def encode_index_chunks_device(coded, n_levels: int, bounds) -> list[bytes]:
    """Coder-id-4 payloads for each chunk range, dispatch-all then
    finalize-all."""
    return finalize_index_chunks(dispatch_index_chunks(coded, n_levels,
                                                       bounds))


def dispatch_index_chunks(coded, n_levels: int, bounds):
    """Launch phase of :func:`encode_index_chunks_device`: one size
    pre-pass, plane build and step-loop launch for every chunk, returning
    an opaque pending batch.  Shapes the device stage does not take are
    host-coded inline (the pending batch then holds finished payloads)."""
    from ..core import cabac
    coded = _flat_indices(coded)
    n = int(coded.shape[0])
    if not device_supported(n, n_levels):
        host = coded.cpu().numpy()
        return ("host", [cabac.wrap_device_blob(
            b"" if s >= e else _host_blob(host[s:e], n_levels))
            for s, e in bounds])
    with span("device_entropy", chunks=len(bounds)):
        return ("dev", _dispatch(coded, n_levels, bounds))


def finalize_index_chunks(pending) -> list[bytes]:
    """Drain phase of :func:`dispatch_index_chunks`: fetch every chunk's
    coded bytes and assemble coder-id-4 payloads, in chunk order."""
    from ..core import cabac
    kind, p = pending
    if kind == "host":
        return p
    return [cabac.wrap_device_blob(b"" if s is None else blob)
            for s, blob in zip(p.streams, _finalize(p))]
