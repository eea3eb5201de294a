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

The step loop (:func:`rans_step`) replaces the Pallas kernel
``repro/kernels/rans_coder.py`` ``_rans_step_kernel``
(``_step_loop_pallas``).  Source: ``csrc/rans_coder.cu``
``repro_rans_step``.  On the card it is bound by the serial per-lane
chain (a 32-bit division per step); one thread per lane runs every step
of its lane with the state in a register, one launch per stream.  Its
plain torch version runs the states in int64 (torch's uint32 support is
thin).  A CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises.

Eager torch sizes every buffer exactly (the reference's power-of-two
buckets only bounded jit retraces); the bytes are the same.
"""

from __future__ import annotations

import struct

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

# the device plane build materializes one compacted array per TU plane;
# past this level count the host coder codes the stream inside the same
# coder-4 container (the wire format never depends on where it was coded)
MAX_DEVICE_LEVELS = 16


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


def _plane_sizes(coded: torch.Tensor, n_levels: int) -> list[int]:
    """Per-plane element counts: ``sizes[j] = #{i : coded[i] >= j}``.

    The only data-dependent scalars the host needs: their sum picks the
    lane count, and each sizes its plane's buffers."""
    jv = torch.arange(n_levels - 1, device=coded.device, dtype=coded.dtype)
    return (coded[None, :] >= jv[:, None]).sum(1).tolist()


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


def _build_planes(coded: torch.Tensor, sizes: list[int], lanes: int):
    """Device mirror of ``index_to_context_bits`` + ``rans._plane_setup``.

    ``sizes`` are the non-empty planes' element counts.  Returns the
    (total_steps, lanes) uint8 step matrix, the (total_steps,) int32
    per-step probability and the int32 probability table."""
    dev = coded.device
    chunk_bits = _CHUNK_STEPS * lanes
    rows, f1s, ftabs = [], [], []
    cur = coded
    for j, size in enumerate(sizes):
        b = cur > j                      # plane j: one bit per survivor
        steps = -(-size // lanes)
        nch = -(-size // chunk_bits)
        bi = torch.zeros(nch * chunk_bits, dtype=torch.int64, device=dev)
        bi[:size] = b
        ones = bi.reshape(nch, chunk_bits).sum(1)
        csize = torch.clamp(
            size - torch.arange(nch, device=dev) * chunk_bits,
            max=chunk_bits)
        f1 = torch.clamp(_round_half_even_div(ones, csize), 1, _M - 1)
        mps = (f1[-1] >= _M // 2).to(torch.uint8)
        vec = mps.repeat(steps * lanes)
        vec[:size] = b
        rows.append(vec.reshape(steps, lanes))
        f1s.append(f1.repeat_interleave(_CHUNK_STEPS)[:steps])
        ftabs.append(f1)
        if j + 1 < len(sizes):
            cur = cur[b]                 # plane j's ones are j+1's alive set
    return (torch.cat(rows), torch.cat(f1s).to(torch.int32),
            torch.cat(ftabs).to(torch.int32))


def rans_step_plain(bits2d: torch.Tensor, f1_steps: torch.Tensor,
                    lanes: int):
    """Plain torch version of :func:`rans_step`: the reverse step loop
    with int64 states.  Returns (states, overflow, words)."""
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


def rans_step(bits2d: torch.Tensor, f1_steps: torch.Tensor, lanes: int):
    """Reverse interleaved rANS over a (total_steps, lanes) uint8 bit
    matrix with per-step int32 probabilities ``f1_steps``.

    Returns (states (lanes,), overflow (total_steps, lanes) uint8, words
    (total_steps, lanes)): final lane states, the per-step renorm flags
    and every step's pre-renorm low 16 bits.  The kernel returns states
    as int32 and words as int16 holding the uint32 / uint16 bit patterns
    (torch's unsigned types lack indexing ops); the plain version returns
    both as int64 values."""
    if bits2d.device.type == "cpu":
        return rans_step_plain(bits2d, f1_steps, lanes)
    if bits2d.device.type != "cuda":
        raise ValueError(f"unsupported device {bits2d.device}")
    _build.check_cuda("bits2d", bits2d, (torch.uint8,), ndim=2)
    _build.check_cuda("f1_steps", f1_steps, (torch.int32,), ndim=1)
    n_steps = bits2d.shape[0]
    if bits2d.shape[1] != lanes or f1_steps.shape[0] != n_steps:
        raise ValueError("step matrix, probabilities and lanes disagree")
    dev = bits2d.device
    states = torch.empty(lanes, dtype=torch.int32, device=dev)
    ov = torch.empty((n_steps, lanes), dtype=torch.uint8, device=dev)
    w = torch.empty((n_steps, lanes), dtype=torch.int16, device=dev)
    _build.launch("rans_step", "repro_rans_step", bits2d.data_ptr(),
                  f1_steps.data_ptr(), n_steps, lanes, states.data_ptr(),
                  ov.data_ptr(), w.data_ptr())
    return states, ov, w


def _dispatch(coded: torch.Tensor, n_levels: int):
    """Size pre-pass, plane build and step-loop launch for one stream.

    Returns the pending device buffers plus the host-side layout, or
    None for an empty stream."""
    n = int(coded.shape[0])
    if n == 0 or n_levels < 2:
        return None
    sizes = _plane_sizes(coded, n_levels)
    lanes = rans.lane_count(sum(sizes))
    while sizes and sizes[-1] == 0:      # host coder skips empty planes
        sizes.pop()
    bits2d, f1_steps, ftab = _build_planes(coded, sizes, lanes)
    x, ov, w = rans_step(bits2d, f1_steps, lanes)
    return lanes, ftab, x, ov, w


def _compact_words(ov: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Emitted words in (step asc, lane asc) order -- the host coder's
    ``w_rows[over_rows]``."""
    return w.reshape(-1)[ov.reshape(-1).to(torch.bool)]


def _finalize(pending) -> bytes:
    """Compact the words, fetch, assemble the blob."""
    if pending is None:
        return struct.pack(_HEADER_FMT, 0, 0)
    lanes, ftab, x, ov, w = pending
    with span("wire_d2h", lanes=lanes):
        words_h = _compact_words(ov, w).cpu().numpy()
        ftab_h = ftab.cpu().numpy()
        x_h = x.cpu().numpy()
    # astype wraps the signed bit-pattern containers to their unsigned
    # values, and is exact for the plain version's int64 values
    blob = (struct.pack(_HEADER_FMT, lanes, ftab_h.size)
            + ftab_h.astype("<u2").tobytes()
            + x_h.astype("<u4").tobytes()
            + words_h.astype("<u2").tobytes())
    _d2h_counter().inc(len(blob))
    return blob


def _flat_indices(coded) -> torch.Tensor:
    if not isinstance(coded, torch.Tensor):
        from ..core.backend import host_tensor
        coded = host_tensor(coded)
    t = coded
    return t.reshape(-1).to(torch.int32)


def encode_planes_device(coded, n_levels: int) -> bytes:
    """Device-coded rANS blob, byte-identical to
    ``rans.encode_planes(index_to_context_bits(coded, n_levels))``."""
    coded = _flat_indices(coded)
    with span("device_entropy", n_elems=int(coded.shape[0])):
        pending = _dispatch(coded, n_levels)
    return _finalize(pending)


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
    from ..core import cabac
    coded = _flat_indices(coded)
    n = int(coded.shape[0])
    if n == 0:
        return cabac.wrap_device_blob(b"")
    if not device_supported(n, n_levels):
        blob = _host_blob(coded.cpu().numpy(), n_levels)
    else:
        blob = encode_planes_device(coded, n_levels)
    return cabac.wrap_device_blob(blob)


def encode_index_chunks_device(coded, n_levels: int, bounds) -> list[bytes]:
    """Coder-id-4 payloads for each chunk range, dispatch-all then
    finalize-all."""
    return finalize_index_chunks(dispatch_index_chunks(coded, n_levels,
                                                       bounds))


def dispatch_index_chunks(coded, n_levels: int, bounds):
    """Launch phase of :func:`encode_index_chunks_device`: launch every
    chunk's entropy stage and return an opaque pending list.  Shapes the
    device stage does not take are host-coded inline (their pending
    entries are already-finished payloads)."""
    from ..core import cabac
    coded = _flat_indices(coded)
    n = int(coded.shape[0])
    if not device_supported(n, n_levels):
        host = coded.cpu().numpy()
        return [("host", cabac.wrap_device_blob(
            b"" if s >= e else _host_blob(host[s:e], n_levels)))
            for s, e in bounds]
    with span("device_entropy", chunks=len(bounds)):
        return [("dev", None) if s >= e else
                ("dev", _dispatch(coded[s:e], n_levels))
                for s, e in bounds]


def finalize_index_chunks(pending) -> list[bytes]:
    """Drain phase of :func:`dispatch_index_chunks`: fetch each chunk's
    coded bytes (in order) and assemble coder-id-4 payloads."""
    from ..core import cabac
    out = []
    for kind, p in pending:
        if kind == "host":
            out.append(p)
        else:
            out.append(cabac.wrap_device_blob(
                b"" if p is None else _finalize(p)))
    return out
