"""QuantBackend: one dispatch point for every quantization primitive.

``FeatureCodec`` (and everything above it: the serving engine, the
launchers) routes through a backend object, so the hot path picks the
hand-written CUDA kernels on the card and the plain torch reference on
the CPU, from a single code path.

Backends implement nine primitives over a :class:`QuantSpec`:

    quantize(x, spec)             -> int32 indices
    dequantize(idx, spec, dtype)  -> reconstructed values
    quantize_dequantize(x, spec)  -> (indices, reconstruction)  [fused]
    quantize_with_histogram(x, spec, want_deq)
                                  -> (indices, reconstruction | None,
                                      (n_levels,) counts | None)  [fused]
    quantize_packed_with_histogram(x, spec, bits)
                                  -> (uint8 wire bytes, counts)  [fused]
    histogram(idx, n_levels)      -> (n_levels,) int32 counts
    tile_histogram(idx, spec)     -> (n_cgroups, n_sblocks, N) counts
    pack_indices(idx, bits)       -> uint8 wire bytes (in-graph pack)
    encode_fused(x, spec, bits)   -> (coded-order indices, per-tile hists)

``quantize_with_histogram`` is the in-graph rate path's single-pass
contract: for a spec of at most
:data:`~repro_torch.kernels.rate_hist.MAX_LEVELS` levels, per tensor
(uniform or ECSQ) or uniform under a plan the per-tile quantizer's fast
route takes (channels last, one spatial block, channel groups of 8-256),
the CUDA backend's one quantizer launch also counts the indices -- (N,),
or (n_cgroups, 1, N) per tile -- and writes no reconstruction unless
asked; every other spec
returns ``None`` for the counts, decided from the spec before any
launch, and its caller histograms the indices itself.  The torch
backend makes the same choice.  ``quantize_packed_with_histogram`` goes
one step further for the packed transport: for those specs at a wire
width of 1, 2 or 4 bits (:func:`packs_in_quantizer`) the same launch
writes the indices as wire bytes instead of int32, so no pack runs
after it; other specs raise.  ``quantize`` writes no reconstruction on
any spec.

``encode_fused`` is the host encode path's single-pass contract: on the
CUDA backend one fused megakernel pass (clip -> quantize -> bit-pack ->
per-tile histogram) produces wire-width packed bytes plus tile index
counts, so exactly one device->host transfer feeds the entropy stage.
The torch backend fulfils the same contract with its vectorized
formulas.  Both return bit-identical coded-order indices, which keeps
the entropy payload byte-identical to the unfused reference path.

``encode_fused(..., emit_wire=True)`` moves the *entropy stage itself*
onto the tensor's device: quantize, coded-order permute and the
interleaved-rANS bit-plane coder (:mod:`repro_torch.kernels.rans_coder`)
run there, and the call returns ``(payload, None)`` where ``payload`` is
a finished coder-id-4 bitstream (or a list of per-chunk payloads when
``chunk_bounds`` is given).  Payloads are byte-identical to the host
coder id 2 single-shard stream past the id byte; level counts above
:data:`~repro_torch.kernels.rans_coder.MAX_DEVICE_LEVELS` are host-coded
inside the same container.  ``want_hist`` is incompatible with
``emit_wire``.

Selection: ``get_backend()`` with no name is the CUDA backend, and it
raises where no CUDA device exists; ``get_backend("torch")`` (or
``CodecConfig(backend="torch")``) is the CPU reference.

Granularity is a :class:`~repro_torch.core.tiling.TilePlan`: ``spec.plan
is None`` with scalar cmin/cmax is the paper's per-tensor mode; a plan
makes cmin/cmax (n_cgroups, n_sblocks) per-tile tables over the
channel-major view.  The legacy per-channel spec form -- (C,) vectors
plus ``channel_axis`` -- is normalized into a one-spatial-block plan on
entry.  Both backends cover every plan and ECSQ form, and the in-graph
pack: the CUDA backend packs 1/2/4-bit indices with the pack kernel.
Dequantize-only calls (receiver side) use the torch formula on the
tensor's device in both backends -- the reference has no kernel there
either -- and so do level counts above a kernel's table width and pack
widths of one index per byte, exactly where the reference falls back
to jnp.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..obs.tracing import tracer
from . import uniform
from .tiling import TileECSQ, TilePlan

_CHANNEL_EPS = 1e-12  # degenerate-range guard, shared with the tile kernel


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Everything a backend needs to quantize one tensor.

    ``cmin``/``cmax`` are floats (per-tensor), (C,) arrays broadcast
    along ``channel_axis`` (legacy per-channel form), or
    (n_cgroups, n_sblocks) per-tile tables when ``plan`` is set.
    ``ecsq`` optionally carries a designed non-uniform quantizer: an
    ``ECSQQuantizer`` (per-tensor) or a ``TileECSQ`` (per-tile, with
    ``plan``).
    """

    cmin: Any
    cmax: Any
    n_levels: int
    channel_axis: int | None = None
    ecsq: Any = None
    plan: TilePlan | None = None

    @property
    def per_channel(self) -> bool:
        return self.channel_axis is not None or self.plan is not None


def _normalize(spec: QuantSpec) -> QuantSpec:
    """Fold the legacy (C,)-vector per-channel form into a TilePlan, and
    reject spec combinations that would otherwise be silently ignored."""
    if spec.plan is not None or spec.channel_axis is not None:
        if spec.ecsq is not None and not isinstance(spec.ecsq, TileECSQ):
            raise ValueError(
                "a tiled QuantSpec needs per-tile TileECSQ tables; a "
                "per-tensor ECSQQuantizer cannot be combined with a "
                "plan or channel_axis")
    if spec.plan is not None:
        return spec
    if spec.channel_axis is None:
        return spec
    lo = np.asarray(spec.cmin, np.float32).reshape(-1, 1)
    hi = np.asarray(spec.cmax, np.float32).reshape(-1, 1)
    plan = TilePlan(channel_axis=spec.channel_axis, channel_group_size=1,
                    spatial_block_size=0, n_channels=lo.shape[0])
    return dataclasses.replace(spec, cmin=lo, cmax=hi, plan=plan)


def host_tensor(a, dtype=None, device=None) -> torch.Tensor:
    """Host array -> tensor (on ``device``), copying read-only or
    non-contiguous buffers (e.g. header tables read with frombuffer)."""
    arr = np.require(np.asarray(a, dtype), requirements=["C", "W"])
    return torch.as_tensor(arr, device=device)


def _div(num, den: torch.Tensor) -> torch.Tensor:
    """Correctly rounded elementwise divide against a full-shape operand
    (torch may turn a division by a scalar into a reciprocal multiply)."""
    if not isinstance(num, torch.Tensor):
        return torch.full_like(den, float(num)) / den
    return num / torch.broadcast_to(den, num.shape).contiguous()


def _tile_tables(shape, spec: QuantSpec, device):
    """Per-element (C, M) range views for a plan spec over ``shape``.

    Returns (axis, C, M, lo, hi) with lo/hi broadcastable against the
    channel-major (C, M) view: (C, 1) for one spatial block, full (C, M)
    gathers otherwise.
    """
    plan = spec.plan
    axis, c, m = plan.resolve(tuple(shape))
    shape2 = (plan.n_cgroups, plan.n_sblocks)
    lo = host_tensor(spec.cmin, np.float32, device).reshape(shape2)
    hi = host_tensor(spec.cmax, np.float32, device).reshape(shape2)
    cg = torch.as_tensor(plan.cgroup_ids(), device=device).long()
    if plan.n_sblocks == 1:
        return axis, c, m, lo[cg], hi[cg]          # (C, 1) broadcast
    sb = torch.as_tensor(plan.sblock_ids(m), device=device).long()
    return axis, c, m, lo[cg][:, sb], hi[cg][:, sb]


def _restore(a: torch.Tensor, shape, axis: int, c: int, dtype):
    """(C, M) channel-major view -> tensor layout ``shape``."""
    moved = (c,) + tuple(s for d, s in enumerate(shape) if d != axis)
    return torch.movedim(a.reshape(moved), 0, axis).to(dtype)


def _coded_order(idx: np.ndarray, spec: QuantSpec) -> np.ndarray:
    """Flat coded-order view of quantizer indices (tile-major for plans)."""
    if spec.plan is not None:
        return spec.plan.to_coded_order(idx)
    return np.asarray(idx).ravel()


def _coded_order_device(q: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Device mirror of :func:`_coded_order`: coded-order indices with no
    host round-trip (the spatial permutation is a gather)."""
    plan = spec.plan
    if plan is None:
        return q.reshape(-1)
    axis, c, m = plan.resolve(tuple(q.shape))
    rows = torch.movedim(q, axis, 0).reshape(c, m)
    perm = plan.spatial_perm(m)
    if perm is not None:
        rows = rows[:, torch.from_numpy(perm.copy()).to(q.device)]
    return rows.reshape(-1)


def _unpack_bytes_device(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """Device mirror of ``ops.unpack_bytes`` (uint8 -> int32 indices)."""
    per = 8 // bits if bits in (1, 2, 4) else 1
    if per == 1:
        return packed.to(torch.int32)
    shifts = (torch.arange(per, device=packed.device) * bits)[None, :]
    vals = (packed.reshape(-1, 1).to(torch.int32) >> shifts) \
        & ((1 << bits) - 1)
    return vals.reshape(tuple(packed.shape[:-1]) + (-1,)).to(torch.int32)


def _unpack_layout_device(idx2d: torch.Tensor, lay) -> torch.Tensor:
    """Device mirror of ``PaddedLayout.unpack_indices``: strip the
    megakernel's padded (rows, cols) view down to flat coded order."""
    idx2d = idx2d.reshape(lay.rows, lay.cols)
    if lay.flat_n is not None:
        return idx2d.reshape(-1)[:lay.flat_n]
    if lay.band_valid is not None:
        cols = torch.as_tensor(lay.coded_cols(), device=idx2d.device)
        return idx2d[:lay.ch][:, cols].reshape(-1)
    a = idx2d[:lay.ch].reshape(lay.ch, lay.n_sblocks, lay.sb_cols)
    a = a[:, :, :lay.bs].reshape(lay.ch, -1)[:, :lay.m]
    return a.reshape(-1)


def _encode_wire(coded: torch.Tensor, spec: QuantSpec, chunk_bounds):
    """Device entropy stage: coded-order indices (on the device) ->
    finished coder-id-4 payload bytes (one, or one per chunk range)."""
    from ..kernels import rans_coder
    if chunk_bounds is None:
        return rans_coder.encode_indices_device(coded, spec.n_levels)
    return rans_coder.encode_index_chunks_device(coded, spec.n_levels,
                                                 list(chunk_bounds))


def _tile_hists_np(coded: np.ndarray, spec: QuantSpec) -> np.ndarray:
    """Host per-tile histograms from coded-order indices:
    (n_cgroups, n_sblocks, N); (1, 1, N) for per-tensor specs."""
    n = spec.n_levels
    if spec.plan is None:
        return np.bincount(coded, minlength=n).reshape(1, 1, n) \
            .astype(np.int32)
    plan = spec.plan
    c = plan.n_channels
    m = coded.size // max(c, 1)
    arr = coded.reshape(c, m)
    gc = plan.channel_group_size
    bounds = plan.coded_band_bounds(m)
    out = np.zeros((plan.n_cgroups, plan.n_sblocks, n), np.int32)
    for g in range(plan.n_cgroups):
        rows = arr[g * gc:min((g + 1) * gc, c)]
        for b in range(plan.n_sblocks):
            out[g, b] = np.bincount(
                rows[:, bounds[b]:bounds[b + 1]].ravel(), minlength=n)
    return out


def _dequantize(idx: torch.Tensor, spec: QuantSpec, dtype) -> torch.Tensor:
    """Reconstruction from indices (torch formulas on idx's device)."""
    spec = _normalize(spec)
    if spec.plan is not None:
        axis, c, m, lo, hi = _tile_tables(idx.shape, spec, idx.device)
        im = torch.movedim(idx, axis, 0).reshape(c, m).long()
        if isinstance(spec.ecsq, TileECSQ):
            lv = host_tensor(spec.ecsq.levels, np.float32,
                                 device=idx.device)
            tid = torch.as_tensor(spec.plan.tile_ids_2d(m),
                                  device=idx.device).long()
            out = lv[tid, im]
        else:
            span_ = torch.maximum(hi - lo, torch.full_like(hi, _CHANNEL_EPS))
            delta = _div(span_, torch.full_like(span_, spec.n_levels - 1))
            out = lo + im.to(torch.float32) * delta
        return _restore(out, idx.shape, axis, c, dtype)
    if spec.ecsq is not None:
        lv = host_tensor(spec.ecsq.levels, np.float32,
                             device=idx.device)
        return lv[idx.long()].to(dtype)
    return uniform.dequantize(idx, spec.cmin, spec.cmax, spec.n_levels,
                              dtype=dtype)


def _pack_indices(idx: torch.Tensor, bits: int) -> torch.Tensor:
    """The wire bit-pack by the torch formula on ``idx``'s device: the
    plain pack for 1/2/4 bits, else one byte per index in ``idx``'s
    shape (the jnp backend's layout)."""
    from ..kernels.pack_bits import PACK_BITS, pack_bits_plain
    if bits not in PACK_BITS:
        return idx.to(torch.uint8)
    return pack_bits_plain(idx, bits)


def _check_cpu(t: torch.Tensor) -> torch.Tensor:
    if t.device.type != "cpu":
        raise ValueError("the torch backend is the CPU reference; CUDA "
                         "tensors go through the CUDA backend")
    return t


def _tiled_qdq(x: torch.Tensor, spec: QuantSpec, want_deq: bool):
    """Plan specs by the torch formulas on ``x``'s device (the reference's
    jnp formulas): (indices, reconstruction or None)."""
    dev = x.device
    axis, c, m, lo, hi = _tile_tables(x.shape, spec, dev)
    xm = torch.movedim(x, axis, 0).reshape(c, m).to(torch.float32)
    if isinstance(spec.ecsq, TileECSQ):
        tid = torch.as_tensor(spec.plan.tile_ids_2d(m), device=dev).long()
        thr = host_tensor(spec.ecsq.thresholds, np.float32, dev)
        xc = torch.clamp(xm, lo, hi)
        idx = torch.zeros(xm.shape, dtype=torch.int32, device=dev)
        for k in range(spec.n_levels - 1):
            idx += (xc >= thr[:, k][tid]).to(torch.int32)
        deq = None
        if want_deq:
            lv = host_tensor(spec.ecsq.levels, np.float32, dev)
            deq = lv[tid, idx.long()]
    else:
        span_ = torch.maximum(hi - lo, torch.full_like(hi, _CHANNEL_EPS))
        scale = _div(spec.n_levels - 1, span_)
        xc = torch.clamp(xm, lo, hi)
        q = torch.floor((xc - lo) * scale + 0.5)
        idx = q.to(torch.int32)
        deq = (lo + q * _div(span_, torch.full_like(
            span_, spec.n_levels - 1))) if want_deq else None
    idx = _restore(idx, x.shape, axis, c, torch.int32)
    return idx, (_restore(deq, x.shape, axis, c, x.dtype)
                 if want_deq else None)


def _ecsq_qdq(x: torch.Tensor, spec: QuantSpec, want_deq: bool):
    """Per-tensor ECSQ by the torch formulas on ``x``'s device."""
    t = host_tensor(spec.ecsq.thresholds, np.float32, x.device)
    xf = x.to(torch.float32)
    xc = torch.clamp(xf, uniform._scalar(spec.cmin, xf),
                     uniform._scalar(spec.cmax, xf))
    idx = torch.searchsorted(t, xc.contiguous(), right=True) \
        .to(torch.int32)
    if not want_deq:
        return idx, None
    lv = host_tensor(spec.ecsq.levels, np.float32, x.device)
    return idx, lv[idx.long()].to(x.dtype)


def _counts_in_quantizer(spec: QuantSpec) -> bool:
    """Whether ``quantize_with_histogram`` returns counts for ``spec``
    (normalized): within the histogram kernels' width, per tensor
    (uniform or ECSQ), or uniform under a plan the per-tile quantizer's
    fast route takes (:func:`~repro_torch.kernels.fused_clip_quant.
    plan_fast_route`: channels last, one spatial block, channel groups of
    8-256).  Per-tile ECSQ (``TileECSQ``) does not count."""
    from ..kernels.fused_clip_quant import plan_fast_route
    from ..kernels.rate_hist import MAX_LEVELS
    if spec.n_levels > MAX_LEVELS or isinstance(spec.ecsq, TileECSQ):
        return False
    return spec.plan is None or plan_fast_route(spec.plan)


def packs_in_quantizer(spec: QuantSpec, bits: int) -> bool:
    """Whether ``quantize_packed_with_histogram`` takes ``spec`` (any form)
    at wire width ``bits``: a spec whose quantizer counts its indices
    (:func:`_counts_in_quantizer`) and a width whose bytes hold several
    indices, each fitting its lane."""
    from ..kernels.pack_bits import PACK_BITS
    spec = _normalize(spec)
    return _counts_in_quantizer(spec) and bits in PACK_BITS \
        and spec.n_levels <= 1 << bits


def _check_packs(spec: QuantSpec, bits: int) -> None:
    if not packs_in_quantizer(spec, bits):
        kind = "per-tile ECSQ" if isinstance(spec.ecsq, TileECSQ) else \
            "per-tensor ECSQ" if spec.ecsq is not None else \
            "tile plan" if spec.plan is not None else "per-tensor uniform"
        raise ValueError(
            "the quantizer packs per-tensor specs (uniform or ECSQ) and "
            "uniform plans with channels last, one spatial block and "
            "groups of 8-256 channels, at 1/2/4 bits with every index "
            f"fitting its lane; got a {kind} spec of {spec.n_levels} "
            f"levels at {bits} bits")


def _counts(backend, idx: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """The counts the quantizer's launch gives, by the backend's own
    histograms: per tile (n_cgroups, 1, N) for a plan, else (N,)."""
    if spec.plan is not None:
        return backend.tile_histogram(idx, spec)
    return backend.histogram(idx, spec.n_levels)


def _tile_histogram(idx: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """(n_cgroups, n_sblocks, N) per-tile counts by the torch formula on
    ``idx``'s device."""
    plan = spec.plan
    axis, c, m = plan.resolve(tuple(idx.shape))
    im = torch.movedim(idx, axis, 0).reshape(c, m).long()
    tid = torch.as_tensor(plan.tile_ids_2d(m), device=idx.device).long()
    hist = torch.zeros((plan.n_tiles, spec.n_levels), dtype=torch.int32,
                       device=idx.device)
    hist.index_put_((tid, im), torch.ones_like(im, dtype=torch.int32),
                    accumulate=True)
    return hist.reshape(plan.n_cgroups, plan.n_sblocks, spec.n_levels)


class TorchBackend:
    """Plain torch reference path on CPU tensors (mirrors the JAX
    package's jnp backend method for method)."""

    name = "torch"
    device = torch.device("cpu")

    def quantize(self, x, spec: QuantSpec):
        # index-only path: host callers (encode/estimate_rate) would
        # otherwise materialize a discarded reconstruction tensor
        _check_cpu(x)
        spec = _normalize(spec)
        if spec.plan is not None:
            return _tiled_qdq(x, spec, want_deq=False)[0]
        if spec.ecsq is not None:
            return _ecsq_qdq(x, spec, want_deq=False)[0]
        return uniform.quantize(x, spec.cmin, spec.cmax, spec.n_levels)

    def quantize_dequantize(self, x, spec: QuantSpec):
        _check_cpu(x)
        spec = _normalize(spec)
        if spec.plan is not None:
            return _tiled_qdq(x, spec, want_deq=True)
        if spec.ecsq is not None:
            return _ecsq_qdq(x, spec, want_deq=True)
        idx = uniform.quantize(x, spec.cmin, spec.cmax, spec.n_levels)
        deq = uniform.dequantize(idx, spec.cmin, spec.cmax,
                                 spec.n_levels, dtype=x.dtype)
        return idx, deq

    def quantize_with_histogram(self, x, spec: QuantSpec,
                                want_deq: bool = True):
        """(indices, reconstruction or None, counts or None): the plain
        formulas, with the counts for the specs the CUDA backend counts
        in its quantizer launch."""
        spec = _normalize(spec)
        if want_deq:
            idx, deq = self.quantize_dequantize(x, spec)
        else:
            idx, deq = self.quantize(x, spec), None
        hist = _counts(self, idx, spec) \
            if _counts_in_quantizer(spec) else None
        return idx, deq, hist

    def quantize_packed_with_histogram(self, x, spec: QuantSpec,
                                       bits: int):
        """(packed uint8 wire bytes of the flat indices, counts): the plain
        quantizer, pack and histogram, for the specs the CUDA backend
        packs in its quantizer launch (:func:`packs_in_quantizer`); any
        other spec raises."""
        spec = _normalize(spec)
        _check_packs(spec, bits)
        idx = self.quantize(x, spec)
        return (self.pack_indices(idx.reshape(-1), bits),
                _counts(self, idx, spec))

    def dequantize(self, idx, spec: QuantSpec, dtype=torch.float32):
        return _dequantize(_check_cpu(idx), spec, dtype)

    def histogram(self, idx, n_levels: int):
        from .rate_model import index_histogram
        return index_histogram(_check_cpu(idx), n_levels)

    def tile_histogram(self, idx, spec: QuantSpec):
        """(n_cgroups, n_sblocks, N) per-tile index counts."""
        spec = _normalize(spec)
        if spec.plan is None:
            return self.histogram(idx, spec.n_levels).reshape(1, 1, -1)
        return _tile_histogram(_check_cpu(idx), spec)

    def coded_indices_device(self, x, spec: QuantSpec, bits: int):
        """Coded-order indices on the tensor's device, no host transfer
        (the emit_wire intermediate)."""
        spec = _normalize(spec)
        return _coded_order_device(self.quantize(x, spec), spec)

    def encode_fused(self, x, spec: QuantSpec, bits: int,
                     want_hist: bool = False, emit_wire: bool = False,
                     chunk_bounds=None):
        """Fused-encode contract on the reference path: coded-order
        indices plus (optionally) host per-tile histograms; with
        ``emit_wire`` the entropy stage returns finished payload bytes
        instead (see the module docstring)."""
        spec = _normalize(spec)
        tr = tracer()
        if emit_wire:
            if want_hist:
                raise ValueError("emit_wire returns wire bytes; per-tile "
                                 "histograms need the index path")
            with tr.span("fused_launch", backend=self.name), \
                    tr.annotate("repro.encode_fused"):
                coded = self.coded_indices_device(x, spec, bits)
            return _encode_wire(coded, spec, chunk_bounds), None
        with tr.span("fused_launch", backend=self.name), \
                tr.annotate("repro.encode_fused"):
            q = self.quantize(x, spec)
        with tr.span("device_to_host"):
            q = q.numpy()
        with tr.span("host_unpack"):
            coded = _coded_order(q, spec)
        hists = _tile_hists_np(coded, spec) if want_hist else None
        return coded, hists

    def pack_indices(self, idx, bits: int):
        """Host bit-pack (the wire layout every backend shares)."""
        return _pack_indices(_check_cpu(idx), bits)


class CudaBackend:
    """Hand-written CUDA kernel path (mirrors the JAX package's Pallas
    kernel backend branch for branch, on CUDA tensors).

    Quantization runs the per-tensor or per-tile clip+quant kernel, or
    the per-tensor or per-tile ECSQ assignment kernel (the clip+quant
    kernels and the per-tensor ECSQ kernel also count, and pack, their
    indices for the specs
    :func:`_counts_in_quantizer` takes; the per-tile ECSQ kernel writes
    coded order for ``coded_indices_device``); histograms the global or
    per-tile index histogram kernel; the fused encode the megakernel
    over the flat or banded view, plus the device rANS stage; the
    in-graph pack of 1/2/4-bit indices the pack kernel.  Level counts
    above a kernel's table width, and pack widths of one index per byte,
    use the torch formulas on the device, exactly where the reference
    uses jnp.
    """

    name = "cuda"

    def __init__(self) -> None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the CUDA backend needs a CUDA device and none is "
                "available; pass backend='torch' for the CPU reference")
        self.device = torch.device("cuda")

    def _in(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type != "cuda":
            raise ValueError(f"the CUDA backend takes CUDA tensors, got "
                             f"{x.device}")
        return x

    def quantize(self, x, spec: QuantSpec):
        """Indices only: every kernel writes no reconstruction."""
        return self._quantize(self._in(x), _normalize(spec),
                              want_deq=False)[0]

    def quantize_with_histogram(self, x, spec: QuantSpec,
                                want_deq: bool = True):
        """(indices, reconstruction or None, counts or None).  For the
        specs :func:`_counts_in_quantizer` takes -- per tensor, uniform or
        ECSQ, or a uniform plan on the per-tile quantizer's fast route, of
        at most 64 levels -- one quantizer launch (clip+quant or ECSQ)
        also counts its indices ((N,), or (n_cgroups, 1, N) per tile); any
        other spec takes its quantizer alone and returns no counts."""
        from ..kernels import ops
        spec = _normalize(spec)
        x = self._in(x)
        if not _counts_in_quantizer(spec):
            return (*self._quantize(x, spec, want_deq), None)
        if spec.plan is not None:
            return ops.clip_quantize_tiled(x, spec.cmin, spec.cmax,
                                           n_levels=spec.n_levels,
                                           plan=spec.plan, want_deq=want_deq,
                                           want_hist=True)
        if spec.ecsq is not None:
            return ops.ecsq_quantize(x, spec.ecsq.thresholds,
                                     spec.ecsq.levels, cmin=float(spec.cmin),
                                     cmax=float(spec.cmax),
                                     want_deq=want_deq, want_hist=True)
        return ops.clip_quantize(x, cmin=float(spec.cmin),
                                 cmax=float(spec.cmax),
                                 n_levels=spec.n_levels, want_deq=want_deq,
                                 want_hist=True)

    def quantize_packed_with_histogram(self, x, spec: QuantSpec,
                                       bits: int):
        """(packed uint8 wire bytes of the flat indices, counts) from one
        quantizer launch (clip+quant or ECSQ) that packs and counts its
        indices, for the specs :func:`packs_in_quantizer` takes; any other
        spec raises."""
        from ..kernels import ops
        spec = _normalize(spec)
        _check_packs(spec, bits)
        if spec.plan is not None:
            return ops.clip_quantize_tiled_pack(self._in(x), spec.cmin,
                                                spec.cmax,
                                                n_levels=spec.n_levels,
                                                plan=spec.plan, bits=bits)
        if spec.ecsq is not None:
            return ops.ecsq_quantize_pack(self._in(x), spec.ecsq.thresholds,
                                          spec.ecsq.levels,
                                          cmin=float(spec.cmin),
                                          cmax=float(spec.cmax), bits=bits)
        return ops.clip_quantize_pack(self._in(x), cmin=float(spec.cmin),
                                      cmax=float(spec.cmax),
                                      n_levels=spec.n_levels, bits=bits)

    def quantize_dequantize(self, x, spec: QuantSpec):
        return self._quantize(self._in(x), _normalize(spec), want_deq=True)

    def _quantize(self, x, spec: QuantSpec, want_deq: bool):
        """(indices, reconstruction or None) of a normalized spec: one
        kernel launch, which writes the reconstruction only when asked."""
        from ..kernels import ops
        from ..kernels.ecsq_assign import MAX_LEVELS
        if spec.plan is not None:
            if isinstance(spec.ecsq, TileECSQ):
                if spec.n_levels > MAX_LEVELS:
                    return _tiled_qdq(x, spec, want_deq)
                return ops.ecsq_quantize_tiled(
                    x, spec.cmin, spec.cmax, spec.ecsq.thresholds,
                    spec.ecsq.levels, n_levels=spec.n_levels, plan=spec.plan,
                    want_deq=want_deq)
            return ops.clip_quantize_tiled(x, spec.cmin, spec.cmax,
                                           n_levels=spec.n_levels,
                                           plan=spec.plan, want_deq=want_deq)
        if spec.ecsq is not None:
            if spec.n_levels > MAX_LEVELS:
                return _ecsq_qdq(x, spec, want_deq)
            return ops.ecsq_quantize(x, spec.ecsq.thresholds,
                                     spec.ecsq.levels, cmin=float(spec.cmin),
                                     cmax=float(spec.cmax),
                                     want_deq=want_deq)
        return ops.clip_quantize(x, cmin=float(spec.cmin),
                                 cmax=float(spec.cmax),
                                 n_levels=spec.n_levels, want_deq=want_deq)

    def dequantize(self, idx, spec: QuantSpec, dtype=torch.float32):
        return _dequantize(self._in(idx), spec, dtype)

    def histogram(self, idx, n_levels: int):
        from ..kernels import ops
        from ..kernels.rate_hist import MAX_LEVELS
        from .rate_model import index_histogram
        if n_levels > MAX_LEVELS:
            return index_histogram(self._in(idx), n_levels)
        return ops.index_histogram(self._in(idx), n_levels=n_levels)

    def tile_histogram(self, idx, spec: QuantSpec):
        from ..kernels import ops
        from ..kernels.rate_hist import MAX_LEVELS
        spec = _normalize(spec)
        if spec.plan is None:
            return self.histogram(idx, spec.n_levels).reshape(1, 1, -1)
        if spec.n_levels > MAX_LEVELS:
            return _tile_histogram(self._in(idx), spec)
        return ops.index_histogram_tiled(self._in(idx),
                                         n_levels=spec.n_levels,
                                         plan=spec.plan)

    def _megakernel(self, x, spec: QuantSpec, bits: int):
        """One encode megakernel pass: (packed, hist_raw, layout)."""
        from ..kernels import ops
        if spec.plan is None:
            return ops.encode_fused(self._in(x), float(spec.cmin),
                                    float(spec.cmax), n_levels=spec.n_levels,
                                    bits=bits)
        return ops.encode_fused(self._in(x), spec.cmin, spec.cmax,
                                n_levels=spec.n_levels, bits=bits,
                                plan=spec.plan)

    def coded_indices_device(self, x, spec: QuantSpec, bits: int):
        """Device coded-order indices, no host transfer: the megakernel's
        packed output is unpacked and layout-stripped on the device (the
        emit_wire intermediate); the per-tile ECSQ kernel writes coded
        order itself on its fast route; other designed quantizers
        quantize through their kernel and permute to coded order."""
        from ..kernels import ops
        from ..kernels.ecsq_assign import MAX_LEVELS
        from ..kernels.fused_clip_quant import HIST_WIDTH, fast_route, \
            tile_maps
        spec = _normalize(spec)
        x = self._in(x)
        if isinstance(spec.ecsq, TileECSQ) and spec.n_levels <= MAX_LEVELS \
                and fast_route(tile_maps(spec.plan, x.shape, x.device)):
            # the ECSQ tile kernel writes coded order itself: one launch
            return ops.ecsq_quantize_tiled_coded(
                x, spec.cmin, spec.cmax, spec.ecsq.thresholds,
                spec.ecsq.levels, n_levels=spec.n_levels, plan=spec.plan)
        if spec.ecsq is not None or spec.n_levels > HIST_WIDTH:
            return _coded_order_device(self.quantize(x, spec), spec)
        packed, _, lay = self._megakernel(x, spec, bits)
        return _unpack_layout_device(_unpack_bytes_device(packed, bits), lay)

    def encode_fused(self, x, spec: QuantSpec, bits: int,
                     want_hist: bool = False, emit_wire: bool = False,
                     chunk_bounds=None):
        """One megakernel pass -> (packed bytes + tile hists) on the
        device; the fetch here is the path's single transfer, and the
        host only unpacks wire-width bytes back to indices.

        ``emit_wire=True`` keeps going on the device: the unpacked
        coded-order indices feed the device rANS stage, so only the
        finished coder-id-4 payload crosses to the host."""
        from ..kernels import ops
        from ..kernels.fused_clip_quant import HIST_WIDTH
        spec = _normalize(spec)
        tr = tracer()
        if emit_wire:
            if want_hist:
                raise ValueError("emit_wire returns wire bytes; per-tile "
                                 "histograms need the index path")
            with tr.span("fused_launch", backend=self.name), \
                    tr.annotate("repro.encode_fused"):
                coded = self.coded_indices_device(x, spec, bits)
            return _encode_wire(coded, spec, chunk_bounds), None
        if spec.ecsq is not None or spec.n_levels > HIST_WIDTH:
            # no fused kernel for designed quantizers / wide histograms:
            # kernel-quantize, then the host side of the contract
            with tr.span("fused_launch", backend=self.name), \
                    tr.annotate("repro.encode_fused"):
                q = self.quantize(x, spec)
                if tr.enabled:
                    torch.cuda.synchronize(q.device)
            with tr.span("device_to_host"):
                q = q.cpu().numpy()
            with tr.span("host_unpack"):
                coded = _coded_order(q, spec)
            return coded, (_tile_hists_np(coded, spec) if want_hist
                           else None)
        with tr.span("fused_launch", backend=self.name), \
                tr.annotate("repro.encode_fused"):
            packed, hist, lay = self._megakernel(x, spec, bits)
            if tr.enabled:
                # bound the launch at the device sync so the transfer
                # span below measures only the packed-bytes fetch
                torch.cuda.synchronize(packed.device)
        with tr.span("device_to_host"):
            packed = packed.cpu().numpy()
            hist = hist.cpu().numpy() if want_hist else hist
        with tr.span("host_unpack"):
            coded = lay.unpack_indices(ops.unpack_bytes(packed, bits))
        hists = lay.group_hists(hist, spec.n_levels,
                                HIST_WIDTH) if want_hist else None
        return coded, hists

    def pack_indices(self, idx, bits: int):
        from ..kernels import ops
        from ..kernels.pack_bits import PACK_BITS
        idx = self._in(idx)
        if bits not in PACK_BITS:
            return _pack_indices(idx, bits)
        return ops.pack_indices(idx, bits=bits)


_BACKENDS: dict[str, Any] = {}


def get_backend(name: str | None = None):
    """Resolve a backend by name; ``None`` is the CUDA backend, which
    raises where no CUDA device exists."""
    if name is None:
        name = "cuda"
    if name not in _BACKENDS:
        if name == "torch":
            _BACKENDS[name] = TorchBackend()
        elif name == "cuda":
            _BACKENDS[name] = CudaBackend()
        else:
            raise ValueError(f"unknown quant backend {name!r}")
    return _BACKENDS[name]


def spec_from_numpy(cmin, cmax, n_levels: int, channel_axis: int | None,
                    ecsq=None) -> QuantSpec:
    """Build a QuantSpec from host (numpy/float) calibration state."""
    if channel_axis is None:
        return QuantSpec(float(cmin), float(cmax), n_levels, None, ecsq)
    return QuantSpec(np.asarray(cmin, np.float32),
                     np.asarray(cmax, np.float32),
                     n_levels, channel_axis, ecsq)
