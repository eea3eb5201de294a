"""Fused clip + uniform quantize kernels (paper eq. 1), CUDA for Hopper.

Three kernels, each beside its plain torch version:

* :func:`clip_quant_2d` replaces the Pallas kernel
  ``repro/kernels/fused_clip_quant.py`` ``_kernel`` (``clip_quant_2d``):
  per-tensor clip -> quantize -> dequantize, the ``codec=`` serving
  hookup's fake-quant pass.  On request the same launch skips the
  reconstruction (``want_deq=False``) and counts the histogram of its
  indices (``want_hist=True``), the rate estimate the ``codec=`` hookup
  and the split runtime's crossing take, so they launch no index
  histogram after it.  Source: ``csrc/fused_clip_quant.cu``
  ``repro_clip_quant``.  :func:`clip_quant_pack` is the same launch
  writing the indices bit-packed to the wire width in place of the int32
  indices, with the histogram: the packed split runtime's crossing,
  which so launches no pack kernel (#9) after it.  Source:
  ``repro_clip_quant_pack``.
* :func:`clip_quant_tiles` replaces ``_kernel_tiles``
  (``clip_quant_tiles_2d``, ``clip_quant_rows_2d``): the same with one
  range per :class:`~repro_torch.core.tiling.TilePlan` tile, the
  ``codec=`` hookup's pass for channel and tile granularities.  It reads
  the tensor in its own layout instead of the reference's banded,
  lane-padded copy, and writes its outputs in that layout.  Plans with
  channels innermost, one spatial block and channel groups of 8-256
  (:func:`fast_route`, the serving codecs') take the fast route: a
  thread quantizes 8 channels of a row from one vector load with its
  tile's range and scale computed once, threads grouped by tile, and on
  request the same launch counts the per-tile histogram
  (``want_hist``) or, in :func:`clip_quant_tiles_pack`, writes the
  indices bit-packed with the counts and no int32 indices -- the
  split runtime's per-channel crossing in one launch, with no tile
  histogram (#5) or pack (#9) after it.  Other plans take the element
  route, each element's tile looked up through the plan's maps
  (:func:`tile_maps`).  Either writes no reconstruction when asked for
  none.  Sources: ``csrc/fused_clip_quant.cu``
  ``repro_clip_quant_tiles_fast`` and ``repro_clip_quant_tiles``.
* :func:`encode_tiles_2d` replaces ``_kernel_encode``
  (``encode_tiles_2d``): the encode megakernel -- clip -> quantize ->
  bit-pack -> per-(row, band) histogram in one pass, the
  ``codec_host_fn`` hookup's device side.  Source:
  ``csrc/fused_clip_quant.cu`` ``repro_encode_tiles``.  A thread makes
  four packed bytes from one vector load; a block owns whole (row, band)
  cells, counts them with lane-group reductions and no atomics, and
  stores each cell's histogram row once, so the output is not zeroed
  first.  Bound more by its launch and per-thread work than by its bytes
  (see the source note).

All are bound by bytes on the card (one read per element, a few
flops); each makes a single pass over device memory (see the source
notes).

Numerics follow the reference exactly.  The per-tensor kernel takes its
range scalars as the reference forms them -- ``scale`` and ``inv_scale``
divided in double on the host and rounded once to float32.  The tiled
kernel and the megakernel divide in float32 on the device, ``(N-1) /
max(hi-lo, 1e-12)`` and ``max(hi-lo, 1e-12) / (N-1)`` with correctly
rounded divides.  Every multiply and add is
rounded separately (no fused multiply-add), in the kernels and in the
plain versions, whose divides are tensor-by-tensor (torch's ``scalar /
tensor`` multiplies by a reciprocal instead).  Indices are therefore
bit-exact with the reference; the reconstruction ``lo + q * inv_scale``
matches the reference's jnp formula exactly and sits within one rounding
of its interpreted Pallas kernel, whose compiler may fuse the two steps.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..core.tiling import TilePlan
from . import _build

HIST_WIDTH = 64        # lane width of the per-(row, band) histogram output
_EPS = 1e-12           # degenerate-range guard of the tiled formula


def _on_cpu(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return False


def range_scalars(cmin: float, cmax: float, n_levels: int):
    """float32 (lo, hi, scale, inv_scale) of the per-tensor formula: the
    ratios divide in double and round once, as the reference's static
    Python scalars do."""
    cmin, cmax = float(cmin), float(cmax)
    return (np.float32(cmin), np.float32(cmax),
            np.float32((n_levels - 1) / (cmax - cmin)),
            np.float32((cmax - cmin) / (n_levels - 1)))


# -- kernel 1: per-tensor clip + quantize + dequantize -------------------------

def clip_quant_plain(x: torch.Tensor, cmin: float, cmax: float,
                     n_levels: int, *, want_deq: bool = True,
                     want_hist: bool = False):
    """Plain torch version of :func:`clip_quant_2d` (same arithmetic; the
    histogram is :func:`~repro_torch.kernels.rate_hist.
    index_histogram_plain` of the indices)."""
    from .rate_hist import index_histogram_plain
    lo, hi, scale, inv = (torch.full((), float(v), dtype=torch.float32,
                                     device=x.device)
                          for v in range_scalars(cmin, cmax, n_levels))
    xc = torch.clamp(x.to(torch.float32), lo, hi)
    q = torch.floor((xc - lo) * scale + 0.5)
    idx = q.to(torch.int32)
    deq = (lo + q * inv).to(x.dtype) if want_deq else None
    if not want_hist:
        return idx, deq
    return idx, deq, index_histogram_plain(idx, n_levels)


def clip_quant_2d(x: torch.Tensor, cmin: float, cmax: float,
                  n_levels: int, *, want_deq: bool = True,
                  want_hist: bool = False):
    """Fused clip+quantize(+dequantize)(+histogram) of ``x`` (any shape),
    one launch on the card.

    Returns (idx int32, deq in ``x.dtype`` or None when ``want_deq`` is
    false), both shaped like ``x``; with ``want_hist`` also the
    (n_levels,) int32 histogram of idx (N <= 64)."""
    if want_hist and n_levels > HIST_WIDTH:
        raise ValueError(f"n_levels {n_levels} > {HIST_WIDTH}")
    if _on_cpu(x):
        return clip_quant_plain(x, cmin, cmax, n_levels, want_deq=want_deq,
                                want_hist=want_hist)
    _build.check_cuda("x", x, tuple(_build.DTYPE_CODES))
    idx = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    deq = torch.empty_like(x) if want_deq else None
    out = (idx, deq)
    if x.numel() == 0:
        return out + ((torch.zeros(n_levels, dtype=torch.int32,
                                   device=x.device),) if want_hist else ())
    hist = rows = None
    if want_hist:
        hist = torch.empty(n_levels, dtype=torch.int32, device=x.device)
        rows = _build.hist_rows(x.numel(), x.device)
    lo, hi, scale, inv = range_scalars(cmin, cmax, n_levels)
    _build.launch("clip_quant", "repro_clip_quant", x.data_ptr(),
                  _build.DTYPE_CODES[x.dtype], x.numel(), float(lo),
                  float(hi), float(scale), float(inv), n_levels,
                  idx.data_ptr(), _build.ptr(deq), _build.ptr(hist),
                  _build.ptr(rows), 0 if rows is None else rows.shape[0],
                  _build.hist_ticket(x.device).data_ptr() if want_hist
                  else None)
    return out + ((hist,) if want_hist else ())


# -- kernel 1 packing: per-tensor clip + quantize + bit-pack + histogram -------

def clip_quant_pack_plain(x: torch.Tensor, cmin: float, cmax: float,
                          n_levels: int, bits: int):
    """Plain torch version of :func:`clip_quant_pack`: the plain quantizer,
    then :func:`~repro_torch.kernels.pack_bits.pack_bits_plain` and the
    plain index histogram."""
    from .pack_bits import pack_bits_plain
    from .rate_hist import index_histogram_plain
    idx, _ = clip_quant_plain(x, cmin, cmax, n_levels, want_deq=False)
    return (pack_bits_plain(idx.reshape(-1), bits),
            index_histogram_plain(idx, n_levels))


def clip_quant_pack(x: torch.Tensor, cmin: float, cmax: float,
                    n_levels: int, bits: int):
    """Fused clip+quantize+bit-pack+histogram of ``x`` (any shape), one
    launch on the card: the indices leave the launch only as wire bytes.

    Returns (packed uint8 of ``ceil(n / (8 // bits))`` bytes, the flat
    indices' layout of :func:`~repro_torch.kernels.pack_bits.pack_bits`;
    (n_levels,) int32 histogram of the indices).  ``bits`` is 1, 2 or 4,
    with ``n_levels <= 2 ** bits`` (every index fits its lane) and
    ``n_levels <= 64``."""
    from .pack_bits import PACK_BITS
    if bits not in PACK_BITS:
        raise ValueError(f"packable bit widths are 1/2/4, got {bits}")
    if not 2 <= n_levels <= min(HIST_WIDTH, 1 << bits):
        raise ValueError(f"n_levels {n_levels} does not fit {bits}-bit "
                         f"lanes and a {HIST_WIDTH}-bin histogram")
    if _on_cpu(x):
        return clip_quant_pack_plain(x, cmin, cmax, n_levels, bits)
    _build.check_cuda("x", x, tuple(_build.DTYPE_CODES))
    n = x.numel()
    per = 8 // bits
    packed = torch.empty(-(-n // per), dtype=torch.uint8, device=x.device)
    if n == 0:
        return packed, torch.zeros(n_levels, dtype=torch.int32,
                                   device=x.device)
    hist = torch.empty(n_levels, dtype=torch.int32, device=x.device)
    rows = _build.hist_rows(n, x.device)
    lo, hi, scale, _ = range_scalars(cmin, cmax, n_levels)
    _build.launch("clip_quant", "repro_clip_quant_pack", x.data_ptr(),
                  _build.DTYPE_CODES[x.dtype], n, float(lo), float(hi),
                  float(scale), n_levels, bits, packed.data_ptr(),
                  hist.data_ptr(), rows.data_ptr(), rows.shape[0],
                  _build.hist_ticket(x.device).data_ptr())
    return packed, hist


# -- kernel 2: per-tile clip + quantize + dequantize ---------------------------

class TileMaps(NamedTuple):
    """Element -> tile geometry of one tensor shape under a TilePlan, with
    its maps on the tensor's device; shared by the tiled kernels (#2, #5,
    #8) and their plain versions."""

    axis: int                     # channel axis, normalized
    c: int                        # channels
    m: int                        # flattened spatial extent (channel-major)
    inner: int                    # elements after the channel axis in memory
    n_sblocks: int
    group_size: int
    cgroup: torch.Tensor          # (C,) int32 channel -> channel group
    sblock: torch.Tensor | None   # (M,) int32 position -> spatial block
    #                               (None: the plan has one block)
    bounds: torch.Tensor          # (n_sblocks + 1,) int32 coded band bounds
    perm: torch.Tensor | None     # (M,) int32 coded -> spatial position
    #                               (2-D plans; None: identity)
    max_tile: int                 # elements of the largest tile


@functools.lru_cache(maxsize=64)
def _tile_maps(plan: TilePlan, shape: tuple[int, ...],
               device: torch.device) -> TileMaps:
    axis, c, m = plan.resolve(shape)
    inner = int(np.prod(shape[axis + 1:], dtype=np.int64))
    perm = plan.spatial_perm(m)

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    return TileMaps(axis, c, m, inner, plan.n_sblocks,
                    plan.channel_group_size, dev(plan.cgroup_ids()),
                    dev(plan.sblock_ids(m)) if plan.n_sblocks > 1 else None,
                    dev(plan.coded_band_bounds(m)),
                    None if perm is None else dev(perm),
                    min(plan.channel_group_size, c)
                    * int(plan.band_sizes(m).max()))


def tile_maps(plan: TilePlan, shape, device) -> TileMaps:
    """The (cached) :class:`TileMaps` of ``shape`` under ``plan`` on
    ``device``; raises if the shape does not fit the plan."""
    return _tile_maps(plan, tuple(int(s) for s in shape),
                      torch.device(device))


def tile_ids(maps: TileMaps) -> torch.Tensor:
    """int64 flat tile id of every element of the channel-major (C, M)
    view: (C, M), or (C, 1) to broadcast when the plan has one block."""
    t = maps.cgroup.long()[:, None] * maps.n_sblocks
    return t if maps.sblock is None else t + maps.sblock.long()[None, :]


def channel_major(x: torch.Tensor, maps: TileMaps) -> torch.Tensor:
    """``x`` as its channel-major (C, M) view."""
    return torch.movedim(x, maps.axis, 0).reshape(maps.c, maps.m)


def restore(a: torch.Tensor, shape, maps: TileMaps) -> torch.Tensor:
    """Inverse of :func:`channel_major` for a tensor of ``shape``."""
    moved = (maps.c,) + tuple(s for d, s in enumerate(shape)
                              if d != maps.axis)
    return torch.movedim(a.reshape(moved), 0, maps.axis)


def check_tables(plan: TilePlan, **tables: torch.Tensor) -> None:
    """Per-tile tables must be (n_cgroups, n_sblocks, ...)."""
    want = (plan.n_cgroups, plan.n_sblocks)
    for name, t in tables.items():
        if tuple(t.shape[:2]) != want:
            raise ValueError(f"{name} must be shaped {want}, got "
                             f"{tuple(t.shape)}")


# The fast route of the tiled kernels (#2, #8): channels innermost, one
# spatial block, channel groups of FAST_GROUPS channels and a channel count
# that is a multiple of UNIT, so the UNIT consecutive values of a row that
# a thread loads (16 bytes of bfloat16) lie in one tile.
UNIT = 8
FAST_GROUPS = (8, 16, 32, 64, 128, 256)


def fast_route(maps: TileMaps) -> bool:
    """Whether the tiled kernels take their fast route on this geometry
    (a thread a unit of ``UNIT`` channels of one row, its tile's range
    once); every other geometry takes the element route, which looks up
    each element's tile.  Only the fast route of #2 counts its indices
    and packs them."""
    return (maps.inner == 1 and maps.n_sblocks == 1 and maps.perm is None
            and maps.group_size in FAST_GROUPS and maps.c % UNIT == 0)


def plan_fast_route(plan: TilePlan) -> bool:
    """:func:`fast_route` decided from the plan alone, for every shape the
    plan takes: channels last (``channel_axis == -1``), one spatial
    block, and the same group and channel conditions."""
    return (plan.channel_axis == -1 and not plan.is_2d
            and plan.n_sblocks == 1 and plan.n_channels is not None
            and plan.channel_group_size in FAST_GROUPS
            and plan.n_channels % UNIT == 0)


def _check_counts(maps: TileMaps, n_levels: int, what: str) -> None:
    if not fast_route(maps):
        raise ValueError(f"the per-tile quantizer {what} only on its fast "
                         "route (channels innermost, one spatial block, "
                         f"channel groups of {FAST_GROUPS} channels, a "
                         f"multiple of {UNIT} channels)")
    if n_levels > HIST_WIDTH:
        raise ValueError(f"n_levels {n_levels} > {HIST_WIDTH}")


def clip_quant_tiles_plain(x: torch.Tensor, lo: torch.Tensor,
                           hi: torch.Tensor, n_levels: int, maps: TileMaps,
                           *, want_deq: bool = True,
                           want_hist: bool = False):
    """Plain torch version of :func:`clip_quant_tiles`: the reference's
    tiled formula over the channel-major view, each element's range
    gathered by its tile id (the histogram: :func:`~repro_torch.kernels.
    rate_hist.index_histogram_tiles_plain` of the indices)."""
    from .rate_hist import index_histogram_tiles_plain
    t = tile_ids(maps)
    lo_e, hi_e = lo.reshape(-1)[t], hi.reshape(-1)[t]
    q = quantize_rows(channel_major(x, maps), lo_e, hi_e, n_levels)
    idx = restore(q, x.shape, maps)
    deq = None
    if want_deq:
        span = torch.maximum(hi_e - lo_e, torch.full_like(hi_e, _EPS))
        d = lo_e + q.to(torch.float32) * (
            span / torch.full_like(span, n_levels - 1))
        deq = restore(d, x.shape, maps).to(x.dtype)
    if not want_hist:
        return idx, deq
    return idx, deq, index_histogram_tiles_plain(idx, n_levels, maps)


def clip_quant_tiles(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                     n_levels: int, plan: TilePlan, *, want_deq: bool = True,
                     want_hist: bool = False):
    """Per-tile clip+quantize(+dequantize)(+histogram) of ``x`` (any shape
    the plan takes), one launch on the card.

    lo/hi: (n_cgroups, n_sblocks) float32 range tables on ``x``'s device.
    Returns (idx int32, deq in ``x.dtype`` or None when ``want_deq`` is
    false), both shaped like ``x``; with ``want_hist`` also the
    (n_cgroups, n_sblocks, n_levels) int32 per-tile counts of idx, which
    only the fast route (:func:`fast_route`) gives."""
    maps = tile_maps(plan, x.shape, x.device)
    check_tables(plan, lo=lo, hi=hi)
    if want_hist:
        _check_counts(maps, n_levels, "counts its indices")
    if _on_cpu(x):
        return clip_quant_tiles_plain(x, lo, hi, n_levels, maps,
                                      want_deq=want_deq, want_hist=want_hist)
    _build.check_cuda("x", x, tuple(_build.DTYPE_CODES))
    _build.check_cuda("lo", lo, (torch.float32,))
    _build.check_cuda("hi", hi, (torch.float32,))
    _build.check_numel("x", x)
    idx = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    deq = torch.empty_like(x) if want_deq else None
    hist = torch.empty((plan.n_cgroups, plan.n_sblocks, n_levels),
                       dtype=torch.int32, device=x.device) \
        if want_hist else None
    out = (idx, deq) + ((hist,) if want_hist else ())
    if x.numel() == 0:
        if want_hist:
            hist.zero_()
        return out
    if fast_route(maps):
        _build.launch("clip_quant_tiles", "repro_clip_quant_tiles_fast",
                      x.data_ptr(), _build.DTYPE_CODES[x.dtype],
                      x.numel() // maps.c, maps.c, maps.group_size,
                      lo.data_ptr(), hi.data_ptr(), n_levels, 0,
                      idx.data_ptr(), _build.ptr(deq), None,
                      _build.ptr(hist))
    else:
        _build.launch("clip_quant_tiles", "repro_clip_quant_tiles",
                      x.data_ptr(), _build.DTYPE_CODES[x.dtype], x.numel(),
                      maps.c, maps.inner, maps.cgroup.data_ptr(),
                      _build.ptr(maps.sblock), maps.n_sblocks, lo.data_ptr(),
                      hi.data_ptr(), n_levels, idx.data_ptr(),
                      _build.ptr(deq))
    return out


def clip_quant_tiles_pack_plain(x: torch.Tensor, lo: torch.Tensor,
                                hi: torch.Tensor, n_levels: int,
                                maps: TileMaps, bits: int):
    """Plain torch version of :func:`clip_quant_tiles_pack`: the plain
    tiled quantizer, then :func:`~repro_torch.kernels.pack_bits.
    pack_bits_plain` of the flat indices and the plain tile histogram."""
    from .pack_bits import pack_bits_plain
    idx, _, hist = clip_quant_tiles_plain(x, lo, hi, n_levels, maps,
                                          want_deq=False, want_hist=True)
    return pack_bits_plain(idx.reshape(-1), bits), hist


def clip_quant_tiles_pack(x: torch.Tensor, lo: torch.Tensor,
                          hi: torch.Tensor, n_levels: int, plan: TilePlan,
                          bits: int):
    """Per-tile clip+quantize+bit-pack+histogram of ``x``, one launch on
    the card on the fast route (:func:`fast_route`; other geometries
    raise): the indices leave the launch only as wire bytes.

    Returns (packed uint8 of ``ceil(n / (8 // bits))`` bytes, the flat
    indices' layout of :func:`~repro_torch.kernels.pack_bits.pack_bits`;
    (n_cgroups, 1, n_levels) int32 per-tile counts).  ``bits`` is 1, 2 or
    4, with ``n_levels <= 2 ** bits``."""
    from .pack_bits import PACK_BITS
    if bits not in PACK_BITS:
        raise ValueError(f"packable bit widths are 1/2/4, got {bits}")
    if not 2 <= n_levels <= min(HIST_WIDTH, 1 << bits):
        raise ValueError(f"n_levels {n_levels} does not fit {bits}-bit "
                         f"lanes and a {HIST_WIDTH}-bin histogram")
    maps = tile_maps(plan, x.shape, x.device)
    check_tables(plan, lo=lo, hi=hi)
    _check_counts(maps, n_levels, "packs its indices")
    if _on_cpu(x):
        return clip_quant_tiles_pack_plain(x, lo, hi, n_levels, maps, bits)
    _build.check_cuda("x", x, tuple(_build.DTYPE_CODES))
    _build.check_cuda("lo", lo, (torch.float32,))
    _build.check_cuda("hi", hi, (torch.float32,))
    _build.check_numel("x", x)
    n = x.numel()
    packed = torch.empty(-(-n // (8 // bits)), dtype=torch.uint8,
                         device=x.device)
    hist = torch.empty((plan.n_cgroups, 1, n_levels), dtype=torch.int32,
                       device=x.device)
    if n == 0:
        return packed, hist.zero_()
    _build.launch("clip_quant_tiles", "repro_clip_quant_tiles_fast",
                  x.data_ptr(), _build.DTYPE_CODES[x.dtype], n // maps.c,
                  maps.c, maps.group_size, lo.data_ptr(), hi.data_ptr(),
                  n_levels, bits, None, None, packed.data_ptr(),
                  hist.data_ptr())
    return packed, hist


# -- kernel 3: fused encode megakernel -----------------------------------------

def pack_width(bits: int) -> int:
    """Indices per packed byte: 8 // bits for 1/2/4-bit, else 1."""
    return 8 // bits if bits in (1, 2, 4) else 1


def band_valid_array(n_sblocks: int, bs: int, bs_last: int | None,
                     band_valid=None, device=None) -> torch.Tensor:
    """(n_sblocks,) int32 per-band valid element counts: explicit
    ``band_valid`` (2-D ragged tiles) or the uniform-but-for-the-last
    1-D rule."""
    if band_valid is not None:
        v = list(band_valid)
    else:
        v = [bs] * n_sblocks
        v[-1] = bs if bs_last is None else bs_last
    return torch.tensor(v, dtype=torch.int32, device=device)


def quantize_rows(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                  n_levels: int) -> torch.Tensor:
    """The tiled formula on broadcastable range tables: float32
    ``floor((clip(x) - lo) * ((N-1) / max(hi - lo, 1e-12)) + 0.5)``."""
    span = torch.maximum(hi - lo, torch.full_like(hi, _EPS))
    scale = torch.full_like(span, n_levels - 1) / span
    xc = torch.clamp(x.to(torch.float32), lo, hi)
    return torch.floor((xc - lo) * scale + 0.5).to(torch.int32)


def encode_tiles_plain(x: torch.Tensor, cmin: torch.Tensor,
                       cmax: torch.Tensor, valid: torch.Tensor,
                       n_levels: int, bits: int, sb_cols: int):
    """Plain torch version of :func:`encode_tiles_2d` (same arithmetic)."""
    per = pack_width(bits)
    r, c = x.shape
    nb = c // sb_cols
    q = quantize_rows(x.reshape(r, nb, sb_cols),
                      cmin.to(torch.float32).reshape(r, nb, 1),
                      cmax.to(torch.float32).reshape(r, nb, 1), n_levels)
    q3 = q.reshape(r, c // per, per)
    acc = q3[:, :, 0].clone()
    for k in range(1, per):
        acc += q3[:, :, k] << (k * bits)
    packed = acc.to(torch.uint8)
    cols = torch.arange(sb_cols, device=x.device)
    mask = cols[None, :] < valid.to(x.device)[:, None]        # (nb, sb_cols)
    hist = torch.zeros((r, nb, HIST_WIDTH), dtype=torch.int32,
                       device=x.device)
    for n in range(n_levels):
        hist[:, :, n] = ((q == n) & mask).sum(-1, dtype=torch.int32)
    return packed, hist.reshape(r, nb * HIST_WIDTH)


def encode_tiles_2d(x: torch.Tensor, cmin: torch.Tensor, cmax: torch.Tensor,
                    n_levels: int, bits: int, sb_cols: int, bs: int,
                    bs_last: int | None = None, band_valid=None):
    """Fused encode over a banded 2-D view.

    x: (R, C) with C == n_sblocks * sb_cols; cmin/cmax: (R, n_sblocks)
    float32 per-(row, band) ranges; ``bs`` is the valid element count per
    band (<= sb_cols) and ``bs_last`` the last band's; ``band_valid``
    (n_sblocks,) overrides both with explicit per-band counts (2-D plans:
    ragged edge tiles).  Returns (packed (R, C // per) uint8,
    hist (R, n_sblocks * HIST_WIDTH) int32).
    """
    if n_levels > HIST_WIDTH:
        raise ValueError(f"n_levels {n_levels} > {HIST_WIDTH}")
    per = pack_width(bits)
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D, got shape {tuple(x.shape)}")
    r, c = x.shape
    if c % sb_cols or sb_cols % per:
        raise ValueError(f"C {c} not a multiple of sb_cols {sb_cols}, or "
                         f"sb_cols not a multiple of {per}")
    nb = c // sb_cols
    if tuple(cmin.shape) != (r, nb) or tuple(cmax.shape) != (r, nb):
        raise ValueError(f"range tables must be {(r, nb)}")
    valid = band_valid_array(nb, bs, bs_last, band_valid, device=x.device)
    if _on_cpu(x):
        return encode_tiles_plain(x, cmin, cmax, valid, n_levels, bits,
                                  sb_cols)
    _build.check_cuda("x", x, tuple(_build.DTYPE_CODES))
    _build.check_cuda("cmin", cmin, (torch.float32,))
    _build.check_cuda("cmax", cmax, (torch.float32,))
    packed = torch.empty((r, c // per), dtype=torch.uint8, device=x.device)
    # the kernel stores every histogram entry (each block owns its cells)
    hist = torch.empty((r, nb * HIST_WIDTH), dtype=torch.int32,
                       device=x.device)
    if r == 0:
        return packed, hist
    _build.launch("encode_tiles", "repro_encode_tiles", x.data_ptr(),
                  _build.DTYPE_CODES[x.dtype], r, c, sb_cols, nb,
                  cmin.data_ptr(), cmax.data_ptr(), valid.data_ptr(),
                  n_levels, bits, packed.data_ptr(), hist.data_ptr())
    return packed, hist
