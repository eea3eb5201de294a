"""Public wrappers around the kernels: shape handling and padding.

Named and shaped like the reference's ``repro/kernels/ops.py`` wrappers.
The encode megakernel takes the same padded 2-D views the reference
builds (the flat view of :func:`flat_layout`, the banded view of
:func:`banded_layout`), so the layouts -- and the host's unpacking of
its output -- stay one definition shared with the reference, field for
field.  The per-tensor quantizer and the index histogram take the flat
tensor as it is: no padding, so no pad copy and no padding count to
correct.  The tiled quantize,
histogram and ECSQ kernels need no banded view: they look up each
element's tile in the tensor's own layout (see
:func:`~repro_torch.kernels.fused_clip_quant.tile_maps`), so their
wrappers only convert the range and ECSQ tables.  :func:`pack_indices`
takes the flat indices as they are: the pack kernel needs no lane view.
"""

from __future__ import annotations

import functools
from collections import OrderedDict

import numpy as np
import torch

from ..core.tiling import PaddedLayout, TilePlan
from .ecsq_assign import (ecsq_assign, ecsq_assign_pack, ecsq_assign_tiles,
                          ecsq_assign_tiles_coded)
from .fused_clip_quant import (clip_quant_2d, clip_quant_pack,
                               clip_quant_tiles, clip_quant_tiles_pack,
                               encode_tiles_2d, pack_width)
from .pack_bits import PACK_BITS, pack_bits
from .rate_hist import index_histogram_2d, index_histogram_tiles

_LANE = 128
_ROW = 8


def _pad_lane(n: int, big: int = 512) -> int:
    """Round ``n`` up to a lane multiple; large sizes to a ``big`` multiple
    (the reference's column block)."""
    cols = max(_LANE, ((n + _LANE - 1) // _LANE) * _LANE)
    if cols > big:
        cols = ((cols + big - 1) // big) * big
    return cols


# host tables (range, ECSQ) already on a device, by content: a codec's
# tables cross once, not on every call (a copy is a device operation)
_TABLES: OrderedDict = OrderedDict()
_TABLES_MAX = 64


def _f32(a, device, shape=None) -> torch.Tensor:
    """Host array or tensor -> contiguous float32 tensor on ``device``.
    A host array's copy is kept by its content (the last
    ``_TABLES_MAX``), so a table is uploaded once; the result is read
    only."""
    if isinstance(a, torch.Tensor):
        t = a.to(device=device, dtype=torch.float32)
        return (t if shape is None else t.reshape(shape)).contiguous()
    arr = np.ascontiguousarray(a, np.float32)
    device = torch.device(device)
    key = (arr.tobytes(), arr.shape, shape, str(device))
    t = _TABLES.get(key)
    if t is None:
        t = torch.from_numpy(arr.copy()).to(device)
        t = (t if shape is None else t.reshape(shape)).contiguous()
        _TABLES[key] = t
        if len(_TABLES) > _TABLES_MAX:
            _TABLES.popitem(last=False)
    else:
        _TABLES.move_to_end(key)
    return t


def flat_layout(n: int) -> PaddedLayout:
    """Geometry of the flat padded (R, C) view ``_to_2d`` builds.

    C is a power-of-two multiple of 128 (<= 1024) and R is rounded up to a
    multiple of min(R, 256) (the reference's block grid; the n=513 case
    once left 128 columns outside a 640-wide view).
    """
    k = max(1, (n + _LANE - 1) // _LANE)
    cols = _LANE * min(8, 1 << max(0, (k - 1).bit_length()))
    rows = (n + cols - 1) // cols
    align = _ROW if rows <= 256 else 256
    rows = ((rows + align - 1) // align) * align
    return PaddedLayout(rows=rows, cols=cols, ch=rows, m=cols,
                        n_sblocks=1, sb_cols=cols, bs=cols, flat_n=n)


def _to_2d(x: torch.Tensor, fill: float):
    """Flatten + pad to the (R, C) view of :func:`flat_layout`.
    Returns (x2d, n_valid); no copy when no padding is needed."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    lay = flat_layout(n)
    if lay.rows * lay.cols == n:
        return flat.contiguous().reshape(lay.rows, lay.cols), n
    padded = torch.full((lay.rows * lay.cols,), fill, dtype=x.dtype,
                        device=x.device)
    padded[:n] = flat
    return padded.reshape(lay.rows, lay.cols), n


def banded_layout(shape, plan: TilePlan) -> PaddedLayout:
    """Geometry of the channel-major banded view the encode megakernel
    takes for a plan: each spatial block padded to a whole lane-aligned
    column band, rows padded to the sublane multiple.  2-D plans have one
    band per (row-block, column-block) cell, sized for the largest tile;
    ragged edge tiles record their true sizes in ``band_valid``."""
    axis = plan.channel_axis % len(shape)
    ch = shape[axis]
    m = 1
    for d, s in enumerate(shape):
        if d != axis:
            m *= s
    sizes = plan.band_sizes(m)
    bs = int(sizes.max())
    sb_cols = _pad_lane(bs)
    align = _ROW if ch <= 256 else 256
    rows = ((ch + align - 1) // align) * align
    return PaddedLayout(rows=rows, cols=plan.n_sblocks * sb_cols, ch=ch,
                        m=m, n_sblocks=plan.n_sblocks, sb_cols=sb_cols,
                        bs=bs,
                        channel_group_size=max(1, plan.channel_group_size),
                        band_valid=tuple(int(s) for s in sizes)
                        if plan.is_2d else None)


@functools.lru_cache(maxsize=64)
def _padded_cols(plan: TilePlan, lay: PaddedLayout) -> np.ndarray:
    """(m,) original flat spatial position -> column of the banded padded
    view (2-D plans: tile elements land contiguously in their band)."""
    perm = plan.spatial_perm(lay.m)
    out = np.empty(lay.m, np.int64)
    out[perm] = lay.coded_cols()
    out.setflags(write=False)    # shared cache entry: guard the layout map
    return out


def _banded_view(x: torch.Tensor, lay: PaddedLayout, plan: TilePlan):
    """Scatter ``x`` into the banded view ``lay`` describes.  Returns
    (xp (rows, cols), moved_shape); padding is zero-filled and masked or
    stripped downstream.  2-D plans scatter through the coded-order
    column map, 1-D plans pad each band in place."""
    axis = plan.channel_axis % x.dim()
    xm = torch.movedim(x, axis, 0)
    moved_shape = tuple(xm.shape)
    x2 = xm.reshape(lay.ch, -1)
    xp = torch.zeros((lay.rows, lay.cols), dtype=x.dtype, device=x.device)
    if lay.band_valid is not None:
        pcols = torch.from_numpy(_padded_cols(plan, lay).copy()).to(x.device)
        xp[:lay.ch, pcols] = x2
        return xp, moved_shape
    mp = lay.n_sblocks * lay.bs
    if mp != lay.m:
        x2 = torch.cat([x2, x2.new_zeros((lay.ch, mp - lay.m))], dim=1)
    xp[:lay.ch].view(lay.ch, lay.n_sblocks, lay.sb_cols)[:, :, :lay.bs] = \
        x2.reshape(lay.ch, lay.n_sblocks, lay.bs)
    return xp, moved_shape


def _row_ranges(lo: torch.Tensor, hi: torch.Tensor, lay: PaddedLayout):
    """Expand (n_cgroups, n_sblocks) range tables to per-row columns;
    padding rows get a dummy [0, 1] range."""
    cg = torch.arange(lay.ch, device=lo.device) // lay.channel_group_size
    lo_r = torch.zeros((lay.rows, lay.n_sblocks), dtype=torch.float32,
                       device=lo.device)
    hi_r = torch.ones_like(lo_r)
    lo_r[:lay.ch] = lo.to(torch.float32)[cg]
    hi_r[:lay.ch] = hi.to(torch.float32)[cg]
    return lo_r, hi_r


def _unband(a: torch.Tensor, lay: PaddedLayout, moved_shape, axis: int,
            plan: TilePlan | None = None) -> torch.Tensor:
    """Inverse of :func:`_banded_view` for a same-shape output."""
    if lay.band_valid is not None:
        pcols = torch.from_numpy(_padded_cols(plan, lay).copy()).to(a.device)
        return torch.movedim(a[:lay.ch][:, pcols].reshape(moved_shape), 0,
                             axis)
    a = a[:lay.ch].reshape(lay.ch, lay.n_sblocks, lay.sb_cols)[:, :, :lay.bs]
    mp = lay.n_sblocks * lay.bs
    return torch.movedim(
        a.reshape(lay.ch, mp)[:, :lay.m].reshape(moved_shape), 0, axis)


def clip_quantize(x: torch.Tensor, *, cmin: float, cmax: float,
                  n_levels: int, want_deq: bool = True,
                  want_hist: bool = False):
    """Fused clip+quantize+dequantize.  Returns (idx int32, dequantized,
    or None without ``want_deq``), and with ``want_hist`` the (n_levels,)
    histogram of idx from the same launch.  The kernel takes the tensor
    as it is: no padded view."""
    return clip_quant_2d(x.contiguous(), cmin, cmax, n_levels,
                         want_deq=want_deq, want_hist=want_hist)


def clip_quantize_pack(x: torch.Tensor, *, cmin: float, cmax: float,
                       n_levels: int, bits: int):
    """Fused clip+quantize+bit-pack+histogram: (packed uint8 wire bytes of
    the flat indices, (n_levels,) histogram), one launch on the card."""
    return clip_quant_pack(x.contiguous(), cmin, cmax, n_levels, bits)


def clip_quantize_tiled(x: torch.Tensor, lo, hi, *, n_levels: int,
                        plan: TilePlan, want_deq: bool = True,
                        want_hist: bool = False):
    """TilePlan fused clip+quantize+dequantize (channel x spatial tiling).

    ``lo``/``hi`` are (n_cgroups, n_sblocks) range tables over the plan's
    channel-major (C, M) view (any array of that size: the per-channel
    codec stores its group table raveled).  Returns (idx int32, deq in
    ``x.dtype`` or None without ``want_deq``) shaped like ``x``, and with
    ``want_hist`` the (n_cgroups, n_sblocks, N) per-tile counts from the
    same launch (the fast route's plans only)."""
    shape = (plan.n_cgroups, plan.n_sblocks)
    return clip_quant_tiles(x.contiguous(), _f32(lo, x.device, shape),
                            _f32(hi, x.device, shape), n_levels, plan,
                            want_deq=want_deq, want_hist=want_hist)


def clip_quantize_tiled_pack(x: torch.Tensor, lo, hi, *, n_levels: int,
                             plan: TilePlan, bits: int):
    """TilePlan fused clip+quantize+bit-pack+histogram: (packed uint8 wire
    bytes of the flat indices, (n_cgroups, 1, N) per-tile counts), one
    launch on the card (the fast route's plans only)."""
    shape = (plan.n_cgroups, plan.n_sblocks)
    return clip_quant_tiles_pack(x.contiguous(), _f32(lo, x.device, shape),
                                 _f32(hi, x.device, shape), n_levels, plan,
                                 bits)


def clip_quantize_channels(x: torch.Tensor, cmin, cmax, *, n_levels: int,
                           channel_axis: int = -1):
    """Per-channel fused clip+quantize+dequantize: the one-spatial-block
    case of :func:`clip_quantize_tiled` (kept as a named entry point)."""
    plan = TilePlan(channel_axis=channel_axis, channel_group_size=1,
                    spatial_block_size=0, n_channels=int(np.size(cmin)))
    return clip_quantize_tiled(x, cmin, cmax, n_levels=n_levels, plan=plan)


def ecsq_quantize(x: torch.Tensor, thresholds, levels, *, cmin: float,
                  cmax: float, want_deq: bool = True,
                  want_hist: bool = False):
    """Threshold-based non-uniform quantize (+ dequantize): (idx int32,
    deq or None without ``want_deq``), and with ``want_hist`` the (N,)
    histogram of idx from the same launch.  The tables stay in host
    memory: the kernel takes them by value."""
    return ecsq_assign(x.contiguous(), _f32(thresholds, "cpu"),
                       _f32(levels, "cpu"), cmin, cmax,
                       want_deq=want_deq, want_hist=want_hist)


def ecsq_quantize_pack(x: torch.Tensor, thresholds, levels, *, cmin: float,
                       cmax: float, bits: int):
    """Threshold-based non-uniform quantize + bit-pack + histogram:
    (packed uint8 wire bytes of the flat indices, (N,) histogram), one
    launch on the card."""
    return ecsq_assign_pack(x.contiguous(), _f32(thresholds, "cpu"),
                            _f32(levels, "cpu"), cmin, cmax, bits)


def _ecsq_tables(x, lo, hi, thresholds, levels, plan: TilePlan):
    shape = (plan.n_cgroups, plan.n_sblocks)
    return (x.contiguous(), _f32(lo, x.device, shape),
            _f32(hi, x.device, shape),
            _f32(thresholds, x.device, shape + (-1,)),
            _f32(levels, x.device, shape + (-1,)), plan)


def ecsq_quantize_tiled(x: torch.Tensor, lo, hi, thresholds, levels, *,
                        n_levels: int, plan: TilePlan, want_deq: bool = True):
    """Per-tile ECSQ quantize (+ dequantize).

    ``thresholds`` (n_tiles, N-1) / ``levels`` (n_tiles, N) are the
    :class:`~repro_torch.core.tiling.TileECSQ` tables (flat tile id =
    cgroup * n_sblocks + sblock); ``lo``/``hi`` the (n_cgroups,
    n_sblocks) clip ranges.  Bit-exact indices against the threshold
    compare formula (``xc >= t``)."""
    return ecsq_assign_tiles(*_ecsq_tables(x, lo, hi, thresholds, levels,
                                           plan), want_deq=want_deq)


def ecsq_quantize_tiled_coded(x: torch.Tensor, lo, hi, thresholds, levels,
                              *, n_levels: int, plan: TilePlan):
    """Per-tile ECSQ indices in coded order (flat, channel-major), one
    launch on the card: the fast route's plans only (tables as
    :func:`ecsq_quantize_tiled`)."""
    return ecsq_assign_tiles_coded(*_ecsq_tables(x, lo, hi, thresholds,
                                                 levels, plan))


def encode_fused(x: torch.Tensor, lo, hi, *, n_levels: int, bits: int,
                 plan: TilePlan | None = None):
    """Single-pass fused encode: clip + quantize + bit-pack + histogram.

    Returns (packed uint8, hist_raw int32, :class:`PaddedLayout`); the
    host recovers coded-order indices with ``layout.unpack_indices`` and
    per-tile counts with ``layout.group_hists``.

    ``plan is None`` is the per-tensor mode (``lo``/``hi`` floats): the
    flat view is padded with ``lo`` so the tail quantizes to index 0 (the
    histogram correction contract).  Otherwise ``lo``/``hi`` are
    (n_cgroups, n_sblocks) range tables and the megakernel runs over the
    plan's banded view (:func:`banded_layout`), 1-D runs and 2-D tiles
    alike.
    """
    if plan is not None:
        plan.resolve(tuple(x.shape))
        lay = banded_layout(tuple(x.shape), plan)
        xp, _ = _banded_view(x, lay, plan)
        shape = (plan.n_cgroups, plan.n_sblocks)
        lo_r, hi_r = _row_ranges(_f32(lo, x.device, shape),
                                 _f32(hi, x.device, shape), lay)
        packed, hist = encode_tiles_2d(xp, lo_r, hi_r, n_levels, bits,
                                       sb_cols=lay.sb_cols, bs=lay.bs,
                                       bs_last=lay.bs_last,
                                       band_valid=lay.band_valid)
        return packed, hist, lay
    lay = flat_layout(int(np.prod(tuple(x.shape))))
    x2d, _ = _to_2d(x, float(lo))
    r, c = x2d.shape
    lo_r = torch.full((r, 1), float(np.float32(lo)), dtype=torch.float32,
                      device=x.device)
    hi_r = torch.full((r, 1), float(np.float32(hi)), dtype=torch.float32,
                      device=x.device)
    packed, hist = encode_tiles_2d(x2d, lo_r, hi_r, n_levels, bits,
                                   sb_cols=c, bs=c)
    return packed, hist, lay


def unpack_bytes(packed: np.ndarray, bits: int) -> np.ndarray:
    """Host inverse of the kernel bit-pack: uint8 byte values -> int32
    indices, ``per = 8 // bits`` per byte (identity for ``per == 1``).
    Same little-end-first lane layout as ``FeatureCodec.unpack``."""
    packed = np.asarray(packed, np.uint8)
    per = pack_width(bits)
    if per == 1:
        return packed.astype(np.int32)
    shifts = (np.arange(per, dtype=np.uint8) * bits)[None, :]
    mask = np.uint8((1 << bits) - 1)
    vals = (packed.reshape(-1, 1) >> shifts) & mask
    return vals.reshape(packed.shape[:-1] + (-1,)).astype(np.int32)


def pack_indices(idx: torch.Tensor, *, bits: int) -> torch.Tensor:
    """Pack int32 indices to ``bits``-wide uint8 lanes on the tensor's
    device (the pack kernel on the card).

    Same byte layout as ``TorchBackend.pack_indices`` (see
    :mod:`~repro_torch.kernels.pack_bits`); ``bits`` must be 1, 2 or 4
    (wire widths where a byte holds several indices).  Returns a flat
    uint8 tensor of ``ceil(n / (8 // bits))`` bytes, zero-padded in the
    last byte.
    """
    if bits not in PACK_BITS:
        raise ValueError(f"packable bit widths are 1/2/4, got {bits}")
    return pack_bits(idx.reshape(-1).to(torch.int32).contiguous(), bits)


def index_histogram_tiled(idx: torch.Tensor, *, n_levels: int,
                          plan: TilePlan) -> torch.Tensor:
    """Per-tile index histogram: (n_cgroups, n_sblocks, N) int32, the
    tile-resolved counterpart of :func:`index_histogram`."""
    return index_histogram_tiles(idx.to(torch.int32).contiguous(), n_levels,
                                 plan)


def index_histogram(idx: torch.Tensor, *, n_levels: int) -> torch.Tensor:
    """Histogram of quantizer indices: the kernel takes the flat indices
    as they are (no padded view, no copy, nothing launched around it)."""
    return index_histogram_2d(idx.reshape(-1).to(torch.int32).contiguous(),
                              n_levels)

