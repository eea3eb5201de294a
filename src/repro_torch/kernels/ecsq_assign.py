"""Non-uniform (ECSQ) quantization by decision thresholds, CUDA for Hopper.

Deploy-time counterpart of the paper's Algorithm 1: given designed
thresholds t_1..t_{N-1} and reconstruction levels x_0..x_{N-1}, each
activation maps to ``idx = #{t_k <= clip(x)}`` (ties go to the upper
bin, as ``searchsorted(side="right")`` does) and ``deq = level[idx]``.
Two kernels, each beside its plain torch version:

* :func:`ecsq_assign` replaces the Pallas kernel
  ``repro/kernels/ecsq_assign.py`` ``_kernel`` (``ecsq_assign_2d``): one
  quantizer for the tensor.  On request the same launch writes no
  reconstruction and counts the histogram of its indices
  (``want_hist``), the rate estimate of the ECSQ codec's ``codec=``
  hookup, which so launches no index histogram after it;
  :func:`ecsq_assign_pack` is the same launch writing the indices
  bit-packed to the wire width with the histogram, the packed split
  runtime's crossing, which so launches no pack kernel (#9).  Sources:
  ``csrc/ecsq_assign.cu`` ``repro_ecsq_assign`` and
  ``repro_ecsq_assign_pack``.
* :func:`ecsq_assign_tiles` replaces ``_kernel_tiles``
  (``ecsq_assign_tiles_2d``): one quantizer and clip range per
  ``TilePlan`` tile, read in the tensor's own layout.  On the fast route
  of the tiled kernels (channels innermost, one spatial block, channel
  groups of 8-256: :func:`~repro_torch.kernels.fused_clip_quant.
  fast_route`) a thread takes 8 consecutive channels of a row and its
  tile's table once; other plans take the element route, which looks up
  each element's tile through the plan's maps.  Sources: ``csrc/
  ecsq_assign.cu`` ``repro_ecsq_assign_tiles_fast`` and
  ``repro_ecsq_assign_tiles``.  :func:`ecsq_assign_tiles_coded` is the
  fast route writing only the indices, in coded order (channel-major),
  the device entropy stage's input: no reconstruction and no permute
  copy after it.

All are bound by bytes at small N (one read, two writes per element);
the threshold count costs N-1 compares per element (see the source
note).  Each writes no reconstruction when the caller asks for none.
Tables enter as float32, as the reference casts them; the
reconstruction is a table entry, so kernel and plain version agree
exactly.  The per-tensor kernel takes its one table by value in its
launch parameters, so its tables stay in host memory; the per-tile
kernels read theirs from the device.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import torch

from ..core.tiling import TilePlan
from . import _build
from .fused_clip_quant import (_on_cpu, channel_major, check_tables,
                               fast_route, restore, tile_ids, tile_maps)

MAX_LEVELS = 64


def _check_levels(thresholds: torch.Tensor, levels: torch.Tensor) -> int:
    n_levels = levels.shape[-1]
    if not 2 <= n_levels <= MAX_LEVELS:
        raise ValueError(f"n_levels {n_levels} not in [2, {MAX_LEVELS}]")
    if thresholds.shape[-1] != n_levels - 1:
        raise ValueError(f"{thresholds.shape[-1]} thresholds for "
                         f"{n_levels} levels")
    return n_levels


# -- kernel 7: one quantizer for the tensor ------------------------------------

def ecsq_assign_plain(x: torch.Tensor, thresholds: torch.Tensor,
                      levels: torch.Tensor, cmin: float, cmax: float, *,
                      want_deq: bool = True, want_hist: bool = False):
    """Plain torch version of :func:`ecsq_assign` (same count and gather;
    the histogram is :func:`~repro_torch.kernels.rate_hist.
    index_histogram_plain` of the indices)."""
    from .rate_hist import index_histogram_plain
    lo, hi = (torch.tensor(float(v), dtype=torch.float32, device=x.device)
              for v in (cmin, cmax))
    xc = torch.clamp(x.to(torch.float32), lo, hi)
    idx = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for t in thresholds.to(x.device):
        idx += (xc >= t).to(torch.int32)
    deq = levels.to(x.device)[idx.long()].to(x.dtype) if want_deq else None
    if not want_hist:
        return idx, deq
    return idx, deq, index_histogram_plain(idx, levels.shape[-1])


def _check_cuda(x, thresholds, levels) -> None:
    """The kernel takes its table by value: float32 1-D tensors in host
    memory, read by the launch (a table on the card would be a sync)."""
    _build.check_cuda("x", x, tuple(_build.DTYPE_CODES))
    for name, t in (("thresholds", thresholds), ("levels", levels)):
        if t.device.type != "cpu" or t.dtype != torch.float32 \
                or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D float32 "
                             f"tensor in host memory, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def ecsq_assign(x: torch.Tensor, thresholds: torch.Tensor,
                levels: torch.Tensor, cmin: float, cmax: float, *,
                want_deq: bool = True, want_hist: bool = False):
    """ECSQ quantize (+ dequantize) (+ histogram) of ``x`` (any shape),
    one launch on the card.

    thresholds (N-1,) and levels (N,): float32 in host memory (the
    kernel takes them by value; the plain version any device); the clip
    range rounds to float32.  Returns (idx int32, deq in ``x.dtype`` or
    None when ``want_deq`` is false), both shaped like ``x``; with
    ``want_hist`` also the (N,) int32 histogram of idx."""
    n_levels = _check_levels(thresholds, levels)
    if _on_cpu(x):
        return ecsq_assign_plain(x, thresholds, levels, cmin, cmax,
                                 want_deq=want_deq, want_hist=want_hist)
    _check_cuda(x, thresholds, levels)
    idx = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    deq = torch.empty_like(x) if want_deq else None
    out = (idx, deq)
    if not x.numel():
        return out + ((torch.zeros(n_levels, dtype=torch.int32,
                                   device=x.device),) if want_hist else ())
    hist = rows = None
    if want_hist:
        hist = torch.empty(n_levels, dtype=torch.int32, device=x.device)
        rows = _build.hist_rows(x.numel(), x.device)
    _build.launch("ecsq_assign", "repro_ecsq_assign", x.data_ptr(),
                  _build.DTYPE_CODES[x.dtype], x.numel(), float(cmin),
                  float(cmax), thresholds.data_ptr(), levels.data_ptr(),
                  n_levels, idx.data_ptr(), _build.ptr(deq),
                  _build.ptr(hist), _build.ptr(rows),
                  0 if rows is None else rows.shape[0],
                  _build.hist_ticket(x.device).data_ptr() if want_hist
                  else None)
    return out + ((hist,) if want_hist else ())


def ecsq_assign_pack_plain(x: torch.Tensor, thresholds: torch.Tensor,
                           levels: torch.Tensor, cmin: float, cmax: float,
                           bits: int):
    """Plain torch version of :func:`ecsq_assign_pack`: the plain
    quantizer, then :func:`~repro_torch.kernels.pack_bits.
    pack_bits_plain` and the plain index histogram."""
    from .pack_bits import pack_bits_plain
    idx, _, hist = ecsq_assign_plain(x, thresholds, levels, cmin, cmax,
                                     want_deq=False, want_hist=True)
    return pack_bits_plain(idx.reshape(-1), bits), hist


def ecsq_assign_pack(x: torch.Tensor, thresholds: torch.Tensor,
                     levels: torch.Tensor, cmin: float, cmax: float,
                     bits: int):
    """ECSQ quantize + bit-pack + histogram of ``x`` (any shape), one
    launch on the card: the indices leave the launch only as wire bytes.

    Tables as :func:`ecsq_assign`.  Returns (packed uint8 of ``ceil(n /
    (8 // bits))`` bytes, the flat indices' layout of
    :func:`~repro_torch.kernels.pack_bits.pack_bits`; (N,) int32
    histogram of the indices).  ``bits`` is 1, 2 or 4, with ``N <= 2 **
    bits`` (every index fits its lane)."""
    from .pack_bits import PACK_BITS
    n_levels = _check_levels(thresholds, levels)
    if bits not in PACK_BITS:
        raise ValueError(f"packable bit widths are 1/2/4, got {bits}")
    if n_levels > 1 << bits:
        raise ValueError(f"n_levels {n_levels} does not fit {bits}-bit "
                         "lanes")
    if _on_cpu(x):
        return ecsq_assign_pack_plain(x, thresholds, levels, cmin, cmax,
                                      bits)
    _check_cuda(x, thresholds, levels)
    n = x.numel()
    packed = torch.empty(-(-n // (8 // bits)), dtype=torch.uint8,
                         device=x.device)
    if n == 0:
        return packed, torch.zeros(n_levels, dtype=torch.int32,
                                   device=x.device)
    hist = torch.empty(n_levels, dtype=torch.int32, device=x.device)
    rows = _build.hist_rows(n, x.device)
    _build.launch("ecsq_assign", "repro_ecsq_assign_pack", x.data_ptr(),
                  _build.DTYPE_CODES[x.dtype], n, float(cmin), float(cmax),
                  thresholds.data_ptr(), levels.data_ptr(), n_levels, bits,
                  packed.data_ptr(), hist.data_ptr(), rows.data_ptr(),
                  rows.shape[0], _build.hist_ticket(x.device).data_ptr())
    return packed, hist


# -- kernel 8: one quantizer per tile ------------------------------------------

def ecsq_assign_tiles_plain(x: torch.Tensor, lo: torch.Tensor,
                            hi: torch.Tensor, thresholds: torch.Tensor,
                            levels: torch.Tensor, maps, *,
                            want_deq: bool = True):
    """Plain torch version of :func:`ecsq_assign_tiles`: the reference's
    per-tile compare loop over the channel-major view."""
    t = tile_ids(maps)
    xc = torch.clamp(channel_major(x, maps).to(torch.float32),
                     lo.reshape(-1)[t], hi.reshape(-1)[t])
    n_levels = levels.shape[-1]
    thr = thresholds.reshape(-1, n_levels - 1)
    idx = torch.zeros(xc.shape, dtype=torch.int32, device=x.device)
    for k in range(n_levels - 1):
        idx += (xc >= thr[:, k][t]).to(torch.int32)
    if not want_deq:
        return restore(idx, x.shape, maps), None
    deq = levels.reshape(-1, n_levels)[t, idx.long()]
    return restore(idx, x.shape, maps), restore(deq, x.shape, maps).to(x.dtype)


def _check_tiled(x, lo, hi, thresholds, levels, plan: TilePlan):
    n_levels = _check_levels(thresholds, levels)
    maps = tile_maps(plan, x.shape, x.device)
    check_tables(plan, lo=lo, hi=hi, thresholds=thresholds, levels=levels)
    return n_levels, maps


def _check_tiled_cuda(x, lo, hi, thresholds, levels) -> None:
    _build.check_cuda("x", x, tuple(_build.DTYPE_CODES))
    for name, t in (("lo", lo), ("hi", hi), ("thresholds", thresholds),
                    ("levels", levels)):
        _build.check_cuda(name, t, (torch.float32,))
    _build.check_numel("x", x)


def ecsq_assign_tiles(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                      thresholds: torch.Tensor, levels: torch.Tensor,
                      plan: TilePlan, *, want_deq: bool = True):
    """Per-tile ECSQ quantize (+ dequantize) of ``x`` (any shape the plan
    takes), one launch on the card: the fast route where
    :func:`~repro_torch.kernels.fused_clip_quant.fast_route` takes the
    geometry, else the element route.

    lo/hi: (n_cgroups, n_sblocks) float32 clip ranges; thresholds
    (n_cgroups, n_sblocks, N-1) and levels (n_cgroups, n_sblocks, N)
    float32 tables (flat tile id = cgroup * n_sblocks + sblock), all on
    ``x``'s device.  Returns (idx int32, deq in ``x.dtype`` or None when
    ``want_deq`` is false)."""
    n_levels, maps = _check_tiled(x, lo, hi, thresholds, levels, plan)
    if _on_cpu(x):
        return ecsq_assign_tiles_plain(x, lo, hi, thresholds, levels, maps,
                                       want_deq=want_deq)
    _check_tiled_cuda(x, lo, hi, thresholds, levels)
    idx = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    deq = torch.empty_like(x) if want_deq else None
    if not x.numel():
        return idx, deq
    if fast_route(maps):
        _build.launch("ecsq_assign_tiles", "repro_ecsq_assign_tiles_fast",
                      x.data_ptr(), _build.DTYPE_CODES[x.dtype],
                      x.numel() // maps.c, maps.c, maps.group_size,
                      lo.data_ptr(), hi.data_ptr(), thresholds.data_ptr(),
                      levels.data_ptr(), n_levels, idx.data_ptr(),
                      _build.ptr(deq), 0)
    else:
        _build.launch("ecsq_assign_tiles", "repro_ecsq_assign_tiles",
                      x.data_ptr(), _build.DTYPE_CODES[x.dtype], x.numel(),
                      maps.c, maps.inner, maps.cgroup.data_ptr(),
                      _build.ptr(maps.sblock), maps.n_sblocks, lo.data_ptr(),
                      hi.data_ptr(), thresholds.data_ptr(),
                      levels.data_ptr(), n_levels, idx.data_ptr(),
                      _build.ptr(deq))
    return idx, deq


def ecsq_assign_tiles_coded_plain(x: torch.Tensor, lo: torch.Tensor,
                                  hi: torch.Tensor, thresholds: torch.Tensor,
                                  levels: torch.Tensor, maps):
    """Plain torch version of :func:`ecsq_assign_tiles_coded`: the plain
    indices in coded order (the channel-major view, each row permuted to
    coded order where the plan has a permutation), flat."""
    idx, _ = ecsq_assign_tiles_plain(x, lo, hi, thresholds, levels, maps,
                                     want_deq=False)
    rows = channel_major(idx, maps)
    if maps.perm is not None:
        rows = rows[:, maps.perm.long()]
    return rows.reshape(-1)


def ecsq_assign_tiles_coded(x: torch.Tensor, lo: torch.Tensor,
                            hi: torch.Tensor, thresholds: torch.Tensor,
                            levels: torch.Tensor, plan: TilePlan):
    """Per-tile ECSQ indices of ``x`` written straight in coded order
    (``plan.to_coded_order``: channel-major), one launch on the card, on
    the fast route only (other geometries raise); tables as
    :func:`ecsq_assign_tiles`.  Returns flat int32 indices, the input of
    the device entropy stage."""
    n_levels, maps = _check_tiled(x, lo, hi, thresholds, levels, plan)
    if not fast_route(maps):
        raise ValueError("the per-tile ECSQ quantizer writes coded order "
                         "only on its fast route (channels innermost, one "
                         "spatial block)")
    if _on_cpu(x):
        return ecsq_assign_tiles_coded_plain(x, lo, hi, thresholds, levels,
                                             maps)
    _check_tiled_cuda(x, lo, hi, thresholds, levels)
    coded = torch.empty(x.numel(), dtype=torch.int32, device=x.device)
    if x.numel():
        _build.launch("ecsq_assign_tiles", "repro_ecsq_assign_tiles_fast",
                      x.data_ptr(), _build.DTYPE_CODES[x.dtype],
                      x.numel() // maps.c, maps.c, maps.group_size,
                      lo.data_ptr(), hi.data_ptr(), thresholds.data_ptr(),
                      levels.data_ptr(), n_levels, coded.data_ptr(), None, 1)
    return coded
