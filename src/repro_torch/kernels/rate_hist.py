"""Quantizer-index histogram for in-graph rate estimation, CUDA for Hopper.

The entropy model (:mod:`repro_torch.core.rate_model`) needs only the
N-bin histogram of quantizer indices.  :func:`index_histogram_2d`
replaces the Pallas kernel ``repro/kernels/rate_hist.py`` ``_kernel``
(``index_histogram_2d``), the ``codec=`` serving hookup's rate estimate.
Source: ``csrc/rate_hist.cu`` ``repro_index_histogram``.
:func:`index_histogram_tiles` replaces ``_kernel_tiles``
(``index_histogram_tiles_2d`` plus the wrapper's fold into channel
groups): one N-bin histogram per ``TilePlan`` tile, the tiled codecs'
rate estimate.  Source:
``csrc/rate_hist.cu`` ``repro_index_histogram_tiles``.

Both are bound by bytes on the card (one int32 read per index); at the
serving sizes by their launch.  A call of either is one device
operation: no fill, no copy around it.  Threads count in registers.
The global one takes one block for a small input, a cluster of eight
blocks meeting in shared memory for a decode boundary, and for a larger
one many blocks whose last to finish sums their rows, through the
current stream's ticket word (:func:`~repro_torch.kernels._build.
hist_ticket`), so calls on several streams may run at once.  The tiled
one gives each tile a warp, a block or a cluster of eight blocks, by
tile size, and stores every bin once (see the source note).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import torch

from ..core.tiling import TilePlan
from . import _build
from .fused_clip_quant import channel_major, tile_ids, tile_maps

MAX_LEVELS = 64


def index_histogram_plain(idx: torch.Tensor, n_levels: int) -> torch.Tensor:
    """Plain torch version of :func:`index_histogram_2d`: one equality
    count per level, like the reference kernel's loop."""
    return torch.stack([(idx == n).sum(dtype=torch.int32)
                        for n in range(n_levels)])


def index_histogram_2d(idx: torch.Tensor, n_levels: int) -> torch.Tensor:
    """idx: int32 indices, any shape.  Returns (n_levels,) int32 counts of
    each value in [0, n_levels); other values are not counted."""
    if n_levels > MAX_LEVELS:
        raise ValueError(f"n_levels {n_levels} > {MAX_LEVELS}")
    if idx.device.type == "cpu":
        return index_histogram_plain(idx, n_levels)
    if idx.device.type != "cuda":
        raise ValueError(f"unsupported device {idx.device}")
    _build.check_cuda("idx", idx, (torch.int32,))
    if not idx.numel():
        return torch.zeros(n_levels, dtype=torch.int32, device=idx.device)
    hist = torch.empty(n_levels, dtype=torch.int32, device=idx.device)
    rows = _build.hist_rows(idx.numel(), idx.device)
    _build.launch("index_histogram", "repro_index_histogram",
                  idx.data_ptr(), idx.numel(), n_levels, hist.data_ptr(),
                  rows.data_ptr(), rows.shape[0],
                  _build.hist_ticket(idx.device).data_ptr())
    return hist


def index_histogram_tiles_plain(idx: torch.Tensor, n_levels: int,
                                maps) -> torch.Tensor:
    """Plain torch version of :func:`index_histogram_tiles`: counts of
    each value in [0, n_levels) by tile id over the channel-major view."""
    im = channel_major(idx, maps).long()
    tid = tile_ids(maps).expand(maps.c, maps.m)
    ok = (im >= 0) & (im < n_levels)
    n_tiles = (maps.c + maps.group_size - 1) // maps.group_size \
        * maps.n_sblocks
    hist = torch.zeros(n_tiles * n_levels, dtype=torch.int32,
                       device=idx.device)
    sel = (tid * n_levels + im)[ok]
    hist.index_add_(0, sel, torch.ones_like(sel, dtype=torch.int32))
    return hist.reshape(-1, maps.n_sblocks, n_levels)


def index_histogram_tiles(idx: torch.Tensor, n_levels: int,
                          plan: TilePlan) -> torch.Tensor:
    """idx: int32 indices shaped like a tensor the plan takes.  Returns
    (n_cgroups, n_sblocks, n_levels) int32 per-tile counts of each value
    in [0, n_levels); other values are not counted."""
    if n_levels > MAX_LEVELS:
        raise ValueError(f"n_levels {n_levels} > {MAX_LEVELS}")
    maps = tile_maps(plan, idx.shape, idx.device)
    if idx.device.type == "cpu":
        return index_histogram_tiles_plain(idx, n_levels, maps)
    if idx.device.type != "cuda":
        raise ValueError(f"unsupported device {idx.device}")
    _build.check_cuda("idx", idx, (torch.int32,))
    _build.check_numel("idx", idx)
    shape = (plan.n_cgroups, plan.n_sblocks, n_levels)
    if not idx.numel():
        return torch.zeros(shape, dtype=torch.int32, device=idx.device)
    hist = torch.empty(shape, dtype=torch.int32, device=idx.device)
    _build.launch("index_histogram_tiles", "repro_index_histogram_tiles",
                  idx.data_ptr(), maps.c, maps.inner, maps.group_size,
                  plan.n_tiles, maps.n_sblocks, maps.bounds.data_ptr(),
                  _build.ptr(maps.perm), maps.max_tile, n_levels,
                  hist.data_ptr())
    return hist
