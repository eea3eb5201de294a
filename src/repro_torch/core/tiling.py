"""TilePlan: one geometry object for every codec granularity.

A *tile* is a (channel-group x spatial-block) region of the feature
tensor: channels along ``channel_axis`` are grouped ``channel_group_size``
at a time, and the remaining (flattened, channel-major) spatial extent is
cut into spatial blocks.  Every tile carries its own clipping range (and
optionally its own ECSQ table), so the paper's per-tensor mode, the
companion paper's per-channel mosaic (arXiv 2105.06002) and full
channel x spatial tiling (the spatial redundancy of arXiv 1804.09963) are
all the *same* code path at different plan settings:

    per-tensor   1 tile              (no plan; scalar fast path)
    per-channel  plan(gc=g, bs=0)    n_sblocks == 1, spatial extent free
    tiled (1-D)  plan(gc=g, bs=b)    channel groups x flat spatial runs
    tiled (2-D)  plan(gc=g, bhw=(bh, bw))  channel groups x row x column
                                      blocks of the (H, W) spatial grid

``spatial_block_size == 0`` means "one spatial block spanning everything";
only then may ``spatial_extent`` stay ``None`` (the plan accepts tensors
of any spatial size, like the old per-channel mode).  With ``bs > 0`` the
spatial extent is fixed at calibration time: tile ranges are positional.

2-D mode (``spatial_block_hw``) views the flattened spatial extent as a
``spatial_hw = (H, W)`` grid (W = the innermost non-channel dim; H folds
everything else) and cuts it into (bh, bw) row x column blocks -- conv
feature maps keep their row x column structure instead of smearing it
across flat runs.  Edge blocks at non-multiple H/W are simply smaller
(``band_sizes``); spatial block id ``b = (row // bh) * n_cblocks +
(col // bw)`` and the flat tile id stays ``cgroup * n_sblocks + b``.

Coded order: tiled bitstreams serialize indices in *tile-major* (channel-
major) order.  For 1-D plans that is plain
``moveaxis(channel -> 0).reshape(C, M).ravel()``; 2-D plans additionally
permute each channel row so every tile's elements are contiguous
(row-major within the tile -- the stable sort of positions by block id,
:meth:`spatial_perm`).  Either way consecutive coded symbols share a tile
(aligned index distributions for the chunk-static entropy stage) and
chunk boundaries can align to tile runs (see :meth:`align_chunk_elems`).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """Tile geometry for one calibrated codec.

    ``channel_axis`` is kept as configured (may be negative) and
    normalized per tensor; ``n_channels`` is the calibrated channel count;
    ``spatial_extent`` is the calibrated flattened spatial size (``None``
    only when ``spatial_block_size == 0``).
    """

    channel_axis: int
    channel_group_size: int
    spatial_block_size: int
    n_channels: int
    spatial_extent: int | None = None
    # 2-D (row x column) mode: the spatial extent is an (H, W) grid cut
    # into (bh, bw) blocks.  Mutually exclusive with spatial_block_size.
    spatial_hw: tuple[int, int] | None = None
    spatial_block_hw: tuple[int, int] | None = None

    def __post_init__(self):
        if self.channel_group_size < 1:
            raise ValueError("channel_group_size must be >= 1")
        if self.spatial_block_size < 0:
            raise ValueError("spatial_block_size must be >= 0")
        if self.spatial_block_hw is not None:
            bh, bw = self.spatial_block_hw
            if bh < 1 or bw < 1:
                raise ValueError("spatial_block_hw blocks must be >= 1")
            if self.spatial_block_size:
                raise ValueError("spatial_block_size and spatial_block_hw "
                                 "are mutually exclusive")
            if self.spatial_hw is None:
                raise ValueError("2-D tiling needs the spatial_hw grid")
            h, w = self.spatial_hw
            if h < 1 or w < 1:
                raise ValueError("spatial_hw dims must be >= 1")
            if self.spatial_extent != h * w:
                raise ValueError(
                    f"spatial_extent {self.spatial_extent} != "
                    f"spatial_hw product {h * w}")
        elif self.spatial_hw is not None:
            raise ValueError("spatial_hw is only meaningful with "
                             "spatial_block_hw")
        if self.spatial_block_size > 0 and self.spatial_extent is None:
            raise ValueError("spatial tiling needs a fixed spatial_extent")

    # -- derived geometry -----------------------------------------------------

    @property
    def is_2d(self) -> bool:
        return self.spatial_block_hw is not None

    @property
    def n_cgroups(self) -> int:
        return -(-self.n_channels // self.channel_group_size)

    @property
    def n_rblocks(self) -> int:
        """Row-block count of the 2-D spatial grid (1 for 1-D plans)."""
        if not self.is_2d:
            return 1
        return -(-self.spatial_hw[0] // self.spatial_block_hw[0])

    @property
    def n_cblocks(self) -> int:
        """Column-block count of the 2-D spatial grid (n_sblocks in 1-D)."""
        if not self.is_2d:
            return self.n_sblocks
        return -(-self.spatial_hw[1] // self.spatial_block_hw[1])

    @property
    def n_sblocks(self) -> int:
        if self.is_2d:
            return self.n_rblocks * self.n_cblocks
        if self.spatial_block_size == 0:
            return 1
        return -(-self.spatial_extent // self.spatial_block_size)

    @property
    def n_tiles(self) -> int:
        return self.n_cgroups * self.n_sblocks

    def block_extent(self, spatial_extent: int) -> int:
        """Elements per full spatial block (the whole extent when bs == 0;
        ``bh * bw`` in 2-D mode -- edge blocks may be smaller)."""
        if self.is_2d:
            bh, bw = self.spatial_block_hw
            return min(bh, self.spatial_hw[0]) * min(bw, self.spatial_hw[1])
        return self.spatial_block_size or spatial_extent

    # -- per-tensor validation ------------------------------------------------

    def resolve(self, shape: tuple[int, ...]) -> tuple[int, int, int]:
        """Validate ``shape`` against the plan; returns (axis, C, M)."""
        axis = self.channel_axis % len(shape)
        c = shape[axis]
        if c != self.n_channels:
            raise ValueError(
                f"axis {axis} has {c} channels, plan was calibrated "
                f"for {self.n_channels}")
        m = 1
        for d, s in enumerate(shape):
            if d != axis:
                m *= s
        if self.spatial_extent is not None and m != self.spatial_extent:
            raise ValueError(
                f"tensor has spatial extent {m}, plan was calibrated "
                f"for {self.spatial_extent}")
        if self.is_2d:
            # the (H, W) grid is positional, not just the extent: a
            # same-M tensor with a different row length would silently
            # mis-tile every block
            grid = spatial_grid(shape, self.channel_axis)
            if grid != self.spatial_hw:
                raise ValueError(
                    f"tensor has spatial grid {grid}, plan was "
                    f"calibrated for {self.spatial_hw}")
        return axis, c, m

    # -- element <-> tile maps (host/numpy; jit-constant under trace) ----------

    def cgroup_ids(self) -> np.ndarray:
        """(C,) int32: channel -> channel-group id."""
        return (np.arange(self.n_channels, dtype=np.int32)
                // self.channel_group_size)

    def sblock_ids(self, spatial_extent: int) -> np.ndarray:
        """(M,) int32: flattened spatial position -> spatial-block id."""
        if self.is_2d:
            if spatial_extent != self.spatial_extent:
                raise ValueError(
                    f"spatial extent {spatial_extent} != plan's "
                    f"{self.spatial_extent}")
            h, w = self.spatial_hw
            bh, bw = self.spatial_block_hw
            pos = np.arange(spatial_extent, dtype=np.int64)
            ids = (pos // w // bh) * self.n_cblocks + (pos % w) // bw
            return ids.astype(np.int32)
        return (np.arange(spatial_extent, dtype=np.int32)
                // self.block_extent(spatial_extent))

    def band_sizes(self, spatial_extent: int) -> np.ndarray:
        """(n_sblocks,) int64: valid element count of every spatial block
        (edge blocks at non-multiple extents are smaller)."""
        nb = self.n_sblocks
        if self.is_2d:
            h, w = self.spatial_hw
            bh, bw = self.spatial_block_hw
            rows = np.minimum(bh, h - np.arange(self.n_rblocks) * bh)
            cols = np.minimum(bw, w - np.arange(self.n_cblocks) * bw)
            return (rows[:, None] * cols[None, :]).reshape(-1) \
                .astype(np.int64)
        bs = self.block_extent(spatial_extent)
        sizes = np.full(nb, bs, np.int64)
        sizes[-1] = spatial_extent - (nb - 1) * bs
        return sizes

    def coded_band_bounds(self, spatial_extent: int) -> np.ndarray:
        """(n_sblocks + 1,) cumulative band boundaries in a channel row of
        the coded-order (C, M) view: block ``b`` occupies columns
        ``[bounds[b], bounds[b+1])`` of every coded row."""
        return np.concatenate(
            [[0], np.cumsum(self.band_sizes(spatial_extent))])

    def spatial_perm(self, spatial_extent: int) -> np.ndarray | None:
        """(M,) int64 coded-position -> original flat spatial position, or
        ``None`` when coded order is the identity (1-D plans: flat runs
        are already contiguous).  The permutation is the stable sort of
        positions by spatial block id, i.e. row-major within each tile."""
        if not self.is_2d:
            return None
        return _spatial_perm_2d(self, spatial_extent)

    def tile_ids_2d(self, spatial_extent: int) -> np.ndarray:
        """(C, M) int32 channel-major view of element -> flat tile id
        (cgroup-major, sblock-minor -- the header's table order)."""
        return (self.cgroup_ids()[:, None] * self.n_sblocks
                + self.sblock_ids(spatial_extent)[None, :])

    def tile_ids(self, shape: tuple[int, ...]) -> np.ndarray:
        """int32 array of ``shape``: element -> flat tile id."""
        axis, c, m = self.resolve(shape)
        tid = self.tile_ids_2d(m)                             # (C, M)
        moved = [shape[axis]] + [s for d, s in enumerate(shape) if d != axis]
        return np.moveaxis(tid.reshape(moved), 0, axis)

    def tile_slices(self, c: int, m: int):
        """Yield (tile_id, channel slice, spatial index) over the
        channel-major (C, M) view -- the calibration iteration order.
        The spatial index is a slice for 1-D plans (contiguous runs) and
        an int64 position array for 2-D plans (row x column blocks are
        strided in the flat view)."""
        gc = self.channel_group_size
        if self.is_2d:
            perm = self.spatial_perm(m)
            bounds = self.coded_band_bounds(m)
            for g in range(self.n_cgroups):
                cs = slice(g * gc, min((g + 1) * gc, c))
                for s in range(self.n_sblocks):
                    yield (g * self.n_sblocks + s, cs,
                           perm[bounds[s]:bounds[s + 1]])
            return
        bs = self.block_extent(m)
        for g in range(self.n_cgroups):
            for s in range(self.n_sblocks):
                yield (g * self.n_sblocks + s,
                       slice(g * gc, min((g + 1) * gc, c)),
                       slice(s * bs, min((s + 1) * bs, m)))

    # -- coded order ----------------------------------------------------------

    def to_coded_order(self, arr: np.ndarray) -> np.ndarray:
        """Tensor (original layout) -> flat tile-major coded order."""
        axis, c, m = self.resolve(arr.shape)
        rows = np.moveaxis(np.asarray(arr), axis, 0).reshape(c, m)
        perm = self.spatial_perm(m)
        if perm is not None:
            rows = rows[:, perm]
        return rows.reshape(-1)

    def from_coded_order(self, flat: np.ndarray,
                         shape: tuple[int, ...]) -> np.ndarray:
        """Inverse of :meth:`to_coded_order` for a known tensor shape."""
        axis, c, m = self.resolve(shape)
        rows = np.asarray(flat).reshape(c, m)
        perm = self.spatial_perm(m)
        if perm is not None:
            inv = np.empty_like(perm)
            inv[perm] = np.arange(m, dtype=perm.dtype)
            rows = rows[:, inv]
        moved = [shape[axis]] + [s for d, s in enumerate(shape) if d != axis]
        return np.moveaxis(rows.reshape(moved), 0, axis)

    def align_chunk_elems(self, chunk_elems: int, shape: tuple[int, ...]
                          ) -> int:
        """Round a streaming chunk size up so chunk boundaries never split
        a tile's contiguous run in coded order.

        In tile-major order the tile changes at every spatial-block
        boundary and at every row (channel) end, so a boundary-safe chunk
        period is the common block run length when every block has it
        (all bands equal -- 1-D rows tiling exactly, or a 2-D grid whose
        (H, W) are block multiples) and a whole row ``M`` otherwise.
        """
        _, _, m = self.resolve(shape)
        sizes = self.band_sizes(m)
        run = int(sizes[0]) if (sizes == sizes[0]).all() else m
        return max(run, -(-chunk_elems // run) * run)


@functools.lru_cache(maxsize=64)
def _spatial_perm_2d(plan: TilePlan, spatial_extent: int) -> np.ndarray:
    """Cached coded-order permutation (plans are frozen/hashable and the
    2-D extent is pinned, so one array per plan is ever built)."""
    perm = np.argsort(plan.sblock_ids(spatial_extent),
                      kind="stable").astype(np.int64)
    perm.setflags(write=False)   # shared cache entry: guard the coded order
    return perm


@dataclasses.dataclass(frozen=True)
class PaddedLayout:
    """Geometry of the lane-padded 2-D device view the fused encode pass
    writes, shared by the kernel wrappers (which build the view in-graph)
    and the host (which strips it after the single device->host transfer).

    Tiled view: channel-major rows, each spatial block padded to a whole
    ``sb_cols``-column band (``cols == n_sblocks * sb_cols``), rows padded
    to a sublane multiple.  Flat (per-tensor) view: ``flat_n`` is set and
    the data is simply the raveled tensor padded at the tail -- the pad
    fill is ``cmin`` so padding quantizes to index 0 (the histogram
    correction relies on this).
    """

    rows: int                 # padded row count of the device view
    cols: int                 # padded column count
    ch: int                   # valid rows (channels)
    m: int                    # valid flattened spatial extent per channel
    n_sblocks: int            # spatial bands
    sb_cols: int              # padded columns per band
    bs: int                   # valid elements per band (capacity: the
    #                           largest band when band_valid is set)
    channel_group_size: int = 1
    flat_n: int | None = None  # per-tensor flat view: valid element count
    # 2-D plans: per-band valid element counts (edge bands shorter); when
    # None every band holds `bs` elements except possibly the last
    band_valid: tuple[int, ...] | None = None

    @property
    def bs_last(self) -> int:
        """Valid elements in the last band (its tail may be padding)."""
        if self.band_valid is not None:
            return self.band_valid[-1]
        return self.m - (self.n_sblocks - 1) * self.bs

    def band_sizes(self) -> np.ndarray:
        """(n_sblocks,) valid element count per band."""
        if self.band_valid is not None:
            return np.asarray(self.band_valid, np.int64)
        sizes = np.full(self.n_sblocks, self.bs, np.int64)
        sizes[-1] = self.bs_last
        return sizes

    def coded_cols(self) -> np.ndarray:
        """(m,) padded-view column of the k-th coded element of a row:
        bands are left-aligned in their ``sb_cols`` column slot, so the
        concatenation of valid band columns is coded order."""
        sizes = self.band_sizes()
        return np.concatenate(
            [b * self.sb_cols + np.arange(s, dtype=np.int64)
             for b, s in enumerate(sizes)])

    def unpack_indices(self, idx2d: np.ndarray) -> np.ndarray:
        """Padded (rows, cols) index view -> flat coded-order indices."""
        idx2d = np.asarray(idx2d).reshape(self.rows, self.cols)
        if self.flat_n is not None:
            return idx2d.reshape(-1)[:self.flat_n]
        if self.band_valid is not None:
            return idx2d[:self.ch][:, self.coded_cols()].reshape(-1)
        a = idx2d[:self.ch].reshape(self.ch, self.n_sblocks, self.sb_cols)
        a = a[:, :, :self.bs].reshape(self.ch, -1)[:, :self.m]
        return a.reshape(-1)

    def group_hists(self, hist_raw: np.ndarray, n_levels: int,
                    hist_width: int) -> np.ndarray:
        """Kernel per-(row, band) histogram -> (n_cgroups, n_sblocks, N).

        ``hist_raw`` is the megakernel's (rows, n_sblocks * hist_width)
        output; padding rows are dropped and channel rows are summed into
        their groups.  For the flat view all rows collapse into the one
        tile and the tail padding (which quantized to index 0 by the
        cmin-fill contract) is subtracted from bin 0.
        """
        h = np.asarray(hist_raw).reshape(self.rows, self.n_sblocks,
                                         hist_width)[..., :n_levels]
        if self.flat_n is not None:
            out = h.sum(axis=(0, 1), dtype=np.int64)[None, None]
            out[0, 0, 0] -= self.rows * self.cols - self.flat_n
            return out.astype(np.int32)
        h = h[:self.ch]
        gs = max(1, self.channel_group_size)
        starts = np.arange(0, self.ch, gs)
        return np.add.reduceat(h, starts, axis=0).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class TileECSQ:
    """Per-tile non-uniform quantizer tables (row t = flat tile id t).

    The header ships only ``levels``; ``thresholds`` exist sender-side
    (rebuilt per tile via ``ECSQQuantizer.from_levels`` when a receiver
    wants to re-encode).
    """

    levels: np.ndarray       # (n_tiles, N) float32, rows ascending
    thresholds: np.ndarray   # (n_tiles, N-1) float32

    @property
    def n_levels(self) -> int:
        return self.levels.shape[1]


def spatial_grid(shape: tuple[int, ...], channel_axis: int
                 ) -> tuple[int, int]:
    """(H, W) view of the flattened non-channel extent: W is the
    innermost non-channel dim (the column period of the channel-major
    flat view -- W for both NHWC and NCHW conv maps) and H folds every
    other non-channel dim (image rows, plus batch when present)."""
    axis = channel_axis % len(shape)
    rest = [s for d, s in enumerate(shape) if d != axis]
    w = rest[-1] if rest else 1
    h = 1
    for s in rest[:-1]:
        h *= s
    return h, w


def plan_from_config(cfg, shape: tuple[int, ...]) -> TilePlan:
    """Build the plan a :class:`~repro_torch.core.codec.CodecConfig` describes
    for calibration tensors of ``shape`` (granularity 'channel'|'tile')."""
    axis = cfg.channel_axis % len(shape)
    c = shape[axis]
    m = 1
    for d, s in enumerate(shape):
        if d != axis:
            m *= s
    bhw = getattr(cfg, "spatial_block_hw", None)
    if cfg.granularity == "tile" and bhw is not None:
        if cfg.spatial_block_size:
            raise ValueError("set spatial_block_size or spatial_block_hw, "
                             "not both")
        return TilePlan(channel_axis=cfg.channel_axis,
                        channel_group_size=max(1, cfg.channel_group_size),
                        spatial_block_size=0, n_channels=c,
                        spatial_extent=m,
                        spatial_hw=spatial_grid(shape, cfg.channel_axis),
                        spatial_block_hw=(int(bhw[0]), int(bhw[1])))
    bs = cfg.spatial_block_size if cfg.granularity == "tile" else 0
    return TilePlan(channel_axis=cfg.channel_axis,
                    channel_group_size=max(1, cfg.channel_group_size),
                    spatial_block_size=bs, n_channels=c,
                    spatial_extent=m if bs else None)
