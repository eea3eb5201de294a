"""Public wrappers around the kernels: shape handling and padding.

The kernels take the same padded (R, C) views the reference builds, so
the layout (and its histogram corrections) stays one definition shared
with the host.  Only the flat (per-tensor) views exist so far; the
banded channel/tile layout arrives with the tiled kernels, and a
``TilePlan`` here raises ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.tiling import PaddedLayout, TilePlan
from .fused_clip_quant import clip_quant_2d, encode_tiles_2d, pack_width
from .rate_hist import index_histogram_2d

_LANE = 128
_ROW = 8
TILED_TODO = ("tiled/channel granularity (banded layout + kernels #2 and "
              "#5) is not ported yet; see ROADMAP.md queue B")


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


def clip_quantize(x: torch.Tensor, *, cmin: float, cmax: float,
                  n_levels: int):
    """Fused clip+quantize+dequantize. Returns (idx int32, dequantized)."""
    x2d, n = _to_2d(x, cmin)
    idx, deq = clip_quant_2d(x2d, cmin, cmax, n_levels)
    shape = x.shape
    return (idx.reshape(-1)[:n].reshape(shape),
            deq.reshape(-1)[:n].reshape(shape))


def encode_fused(x: torch.Tensor, lo, hi, *, n_levels: int, bits: int,
                 plan: TilePlan | None = None):
    """Single-pass fused encode: clip + quantize + bit-pack + histogram.

    Returns (packed uint8, hist_raw int32, :class:`PaddedLayout`); the
    host recovers coded-order indices with ``layout.unpack_indices`` and
    per-tile counts with ``layout.group_hists``.  The flat view is padded
    with ``lo`` so the tail quantizes to index 0 (the histogram
    correction contract).
    """
    if plan is not None:
        raise NotImplementedError(TILED_TODO)
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


def index_histogram(idx: torch.Tensor, *, n_levels: int) -> torch.Tensor:
    """Histogram of quantizer indices (padding assigned to bin 0, corrected)."""
    idx2d, n = _to_2d(idx.to(torch.int32), 0)
    hist = index_histogram_2d(idx2d, n_levels).clone()
    pad = idx2d.numel() - n
    if pad:
        hist[0] -= pad
    return hist

