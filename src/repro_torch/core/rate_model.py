"""In-graph (torch) rate estimation for the lightweight codec.

The adaptive arithmetic coder's rate converges to the per-context empirical
entropy of the TU bit planes.  Given the histogram of quantizer indices we
can compute that bound on the device, with no bitstream materialized.

For context j (0 <= j < N-1):
    total_j = #{n >= j}   bits coded in that context
    ones_j  = #{n >  j}   of which are 1
    bits_j  = total_j * H2(ones_j / total_j)
"""

from __future__ import annotations

import numpy as np
import torch


def index_histogram(idx: torch.Tensor, n_levels: int) -> torch.Tensor:
    """Histogram of quantizer indices in [0, n_levels) (int32)."""
    flat = idx.reshape(-1).to(torch.int64)
    keep = (flat >= 0) & (flat < n_levels)
    return torch.bincount(flat[keep], minlength=n_levels)[:n_levels] \
        .to(torch.int32)


def _binary_entropy(p: torch.Tensor) -> torch.Tensor:
    # eps must be representable in float32 near 1.0 (1e-12 rounds to 1.0
    # and yields 0 * log(0) = NaN); degenerate bins carry ~0 bits anyway
    eps = 1e-6
    p = torch.clamp(p, eps, 1.0 - eps)
    return -(p * torch.log2(p) + (1 - p) * torch.log2(1 - p))


def _ge_gt(h: torch.Tensor, n_levels: int):
    """Suffix sums over the last axis: ge[j] = #{n >= j}, gt[j] = #{n > j}."""
    rev_cum = torch.flip(torch.cumsum(torch.flip(h, [-1]), -1), [-1])
    ge = rev_cum[..., : n_levels - 1]
    gt = torch.cat([rev_cum[..., 1:], torch.zeros_like(rev_cum[..., :1])],
                   -1)[..., : n_levels - 1]
    return ge, gt


def estimated_bits_from_hist(hist: torch.Tensor,
                             n_levels: int) -> torch.Tensor:
    """Entropy-coded size estimate (bits) from an index histogram."""
    ge, gt = _ge_gt(hist.to(torch.float32), n_levels)
    p1 = gt / torch.clamp(ge, min=1)
    bits = ge * _binary_entropy(p1)
    return torch.sum(torch.where(ge > 0, bits, torch.zeros_like(bits)))


def estimated_bits_from_tile_hists(hists: torch.Tensor, n_levels: int,
                                   per_tile: bool = False) -> torch.Tensor:
    """Entropy-coded size estimate from per-tile index histograms.

    ``hists`` is (..., N) -- e.g. the (n_cgroups, n_sblocks, N) tables a
    fused encode pass emits.  Each tile's TU planes are modelled with
    tile-local probabilities (what the tile-aligned chunked coder
    actually uses), so the total is never above the single-histogram
    estimate.  Returns the summed bits, or per-tile bits of shape
    ``hists.shape[:-1]`` when ``per_tile`` is set.
    """
    h = hists.to(torch.float32).reshape(-1, n_levels)
    ge, gt = _ge_gt(h, n_levels)
    p1 = gt / torch.clamp(ge, min=1)
    tb = ge * _binary_entropy(p1)
    bits = torch.sum(torch.where(ge > 0, tb, torch.zeros_like(tb)), dim=1)
    if per_tile:
        return bits.reshape(hists.shape[:-1])
    return torch.sum(bits)


def estimated_bits_per_element(idx: torch.Tensor,
                               n_levels: int) -> torch.Tensor:
    hist = index_histogram(idx, n_levels)
    n = max(idx.numel(), 1)
    return estimated_bits_from_hist(hist, n_levels) / n


def estimated_bits_np(idx: np.ndarray, n_levels: int) -> float:
    """Host-side reference of the same estimate."""
    idx = np.asarray(idx).ravel()
    hist = np.bincount(idx, minlength=n_levels).astype(np.float64)
    ge = np.cumsum(hist[::-1])[::-1]
    total = 0.0
    for j in range(n_levels - 1):
        tot = ge[j]
        if tot <= 0:
            continue
        ones = ge[j + 1] if j + 1 < n_levels else 0.0
        p = ones / tot
        if 0 < p < 1:
            total += tot * (-(p * np.log2(p) + (1 - p) * np.log2(1 - p)))
    return total
