"""Uniform N-level quantizer with pinned outer bins (paper eq. 1).

    Q(x_clp) = round((x_clp - c_min) / (c_max - c_min) * (N - 1))

with round-half-away-from-zero.  Values clipped to c_min / c_max incur no
further quantization error (the outer reconstruction levels sit exactly on
the clipping boundaries).  N need not be a power of two.

These are the plain torch reference implementations.  Python-float range
scalars enter the tensor arithmetic rounded to the input's dtype (the
JAX package's weak-typing rule), and every scalar is a 0-d tensor so no
``scalar / tensor`` shortcut (a reciprocal multiply) changes a rounding.
"""

from __future__ import annotations

import numpy as np
import torch


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    """Python scalar as a 0-d tensor of ``like``'s float dtype."""
    dtype = like.dtype if like.is_floating_point() else torch.float32
    return torch.tensor(v, dtype=dtype, device=like.device)


def quantize(x: torch.Tensor, cmin: float, cmax: float,
             n_levels: int) -> torch.Tensor:
    """Clip + quantize to integer indices in [0, n_levels - 1] (int32)."""
    lo, hi = _scalar(cmin, x), _scalar(cmax, x)
    xc = torch.clamp(x, lo, hi)
    scale = (n_levels - 1) / (cmax - cmin)          # double, then rounded
    # scaled value is >= 0, so round-half-away == floor(q + 0.5)
    q = torch.floor((xc - lo) * _scalar(scale, x) + _scalar(0.5, x))
    return q.to(torch.int32)


def dequantize(idx: torch.Tensor, cmin: float, cmax: float, n_levels: int,
               dtype=torch.float32) -> torch.Tensor:
    delta = (cmax - cmin) / (n_levels - 1)
    f = idx.to(torch.float32)
    return (_scalar(cmin, f) + f * _scalar(delta, f)).to(dtype)


def quantize_dequantize(x: torch.Tensor, cmin: float, cmax: float,
                        n_levels: int) -> torch.Tensor:
    """Fake-quant: quantize then dequantize, preserving input dtype."""
    return dequantize(quantize(x, cmin, cmax, n_levels), cmin, cmax,
                      n_levels, dtype=x.dtype)


def straight_through_quant(x: torch.Tensor, cmin: float, cmax: float,
                           n_levels: int) -> torch.Tensor:
    """y = qdq(x) in the forward pass; dy/dx = 1 on [cmin, cmax] else 0."""
    xc = torch.clamp(x, _scalar(cmin, x), _scalar(cmax, x))
    y = quantize_dequantize(x, cmin, cmax, n_levels)
    return xc + (y - xc).detach()


def quantize_np(x: np.ndarray, cmin: float, cmax: float, n_levels: int) -> np.ndarray:
    xc = np.clip(np.asarray(x, dtype=np.float64), cmin, cmax)
    q = np.floor((xc - cmin) / (cmax - cmin) * (n_levels - 1) + 0.5)
    return q.astype(np.int32)


def dequantize_np(idx: np.ndarray, cmin: float, cmax: float, n_levels: int) -> np.ndarray:
    delta = (cmax - cmin) / (n_levels - 1)
    return cmin + idx.astype(np.float64) * delta
