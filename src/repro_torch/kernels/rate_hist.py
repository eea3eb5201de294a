"""Quantizer-index histogram for in-graph rate estimation, CUDA for Hopper.

The entropy model (:mod:`repro_torch.core.rate_model`) needs only the
N-bin histogram of quantizer indices.  :func:`index_histogram_2d`
replaces the Pallas kernel ``repro/kernels/rate_hist.py`` ``_kernel``
(``index_histogram_2d``), the ``codec=`` serving hookup's rate estimate.
Source: ``csrc/rate_hist.cu`` ``repro_index_histogram``.

Bound by bytes on the card (one int32 read per index).  The kernel
counts into per-warp shared-memory bins and adds each block's non-zero
bins to a zeroed (64,) output with one atomic each (see the source
note).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import torch

from . import _build

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
    hist = torch.zeros(MAX_LEVELS, dtype=torch.int32, device=idx.device)
    if idx.numel():
        _build.launch("index_histogram", "repro_index_histogram",
                      idx.data_ptr(), idx.numel(), n_levels,
                      hist.data_ptr())
    return hist[:n_levels]
