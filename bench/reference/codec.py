"""The boundary quantizer (paper eq. 1): an N-level uniform quantizer on
``[cmin, cmax]`` whose outer bins reconstruct at the range's ends.

The arithmetic is float32 on the clipped value, with the step and its
inverse divided in double and rounded once:
``idx = floor((clip(x) - cmin) * ((N-1) / (cmax - cmin)) + 0.5)`` and
``x' = cmin + idx * ((cmax - cmin) / (N-1))``.
"""

from __future__ import annotations

import numpy as np
import torch


def _scalars(cmin: float, cmax: float, n: int, device):
    vals = (np.float32(cmin), np.float32(cmax),
            np.float32((n - 1) / (float(cmax) - float(cmin))),
            np.float32((float(cmax) - float(cmin)) / (n - 1)))
    return [torch.tensor(float(v), dtype=torch.float32, device=device)
            for v in vals]


def indices(x: torch.Tensor, cmin: float, cmax: float, n: int):
    lo, hi, scale, _ = _scalars(cmin, cmax, n, x.device)
    xc = torch.clamp(x.to(torch.float32), lo, hi)
    return torch.floor((xc - lo) * scale + 0.5)


def reconstruct(idx: torch.Tensor, cmin: float, cmax: float, n: int):
    """float32 levels of float indices from :func:`indices`."""
    lo, _, _, step = _scalars(cmin, cmax, n, idx.device)
    return lo + idx * step


def fake_quant(x: torch.Tensor, cmin: float, cmax: float, n: int):
    return reconstruct(indices(x, cmin, cmax, n), cmin, cmax, n)
