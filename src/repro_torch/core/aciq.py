"""ACIQ baseline (Banner et al. [22,23]), as used for comparison in the paper.

For ReLU-style activations ACIQ fixes c_min = 0 and computes (paper eq. 13)

    c_max = b * W(12 * 2^(2M)),

where W is the Lambert W function, M the bit width, and b the Laplace scale
parameter estimated from data.  The paper allows fractional bit widths via
M = log2(N) for an N-level quantizer.

The paper does not state how b was estimated from the ResNet/YOLO feature
tensors; we provide the standard Laplace MLE (mean absolute deviation about
the median) from samples, and the model-based equivalent.  On data drawn
from the fitted analytic models this reproduces ACIQ's qualitative
behaviour reported in the paper: its c_max exceeds the model-optimal c_max
at coarse quantization (N small) and converges toward it as N grows.
"""

from __future__ import annotations

import numpy as np
from scipy import special

from .distributions import FeatureModel


# floor for the Laplace scale estimate: a dead (all-zero / constant)
# tile has b = 0, which would yield a zero clip range and a
# divide-by-zero step size downstream.  The floor keeps c_max positive
# and tiny, so a dead tile quantizes exactly to its constant.
B_FLOOR = 1e-8


def aciq_cmax(b: float, n_levels: int) -> float:
    """Eq. (13) with M = log2(n_levels) (fractional bit widths allowed)."""
    if not np.isfinite(b) or b < 0.0:
        raise ValueError(f"Laplace scale must be finite and >= 0, got {b}")
    m = np.log2(n_levels)
    return float(max(b, B_FLOOR)
                 * special.lambertw(12.0 * 2.0 ** (2.0 * m)).real)


def laplace_b_from_samples(samples: np.ndarray) -> float:
    """Laplace MLE scale: mean |x - median(x)|, floored at ``B_FLOOR``."""
    x = np.asarray(samples, dtype=np.float64).ravel()
    if x.size == 0:
        raise ValueError("cannot estimate Laplace scale from empty samples")
    return float(max(np.mean(np.abs(x - np.median(x))), B_FLOOR))


def laplace_b_from_model(model: FeatureModel) -> float:
    return model.mad_about_median()


def aciq_cmax_from_samples(samples: np.ndarray, n_levels: int) -> float:
    return aciq_cmax(laplace_b_from_samples(samples), n_levels)


def aciq_cmax_from_model(model: FeatureModel, n_levels: int) -> float:
    return aciq_cmax(laplace_b_from_model(model), n_levels)
