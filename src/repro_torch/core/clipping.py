"""Optimal clipping-range computation (paper Sec. III-B, eqs. 9-11).

Given the analytic post-activation model, the total reconstruction error of
an N-level uniform quantizer with *pinned* outer bins (values in the outer
half-bins reconstruct exactly at c_min / c_max) is

    e_tot(c_min, c_max) = e_quant + e_clip

with e_quant given by eq. (9) and e_clip by eq. (10).  Both are exact sums
of piecewise-exponential integrals, so no numeric quadrature is needed.
``optimal_cmax`` / ``optimal_range`` minimize e_tot, reproducing the
"model" columns of paper Table I.
"""

from __future__ import annotations

import numpy as np
from scipy import optimize

from .distributions import FeatureModel


def e_quant(model: FeatureModel, cmin: float, cmax: float, n_levels: int) -> float:
    """Quantization error inside [cmin, cmax], eq. (9). Outer bins are pinned."""
    if n_levels < 2:
        raise ValueError("need at least 2 levels")
    delta = (cmax - cmin) / (n_levels - 1)
    total = 0.0
    if model.atom > 0.0 and cmin <= 0.0 <= cmax:
        # atom at zero reconstructs at nearest level; error is deterministic
        q = int(np.clip(np.floor((0.0 - cmin) / delta + 0.5), 0, n_levels - 1))
        total += model.atom * (cmin + q * delta) ** 2
    for seg in model.segments:
        # outermost bins: reconstruct at the boundary itself
        total += seg.shifted_second_moment(cmin, lo=cmin, hi=cmin + delta / 2)
        total += seg.shifted_second_moment(cmax, lo=cmax - delta / 2, hi=cmax)
        for i in range(1, n_levels - 1):
            lo = cmin + delta / 2 + (i - 1) * delta
            hi = cmin + delta / 2 + i * delta
            total += seg.shifted_second_moment(cmin + i * delta, lo=lo, hi=hi)
    return total


def e_clip(model: FeatureModel, cmin: float, cmax: float) -> float:
    """Clipping error outside [cmin, cmax], eq. (10). No further quant error."""
    total = 0.0
    if model.atom > 0.0 and not (cmin <= 0.0 <= cmax):
        bound = cmin if 0.0 < cmin else cmax
        total += model.atom * bound ** 2
    for seg in model.segments:
        total += seg.shifted_second_moment(cmin, hi=cmin)
        total += seg.shifted_second_moment(cmax, lo=cmax)
    return total


def e_total(model: FeatureModel, cmin: float, cmax: float, n_levels: int) -> float:
    return e_quant(model, cmin, cmax, n_levels) + e_clip(model, cmin, cmax)


def optimal_cmax(model: FeatureModel, n_levels: int, cmin: float = 0.0,
                 hi: float = 100.0) -> float:
    """argmin_{c_max} e_tot(cmin, c_max) - the 'model' column of Table I."""
    res = optimize.minimize_scalar(
        lambda c: e_total(model, cmin, c, n_levels),
        bounds=(cmin + 1e-3, hi), method="bounded",
        options={"xatol": 1e-7})
    return float(res.x)


def optimal_range(model: FeatureModel, n_levels: int) -> tuple[float, float]:
    """Jointly optimal (c_min, c_max) - the 'unconstrained' column of Table I."""
    c0 = optimal_cmax(model, n_levels)
    res = optimize.minimize(
        lambda p: e_total(model, p[0], p[1], n_levels),
        x0=np.array([0.0, c0]), method="Nelder-Mead",
        options={"xatol": 1e-8, "fatol": 1e-14, "maxiter": 4000})
    lo, hi = float(res.x[0]), float(res.x[1])
    return (lo, hi) if lo < hi else (hi, lo)


def empirical_e_total(samples: np.ndarray, cmin: float, cmax: float,
                      n_levels: int) -> float:
    """Measured MSRE between raw samples and clip+quantize+dequantize output."""
    x = np.asarray(samples, dtype=np.float64)
    xc = np.clip(x, cmin, cmax)
    q = np.floor((xc - cmin) / (cmax - cmin) * (n_levels - 1) + 0.5)
    xh = cmin + q * (cmax - cmin) / (n_levels - 1)
    return float(np.mean((x - xh) ** 2))


def empirical_optimal_cmax(samples: np.ndarray, n_levels: int, cmin: float = 0.0,
                           grid: np.ndarray | None = None) -> float:
    """Grid-search c_max minimizing measured MSRE (the paper's 'empirical' mode)."""
    x = np.asarray(samples, dtype=np.float64)
    if x.size == 0:
        raise ValueError("cannot calibrate clip range from empty samples")
    if grid is None:
        lo = max(cmin + 1e-3, 0.1)
        # a dead / near-constant tile collapses the quantile anchor; keep
        # the grid non-degenerate so the search stays well-defined
        hi = max(float(np.quantile(x, 0.9999)) * 1.5, lo + 1e-6)
        grid = np.linspace(lo, hi, 200)
    errs = [empirical_e_total(x, cmin, c, n_levels) for c in grid]
    return float(grid[int(np.argmin(errs))])


def empirical_optimal_range(samples: np.ndarray, n_levels: int,
                            steps: int = 24) -> tuple[float, float]:
    """Two-sided grid search of (c_min, c_max) minimizing measured MSRE.

    The unconstrained analogue of :func:`empirical_optimal_cmax`, used by
    per-channel calibration where channel supports need not start at 0
    (BN-biased channels).  A coarse quantile-anchored grid over both ends
    is plenty: MSRE is smooth in the range and per-channel sample counts
    are small.
    """
    x = np.asarray(samples, dtype=np.float64)
    if x.size == 0:
        raise ValueError("cannot calibrate clip range from empty samples")
    lo0, hi0 = float(np.min(x)), float(np.max(x))
    if hi0 - lo0 < 1e-9:
        return lo0, lo0 + 1e-6
    lo_grid = np.linspace(lo0, float(np.quantile(x, 0.5)), steps)
    hi_grid = np.linspace(float(np.quantile(x, 0.5)), hi0, steps)
    best = (np.inf, lo0, hi0)
    for lo in lo_grid:
        for hi in hi_grid:
            if hi - lo < 1e-6:
                continue
            err = empirical_e_total(x, lo, hi, n_levels)
            if err < best[0]:
                best = (err, float(lo), float(hi))
    return best[1], best[2]
