"""Frozen copy of the paper's ``model``-mode clip calibration (Sec. III-B).

The split layer's activations are modelled as an asymmetric Laplace
variable through a leaky ReLU (eqs. 2-5); (lam, mu) are fitted so the
model's mean and variance match the samples' (eqs. 6-7), and the clip
range minimises the closed-form quantization plus clipping error of an
N-level uniform quantizer with pinned outer bins (eqs. 9-11).  Every
integral is a sum of ``c * exp(a * y)`` pieces, so no quadrature.
"""

from __future__ import annotations

import math

import numpy as np
from scipy import optimize


class Segment:
    """Density ``coef * exp(alpha * y)`` on ``[lo, hi)``."""

    def __init__(self, coef: float, alpha: float, lo: float, hi: float):
        self.coef, self.alpha, self.lo, self.hi = coef, alpha, lo, hi

    def _anti(self, power: int, y: float) -> float:
        if math.isinf(y):
            return 0.0
        a, e = self.alpha, math.exp(self.alpha * y)
        if power == 0:
            return e / a
        if power == 1:
            return e * (y / a - 1.0 / (a * a))
        return e * (y * y / a - 2.0 * y / (a * a) + 2.0 / a ** 3)

    def _limits(self, lo, hi):
        a = self.lo if lo is None else max(lo, self.lo)
        b = self.hi if hi is None else min(hi, self.hi)
        return a, b

    def moment(self, power: int, lo=None, hi=None) -> float:
        a, b = self._limits(lo, hi)
        if b <= a:
            return 0.0
        return self.coef * (self._anti(power, b) - self._anti(power, a))

    def shifted_second(self, r: float, lo=None, hi=None) -> float:
        """Integral of ``(y - r)^2`` times the density on ``[lo, hi]``."""
        a, b = self._limits(lo, hi)
        if b <= a:
            return 0.0
        m0, m1, m2 = (self.coef * (self._anti(p, b) - self._anti(p, a))
                      for p in range(3))
        return m2 - 2.0 * r * m1 + r * r * m0


def segments(lam: float, mu: float, kappa: float, slope: float):
    """(segments, atom at 0) of Y = leaky_relu(X), X ~ AL(lam, mu, kappa)."""
    norm = lam / (kappa + 1.0 / kappa)
    s, segs, atom = slope, [], 0.0
    up, down = math.exp(-lam * mu / kappa), math.exp(lam * kappa * mu)
    if s > 0:
        if mu < 0:
            segs.append(Segment(norm / s * up, lam / (kappa * s),
                                -math.inf, s * mu))
            segs.append(Segment(norm / s * down, -lam * kappa / s,
                                s * mu, 0.0))
            segs.append(Segment(norm * down, -lam * kappa, 0.0, math.inf))
        else:
            segs.append(Segment(norm / s * up, lam / (kappa * s),
                                -math.inf, 0.0))
            segs.append(Segment(norm * up, lam / kappa, 0.0, mu))
            segs.append(Segment(norm * down, -lam * kappa, mu, math.inf))
    elif mu < 0:
        mid = Segment(norm * down, -lam * kappa, mu, 0.0)
        atom = kappa ** 2 / (1 + kappa ** 2) + mid.moment(0)
        segs.append(Segment(norm * down, -lam * kappa, 0.0, math.inf))
    else:
        atom = Segment(norm * up, lam / kappa, -math.inf, 0.0).moment(0)
        segs.append(Segment(norm * up, lam / kappa, 0.0, mu))
        segs.append(Segment(norm * down, -lam * kappa, mu, math.inf))
    return segs, atom


def mean_var(lam, mu, kappa, slope) -> tuple[float, float]:
    segs, _ = segments(lam, mu, kappa, slope)
    m = sum(g.moment(1) for g in segs)
    return m, sum(g.moment(2) for g in segs) - m * m


def fit(mean: float, var: float, kappa: float, slope: float):
    """(segments, atom) whose mean and variance are ``mean``, ``var``."""
    def eqs(p):
        lam, mu = p
        if lam <= 1e-6:
            return [1e6, 1e6]
        m, v = mean_var(lam, mu, kappa, slope)
        return [m - mean, v - var]

    inits = [(1.0, -1.0)] + [(a, b) for a in (0.3, 1.0, 3.0, 10.0)
                             for b in (-3.0, -1.0, -0.3, 0.3)]
    for init in inits:
        sol = optimize.root(eqs, init, method="hybr", tol=1e-13)
        if sol.success:
            lam, mu = sol.x
            return segments(float(lam), float(mu), kappa, slope)
    raise RuntimeError(f"no (lam, mu) fits mean {mean} and var {var}")


def error(model, cmin: float, cmax: float, n: int) -> float:
    """Quantization error inside the range (eq. 9) plus clipping error
    outside it (eq. 10), summed in that order."""
    segs, atom = model
    delta = (cmax - cmin) / (n - 1)
    quant = 0.0
    if atom > 0.0 and cmin <= 0.0 <= cmax:
        q = int(np.clip(np.floor((0.0 - cmin) / delta + 0.5), 0, n - 1))
        quant += atom * (cmin + q * delta) ** 2
    for g in segs:
        quant += g.shifted_second(cmin, lo=cmin, hi=cmin + delta / 2)
        quant += g.shifted_second(cmax, lo=cmax - delta / 2, hi=cmax)
        for i in range(1, n - 1):
            quant += g.shifted_second(cmin + i * delta,
                                      lo=cmin + delta / 2 + (i - 1) * delta,
                                      hi=cmin + delta / 2 + i * delta)
    clip = 0.0
    if atom > 0.0 and not cmin <= 0.0 <= cmax:
        clip += atom * (cmin if 0.0 < cmin else cmax) ** 2
    for g in segs:
        clip += g.shifted_second(cmin, hi=cmin)
        clip += g.shifted_second(cmax, lo=cmax)
    return quant + clip


def best_cmax(model, n: int, cmin: float = 0.0) -> float:
    res = optimize.minimize_scalar(lambda c: error(model, cmin, c, n),
                                   bounds=(cmin + 1e-3, 100.0),
                                   method="bounded", options={"xatol": 1e-7})
    return float(res.x)


def clip_range(samples: np.ndarray, n: int, *, kappa: float, slope: float,
               cmin_zero: bool) -> tuple[float, float]:
    """The ``model``-mode clip range of ``samples``."""
    x = np.asarray(samples, np.float64).ravel()
    batch_mean = float(x.mean())
    mean = batch_mean * x.size / x.size     # a Welford merge into nothing
    var = float(((x - batch_mean) ** 2).sum()) / x.size
    model = fit(mean, var, kappa, slope)
    if cmin_zero:
        cmin, cmax = 0.0, best_cmax(model, n)
    else:
        c0 = best_cmax(model, n)
        res = optimize.minimize(
            lambda p: error(model, p[0], p[1], n), x0=np.array([0.0, c0]),
            method="Nelder-Mead",
            options={"xatol": 1e-8, "fatol": 1e-14, "maxiter": 4000})
        cmin, cmax = sorted((float(res.x[0]), float(res.x[1])))
    if cmax <= cmin:
        cmax = cmin + 1e-6
    return cmin, cmax
