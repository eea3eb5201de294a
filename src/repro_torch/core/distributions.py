"""Analytic models of split-layer feature distributions (paper Sec. III-B).

The input to the split layer's activation is modeled as an asymmetric
Laplace distribution, eq. (2):

    f_L(x) = lam / (kappa + 1/kappa) * { exp( lam (x - mu) / kappa)   x <  mu
                                       { exp(-lam kappa (x - mu))     x >= mu

The activation is leaky ReLU with negative slope ``s`` (eq. 4); the
post-activation density f_Y (eq. 5) is piecewise exponential.  All moments
and clipping/quantization error integrals therefore have exact closed
forms, which we compute via :class:`ExpSegment` antiderivatives instead of
numeric quadrature.  ``s = 0`` (plain ReLU, AlexNet case) is supported via
a point mass at 0.

Reference values from the paper (used in tests):
  ResNet-50 layer 21: mean 1.1235656, var 4.9280124, kappa 0.5, s 0.1
      -> lam 0.7716595, mu -1.4350621   (eq. 8)
  YOLOv3 layer 12:   mean 0.4484323, var 0.5742644
      -> lam 2.3900,   mu -0.30888      (eq. 12)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
from scipy import optimize


# ---------------------------------------------------------------------------
# Exact integration of c * exp(alpha * y) segments
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ExpSegment:
    """Density segment f(y) = coef * exp(alpha * y) on [lo, hi)."""

    coef: float
    alpha: float
    lo: float      # may be -inf
    hi: float      # may be +inf

    def _anti0(self, y: float) -> float:
        # antiderivative of exp(alpha y)
        if np.isinf(y):
            return 0.0  # valid only when exp decays toward that limit
        return math.exp(self.alpha * y) / self.alpha

    def _anti1(self, y: float) -> float:
        # antiderivative of y exp(alpha y)
        if np.isinf(y):
            return 0.0
        a = self.alpha
        return math.exp(a * y) * (y / a - 1.0 / (a * a))

    def _anti2(self, y: float) -> float:
        # antiderivative of y^2 exp(alpha y)
        if np.isinf(y):
            return 0.0
        a = self.alpha
        return math.exp(a * y) * (y * y / a - 2.0 * y / (a * a) + 2.0 / (a ** 3))

    def moment(self, power: int, lo: float | None = None, hi: float | None = None) -> float:
        """Integral of y^power * f(y) over [lo, hi] intersected with segment."""
        a = self.lo if lo is None else max(lo, self.lo)
        b = self.hi if hi is None else min(hi, self.hi)
        if b <= a:
            return 0.0
        anti = (self._anti0, self._anti1, self._anti2)[power]
        return self.coef * (anti(b) - anti(a))

    def shifted_second_moment(self, r: float, lo: float | None = None,
                              hi: float | None = None) -> float:
        """Integral of (y - r)^2 * f(y) over [lo, hi] within segment."""
        a = self.lo if lo is None else max(lo, self.lo)
        b = self.hi if hi is None else min(hi, self.hi)
        if b <= a:
            return 0.0
        m0 = self.coef * (self._anti0(b) - self._anti0(a))
        m1 = self.coef * (self._anti1(b) - self._anti1(a))
        m2 = self.coef * (self._anti2(b) - self._anti2(a))
        return m2 - 2.0 * r * m1 + r * r * m0


# ---------------------------------------------------------------------------
# Post-activation feature model
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FeatureModel:
    """Analytic model of Y = leaky_relu_s(X), X ~ AsymmetricLaplace(lam, mu, kappa).

    ``atom`` is the probability mass concentrated exactly at y = 0 (non-zero
    only for plain ReLU, s == 0).
    """

    lam: float
    mu: float
    kappa: float
    slope: float
    segments: tuple[ExpSegment, ...]
    atom: float = 0.0

    # -- constructors --------------------------------------------------------

    @staticmethod
    def from_params(lam: float, mu: float, kappa: float, slope: float) -> "FeatureModel":
        if lam <= 0 or kappa <= 0:
            raise ValueError("lam and kappa must be positive")
        norm = lam / (kappa + 1.0 / kappa)
        s = slope
        segs: list[ExpSegment] = []
        atom = 0.0
        if s > 0:
            # y < 0 region: x = y / s, extra 1/s Jacobian.
            if mu < 0:
                # below s*mu: rising exponential; [s*mu, 0): falling
                a1 = lam / (kappa * s)
                segs.append(ExpSegment(norm / s * math.exp(-lam * mu / kappa), a1, -math.inf, s * mu))
                a2 = -lam * kappa / s
                segs.append(ExpSegment(norm / s * math.exp(lam * kappa * mu), a2, s * mu, 0.0))
                # y >= 0: x = y (> 0 > mu): falling branch
                segs.append(ExpSegment(norm * math.exp(lam * kappa * mu), -lam * kappa, 0.0, math.inf))
            else:
                a1 = lam / (kappa * s)
                segs.append(ExpSegment(norm / s * math.exp(-lam * mu / kappa), a1, -math.inf, 0.0))
                segs.append(ExpSegment(norm * math.exp(-lam * mu / kappa), lam / kappa, 0.0, mu))
                segs.append(ExpSegment(norm * math.exp(lam * kappa * mu), -lam * kappa, mu, math.inf))
        else:
            # plain ReLU: all x < 0 mass collapses onto the atom at 0.
            if mu < 0:
                atom = (kappa ** 2) / (1 + kappa ** 2) * math.exp(0.0)  # P(X < mu)
                # P(X < mu) = kappa^2/(1+kappa^2); plus P(mu <= X < 0)
                p_lo = (kappa ** 2) / (1 + kappa ** 2)
                seg_mid = ExpSegment(norm * math.exp(lam * kappa * mu), -lam * kappa, mu, 0.0)
                atom = p_lo + seg_mid.moment(0)
                segs.append(ExpSegment(norm * math.exp(lam * kappa * mu), -lam * kappa, 0.0, math.inf))
            else:
                p_lo_seg = ExpSegment(norm * math.exp(-lam * mu / kappa), lam / kappa, -math.inf, 0.0)
                atom = p_lo_seg.moment(0)
                segs.append(ExpSegment(norm * math.exp(-lam * mu / kappa), lam / kappa, 0.0, mu))
                segs.append(ExpSegment(norm * math.exp(lam * kappa * mu), -lam * kappa, mu, math.inf))
        return FeatureModel(lam, mu, kappa, slope, tuple(segs), atom)

    @staticmethod
    def fit(sample_mean: float, sample_var: float, kappa: float = 0.5,
            slope: float = 0.1, init: tuple[float, float] = (1.0, -1.0)) -> "FeatureModel":
        """Solve (lam, mu) s.t. model mean/var match the sample stats (eqs. 6-7)."""

        def eqs(p):
            lam, mu = p
            if lam <= 1e-6:
                return [1e6, 1e6]
            m = FeatureModel.from_params(lam, mu, kappa, slope)
            return [m.mean() - sample_mean, m.var() - sample_var]

        sol = optimize.root(eqs, init, method="hybr", tol=1e-13)
        if not sol.success:  # retry from a grid of inits
            for lam0 in (0.3, 1.0, 3.0, 10.0):
                for mu0 in (-3.0, -1.0, -0.3, 0.3):
                    sol = optimize.root(eqs, (lam0, mu0), method="hybr", tol=1e-13)
                    if sol.success:
                        break
                if sol.success:
                    break
        if not sol.success:
            raise RuntimeError(f"FeatureModel.fit failed: {sol.message}")
        lam, mu = sol.x
        return FeatureModel.from_params(float(lam), float(mu), kappa, slope)

    @staticmethod
    def fit_from_samples(samples: np.ndarray, kappa: float = 0.5,
                         slope: float = 0.1) -> "FeatureModel":
        samples = np.asarray(samples, dtype=np.float64).ravel()
        return FeatureModel.fit(float(samples.mean()), float(samples.var()), kappa, slope)

    # -- density / moments ----------------------------------------------------

    def pdf(self, y) -> np.ndarray:
        y = np.asarray(y, dtype=np.float64)
        out = np.zeros_like(y)
        for s in self.segments:
            m = (y >= s.lo) & (y < s.hi)
            expo = np.clip(s.alpha * y, -700.0, 700.0)
            out = np.where(m, s.coef * np.exp(np.where(m, expo, 0.0)), out)
        return out

    def total_mass(self) -> float:
        return self.atom + sum(s.moment(0) for s in self.segments)

    def mean(self) -> float:
        return sum(s.moment(1) for s in self.segments)

    def second_moment(self) -> float:
        return sum(s.moment(2) for s in self.segments)

    def var(self) -> float:
        m = self.mean()
        return self.second_moment() - m * m

    def cdf_scalar(self, y: float) -> float:
        total = self.atom if y >= 0 else 0.0
        for s in self.segments:
            total += s.moment(0, hi=y)
        return total

    def quantile(self, q: float, bracket: tuple[float, float] = (-100.0, 1000.0)) -> float:
        return optimize.brentq(lambda y: self.cdf_scalar(y) - q, *bracket, xtol=1e-10)

    def median(self) -> float:
        return self.quantile(0.5)

    def mad_about_median(self) -> float:
        """Laplace-MLE scale: E|Y - median| (used by the ACIQ baseline)."""
        med = self.median()
        total = self.atom * abs(med)
        for s in self.segments:
            # |y - med| = (med - y) below med plus (y - med) above
            total += med * s.moment(0, hi=med) - s.moment(1, hi=med)
            total += s.moment(1, lo=med) - med * s.moment(0, lo=med)
        return total

    # -- sampling (for synthetic experiments) ---------------------------------

    def sample(self, n: int, rng: np.random.Generator | None = None) -> np.ndarray:
        """Draw samples of Y by sampling X ~ AL and applying leaky ReLU."""
        rng = rng or np.random.default_rng(0)
        k2 = self.kappa ** 2
        p_neg_branch = k2 / (1.0 + k2)  # P(X < mu)
        u = rng.random(n)
        e = rng.exponential(size=n)
        x = np.where(u < p_neg_branch,
                     self.mu - e * self.kappa / self.lam,
                     self.mu + e / (self.lam * self.kappa))
        return np.where(x < 0, self.slope * x, x)

    # -- closed-form mean/var (paper eqs. 6-7, kappa=0.5, s=0.1, mu<0) --------

    def mean_eq6(self) -> float:
        lam, mu = self.lam, self.mu
        return 0.1 * mu + (1 / lam) * (3 / 20 + (6 / 5) ** 2 * math.exp(0.5 * lam * mu))

    def var_eq7(self) -> float:
        lam, mu = self.lam, self.mu
        return (1 / lam ** 2) * ((5.904 - 0.288 * lam * mu) * math.exp(0.5 * lam * mu)
                                 - 2.0736 * math.exp(lam * mu) + 0.0425)


# Published reference fits ---------------------------------------------------

RESNET50_L21 = dict(sample_mean=1.1235656, sample_var=4.9280124, kappa=0.5, slope=0.1)
YOLOV3_L12 = dict(sample_mean=0.4484323, sample_var=0.5742644, kappa=0.5, slope=0.1)


def resnet50_layer21_model() -> FeatureModel:
    return FeatureModel.fit(**RESNET50_L21)


def yolov3_layer12_model() -> FeatureModel:
    return FeatureModel.fit(**YOLOV3_L12)
