"""Modified entropy-constrained scalar quantizer design (paper Algorithm 1).

Differences from conventional ECSQ [Chou-Lookabaugh-Gray]:
  * the outermost reconstruction values are *pinned* to c_min / c_max so the
    decoded activations span the full clipping range (Step 4), and
  * the rate term uses the known truncated-unary codeword lengths b_n
    instead of -log2(p_n).

Note: the paper's Step 3 prints the Lagrangian as (x - x_n)^2 - lam*b_n; the
sign is a typo -- Step 6's threshold formula is the stationarity condition
of (x - x_n)^2 + lam*b_n, which is what we implement.

Design runs on the host (numpy) over a calibration sample; deployment-time
quantization is a threshold search (see the ECSQ assign kernel).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .binarization import truncated_unary_lengths


@dataclasses.dataclass
class ECSQQuantizer:
    """Designed non-uniform quantizer: reconstruction levels + thresholds."""

    levels: np.ndarray       # (N,) reconstruction values, ascending
    thresholds: np.ndarray   # (N-1,) decision boundaries
    codeword_lengths: np.ndarray  # (N,) bits per index
    lagrangian: float        # lambda used at design time
    cmin: float
    cmax: float

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    @classmethod
    def from_levels(cls, levels: np.ndarray, lagrangian: float = 0.0,
                    codeword_lengths: np.ndarray | None = None
                    ) -> "ECSQQuantizer":
        """Rebuild a usable quantizer from a reconstruction-level table.

        The bitstream header stores only the levels (that is all a
        receiver needs to dequantize); this reconstructs the matching
        decision thresholds -- Step 6's stationarity formula, reducing to
        midpoints when ``lagrangian`` is 0 -- so a receiver-side codec can
        also *re-encode* without the original calibration samples.
        """
        lv = np.asarray(levels, dtype=np.float64).ravel()
        n = lv.size
        if codeword_lengths is None:
            codeword_lengths = truncated_unary_lengths(n)
        b = np.asarray(codeword_lengths, dtype=np.float64)
        thresholds = np.empty(max(n - 1, 0), dtype=np.float64)
        for i in range(1, n):
            gap = lv[i] - lv[i - 1]
            if gap <= 1e-12:
                thresholds[i - 1] = lv[i]
            else:
                thresholds[i - 1] = (lv[i] + lv[i - 1]) / 2.0 \
                    + lagrangian * (b[i] - b[i - 1]) / (2.0 * gap)
        thresholds = np.maximum.accumulate(
            np.clip(thresholds, lv[0], lv[-1])) if n > 1 else thresholds
        return cls(levels=lv, thresholds=thresholds,
                   codeword_lengths=b.astype(np.int32),
                   lagrangian=lagrangian, cmin=float(lv[0]),
                   cmax=float(lv[-1]))

    def quantize_np(self, x: np.ndarray) -> np.ndarray:
        xc = np.clip(x, self.cmin, self.cmax)
        return np.searchsorted(self.thresholds, xc, side="right").astype(np.int32)

    def dequantize_np(self, idx: np.ndarray) -> np.ndarray:
        return self.levels[idx]


def design_ecsq(samples: np.ndarray, n_levels: int, lagrangian: float,
                cmin: float, cmax: float, *, pin_boundaries: bool = True,
                codeword_lengths: np.ndarray | None = None,
                max_iters: int = 200, tol: float = 1e-9) -> ECSQQuantizer:
    """Run Algorithm 1.

    ``pin_boundaries=False`` gives the conventional ECSQ design used as the
    paper's ablation baseline (Figs. 9-10, "conventional" curves).
    """
    x = np.clip(np.asarray(samples, dtype=np.float64).ravel(), cmin, cmax)  # Step 1
    n = n_levels
    if codeword_lengths is None:
        codeword_lengths = truncated_unary_lengths(n)
    b = np.asarray(codeword_lengths, dtype=np.float64)

    levels = np.linspace(cmin, cmax, n)  # Step 2: uniform init
    prev_cost = np.inf
    for _ in range(max_iters):
        # Step 3: assign samples minimizing (x - x_n)^2 + lam * b_n
        cost_mat = (x[:, None] - levels[None, :]) ** 2 + lagrangian * b[None, :]
        assign = np.argmin(cost_mat, axis=1)
        # Step 4: centroid update with pinned boundary bins
        new_levels = levels.copy()
        for i in range(n):
            sel = assign == i
            if np.any(sel):
                new_levels[i] = x[sel].mean()
        if pin_boundaries:
            new_levels[0] = cmin
            new_levels[-1] = cmax
        # enforce monotonicity (degenerate empty-bin cases)
        new_levels = np.maximum.accumulate(new_levels)
        levels = new_levels
        # Step 5: convergence check on the Lagrangian cost
        d = (x - levels[assign]) ** 2
        cost = float(d.mean() + lagrangian * b[assign].mean())
        if prev_cost - cost < tol:
            break
        prev_cost = cost

    # Step 6: decision thresholds between adjacent levels
    thresholds = np.empty(n - 1, dtype=np.float64)
    for i in range(1, n):
        gap = levels[i] - levels[i - 1]
        if gap <= 1e-12:
            thresholds[i - 1] = levels[i]
        else:
            thresholds[i - 1] = (levels[i] + levels[i - 1]) / 2.0 \
                + lagrangian * (b[i] - b[i - 1]) / (2.0 * gap)
    thresholds = np.maximum.accumulate(np.clip(thresholds, cmin, cmax))
    return ECSQQuantizer(levels=levels, thresholds=thresholds,
                         codeword_lengths=b.astype(np.int32),
                         lagrangian=lagrangian, cmin=cmin, cmax=cmax)
