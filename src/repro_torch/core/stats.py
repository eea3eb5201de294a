"""Streaming statistics for codec calibration (paper Sec. III-E).

The clipping model needs only the sample mean and variance of the split
layer's output.  The paper notes these converge within a few hundred
calibration images; we provide a Welford accumulator for host-side
calibration and an on-device (count, sum, sum of squares) reducer whose
triples merge by addition.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class RunningStats:
    """Chan/Welford parallel-merge mean & variance accumulator."""

    count: float = 0.0
    mean: float = 0.0
    m2: float = 0.0

    def update(self, x: np.ndarray) -> "RunningStats":
        x = np.asarray(x, dtype=np.float64).ravel()
        n_b = x.size
        if n_b == 0:
            return self
        mean_b = float(x.mean())
        m2_b = float(((x - mean_b) ** 2).sum())
        n_a, mean_a, m2_a = self.count, self.mean, self.m2
        n = n_a + n_b
        delta = mean_b - mean_a
        self.mean = mean_a + delta * n_b / n
        self.m2 = m2_a + m2_b + delta * delta * n_a * n_b / n
        self.count = n
        return self

    def merge(self, other: "RunningStats") -> "RunningStats":
        n = self.count + other.count
        if n == 0:
            return self
        delta = other.mean - self.mean
        self.mean += delta * other.count / n
        self.m2 += other.m2 + delta * delta * self.count * other.count / n
        self.count = n
        return self

    @property
    def var(self) -> float:
        return self.m2 / self.count if self.count > 0 else 0.0


def batch_stats(x: torch.Tensor):
    """In-graph (count, sum, sum_sq) for one batch; float32-safe."""
    xf = x.to(torch.float32)
    return (torch.tensor(float(xf.numel()), device=x.device),
            torch.sum(xf), torch.sum(xf * xf))


def merge_stat_triples(*triples):
    n = sum(t[0] for t in triples)
    s = sum(t[1] for t in triples)
    ss = sum(t[2] for t in triples)
    return n, s, ss


def mean_var_from_triple(triple):
    n, s, ss = triple
    mean = s / n
    return mean, ss / n - mean * mean

