"""Deterministic synthetic token pipeline.

Host-side generation (a seeded Zipf-ish sampler standing in for tokenized
shards) with exact resumability: the stream is a pure function of
(seed, step), so restoring at step k replays the identical data order
with no state files.  Same batches as the JAX package's pipeline.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 17
    embed_dim: int = 0   # > 0: also emit frontend-stub embeddings


def _batch_at(cfg: DataConfig, step: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
    # Zipf-ish marginal so entropy-coding benchmarks see realistic skew
    z = rng.zipf(1.3, size=(cfg.batch, cfg.seq_len + 1))
    tokens = (z % cfg.vocab_size).astype(np.int32)
    out = {"tokens": tokens[:, : cfg.seq_len]}
    if cfg.embed_dim:
        out["inputs"] = rng.standard_normal(
            (cfg.batch, cfg.seq_len, cfg.embed_dim)).astype(np.float32)
    return out


def stream(cfg: DataConfig, start_step: int = 0) -> Iterator[dict]:
    step = start_step
    while True:
        yield _batch_at(cfg, step)
        step += 1
