"""Deterministic synthetic token pipeline with prefetched device delivery.

Host-side generation (a seeded Zipf-ish sampler standing in for tokenized
shards), double-buffered prefetch onto a device on a background thread,
and exact resumability: the stream is a pure function of (seed, step),
so restoring at step k replays the identical data order with no state
files.  Same batches as the JAX package's pipeline.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np
import torch


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


class PrefetchingLoader:
    """Background-thread prefetch of :func:`stream`'s batches, copied to
    ``device`` (a CUDA device through pinned host memory with a
    non-blocking copy) when one is given; numpy batches otherwise."""

    def __init__(self, cfg: DataConfig, device=None, start_step: int = 0,
                 depth: int = 2):
        self.cfg = cfg
        self.device = None if device is None else torch.device(device)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._worker, args=(start_step,), daemon=True)
        self._thread.start()

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _worker(self, start_step: int):
        for batch in stream(self.cfg, start_step):
            if self.device is not None:
                batch = {k: self._to_device(v) for k, v in batch.items()}
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.05)
                    break
                except queue.Full:
                    pass
            if self._stop.is_set():
                return

    def __iter__(self):
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        """Stop the prefetch thread and wait for it to end."""
        self._stop.set()
        self._thread.join(10.0)
