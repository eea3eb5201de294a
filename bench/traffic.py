"""The one traffic generator: a mix file's parameters and a seed in,
the requests' prompts and output lengths out.

Lengths are a fixed multiset in every block of ``slots`` requests (one
full batch of the engine): the ``i``-th of a block is the
``(i + 0.5) / slots`` quantile of the mix's clipped lognormal, rounded.
The seed only orders them within each block (prompts and outputs apart)
and draws the token ids, so every seed serves the same work in another
order, in any prefix of the queue: runs on different seeds differ by
when each length arrives, not by how much work there is.
Prompt tokens are drawn from ``[1, vocab)``: 0 is the engine's left
padding.
"""

from __future__ import annotations

import math
import statistics

import numpy as np


def lengths(dist: dict, n: int) -> np.ndarray:
    """``n`` lengths at the evenly spaced quantiles of ``dist`` (a
    ``lognormal`` with ``median`` and ``sigma``, clipped to
    ``[min, max]``), ascending."""
    if dist["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    z = statistics.NormalDist()
    out = [round(dist["median"] * math.exp(dist["sigma"]
                                           * z.inv_cdf((i + 0.5) / n)))
           for i in range(n)]
    return np.clip(np.asarray(out, np.int64), dist["min"], dist["max"])


def requests(mix: dict, vocab: int, seed: int) -> list[tuple[np.ndarray, int]]:
    """``(prompt int32 (S,), max_new_tokens)`` for each of the mix's
    ``requests``, in the order the seed gives."""
    n, block = mix["requests"], mix["slots"]
    if n % block:
        raise ValueError(f"{n} requests are not whole blocks of {block}")
    rng = np.random.Generator(np.random.PCG64(seed))
    grid = lengths(mix["prompt_len"], block)
    plens = np.concatenate([rng.permutation(grid) for _ in range(n // block)])
    grid = lengths(mix["output_len"], block)
    olens = np.concatenate([rng.permutation(grid) for _ in range(n // block)])
    toks = rng.integers(1, vocab, size=int(plens.sum()), dtype=np.int32)
    starts = np.concatenate([[0], np.cumsum(plens)[:-1]])
    return [(toks[s:s + p], int(o)) for s, p, o in zip(starts, plens, olens)]


def calibration_tokens(mix: dict, vocab: int, seed: int) -> np.ndarray:
    """The calibration batch, (batch, seq_len) int32, from the seed (a
    stream of its own, apart from the requests')."""
    c = mix["calibration"]
    rng = np.random.Generator(np.random.PCG64([seed, 1]))
    return rng.integers(1, vocab, size=(c["batch"], c["seq_len"]),
                        dtype=np.int32)
