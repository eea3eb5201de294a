"""Truncated-unary binarization (paper Sec. III-D).

Index n in [0, N) maps to n ones followed by a terminating zero, except the
maximum index N-1 which maps to N-1 ones (no terminator):

    N=4:  0 -> 0, 1 -> 10, 2 -> 110, 3 -> 111

One CABAC context is used per bit *position*, so for context j the bit
stream consists of, for every element with index n >= j (and j <= N-2),
a bit equal to (n > j).  This position-major ("bin-plane") ordering is what
``index_to_context_bits`` produces; it is decodable because the decoder
knows after plane j which elements are still "alive" in plane j+1.
"""

from __future__ import annotations

import numpy as np


def truncated_unary_lengths(n_levels: int) -> np.ndarray:
    """Codeword length in bits for each index of an N-level TU code."""
    lens = np.arange(1, n_levels + 1, dtype=np.int32)
    lens[-1] = n_levels - 1
    return lens


def encode_index(n: int, n_levels: int) -> str:
    if n < n_levels - 1:
        return "1" * n + "0"
    return "1" * (n_levels - 1)


def index_to_context_bits(idx: np.ndarray, n_levels: int) -> list[np.ndarray]:
    """Per-context (bit-position) planes of TU bits, vectorized.

    Returns a list of N-1 uint8 arrays; plane j holds the bits of every
    element whose codeword reaches position j (i.e. idx >= j), in element
    order.  Bit value is 1 iff idx > j.
    """
    cur = np.asarray(idx).ravel()
    planes = []
    for j in range(n_levels - 1):
        # iteratively compact the survivors: plane j+1's alive set is
        # exactly plane j's one-bits, so each selection runs over the
        # shrinking alive array instead of the full tensor
        bits = cur > j
        planes.append(bits.view(np.uint8))
        if j < n_levels - 2:
            cur = cur[bits]
    return planes


def context_bits_to_index(planes: list[np.ndarray], n_elems: int,
                          n_levels: int) -> np.ndarray:
    """Inverse of :func:`index_to_context_bits`."""
    idx = np.zeros(n_elems, dtype=np.int32)
    alive = np.ones(n_elems, dtype=bool)
    for j in range(n_levels - 1):
        bits = np.asarray(planes[j], dtype=np.uint8)
        if bits.size != int(alive.sum()):
            raise ValueError("plane size mismatch")
        cont = np.zeros(n_elems, dtype=bool)
        cont[alive] = bits.astype(bool)
        idx[cont] += 1
        alive = cont
    return idx


def total_tu_bits(idx: np.ndarray, n_levels: int) -> int:
    """Number of TU bits before entropy coding."""
    lens = truncated_unary_lengths(n_levels)
    return int(lens[np.asarray(idx).ravel()].sum())
