"""The mixer of a layer of kind ``attn``: causal GQA attention, full or
over a sliding window, with rotary positions in the half-split layout,
softmax in float32, and an output projection."""

from __future__ import annotations

import math

import torch

from bench import roofline as RL
from bench.layers import Matrix
from bench.reference import ops

OPTIONS = ("d_model", "num_heads", "num_kv_heads", "head_dim", "rope_theta",
           "norm", "norm_eps", "dtype", "window")
GROUP = "attn"


def matrices(model: dict, spec: dict) -> list[Matrix]:
    d, hd = model["d_model"], model["head_dim"]
    h, kh = model["num_heads"], model["num_kv_heads"]
    s = 1 / math.sqrt(d)
    return [Matrix("wq", (d, h, hd), s), Matrix("wk", (d, kh, hd), s),
            Matrix("wv", (d, kh, hd), s),
            Matrix("wo", (h, hd, d), 1 / math.sqrt(h * hd))]


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, L, N, hd) at positions 0..L-1."""
    length, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float64) / half)
    ang = torch.arange(length, dtype=torch.float64)[:, None] * freqs
    sin = torch.sin(ang).to(torch.float32).to(x.device)[None, :, None]
    cos = torch.cos(ang).to(torch.float32).to(x.device)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v, window: int | None, chunk: int = 512):
    """Causal GQA attention; q (B, L, H, hd), k/v (B, L, K, hd).  Under
    a ``window`` a query at position i sees the keys at i - window + 1
    .. i, as the port masks them (``q_pos - k_pos < window``)."""
    b, length, h, hd = q.shape
    kh = k.shape[2]
    qg = q.reshape(b, length, kh, h // kh, hd)
    out = torch.empty_like(q)
    for c0 in range(0, length, chunk):
        c1 = min(length, c0 + chunk)
        lo = 0 if window is None else max(0, c0 - window + 1)
        s = torch.einsum("bskgh,btkh->bkgst", qg[:, c0:c1], k[:, lo:c1])
        s = s / math.sqrt(hd)
        q_pos = torch.arange(c0, c1, device=q.device)[:, None]
        k_pos = torch.arange(lo, c1, device=q.device)[None, :]
        masked = k_pos > q_pos
        if window is not None:
            masked |= q_pos - k_pos >= window
        s = s.masked_fill(masked, float("-inf"))
        o = torch.einsum("bkgst,btkh->bskgh", torch.softmax(s, -1),
                         v[:, lo:c1])
        out[:, c0:c1] = o.reshape(b, c1 - c0, h, hd)
    return out


def forward(x, p, spec: dict, model: dict, lowp: bool):
    b, length, d = x.shape
    a = p[GROUP]
    h, kh, hd = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    theta = model.get("rope_theta", 10_000.0)
    hn = ops.norm(x, p["norm1"], model).reshape(b * length, d)
    q = ops.lin(hn, a["wq"].reshape(d, h * hd), lowp).view(b, length, h, hd)
    k = ops.lin(hn, a["wk"].reshape(d, kh * hd), lowp).view(b, length, kh, hd)
    v = ops.lin(hn, a["wv"].reshape(d, kh * hd), lowp).view(b, length, kh, hd)
    o = _attention(_rope(q, theta), _rope(k, theta), v, spec.get("window"))
    return x + ops.lin(o.reshape(b * length, h * hd),
                       a["wo"].reshape(h * hd, d), lowp).view(b, length, d)


def params(model: dict, spec: dict) -> int:
    d, hd = model["d_model"], model["head_dim"]
    h, kh = model["num_heads"], model["num_kv_heads"]
    return d * h * hd * 2 + d * kh * hd * 2


def _seen(first: int, last: int, window: int | None) -> int:
    """Keys seen by the tokens of context lengths first..last: each
    sees its whole context, or the last ``window`` positions of it."""
    w = last if window is None else window
    a, b = first, min(last, w)           # contexts within the window
    seen = (a + b) * (b - a + 1) // 2 if a <= b else 0
    return seen + w * (last - max(first, w + 1) + 1 if last > w else 0)


def context_flops(model: dict, spec: dict, contexts) -> int:
    """The two products over the keys each token sees: scores and the
    weighted values, ``4 H hd`` a query-key pair."""
    pairs = sum(_seen(a, b, spec.get("window")) for a, b in contexts)
    return 4 * model["num_heads"] * model["head_dim"] * pairs


def decode_bytes(model: dict, spec: dict, rows: int, pos: int) -> int:
    """Bytes of one decode step's attention at position ``pos`` over
    ``rows`` rows: the K and V of each row's valid cache slots (the
    written prefix, or the window's ring) read once."""
    window = spec.get("window")
    n_valid = pos + 1 if window is None else min(pos + 1, window)
    return 2 * rows * n_valid * model["num_kv_heads"] * model["head_dim"] \
        * RL.dtype_bytes(model)
