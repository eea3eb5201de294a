"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

Block structure (one 'rglru' mixer):
    x -> [w_in -> causal conv1d(width 4) -> RG-LRU] * gelu(w_gate) -> w_out

RG-LRU recurrence (elementwise over the rnn width r):
    r_t = sigmoid(x_t @ W_a + b_a)          recurrence gate
    i_t = sigmoid(x_t @ W_x + b_x)          input gate
    log a_t = -c * softplus(Lambda) * r_t   (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The linear recurrence runs as a log-depth (Hillis-Steele) scan over the
sequence for prefill, with the JAX package's combine; its order of
products differs from ``lax.associative_scan``'s, so results agree to
rounding.  Decode carries (h, conv state) through the same code at
sequence length 1.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import _act, _normal

_C = 8.0


def init_rglru(gen, cfg, dtype, device=None):
    d, r, cw = cfg.d_model, cfg.rnn_dim, cfg.conv_width
    s_d, s_r = 1.0 / math.sqrt(d), 1.0 / math.sqrt(r)
    return {
        "w_in": _normal(gen, (d, r), dtype, device, s_d),
        "w_gate": _normal(gen, (d, r), dtype, device, s_d),
        "conv_w": _normal(gen, (cw, r), dtype, device, 0.3),
        "conv_b": torch.zeros((r,), dtype=dtype, device=device),
        "wa": _normal(gen, (r, r), dtype, device, s_r),
        "ba": torch.full((r,), 2.0, dtype=dtype, device=device),  # remember
        "wx": _normal(gen, (r, r), dtype, device, s_r),
        "bx": torch.zeros((r,), dtype=dtype, device=device),
        # softplus^-1-ish init; stays float32 whatever the model's dtype
        "lam": torch.full((r,), 0.54, dtype=torch.float32, device=device),
        "w_out": _normal(gen, (r, d), dtype, device, s_r),
    }


def _causal_conv(x, w, b, state=None):
    """x: (B, S, r); w: (cw, r) depthwise. state: (B, cw-1, r) prior inputs."""
    cw = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], cw - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, S+cw-1, r)
    out = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(cw))
    new_state = xp[:, -(cw - 1):, :]
    return out + b, new_state


def _gates(x, p):
    """a (decay) and gated input, elementwise. x: (..., r), float32 math."""
    xf = x.to(torch.float32)
    rg = torch.sigmoid(xf @ p["wa"].to(torch.float32)
                       + p["ba"].to(torch.float32))
    ig = torch.sigmoid(xf @ p["wx"].to(torch.float32)
                       + p["bx"].to(torch.float32))
    log_a = -_C * F.softplus(p["lam"]) * rg
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (ig * xf)
    return a, gated


def _linear_scan(a, b):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t (h_{-1} = 0) over axis 1,
    in log2(S) Hillis-Steele steps of the combine
    (a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2)."""
    off = 1
    while off < a.shape[1]:
        a_prev, b_prev = a[:, :-off], b[:, :-off]
        a_cur, b_cur = a[:, off:], b[:, off:]
        a = torch.cat([a[:, :off], a_prev * a_cur], dim=1)
        b = torch.cat([b[:, :off], a_cur * b_prev + b_cur], dim=1)
        off *= 2
    return b


def rglru_scan(x, p, h0=None):
    """Full-sequence RG-LRU. x: (B, S, r) post-conv."""
    a, bt = _gates(x, p)  # (B, S, r) f32
    if h0 is not None:
        # fold initial state into the first step: b_0 += a_0 * h0
        bt = torch.cat([bt[:, :1] + a[:, :1] * h0.to(torch.float32)[:, None],
                        bt[:, 1:]], dim=1)
    h = _linear_scan(a, bt)
    return h.to(x.dtype), h[:, -1, :]  # outputs, final state (f32)


def rglru_block_apply(x, p, cfg, cache=None):
    """Full mixer. x: (B, S, d). cache: {'h': (B,r) f32, 'conv': (B,cw-1,r)}.

    Returns (out (B,S,d), new_cache_or_None).
    """
    gate = _act("gelu")(x @ p["w_gate"])
    u = x @ p["w_in"]
    conv_state = cache["conv"] if cache is not None else None
    u, new_conv = _causal_conv(u, p["conv_w"], p["conv_b"], conv_state)
    h0 = cache["h"] if cache is not None else None
    h, h_last = rglru_scan(u, p, h0)
    out = (gate * h) @ p["w_out"]
    new_cache = None
    if cache is not None:
        new_cache = {"h": h_last, "conv": new_conv.to(cache["conv"].dtype)}
    return out, new_cache


def init_rglru_cache(cfg, batch: int, dtype, device=None):
    r, cw = cfg.rnn_dim, cfg.conv_width
    return {"h": torch.zeros((batch, r), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cw - 1, r), dtype=dtype,
                                device=device)}
