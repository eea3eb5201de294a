"""Shared neural layers: norms, RoPE, GQA attention (global/sliding-window,
query-chunked), gated MLPs.

Layouts follow the JAX package: activations (B, S, d), q (B, S, H, hd),
k/v (B, S, K, hd).  Attention is plain torch: logits, softmax and the
value accumulation run in float32 regardless of the activation dtype,
exactly like the reference's ``_attn_core``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_NEG_INF = -1e30
DEFAULT_Q_CHUNK = 512


# -- norms ---------------------------------------------------------------------

def rms_norm(x, scale, eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.to(torch.float32)
    return out.to(x.dtype)


def layer_norm(x, scale, bias, eps: float = 1e-6):
    xf = x.to(torch.float32)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mean) ** 2, dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps) * scale.to(torch.float32) \
        + bias.to(torch.float32)
    return out.to(x.dtype)


def apply_norm(x, params, kind: str, eps: float):
    if kind == "layernorm":
        return layer_norm(x, params["scale"], params["bias"], eps)
    return rms_norm(x, params["scale"], eps)


def init_norm(kind: str, d: int, dtype, device=None):
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


# -- positional embeddings -------------------------------------------------------

def rope(x, positions, theta: float = 10_000.0):
    """Rotary embedding. x: (..., S, N, hd); positions: (S,) or (B, S)."""
    hd = x.shape[-1]
    half = hd // 2
    expo = -torch.arange(0, half, dtype=torch.float32, device=x.device) \
        / torch.full((half,), float(half), device=x.device)
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=x.device), expo)
    ang = positions.to(torch.float32)[..., None] * freqs
    if ang.dim() == 2:   # (S, hd/2) -> broadcast over batch and heads
        ang = ang[None, :, None, :]
    else:                # (B, S, hd/2)
        ang = ang[:, :, None, :]
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos_emb(positions, d: int, dtype=torch.float32):
    """Classic transformer sinusoidal embedding for given positions (S,)."""
    half = d // 2
    freqs = torch.exp(-math.log(10_000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.to(torch.float32)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


# -- attention -------------------------------------------------------------------

def _attn_core(q, k, v, q_positions, k_positions, *, window, softcap, dtype):
    """Exact attention for one query block.

    q: (B, Sq, K, G, hd); k/v: (B, Sk, K, hd);
    q_positions: (Sq,), k_positions: (Sk,) (negative = invalid slot).
    """
    hd = q.shape[-1]
    logits = torch.einsum("bskgh,btkh->bkgst", q.to(torch.float32),
                          k.to(torch.float32))
    logits = logits * (1.0 / math.sqrt(hd))
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    valid = (k_positions[None, :] <= q_positions[:, None]) & \
        (k_positions[None, :] >= 0)
    if window is not None:
        valid &= q_positions[:, None] - k_positions[None, :] < window
    logits = torch.where(valid[None, None, None], logits,
                         torch.full_like(logits, _NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh",
                       probs.to(v.dtype).to(torch.float32),
                       v.to(torch.float32))
    return out.to(dtype)


def multi_head_attention(q, k, v, *, q_offset: int = 0, k_positions=None,
                         window=None, softcap: float = 0.0,
                         q_chunk: int = DEFAULT_Q_CHUNK):
    """GQA attention with optional sliding window and query chunking.

    q: (B, Sq, H, hd); k, v: (B, Sk, K, hd) with H % K == 0.
    ``q_offset``: absolute position of q[0].  ``k_positions``: absolute
    positions of cache slots, (Sk,); defaults to arange(Sk).  Entries < 0
    are masked out (unwritten ring slots).  Long query blocks run in
    chunks of ``q_chunk`` rows (exact: each chunk sees whole key rows).
    """
    b, sq, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
    qg = q.reshape(b, sq, kh, g, hd)
    dev = q.device
    if k_positions is None:
        k_positions = torch.arange(sk, dtype=torch.int32, device=dev)
    step = q_chunk if (sq > q_chunk and sq % q_chunk == 0) else sq
    outs = []
    for c0 in range(0, sq, step):
        q_pos = q_offset + c0 + torch.arange(step, dtype=torch.int32,
                                             device=dev)
        outs.append(_attn_core(qg[:, c0:c0 + step], k, v, q_pos,
                               k_positions, window=window, softcap=softcap,
                               dtype=q.dtype))
    return torch.cat(outs, dim=1).reshape(b, sq, h, hd)


# -- MLP -------------------------------------------------------------------------

def _act(name: str):
    if name == "gelu":
        return lambda t: F.gelu(t, approximate="tanh")   # jax.nn.gelu
    return F.silu


def mlp_apply(x, p, act: str, gated: bool):
    if gated:
        h = _act(act)(x @ p["w1"]) * (x @ p["w3"])
    else:
        h = _act(act)(x @ p["w1"])
    return h @ p["w2"]


def _normal(gen, shape, dtype, device, scale: float):
    t = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    return t.mul_(scale)


def init_mlp(gen, d: int, f: int, gated: bool, dtype, device=None):
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    p = {"w1": _normal(gen, (d, f), dtype, device, s_in),
         "w2": _normal(gen, (f, d), dtype, device, s_out)}
    if gated:
        p["w3"] = _normal(gen, (d, f), dtype, device, s_in)
    return p


# -- attention parameter block ----------------------------------------------------

def init_attention(gen, cfg, dtype, device=None):
    d, h, kh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = 1.0 / math.sqrt(d)
    p = {
        "wq": _normal(gen, (d, h, hd), dtype, device, s),
        "wk": _normal(gen, (d, kh, hd), dtype, device, s),
        "wv": _normal(gen, (d, kh, hd), dtype, device, s),
        "wo": _normal(gen, (h, hd, d), dtype, device,
                      1.0 / math.sqrt(h * hd)),
    }
    if cfg.use_qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=device)
    return p


def attention_qkv(x, p, cfg, positions):
    """Project + RoPE.  x: (B,S,d) -> q (B,S,H,hd), k/v (B,S,K,hd)."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.use_qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.pos_emb == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_out(attn, p):
    return torch.einsum("bshk,hkd->bsd", attn, p["wo"])
