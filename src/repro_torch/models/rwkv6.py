"""RWKV-6 "Finch" time-mix and channel-mix (arXiv:2404.05892).

Per head (head dim n), with data-dependent per-channel decay w_t:

    o_t = r_t @ (S_{t-1} + diag(u) k_t^T v_t)
    S_t = diag(w_t) S_{t-1} + k_t^T v_t

where w_t = exp(-exp(w0 + tanh(x_w A) B)) is the Finch low-rank
data-dependent decay.  Token shift mixes x_{t-1} into each projection
input with learned per-channel ratios mu_*.

Execution: projections/LoRA are parallel over the sequence; the state
recurrence runs over *time chunks* of 16 steps (the sequence padded to a
whole number of chunks, as the JAX package pads it, so the same work is
done) of rank-1 state updates batched over (B, H).  Decode is a single
state update.  :func:`time_loop` swaps the loop over the padded
sequence for another with the same signature (the cost analysis counts
one step of it times the sequence length).

Simplifications vs the reference implementation (noted in DESIGN.md):
static token-shift mix ratios (Finch makes them data-dependent), and
a per-channel RMS norm on the time-mix output instead of per-head
GroupNorm.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from .layers import _normal, rms_norm

_CHUNK = 16


def _uniform(gen, shape, dtype, device):
    return torch.rand(shape, generator=gen, dtype=dtype, device=device)


def init_rwkv(gen, cfg, dtype, device=None):
    d = cfg.d_model
    h, n = cfg.num_heads, cfg.rwkv_head_dim
    m = h * n
    rank = cfg.rwkv_lora_rank
    s_d = 1.0 / math.sqrt(d)
    return {
        "mu": _uniform(gen, (5, d), dtype, device),  # r,k,v,w,g mix ratios
        "wr": _normal(gen, (d, m), dtype, device, s_d),
        "wk": _normal(gen, (d, m), dtype, device, s_d),
        "wv": _normal(gen, (d, m), dtype, device, s_d),
        "wg": _normal(gen, (d, m), dtype, device, s_d),
        "wo": _normal(gen, (m, d), dtype, device, 1.0 / math.sqrt(m)),
        # base decay and first-token bonus stay float32
        "w0": torch.full((m,), -2.0, dtype=torch.float32, device=device),
        "wa": _normal(gen, (d, rank), dtype, device, s_d),
        "wb": _normal(gen, (rank, m), dtype, device, 1.0 / math.sqrt(rank)),
        "u": torch.zeros((h, n), dtype=torch.float32, device=device),
        "ln": torch.ones((m,), dtype=dtype, device=device),
    }


def init_channel_mix(gen, cfg, dtype, device=None):
    d, f = cfg.d_model, cfg.d_ff
    s_d, s_f = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    return {
        "mu": _uniform(gen, (2, d), dtype, device),  # k, r mix ratios
        "wk": _normal(gen, (d, f), dtype, device, s_d),
        "wv": _normal(gen, (f, d), dtype, device, s_f),
        "wr": _normal(gen, (d, d), dtype, device, s_d),
    }


def _token_shift(x, last):
    """x: (B, S, d); last: (B, d) previous token (zeros at t=0)."""
    return torch.cat([last[:, None, :], x[:, :-1, :]], dim=1)


def _wkv_step(r, k, v, w, u, state):
    """Single decode step. r,k,v,w: (B, H, n); state: (B, H, n, n)."""
    kv = k[..., :, None] * v[..., None, :]
    o = torch.einsum("bhi,bhij->bhj", r, state + u[..., None] * kv)
    new_state = w[..., :, None] * state + kv
    return o, new_state


def time_mix_apply(x, p, cfg, cache=None):
    """RWKV-6 time mixing. x: (B, S, d).

    cache: {'state': (B,H,n,n) f32, 'shift': (B,d) f32} or None.
    Returns (out (B, S, d), new_cache_or_None).
    """
    b, s, d = x.shape
    h, n = cfg.num_heads, cfg.rwkv_head_dim
    last = cache["shift"].to(x.dtype) if cache is not None \
        else torch.zeros((b, d), dtype=x.dtype, device=x.device)
    prev = _token_shift(x, last)

    def mix(i):
        mu = p["mu"][i].to(x.dtype)
        return x + mu * (prev - x)

    xr, xk, xv, xw, xg = (mix(i) for i in range(5))
    r = (xr @ p["wr"]).to(torch.float32).reshape(b, s, h, n)
    k = (xk @ p["wk"]).to(torch.float32).reshape(b, s, h, n)
    v = (xv @ p["wv"]).to(torch.float32).reshape(b, s, h, n)
    g = F.silu(xg @ p["wg"])
    # data-dependent decay (Finch): w = exp(-exp(w0 + tanh(xw A) B))
    lw = p["w0"].to(torch.float32) + \
        (torch.tanh(xw.to(torch.float32) @ p["wa"].to(torch.float32))
         @ p["wb"].to(torch.float32))
    w = torch.exp(-torch.exp(torch.clamp(lw, -12.0, 4.0))).reshape(b, s, h, n)
    u = p["u"].to(torch.float32)

    if cache is not None and s == 1:
        o, new_state = _wkv_step(r[:, 0], k[:, 0], v[:, 0], w[:, 0], u,
                                 cache["state"])
        o = o[:, None]
    else:
        state0 = cache["state"] if cache is not None else \
            torch.zeros((b, h, n, n), dtype=torch.float32, device=x.device)
        o, new_state = _wkv_chunk_scan(r, k, v, w, u, state0)

    o = o.reshape(b, s, h * n).to(x.dtype)
    o = rms_norm(o, p["ln"], cfg.norm_eps) * g
    out = o @ p["wo"]
    new_cache = None
    if cache is not None:
        new_cache = {"state": new_state,
                     "shift": x[:, -1, :].to(torch.float32)}
    return out, new_cache


def _wkv_loop(step, r, k, v, w, u, state):
    """The recurrence over the whole (padded) sequence, ``step`` (one
    rank-1 state update, :func:`_wkv_step`) a time step.  Returns (o,
    final_state)."""
    outs = []
    for t in range(r.shape[1]):
        o, state = step(r[:, t], k[:, t], v[:, t], w[:, t], u, state)
        outs.append(o)
    return torch.stack(outs, dim=1), state


# the loop _wkv_chunk_scan runs over the padded sequence (see time_loop)
_time_loop = _wkv_loop


@contextlib.contextmanager
def time_loop(loop):
    """Inside ``with``, the chunk scan runs ``loop(step, r, k, v, w, u,
    state) -> (o, final_state)`` over the padded sequence in place of
    :func:`_wkv_loop`."""
    global _time_loop
    prev, _time_loop = _time_loop, loop
    try:
        yield
    finally:
        _time_loop = prev


def _wkv_chunk_scan(r, k, v, w, u, state0):
    """Exact recurrence over time chunks of length _CHUNK.

    r,k,v,w: (B, S, H, n) f32 (w is the per-step decay in (0,1));
    u: (H, n); state0: (B, H, n, n).  The sequence is padded to whole
    chunks (zeros; w with 1.0, which leaves the state as it is), as the
    reference pads it.  Returns (o, final_state).
    """
    s = r.shape[1]
    pad = (-s) % _CHUNK
    if pad:
        def zp(a, cv=0.0):
            return F.pad(a, (0, 0, 0, 0, 0, pad), value=cv)
        r, k, v, w = zp(r), zp(k), zp(v), zp(w, 1.0)
    o, state = _time_loop(_wkv_step, r, k, v, w, u,
                          state0.to(torch.float32))
    return o[:, :s], state


def channel_mix_apply(x, p, cache=None):
    """RWKV channel mixing (the FFN). x: (B, S, d)."""
    b, s, d = x.shape
    last = cache["shift"].to(x.dtype) if cache is not None \
        else torch.zeros((b, d), dtype=x.dtype, device=x.device)
    prev = _token_shift(x, last)
    xk = x + p["mu"][0].to(x.dtype) * (prev - x)
    xr = x + p["mu"][1].to(x.dtype) * (prev - x)
    kk = torch.square(torch.relu(xk @ p["wk"]))
    out = torch.sigmoid(xr @ p["wr"]) * (kk @ p["wv"])
    new_cache = None
    if cache is not None:
        new_cache = {"shift": x[:, -1, :].to(torch.float32)}
    return out, new_cache


def init_rwkv_cache(cfg, batch: int, device=None):
    h, n, d = cfg.num_heads, cfg.rwkv_head_dim, cfg.d_model

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return {"tmix": {"state": zeros(batch, h, n, n), "shift": zeros(batch, d)},
            "cmix": {"shift": zeros(batch, d)}}
