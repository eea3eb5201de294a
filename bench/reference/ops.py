"""Plain float32 operations that the layer kinds (``bench/layers``) and the
model's embedding and head share: the linear product, with the float8
control's operands, the activations and the norms."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` through float8 (e4m3, one scale a tensor) and back."""
    scale = t.abs().amax().clamp(min=1e-12) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def lin(a: torch.Tensor, w: torch.Tensor, lowp: bool) -> torch.Tensor:
    """(n, k) @ (k, m) in float32, through float8 operands for ``lowp``."""
    if lowp:
        a, w = fp8(a), fp8(w)
    return a @ w


def act(name: str):
    if name == "gelu":
        return lambda t: F.gelu(t, approximate="tanh")
    return F.silu


def norm(x, p, model):
    eps = model.get("norm_eps", 1e-6)
    if model.get("norm", "rmsnorm") == "layernorm":
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * p["scale"]
