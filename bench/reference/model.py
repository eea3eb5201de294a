"""Plain float32 forward pass of the decoder LMs the cells serve.

Pre-norm decoder layers: GQA attention with rotary positions (the
half-split layout), causal, softmax in float32; a gated MLP or a top-k
mixture of experts that drops nothing; an untied head.  The boundary
quantizer runs between two layers at every position.

It runs layer by layer over a list of :class:`Item` (sequence batches):
each layer's weights are made again from the seed (``bench.weights``),
widened to float32, used on every item and dropped, so at most one
float32 layer is on the device beside the activations.  Float32 matrix
products run without TF32.

``lowp=True`` is the control: every linear product takes its operands
through float8 (e4m3, one scale a tensor), the precision below the
configuration's bfloat16.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from .. import weights as W
from ..roofline import layer_specs
from . import codec as QC


@dataclasses.dataclass
class Item:
    """A batch of token rows run together.  ``first``: the first
    position whose logits are kept; ``edge_only``: stop at the boundary
    and keep its activations."""
    tokens: torch.Tensor                    # (B, L) integer
    first: int = 0
    edge_only: bool = False
    logits: torch.Tensor | None = None      # (B, L - first, V) float32
    boundary: torch.Tensor | None = None    # (B, L, d) float32


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.abs().amax().clamp(min=1e-12) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _lin(a: torch.Tensor, w: torch.Tensor, lowp: bool) -> torch.Tensor:
    """(n, k) @ (k, m) in float32, through float8 operands for ``lowp``."""
    if lowp:
        a, w = _fp8(a), _fp8(w)
    return a @ w


def _act(name: str):
    if name == "gelu":
        return lambda t: F.gelu(t, approximate="tanh")
    return F.silu


def _norm(x, p, model):
    eps = model.get("norm_eps", 1e-6)
    if model.get("norm", "rmsnorm") == "layernorm":
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * p["scale"]


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


def _attention(q, k, v, chunk: int = 512):
    """Causal GQA attention; q (B, L, H, hd), k/v (B, L, K, hd)."""
    b, length, h, hd = q.shape
    kh = k.shape[2]
    qg = q.reshape(b, length, kh, h // kh, hd)
    out = torch.empty_like(q)
    for c0 in range(0, length, chunk):
        c1 = min(length, c0 + chunk)
        s = torch.einsum("bskgh,btkh->bkgst", qg[:, c0:c1], k[:, :c1])
        s = s / math.sqrt(hd)
        future = torch.arange(c1, device=q.device)[None, :] \
            > torch.arange(c0, c1, device=q.device)[:, None]
        s = s.masked_fill(future, float("-inf"))
        o = torch.einsum("bkgst,btkh->bskgh", torch.softmax(s, -1),
                         v[:, :c1])
        out[:, c0:c1] = o.reshape(b, c1 - c0, h, hd)
    return out


def moe(xs: torch.Tensor, p: dict, model: dict, lowp: bool) -> torch.Tensor:
    """Top-k routing over every expert, the k weights renormalised; every
    routed token is computed."""
    act = _act(model.get("act", "silu"))
    probs = torch.softmax(xs @ p["router"], dim=-1)
    w, idx = torch.topk(probs, model["experts_per_token"], dim=-1)
    w = w / w.sum(-1, keepdim=True)
    out = torch.zeros_like(xs)
    for e in range(model["num_experts"]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = xs[tok]
        he = act(_lin(xe, p["w1"][e], lowp)) * _lin(xe, p["w3"][e], lowp)
        out.index_add_(0, tok, _lin(he, p["w2"][e], lowp)
                       * w[tok, slot][:, None])
    return out


def layer_forward(x, p, spec: dict, model: dict, lowp: bool):
    b, length, d = x.shape
    a = p["attn"]
    h, kh, hd = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    theta = model.get("rope_theta", 10_000.0)
    hn = _norm(x, p["norm1"], model).reshape(b * length, d)
    q = _lin(hn, a["wq"].reshape(d, h * hd), lowp).view(b, length, h, hd)
    k = _lin(hn, a["wk"].reshape(d, kh * hd), lowp).view(b, length, kh, hd)
    v = _lin(hn, a["wv"].reshape(d, kh * hd), lowp).view(b, length, kh, hd)
    o = _attention(_rope(q, theta), _rope(k, theta), v)
    x = x + _lin(o.reshape(b * length, h * hd), a["wo"].reshape(h * hd, d),
                 lowp).view(b, length, d)
    hn = _norm(x, p["norm2"], model)
    if spec["moe"]:
        y = moe(hn.reshape(b * length, d), p["moe"], model,
                lowp).view(b, length, d)
    else:
        m, act = p["mlp"], _act(model.get("act", "silu"))
        flat = hn.reshape(b * length, d)
        y = _lin(act(_lin(flat, m["w1"], lowp)) * _lin(flat, m["w3"], lowp),
                 m["w2"], lowp).view(b, length, d)
    return x + y


def _widen(tree):
    if isinstance(tree, dict):
        return {k: _widen(v) for k, v in tree.items()}
    return tree.to(torch.float32)


class Reference:
    """The configuration file's model from ``seed``'s weights."""

    def __init__(self, config: dict, seed: int, device, lowp: bool = False):
        self.model = config["model"]
        self.seed, self.device, self.lowp = seed, torch.device(device), lowp
        self.specs = layer_specs(self.model)
        self.split = self.model["split_after_period"] \
            * len(self.model.get("pattern") or [{}])

    def run(self, items: list[Item], boundary) -> tuple:
        """Fill each item's ``logits`` (or ``boundary``); ``boundary(
        edge_items)`` is called once, after the edge layers, with the
        edge-only items' activations set, and returns ``(cmin, cmax,
        n_levels)``, the range every other item's boundary is quantized
        on.  Returns that range."""
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return self._run(items, boundary)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = prev

    @torch.no_grad()
    def _run(self, items, boundary):
        model, dev = self.model, self.device
        table = W.embed(model, self.seed, dev)
        xs = [table[it.tokens.to(dev).long()].to(torch.float32)
              for it in items]
        del table
        live = list(range(len(items)))
        qrange = None
        for i, spec in enumerate(self.specs):
            p = _widen(W.layer(model, i, self.seed, dev))
            for j in live:
                xs[j] = layer_forward(xs[j], p, spec, model, self.lowp)
            del p
            if i + 1 == self.split:
                edge = [j for j in live if items[j].edge_only]
                for j in edge:
                    items[j].boundary = xs[j]
                qrange = boundary([items[j] for j in edge])
                live = [j for j in live if not items[j].edge_only]
                for j in live:
                    xs[j] = QC.fake_quant(xs[j], *qrange)
        top = _widen(W.head(model, self.seed, dev))
        for j in live:
            x = _norm(xs[j][:, items[j].first:], top["final_norm"], model)
            b, n, d = x.shape
            items[j].logits = _lin(x.reshape(b * n, d), top["w"],
                                   self.lowp).view(b, n, -1)
            xs[j] = None
        return qrange
