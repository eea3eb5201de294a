"""The feed-forward of a layer whose spec sets ``moe``: a softmax router
over every expert, the top k of them with their weights renormalised,
each a gated MLP; every routed token is computed (nothing dropped)."""

from __future__ import annotations

import math

import torch

from bench.layers import Matrix
from bench.reference import ops

OPTIONS = ("d_model", "num_experts", "experts_per_token", "moe_d_ff", "act",
           "norm", "norm_eps")
GROUP = "moe"


def matrices(model: dict, spec: dict) -> list[Matrix]:
    d, e, f = model["d_model"], model["num_experts"], model["moe_d_ff"]
    return [Matrix("router", (d, e), 1 / math.sqrt(d), own="router"),
            Matrix("w1", (e, d, f), 1 / math.sqrt(d)),
            Matrix("w3", (e, d, f), 1 / math.sqrt(d)),
            Matrix("w2", (e, f, d), 1 / math.sqrt(f))]


def mixture(xs: torch.Tensor, p: dict, model: dict,
            lowp: bool) -> torch.Tensor:
    """The expert layer on the rows of ``xs`` (n, d)."""
    act = ops.act(model.get("act", "silu"))
    probs = torch.softmax(xs @ p["router"], dim=-1)
    w, idx = torch.topk(probs, model["experts_per_token"], dim=-1)
    w = w / w.sum(-1, keepdim=True)
    out = torch.zeros_like(xs)
    for e in range(model["num_experts"]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = xs[tok]
        he = act(ops.lin(xe, p["w1"][e], lowp)) \
            * ops.lin(xe, p["w3"][e], lowp)
        out.index_add_(0, tok, ops.lin(he, p["w2"][e], lowp)
                       * w[tok, slot][:, None])
    return out


def forward(x, p, spec: dict, model: dict, lowp: bool):
    b, length, d = x.shape
    hn = ops.norm(x, p["norm2"], model)
    return x + mixture(hn.reshape(b * length, d), p[GROUP], model,
                       lowp).view(b, length, d)


def params(model: dict, spec: dict) -> int:
    """The router and the k experts a token is routed to."""
    d, e, k, f = (model["d_model"], model["num_experts"],
                  model["experts_per_token"], model["moe_d_ff"])
    return d * e + k * 3 * d * f


def context_flops(model: dict, spec: dict, contexts) -> int:
    return 0
