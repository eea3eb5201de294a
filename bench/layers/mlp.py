"""The feed-forward of a layer whose spec does not set ``moe``: a gated
MLP, ``w2 (act(x w1) * (x w3))``."""

from __future__ import annotations

import math

from bench.layers import Matrix
from bench.reference import ops

OPTIONS = ("d_model", "d_ff", "act", "norm", "norm_eps")
GROUP = "mlp"


def matrices(model: dict, spec: dict) -> list[Matrix]:
    d, f = model["d_model"], model["d_ff"]
    return [Matrix("w1", (d, f), 1 / math.sqrt(d)),
            Matrix("w2", (f, d), 1 / math.sqrt(f)),
            Matrix("w3", (d, f), 1 / math.sqrt(d))]


def forward(x, p, spec: dict, model: dict, lowp: bool):
    b, length, d = x.shape
    m, act = p[GROUP], ops.act(model.get("act", "silu"))
    flat = ops.norm(x, p["norm2"], model).reshape(b * length, d)
    y = ops.lin(act(ops.lin(flat, m["w1"], lowp))
                * ops.lin(flat, m["w3"], lowp), m["w2"], lowp)
    return x + y.view(b, length, d)


def params(model: dict, spec: dict) -> int:
    return 3 * model["d_model"] * model["d_ff"]


def context_flops(model: dict, spec: dict, contexts) -> int:
    return 0
