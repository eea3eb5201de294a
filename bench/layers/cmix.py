"""The feed-forward that an RWKV-6 ("Finch") mixer names as its
``FEED_FORWARD``: the channel mix of RWKV-LM v6's ``ChannelMix``.  Over
the normed input ``h`` and ``prev``, ``h`` shifted one position later
(zeros at a row's start),

    xk = h + mu_0 (prev - h),   xr = h + mu_1 (prev - h),
    out = sigmoid(xr wr) * (relu(xk wk)^2 wv).

The port's ``channel_mix_apply`` computes the same, in its layout."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench.layers import Matrix
from bench.reference import ops

OPTIONS = ("d_model", "d_ff", "norm", "norm_eps")
GROUP = "cmix"


def matrices(model: dict, spec: dict) -> list[Matrix]:
    d, f = model["d_model"], model["d_ff"]
    # the mix ratios: the port draws them U(0, 1), so mean 1/2, spread
    # 1/sqrt(12)
    return [Matrix("mu", (2, d), 1 / math.sqrt(12), mean=0.5),
            Matrix("wk", (d, f), 1 / math.sqrt(d)),
            Matrix("wv", (f, d), 1 / math.sqrt(f)),
            Matrix("wr", (d, d), 1 / math.sqrt(d))]


def forward(x, p, spec: dict, model: dict, lowp: bool):
    b, length, d = x.shape
    c = p[GROUP]
    h = ops.norm(x, p["norm2"], model)
    prev = F.pad(h, (0, 0, 1, 0))[:, :-1]
    xk = (h + c["mu"][0] * (prev - h)).reshape(b * length, d)
    xr = (h + c["mu"][1] * (prev - h)).reshape(b * length, d)
    k = torch.relu(ops.lin(xk, c["wk"], lowp)).square()
    y = torch.sigmoid(ops.lin(xr, c["wr"], lowp)) * ops.lin(k, c["wv"], lowp)
    return x + y.view(b, length, d)


def params(model: dict, spec: dict) -> int:
    d, f = model["d_model"], model["d_ff"]
    return 2 * d * f + d * d


def context_flops(model: dict, spec: dict, contexts) -> int:
    return 0
