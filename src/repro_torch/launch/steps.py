"""Train / prefill / decode steps (``make_*_step``) as plain functions
over the port's model, on one device or under a ``DistContext``.

Under a context (see :mod:`repro_torch.models.context`) the train step
takes the *global* batch and each rank trains on its dp rows, with the
MoE layers expert-parallel over the tp ranks; its gradients are averaged
over the mesh before the update (``context.average_grads``) and the
global norm is reduced over the tp group, so the update equals the
one-device step on the global batch.  The prefill and decode steps run
the rows they are given on every rank.
"""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..models import decode_step as _decode
from ..models import loss_and_grads, prefill as _prefill
from ..models.context import DistContext, average_grads, dp_rows, mesh_mean
from ..optim import AdamWConfig, adamw_update
from ..tree import leaves, rebuild


def make_train_step(cfg: ModelConfig, ctx: DistContext | None = None,
                    opt_cfg: AdamWConfig | None = None, codec_fn=None,
                    remat: bool = True, microbatches: int = 1):
    """Train step ``(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with optional gradient accumulation over microbatches: the
    batch is cut into ``microbatches`` equal parts along its first axis,
    their gradients summed in float32 and divided by the count.
    ``batch`` holds tensors on the parameters' device; under ``ctx`` it
    is the global batch, of which this rank takes its dp rows (the
    microbatches cut those), and the parameters hold this rank's
    experts."""
    opt_cfg = opt_cfg or AdamWConfig()

    def grads_of(params, batch):
        return loss_and_grads(cfg, params, batch["tokens"],
                              inputs=batch.get("inputs"), codec_fn=codec_fn,
                              remat=remat, ctx=ctx)

    def train_step(params, opt_state, batch):
        batch = {k: dp_rows(v, ctx) for k, v in batch.items()}
        if microbatches == 1:
            (loss, aux), grads = grads_of(params, batch)
        else:
            parts = {k: v.reshape(microbatches, v.shape[0] // microbatches,
                                  *v.shape[1:]) for k, v in batch.items()}
            gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                    for _, p in leaves(params)]
            losses = []
            for i in range(microbatches):
                (loss, _), g = grads_of(params,
                                        {k: v[i] for k, v in parts.items()})
                gsum = [a + b.to(torch.float32)
                        for a, (_, b) in zip(gsum, leaves(g))]
                losses.append(loss)
            n = torch.tensor(float(microbatches), device=gsum[0].device)
            grads = rebuild(params, iter([a / n for a in gsum]))
            loss, aux = torch.mean(torch.stack(losses)), {}
        grads = average_grads(grads, ctx)
        new_params, new_opt, metrics = adamw_update(opt_cfg, params, grads,
                                                    opt_state, ctx=ctx)
        out = {"loss": mesh_mean(loss, ctx), **metrics}
        if "codec_rate_bits" in aux:
            out["codec_rate_bits"] = aux["codec_rate_bits"]
        return new_params, new_opt, out

    return train_step


def make_prefill_step(cfg: ModelConfig, ctx: DistContext | None = None,
                      codec_fn=None):
    def prefill_step(params, batch, cache):
        inp = batch.get("inputs", batch["tokens"])
        logits, new_cache = _prefill(cfg, params, inp, cache, ctx=ctx,
                                     codec_fn=codec_fn)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, new_cache

    return prefill_step


def make_decode_step(cfg: ModelConfig, ctx: DistContext | None = None,
                     codec_fn=None):
    def serve_step(params, token, cache, pos):
        logits, new_cache, _ = _decode(cfg, params, token, cache, pos,
                                       ctx=ctx, codec_fn=codec_fn)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, new_cache

    return serve_step
