"""Train / prefill / decode steps (``make_*_step``) as plain functions
over the port's model (one device: no ``DistContext``)."""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..models import decode_step as _decode
from ..models import loss_and_grads, prefill as _prefill
from ..optim import AdamWConfig, adamw_update
from ..tree import leaves, rebuild


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig | None = None,
                    codec_fn=None, remat: bool = True,
                    microbatches: int = 1):
    """Train step ``(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with optional gradient accumulation over microbatches: the
    batch is cut into ``microbatches`` equal parts along its first axis,
    their gradients summed in float32 and divided by the count.
    ``batch`` holds tensors on the parameters' device."""
    opt_cfg = opt_cfg or AdamWConfig()

    def grads_of(params, batch):
        return loss_and_grads(cfg, params, batch["tokens"],
                              inputs=batch.get("inputs"), codec_fn=codec_fn,
                              remat=remat)

    def train_step(params, opt_state, batch):
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
        new_params, new_opt, metrics = adamw_update(opt_cfg, params, grads,
                                                    opt_state)
        out = {"loss": loss, **metrics}
        if "codec_rate_bits" in aux:
            out["codec_rate_bits"] = aux["codec_rate_bits"]
        return new_params, new_opt, out

    return train_step


def make_prefill_step(cfg: ModelConfig, codec_fn=None):
    def prefill_step(params, batch, cache):
        inp = batch.get("inputs", batch["tokens"])
        logits, new_cache = _prefill(cfg, params, inp, cache,
                                     codec_fn=codec_fn)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, new_cache

    return prefill_step


def make_decode_step(cfg: ModelConfig, codec_fn=None):
    def serve_step(params, token, cache, pos):
        logits, new_cache, _ = _decode(cfg, params, token, cache, pos,
                                       codec_fn=codec_fn)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, new_cache

    return serve_step
