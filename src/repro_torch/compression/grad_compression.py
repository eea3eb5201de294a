"""Gradient compression with error feedback (beyond-paper application of the
paper's quantizer to distributed training).

Each gradient tensor is clipped to a model-derived range and quantized to
N levels (paper eq. 1) before the data-parallel reduction; the residual
(g - deq(q(g))) is carried in an error-feedback buffer and added back the
next step, which keeps SGD/Adam convergence intact (Karimireddy et al.
style EF).  Clipping ranges come from per-tensor moment estimates --
gradients are roughly symmetric, so we use a symmetric range +/- c where
c = clip_sigmas * std (the population standard deviation).

On real hardware the wire format is the packed uint8 index stream (4x
smaller than f32); here the quantize->dequantize happens before the
reduction, so accuracy effects are exactly reproduced while the byte
saving is documented analytically.

Gradients and buffers are nested dicts and lists of tensors.  The
quantizer is the eq. 1 formula of :mod:`repro_torch.core.uniform` with
the range a float32 tensor on the gradient's device: no kernel runs here.

Under a :class:`~repro_torch.models.DistContext` with a tp axis of more
than one rank, a rank holds only its slice of each expert stack, so the
clip range of an expert leaf comes from the population std of the whole
stack, as the reference's ``jnp.std`` of the sharded stack gives it: the
ranks' float64 sums are reduced over the tp group, first for the mean,
then for the squared deviations from it (no gradient is gathered), and
the leaf's mean squared residual is the whole stack's the same way.  The
other leaves are whole on every rank (``average_grads``) and take the
one-device path.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from ..models.context import is_expert_leaf
from ..tree import leaves as tree_leaves


@dataclasses.dataclass(frozen=True)
class GradCompressionConfig:
    n_levels: int = 16          # 4-bit gradients
    clip_sigmas: float = 4.0
    enabled: bool = True


def _map(fn, *trees):
    """Apply ``fn`` leaf-wise over nested dicts / lists / tuples."""
    head = trees[0]
    if isinstance(head, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in head}
    if isinstance(head, (list, tuple)):
        return type(head)(_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def init_error_feedback(params):
    return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)


def _quantize_dequantize(x: torch.Tensor, c: torch.Tensor,
                         n_levels: int) -> torch.Tensor:
    """Eq. 1 over [-c, c] with a float32 tensor ``c``, every step rounded
    in float32 as the reference's traced range does (tensor / tensor
    divides: torch's ``scalar / tensor`` is a reciprocal multiply)."""
    lo, hi = -c, c
    span = hi - lo
    n1 = torch.full_like(c, n_levels - 1)
    q = torch.floor((torch.clamp(x, lo, hi) - lo) * (n1 / span) + 0.5)
    return lo + q * (span / n1)


def _tp_sum(t: torch.Tensor, ctx) -> torch.Tensor:
    """The sum of ``t``'s elements over this rank's tp group, in
    float64."""
    out = t.sum(dtype=torch.float64).reshape(1)
    dist.all_reduce(out, group=ctx.tp_group)
    return out[0]


def _stack_std(gf: torch.Tensor, ctx) -> torch.Tensor:
    """Population std of the whole expert stack whose slice ``gf`` (float32)
    this rank holds, every slice of ``gf``'s size: two passes, each summed
    in float64 over the tp group.  The deviations are taken from the mean
    rounded to float32 (one float32 temporary, as ``torch.std``'s), and
    the variance corrected for that rounding."""
    n = gf.numel() * ctx.tp_size
    mean = _tp_sum(gf, ctx) / n
    m32 = mean.to(torch.float32)
    var = _tp_sum((gf - m32) ** 2, ctx) / n - (mean - m32.double()) ** 2
    return torch.sqrt(var).to(torch.float32)


def compress_grads(cfg: GradCompressionConfig, grads, ef_state, ctx=None):
    """Returns (compressed grads, new ef_state, metrics).  ``ctx``: the
    context the gradients were averaged under; it changes only the expert
    leaves' statistics under a tp axis of more than one rank."""
    if not cfg.enabled:
        return grads, ef_state, {"grad_compress_mse": torch.zeros(())}
    split = ctx is not None and ctx.tp_size > 1

    def one(g, e, sliced):
        gf = g.to(torch.float32) + e
        std = (_stack_std(gf, ctx) if sliced
               else torch.std(gf, correction=0)) + 1e-12
        c = cfg.clip_sigmas * std
        deq = _quantize_dequantize(gf, c, cfg.n_levels)
        # the residual must be measured against what is actually summed
        # in the reduction -- the value *after* the cast back to g.dtype.
        # Under bf16 the cast rounds deq, and EF only preserves the
        # convergence guarantee when cg + new_e == gf (in f32).
        cg = deq.to(g.dtype)
        new_e = gf - cg.to(torch.float32)
        sq = new_e ** 2
        mse = (_tp_sum(sq, ctx) / (sq.numel() * ctx.tp_size)).to(
            torch.float32) if sliced else torch.mean(sq)
        return cg, new_e, mse

    # buffers pair with gradients by key and position, as jax.tree does;
    # _map visits the leaves in the order of tree.leaves
    sliced = iter([split and is_expert_leaf(path)
                   for path, _ in tree_leaves(grads)])
    out = []
    cg = _map(lambda g, e: out.append(one(g, e, next(sliced))) or out[-1][0],
              grads, ef_state)
    ne_it = iter([o[1] for o in out])
    ne = _map(lambda _: next(ne_it), grads)
    mse = sum(o[2] for o in out) / max(len(out), 1)
    return cg, ne, {"grad_compress_mse": mse}


def wire_bytes_ratio(cfg: GradCompressionConfig) -> float:
    """Analytic wire saving vs f32 all-reduce (packed index stream)."""
    bits = max(1, math.ceil(math.log2(cfg.n_levels)))
    return bits / 32.0
