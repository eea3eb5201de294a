"""AdamW as plain torch functions over the port's nested parameter dicts.

Moments are float32 regardless of the parameter dtype (mixed-precision
master statistics), the step count an int32 tensor.  Each step follows
the JAX package's formula (``repro.optim.adamw``) operation by
operation; every divide is tensor by tensor, since torch turns a
division by a python number into a reciprocal multiply on the card.

Under a :class:`~repro_torch.models.context.DistContext` whose tp ranks
hold slices of the expert stacks, the global norm adds the expert
leaves' sums of squares over the tp group and counts every replicated
leaf once, so every rank clips by the one-device norm (ranks that
clipped by their own norms would drift apart).

Weight decay follows the rank a leaf has in the JAX package's layout,
where a layer's leaves are stacked over the periods of its group: a leaf
under ``params["layers"]`` counts one axis more than it has here, so
every layer leaf (its norm scales too) is decayed, while
``final_norm/scale`` is not.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.context import is_expert_leaf, tp_sum
from ..tree import leaves, rebuild, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0


def _zeros(tree):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), tree)


def init_opt_state(params):
    dev = next(p for _, p in leaves(params)).device
    return {"mu": _zeros(params), "nu": _zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree, ctx=None) -> torch.Tensor:
    sums = [torch.sum(torch.square(leaf.to(torch.float32)))
            for _, leaf in leaves(tree)]
    if ctx is None or ctx.tp_size == 1:
        return torch.sqrt(torch.sum(torch.stack(sums)))
    # a tp rank holds a slice of each expert stack and the whole of every
    # other leaf
    paths = [path for path, _ in leaves(tree)]
    experts = [s for path, s in zip(paths, sums) if is_expert_leaf(path)]
    rest = [s for path, s in zip(paths, sums) if not is_expert_leaf(path)]
    total = torch.sum(torch.stack(rest)) if rest else \
        torch.zeros((), device=sums[0].device)
    if experts:
        total = total + tp_sum(torch.sum(torch.stack(experts)), ctx)
    return torch.sqrt(total)


def reference_rank(path, p: torch.Tensor) -> int:
    """``p``'s rank in the JAX package's stacked layout."""
    return p.dim() + (1 if path and path[0] == "layers" else 0)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state, lr_scale=1.0,
                 ctx=None):
    """Returns (new_params, new_state, metrics).  ``ctx``: the context
    whose tp ranks hold slices of the expert leaves (for the norm)."""
    step = state["step"] + 1
    dev = step.device
    gnorm = global_norm(grads, ctx)
    clip = torch.minimum(
        torch.ones((), device=dev),
        torch.full((), cfg.grad_clip_norm, device=dev) / (gnorm + 1e-9))
    lr = (cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32)).to(dev)
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(torch.full((), cfg.b1, device=dev), stepf)
    b2c = 1.0 - torch.pow(torch.full((), cfg.b2, device=dev), stepf)

    def upd(path, p, g, mu, nu):
        g = g.to(torch.float32) * clip
        mu = cfg.b1 * mu + (1 - cfg.b1) * g
        nu = cfg.b2 * nu + (1 - cfg.b2) * g * g
        update = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps)
        if reference_rank(path, p) >= 2:   # decay matrices only
            update = update + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * update).to(p.dtype), mu, nu

    # gradients and moments pair with parameters by path, as jax.tree does
    g, mu, nu = (dict(leaves(t)) for t in (grads, state["mu"], state["nu"]))
    out = [upd(path, p, g[path], mu[path], nu[path])
           for path, p in leaves(params)]
    new_p = rebuild(params, iter([o[0] for o in out]))
    new_state = {"mu": rebuild(params, iter([o[1] for o in out])),
                 "nu": rebuild(params, iter([o[2] for o in out])),
                 "step": step}
    return new_p, new_state, {"grad_norm": gnorm, "lr": lr}
