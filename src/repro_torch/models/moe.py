"""Top-k routed Mixture-of-Experts with capacity-based dispatch.

Two execution paths sharing the same routing math:

  * ``_moe_dense_ref`` -- every expert on every token (oracle for tests);
  * ``moe_local``      -- sort/scatter dispatch on one device.

Dropped-token semantics: assignments beyond an expert's capacity
C = ceil(T*k/E * capacity_factor) are dropped (standard capacity MoE;
dbrx/qwen3 are dropless -- noted in DESIGN.md §Arch-applicability).

The JAX package's expert-parallel path (``moe_expert_parallel``, a
shard_map over the mesh's model axis) exists only across devices and is
not part of this module: :func:`moe_apply` takes the ``moe_local`` route,
the one the reference takes without a mesh.
"""

from __future__ import annotations

import math

import torch

from .layers import _act, _normal


def init_moe(gen, cfg, dtype, device=None):
    d, e, ef = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(ef)
    return {
        # the router stays float32 whatever the model's dtype
        "router": _normal(gen, (d, e), torch.float32, device, s_in),
        "w1": _normal(gen, (e, d, ef), dtype, device, s_in),
        "w3": _normal(gen, (e, d, ef), dtype, device, s_in),
        "w2": _normal(gen, (e, ef, d), dtype, device, s_out),
    }


def _route(x2d, router, k: int):
    """x2d: (T, d) -> (weights (T,k) f32, expert ids (T,k) int64)."""
    logits = x2d.to(torch.float32) @ router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.topk(probs, k, dim=-1)
    top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)  # renormalize
    return top_w, top_i


def _capacity(t: int, k: int, e: int, cf: float) -> int:
    return max(8, int(math.ceil(t * k / e * cf)))


def _expert_ffn(buf, p, act_fn):
    """buf: (E, C, d); expert weights (E, d, ef)/(E, ef, d)."""
    h = act_fn(torch.einsum("ecd,edf->ecf", buf, p["w1"])) \
        * torch.einsum("ecd,edf->ecf", buf, p["w3"])
    return torch.einsum("ecf,efd->ecd", h, p["w2"])


def _dispatch_indices(top_i, k: int, e: int, cap: int):
    """Compute per-assignment (slot, keep, token, order) under capacity.

    Assignments are stably sorted by expert; returns slot ids in
    [0, E*cap) with dropped assignments mapped out of range (E*cap).
    """
    t = top_i.shape[0]
    dev = top_i.device
    flat_e = top_i.reshape(-1)                          # (T*k,)
    token_of = torch.arange(t, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = torch.bincount(flat_e, minlength=e)        # (E,)
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(t * k, device=dev) - starts[sorted_e]
    keep = pos_in_e < cap
    slot = torch.where(keep, sorted_e * cap + pos_in_e,
                       torch.full_like(pos_in_e, e * cap))  # OOB when dropped
    return slot, keep, token_of[order], order


def _moe_dense_ref(x2d, p, cfg):
    """Oracle: weighted sum over ALL experts (no capacity, no dropping)."""
    act_fn = _act(cfg.act)
    w, i = _route(x2d, p["router"], cfg.experts_per_token)
    outs = []
    for ei in range(cfg.num_experts):
        h = act_fn(x2d @ p["w1"][ei]) * (x2d @ p["w3"][ei])
        outs.append(h @ p["w2"][ei])
    stacked = torch.stack(outs, dim=1)  # (T, E, d)
    mask = torch.zeros(x2d.shape[0], cfg.num_experts, dtype=w.dtype,
                       device=w.device).scatter_add_(1, i, w)  # (T, E)
    return torch.einsum("te,ted->td", mask,
                        stacked.to(w.dtype)).to(x2d.dtype)


def moe_local(x2d, p, cfg, cap: int | None = None):
    """Capacity dispatch on one device. x2d: (T, d)."""
    act_fn = _act(cfg.act)
    t, d = x2d.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    cap = cap or _capacity(t, k, e, cfg.capacity_factor)
    w, i = _route(x2d, p["router"], k)
    slot, keep, tok_sorted, order = _dispatch_indices(i, k, e, cap)
    kept = slot[keep]
    buf = torch.zeros((e * cap, d), dtype=x2d.dtype, device=x2d.device)
    buf[kept] = x2d[tok_sorted[keep]]
    y = _expert_ffn(buf.reshape(e, cap, d), p, act_fn).reshape(e * cap, d)
    contrib = torch.zeros((t * k, d), dtype=torch.float32, device=x2d.device)
    contrib[keep] = y[kept].to(torch.float32)
    w_sorted = w.reshape(-1)[order]
    out = torch.zeros((t, d), dtype=torch.float32, device=x2d.device)
    out.index_add_(0, tok_sorted, contrib * w_sorted[:, None])
    return out.to(x2d.dtype)


def moe_apply(x, p, cfg):
    """Entry point: (B, S, d) -> (B, S, d) through :func:`moe_local`."""
    b, s, d = x.shape
    return moe_local(x.reshape(b * s, d), p, cfg).reshape(b, s, d)
