"""Top-k routed Mixture-of-Experts with capacity-based dispatch.

Three execution paths sharing the same routing math:

  * ``_moe_dense_ref``      -- every expert on every token (oracle for
                               tests);
  * ``moe_local``           -- sort/scatter dispatch, no collectives
                               (single device or pure data parallelism);
  * ``moe_expert_parallel`` -- across the tp ranks of a
                               :class:`~.context.DistContext`, each
                               holding E/M experts:
      - train/prefill: tokens are *sequence-split* across the expert
        axis, dispatched locally to (E, C, d) slots, exchanged with
        all_to_all so each rank runs only its E/M local experts, and
        combined after the reverse all_to_all (the standard EP
        pipeline); the chunks are then all-gathered along the sequence;
      - decode (or S not divisible): every rank routes every token,
        computes its local experts' contributions, and the partial
        outputs are summed across the ranks (TP-style, cheap at small T).

Dropped-token semantics: assignments beyond an expert's capacity
C = ceil(T*k/E * capacity_factor) are dropped (standard capacity MoE;
dbrx/qwen3 are dropless -- noted in DESIGN.md §Arch-applicability).  The
expert-parallel sequence path sizes C from a rank's chunk of T*/M tokens
(T* its dp rows' tokens) and dispatches each chunk on its own, the
decode path from all T* tokens: where assignments are dropped, the
sequence path equals ``moe_local`` chunk by chunk, not over the whole
batch.

Every shape is independent of the routing, so a step runs on ``meta``.
"""

from __future__ import annotations

import math

import torch

from . import context as C
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
    counts = torch.zeros(e, dtype=flat_e.dtype, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))             # (E,)
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


def _combine(y, slot, keep, tok_sorted, order, w, t: int, n_slots: int):
    """Weighted sum of each token's kept expert outputs, in float32.
    ``y`` (n_slots, d) holds the outputs of the dispatch slots; dropped
    assignments gather a clamped slot with weight 0."""
    contrib = y[slot.clamp_max(n_slots - 1)].to(torch.float32)
    w_sorted = w.reshape(-1)[order] * keep
    out = torch.zeros((t, y.shape[-1]), dtype=torch.float32, device=y.device)
    out.index_add_(0, tok_sorted, contrib * w_sorted[:, None])
    return out


def moe_local(x2d, p, cfg, cap: int | None = None):
    """Capacity dispatch on one device. x2d: (T, d)."""
    act_fn = _act(cfg.act)
    t, d = x2d.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    cap = cap or _capacity(t, k, e, cfg.capacity_factor)
    w, i = _route(x2d, p["router"], k)
    slot, keep, tok_sorted, order = _dispatch_indices(i, k, e, cap)
    # every shape stays independent of the routing, so the step runs on
    # "meta": a spare row past the E*cap slots takes the dropped
    # assignments (the reference's mode="drop" scatter), and they gather
    # a clamped slot with weight 0 (its mode="fill" gather)
    buf = torch.zeros((e * cap + 1, d), dtype=x2d.dtype, device=x2d.device)
    buf[slot] = x2d[tok_sorted]
    y = _expert_ffn(buf[:e * cap].reshape(e, cap, d), p, act_fn) \
        .reshape(e * cap, d)
    return _combine(y, slot, keep, tok_sorted, order, w, t,
                    e * cap).to(x2d.dtype)


def moe_expert_parallel(x, p, cfg, ctx):
    """x: (B*, S, d), this rank's dp rows (the same on every rank of its
    tp group); ``p`` holds this rank's E/M experts (leading-axis slices
    of w1, w3, w2) and the whole router.  Returns (B*, S, d), the same on
    every rank of the tp group.  See the module docstring."""
    b, s, d = x.shape
    m = ctx.tp_size
    e, k = cfg.num_experts, cfg.experts_per_token
    act_fn = _act(cfg.act)
    if e % m != 0:
        raise ValueError(f"{e} experts not divisible by axis "
                         f"{ctx.tp_axis}={m}")
    e_loc = e // m
    # each rank routes part of the tokens (its chunk, or its experts'
    # share): the replicated router's gradient is the ranks' sum
    router = C.replica_grad(p["router"], ctx)

    if s % m == 0 and s >= m:
        # ---- sequence-split dispatch + all_to_all ---------------------------
        xl = C.take_chunk(x, ctx, dim=1)                # (B*, S/M, d)
        t = b * (s // m)
        x2d = xl.reshape(t, d)
        # per-chunk capacity, as the reference's shard_map body sizes it
        cap = _capacity(t, k, e, cfg.capacity_factor)
        w, i = _route(x2d, router, k)
        slot, keep, tok_sorted, order = _dispatch_indices(i, k, e, cap)
        buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
        buf[slot] = x2d[tok_sorted]
        # exchange: each rank keeps its E/M experts, all peers' slots
        h = C.to_experts(buf[:e * cap].reshape(e, cap, d), ctx)
        y = _expert_ffn(h, p, act_fn)                   # (E/M, M*cap, d)
        y = C.to_tokens(y, ctx).reshape(e * cap, d)     # back to (E*cap, d)
        out = _combine(y, slot, keep, tok_sorted, order, w, t, e * cap)
        return C.gather_chunks(out.reshape(b, s // m, d).to(x.dtype), ctx,
                               dim=1)

    # ---- every token on every rank, local experts, summed (decode) ----------
    xr = C.replica_grad(x, ctx)
    t = b * s
    x2d = xr.reshape(t, d)
    # capacity from all of the rank's tokens
    cap = _capacity(t, k, e, cfg.capacity_factor)
    w, i = _route(x2d, router, k)
    # shift ids so local experts live in [0, e_loc); the others share one
    # extra bin, whose slots are dropped with the over-capacity ones
    i_loc = i - ctx.tp_rank * e_loc
    i_loc = torch.where((i_loc >= 0) & (i_loc < e_loc), i_loc,
                        torch.full_like(i_loc, e_loc))
    slot, keep, tok_sorted, order = _dispatch_indices(i_loc, k, e_loc + 1,
                                                      cap)
    keep = keep & (slot < e_loc * cap)
    slot = torch.where(keep, slot, torch.full_like(slot, e_loc * cap))
    buf = torch.zeros((e_loc * cap + 1, d), dtype=x.dtype, device=x.device)
    buf[slot] = x2d[tok_sorted]
    y = _expert_ffn(buf[:e_loc * cap].reshape(e_loc, cap, d), p, act_fn) \
        .reshape(e_loc * cap, d)
    out = _combine(y, slot, keep, tok_sorted, order, w, t, e_loc * cap)
    # float32 partials summed per rank, then across ranks: another order
    # of the sum than moe_local's, so not bit-equal to it
    return C.sum_partials(out, ctx).reshape(b, s, d).to(x.dtype)


def moe_apply(x, p, cfg, ctx=None):
    """Entry point: (B, S, d) -> (B, S, d); picks the execution path as the
    reference does: local without a context, a mesh, a tp axis of more
    than one rank, or an expert count that axis divides."""
    if ctx is None or ctx.mesh is None or ctx.tp_size == 1 \
            or cfg.num_experts % ctx.tp_size != 0:
        b, s, d = x.shape
        return moe_local(x.reshape(b * s, d), p, cfg).reshape(b, s, d)
    return moe_expert_parallel(x, p, cfg, ctx)
