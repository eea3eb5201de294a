"""Generic decoder LM assembled from the config's layer pattern.

Layers run in order, grouped into the same *groups* as the JAX package
(``build_groups``): the collaborative-intelligence split point (the
paper's edge/cloud boundary) falls between two groups, where the
FeatureCodec fake-quant (``codec_fn``) or a host round-trip between the
``*_to_boundary`` / ``*_from_boundary`` halves is applied.

Parameters are a dict with per-layer entries (``params["layers"][i]``)
in place of the reference's stacked scan leaves (see
:func:`repro_torch.models.convert.params_from_numpy`).  A layer's mixer
is attention, an RG-LRU block (``rec``) or RWKV-6 time mixing
(``tmix``); its feed-forward a dense MLP, an MoE (``moe``) or RWKV
channel mixing (``cmix``).  Caches are a list per group of per-layer
dicts: ``{"k", "v"}`` (B, S, K, hd) for attention, ``{"h", "conv"}`` for
RG-LRU, ``{"tmix": {"state", "shift"}, "cmix": {"shift"}}`` for RWKV.
Caches are updated in place: a decode or prefill writes into the cache
tensors it was given and returns the same objects.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from ..configs.base import LayerSpec, ModelConfig
from . import layers as L
from . import moe as MOE
from . import rglru as RG
from . import rwkv6 as RW

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# group structure
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Group:
    specs: tuple[LayerSpec, ...]
    n_periods: int


def build_groups(cfg: ModelConfig, split: bool = False,
                 split_after: int | None = None) -> tuple[list[Group], int]:
    """Partition layers into groups.  Returns (groups, split_boundary)
    where the codec applies after ``groups[:split_boundary]`` (0 = no split).

    ``split_after`` overrides ``cfg.split_after_period`` for this call:
    the boundary lands after that many full periods.  Explicit values
    are validated (1 <= split_after <= n_full_periods - 1) rather than
    clamped."""
    n_main = cfg.n_full_periods
    groups: list[Group] = []
    boundary = 0
    if split and n_main >= 2:
        if split_after is not None:
            if not 1 <= split_after <= n_main - 1:
                raise ValueError(
                    f"{cfg.name}: split_after={split_after} out of range "
                    f"(need 1 <= split_after <= {n_main - 1})")
            sp = split_after
        else:
            sp = cfg.split_after_period or max(1, n_main // 4)
            sp = min(sp, n_main - 1)
        groups.append(Group(cfg.pattern, sp))
        groups.append(Group(cfg.pattern, n_main - sp))
        boundary = 1
    else:
        groups.append(Group(cfg.pattern, n_main))
    if cfg.remainder:
        groups.append(Group(cfg.remainder, 1))
    return groups, boundary


def _group_layers(groups: list[Group]) -> list[list[tuple[LayerSpec, int]]]:
    """Per group, the (spec, global layer index) pairs it runs in order."""
    out, i = [], 0
    for g in groups:
        members = []
        for _ in range(g.n_periods):
            for spec in g.specs:
                members.append((spec, i))
                i += 1
        out.append(members)
    return out


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------

def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist (no silent
    drop to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA "
                           "device is available; pass device='cpu' for "
                           "the CPU path")
    return dev


def _init_spec(gen, spec: LayerSpec, cfg: ModelConfig, dtype, device):
    p = {"norm1": L.init_norm(cfg.norm, cfg.d_model, dtype, device),
         "norm2": L.init_norm(cfg.norm, cfg.d_model, dtype, device)}
    if spec.kind == "attn":
        p["attn"] = L.init_attention(gen, cfg, dtype, device)
    elif spec.kind == "rglru":
        p["rec"] = RG.init_rglru(gen, cfg, dtype, device)
    elif spec.kind == "rwkv":
        p["tmix"] = RW.init_rwkv(gen, cfg, dtype, device)
    else:
        raise ValueError(spec.kind)
    if spec.moe:
        p["moe"] = MOE.init_moe(gen, cfg, dtype, device)
    elif spec.kind == "rwkv":
        p["cmix"] = RW.init_channel_mix(gen, cfg, dtype, device)
    else:
        p["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp,
                              dtype, device)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator, *,
                device="cuda"):
    """Random parameters drawn from ``generator`` (on ``device``, the
    card unless the CPU is asked for; ``generator`` must live there too).

    Same shapes and scales as the JAX package's init; the numbers differ
    (a different generator).  To compute the same function as a JAX
    model, convert its parameters with ``params_from_numpy``."""
    device = resolve_device(device)
    dtype = torch_dtype(cfg)
    params = {"embed": {"table": L._normal(
        generator, (cfg.vocab_size, cfg.d_model), dtype, device, 0.02)},
        "final_norm": L.init_norm(cfg.norm, cfg.d_model, dtype, device)}
    if not cfg.tie_embeddings:
        params["head"] = {"w": L._normal(
            generator, (cfg.d_model, cfg.vocab_size), dtype, device,
            1.0 / math.sqrt(cfg.d_model))}
    params["layers"] = [_init_spec(generator, spec, cfg, dtype, device)
                        for spec in cfg.layer_specs()]
    return params


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def _init_spec_cache(spec: LayerSpec, cfg: ModelConfig, batch: int,
                     max_seq: int, dtype, device):
    if spec.kind == "rglru":
        return RG.init_rglru_cache(cfg, batch, dtype, device)
    if spec.kind == "rwkv":
        return RW.init_rwkv_cache(cfg, batch, device)
    s = min(spec.window, max_seq) if spec.window else max_seq
    kv = (batch, s, cfg.num_kv_heads, cfg.head_dim)
    if cfg.kv_quant_bits:
        # paper eq. 1 applied to the KV cache: uint8 index storage
        dtype = torch.uint8
    return {"k": torch.zeros(kv, dtype=dtype, device=device),
            "v": torch.zeros(kv, dtype=dtype, device=device)}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               split: bool = False, *, device=None):
    dtype = torch_dtype(cfg)
    groups, _ = build_groups(cfg, split)
    return [[_init_spec_cache(spec, cfg, batch, max_seq, dtype, device)
             for spec, _ in members] for members in _group_layers(groups)]


def _kv_enc(cfg: ModelConfig, t):
    """Quantize K/V for cache storage (pinned-boundary uniform, eq. 1)."""
    if not cfg.kv_quant_bits:
        return t
    from ..core import uniform
    n = 1 << cfg.kv_quant_bits
    return uniform.quantize(t, -cfg.kv_clip, cfg.kv_clip, n).to(torch.uint8)


def _kv_dec(cfg: ModelConfig, t, dtype):
    if not cfg.kv_quant_bits:
        return t
    from ..core import uniform
    n = 1 << cfg.kv_quant_bits
    return uniform.dequantize(t.to(torch.int32), -cfg.kv_clip, cfg.kv_clip,
                              n, dtype=dtype)


# ---------------------------------------------------------------------------
# one layer
# ---------------------------------------------------------------------------

def _attention(h, p, spec: LayerSpec, cfg: ModelConfig, *, pos: int, cache,
               positions):
    """Attention mixer. cache: this layer's {"k","v"} dict or None
    (written in place)."""
    q, k, v = L.attention_qkv(h, p, cfg, positions)
    if cache is None:
        return L.multi_head_attention(q, k, v, q_offset=0,
                                      window=spec.window,
                                      softcap=cfg.attn_logit_softcap)
    s_new = q.shape[1]
    ck, cv = cache["k"], cache["v"]
    s_cache = ck.shape[1]
    if s_new == 1:
        # decode: write into ring/linear slot, attend over cache
        slot = pos % s_cache if spec.window else pos
        ck[:, slot] = _kv_enc(cfg, k[:, 0])
        cv[:, slot] = _kv_enc(cfg, v[:, 0])
        idx = torch.arange(s_cache, dtype=torch.int32, device=h.device)
        k_pos = pos - (pos - idx) % s_cache if spec.window else idx
        return L.multi_head_attention(
            q, _kv_dec(cfg, ck, q.dtype), _kv_dec(cfg, cv, q.dtype),
            q_offset=pos, k_positions=k_pos, window=spec.window,
            softcap=cfg.attn_logit_softcap)
    # prefill from scratch: attend over fresh K/V, then fill cache
    attn = L.multi_head_attention(q, k, v, q_offset=0, window=spec.window,
                                  softcap=cfg.attn_logit_softcap)
    kq, vq = _kv_enc(cfg, k), _kv_enc(cfg, v)
    if s_new >= s_cache:
        tail = torch.arange(s_new - s_cache, s_new, device=h.device) % s_cache
        ck[:, tail] = kq[:, -s_cache:]
        cv[:, tail] = vq[:, -s_cache:]
    else:
        ck[:, :s_new] = kq
        cv[:, :s_new] = vq
    return attn


def _write(cache, new) -> None:
    """Copy a recurrent layer's new state into its cache tensors."""
    for name, leaf in new.items():
        if isinstance(leaf, dict):
            _write(cache[name], leaf)
        else:
            cache[name].copy_(leaf)


def _apply_layer(x, p, spec: LayerSpec, cfg: ModelConfig, *, pos: int,
                 cache, positions):
    """x: (B,S,d). cache: this layer's cache dict or None (written in
    place). pos: absolute position of x[:, 0]."""
    h = L.apply_norm(x, p["norm1"], cfg.norm, cfg.norm_eps)
    if spec.kind == "attn":
        x = x + L.attention_out(_attention(h, p["attn"], spec, cfg, pos=pos,
                                           cache=cache, positions=positions),
                                p["attn"])
    elif spec.kind == "rglru":
        out, new = RG.rglru_block_apply(h, p["rec"], cfg, cache)
        x = x + out
        if cache is not None:
            _write(cache, new)
    elif spec.kind == "rwkv":
        out, new = RW.time_mix_apply(h, p["tmix"], cfg,
                                     cache["tmix"] if cache else None)
        x = x + out
        if cache is not None:
            _write(cache["tmix"], new)
    h2 = L.apply_norm(x, p["norm2"], cfg.norm, cfg.norm_eps)
    if spec.moe:
        return x + MOE.moe_apply(h2, p["moe"], cfg)
    if spec.kind == "rwkv":
        out, new = RW.channel_mix_apply(h2, p["cmix"],
                                        cache["cmix"] if cache else None)
        if cache is not None:
            _write(cache["cmix"], new)
        return x + out
    return x + L.mlp_apply(h2, p["mlp"], cfg.act, cfg.gated_mlp)


def _apply_group(x, params, members, cfg: ModelConfig, *, pos: int,
                 gcache, positions):
    for j, (spec, li) in enumerate(members):
        x = _apply_layer(x, params["layers"][li], spec, cfg, pos=pos,
                         cache=gcache[j] if gcache is not None else None,
                         positions=positions)
    return x


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def _embed_in(cfg, params, batch_in, pos0: int = 0):
    """batch_in: tokens (B,S) int or embeddings (B,S,d)."""
    if batch_in.dim() == 3:
        x = batch_in.to(torch_dtype(cfg))
    else:
        x = params["embed"]["table"][batch_in.long()]
    if cfg.pos_emb == "sinusoidal":
        s = x.shape[1]
        pe = L.sinusoidal_pos_emb(
            pos0 + torch.arange(s, device=x.device), cfg.d_model, x.dtype)
        x = x + pe[None]
    return x


def _logits_out(cfg, params, x):
    xn = L.apply_norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", xn, params["embed"]["table"])
    else:
        logits = xn @ params["head"]["w"]
    logits = logits.to(torch.float32)
    if cfg.final_logit_softcap > 0:
        c = cfg.final_logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def _positions(x, pos: int | None = None):
    if pos is None:
        return torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    return torch.full((1,), pos, dtype=torch.int32, device=x.device)


def _setup(cfg, split, split_after=None):
    groups, boundary = build_groups(cfg, split, split_after=split_after)
    return _group_layers(groups), boundary


def _need_boundary(cfg, boundary):
    if not boundary:
        raise ValueError(f"{cfg.name}: no split boundary (needs >= 2 "
                         "full periods)")


def forward(cfg: ModelConfig, params, batch_in, *,
            codec_fn: Callable | None = None, split: bool = False):
    """Scoring forward pass (no cache).  Returns (logits, aux)."""
    groups, boundary = _setup(cfg, split or codec_fn is not None)
    x = _embed_in(cfg, params, batch_in)
    positions = _positions(x)
    aux = {}
    for gi, members in enumerate(groups):
        x = _apply_group(x, params, members, cfg, pos=0, gcache=None,
                         positions=positions)
        if codec_fn is not None and boundary and gi == boundary - 1:
            x, rate = codec_fn(x)
            aux["codec_rate_bits"] = rate
    return _logits_out(cfg, params, x), aux


def forward_head(cfg: ModelConfig, params, batch_in, *,
                 split_after: int | None = None):
    """Edge half of the split forward: embed + the groups before the
    boundary.  Returns the raw split-layer activations (B, S, d)."""
    groups, boundary = _setup(cfg, True, split_after)
    _need_boundary(cfg, boundary)
    x = _embed_in(cfg, params, batch_in)
    positions = _positions(x)
    for gi in range(boundary):
        x = _apply_group(x, params, groups[gi], cfg, pos=0, gcache=None,
                         positions=positions)
    return x


def forward_from_boundary(cfg: ModelConfig, params, x, *,
                          split_after: int | None = None):
    """Cloud half: the groups after the boundary + final norm/head.
    Returns logits (B, S, V)."""
    groups, boundary = _setup(cfg, True, split_after)
    _need_boundary(cfg, boundary)
    x = x.to(torch_dtype(cfg))
    positions = _positions(x)
    for gi in range(boundary, len(groups)):
        x = _apply_group(x, params, groups[gi], cfg, pos=0, gcache=None,
                         positions=positions)
    return _logits_out(cfg, params, x)


def prefill(cfg: ModelConfig, params, batch_in, cache, *, codec_fn=None,
            split: bool = False):
    """Process a prompt, filling the cache.  Returns (last_logits, cache)."""
    groups, boundary = _setup(cfg, split or codec_fn is not None)
    x = _embed_in(cfg, params, batch_in)
    positions = _positions(x)
    for gi, members in enumerate(groups):
        x = _apply_group(x, params, members, cfg, pos=0, gcache=cache[gi],
                         positions=positions)
        if codec_fn is not None and boundary and gi == boundary - 1:
            x, _ = codec_fn(x)
    logits = _logits_out(cfg, params, x[:, -1:])
    return logits[:, 0], cache


def prefill_to_boundary(cfg: ModelConfig, params, batch_in, cache):
    """Edge half of a split prefill: embed + the pre-boundary groups.

    Returns (split-layer activations (B, S, d), pre-boundary caches), so
    a host round-trip can run between the two halves."""
    groups, boundary = _setup(cfg, True)
    _need_boundary(cfg, boundary)
    x = _embed_in(cfg, params, batch_in)
    positions = _positions(x)
    for gi in range(boundary):
        x = _apply_group(x, params, groups[gi], cfg, pos=0,
                         gcache=cache[gi], positions=positions)
    return x, cache[:boundary]


def prefill_from_boundary(cfg: ModelConfig, params, x, cache):
    """Cloud half of a split prefill: post-boundary groups + head.
    ``cache`` is the full per-group cache list (only the post-boundary
    entries are touched).  Returns (last-token logits (B, V),
    post-boundary caches)."""
    groups, boundary = _setup(cfg, True)
    x = x.to(torch_dtype(cfg))
    positions = _positions(x)
    for gi in range(boundary, len(groups)):
        x = _apply_group(x, params, groups[gi], cfg, pos=0,
                         gcache=cache[gi], positions=positions)
    logits = _logits_out(cfg, params, x[:, -1:])
    return logits[:, 0], cache[boundary:]


def _token_batch(token_in):
    return token_in[:, None] if token_in.dim() == 1 else token_in


def decode_to_boundary(cfg: ModelConfig, params, token_in, cache, pos: int):
    """Edge half of a split decode step.
    Returns (boundary activations (B, 1, d), pre-boundary caches)."""
    groups, boundary = _setup(cfg, True)
    _need_boundary(cfg, boundary)
    x = _embed_in(cfg, params, _token_batch(token_in), pos0=pos)
    positions = _positions(x, pos)
    for gi in range(boundary):
        x = _apply_group(x, params, groups[gi], cfg, pos=pos,
                         gcache=cache[gi], positions=positions)
    return x, cache[:boundary]


def decode_from_boundary(cfg: ModelConfig, params, x, cache, pos: int):
    """Cloud half of a split decode step: post-boundary groups + head.
    Returns (logits (B, V), post-boundary caches)."""
    groups, boundary = _setup(cfg, True)
    x = x.to(torch_dtype(cfg))
    positions = _positions(x, pos)
    for gi in range(boundary, len(groups)):
        x = _apply_group(x, params, groups[gi], cfg, pos=pos,
                         gcache=cache[gi], positions=positions)
    logits = _logits_out(cfg, params, x)
    return logits[:, 0], cache[boundary:]


def decode_step(cfg: ModelConfig, params, token_in, cache, pos: int, *,
                codec_fn=None, split: bool = False):
    """One decode step.  token_in: (B,) tokens or (B,1,d) embeddings;
    pos: absolute position.  Returns (logits (B,V), cache, aux)."""
    groups, boundary = _setup(cfg, split or codec_fn is not None)
    x = _embed_in(cfg, params, _token_batch(token_in), pos0=pos)
    positions = _positions(x, pos)
    aux = {}
    for gi, members in enumerate(groups):
        x = _apply_group(x, params, members, cfg, pos=pos,
                         gcache=cache[gi], positions=positions)
        if codec_fn is not None and boundary and gi == boundary - 1:
            x, rate = codec_fn(x)
            aux["codec_rate_bits"] = rate
    logits = _logits_out(cfg, params, x)
    return logits[:, 0], cache, aux
