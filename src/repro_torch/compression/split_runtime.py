"""Collaborative-intelligence split runtime: the paper's edge/cloud system
as one decode step.

The *edge* stage -- embedding and the first ``half`` layers -- lives on
``edge_device``; the *cloud* stage -- the next ``half`` layers, the tail
layer of an odd layer count, the final norm and the head -- on
``cloud_device``.  At the boundary the activations are clipped and
coarsely quantized (paper eq. 1), bit-packed to uint8 lanes (8x1b / 4x2b
/ 2x4b per byte) and moved to the cloud device, which unpacks and
dequantizes them and finishes the step.  The move is the crossing: the
payload's ``.to(cloud_device)``.  With both stages on one card it moves
no bytes, and the payload's size is what a link would carry.

The codec ops route through the codec's backend: on the card the
quantize is the clip+quant kernel (the ECSQ kernel for an ECSQ codec),
which for a per-tensor codec, uniform or ECSQ, and for a uniform
per-channel one with channels last and groups of 8-256 channels (e.g.
``granularity="channel"`` over the d_model axis at g=8), also counts the
indices for the rate estimate in the same launch and writes no
reconstruction; on the packed transport, at a 1/2/4-bit wire width, the
same launch writes the packed bytes in place of the indices
(``quantize_packed_with_rate``), so the edge's stage is one launch.
Other tiled codecs take the per-tile quantizer, then the per-tile index
histogram kernel, and on the packed transport the pack kernel.  On the
CPU the torch formulas.

The reference (``repro/compression/split_runtime.py``) writes the same
flow as SPMD over a shard_map'd ``pod`` axis, where both pods run both
supersteps, each keeps its own half's result, and the payload crosses
with ``lax.ppermute``.  Here the two stages are placed on explicit
devices in one process, and each half runs once.  A crossing between
processes or hosts is not part of this module.

Supported for homogeneous (period-1) architectures with >= 2 layers;
the boundary falls after ``num_layers // 2`` layers (:func:`stage_layout`),
not at the model's configured split point.
"""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..core.codec import FeatureCodec
from ..models import transformer as T

TRANSPORTS = ("packed", "quantized_f16", "raw")
RAW_RATE_BITS = 16.0    # bfloat16 activations cross, whatever the model dtype


def split_supported(cfg: ModelConfig) -> bool:
    return cfg.period == 1 and cfg.num_layers >= 2


def stage_layout(cfg: ModelConfig) -> tuple[int, int]:
    """(layers per stage, tail layers appended on the cloud side)."""
    half = cfg.num_layers // 2
    return half, cfg.num_layers - 2 * half


def _check_supported(cfg: ModelConfig) -> None:
    if not split_supported(cfg):
        raise ValueError(f"{cfg.name}: split runtime needs a period-1 arch")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def split_params(cfg: ModelConfig, params, *, edge_device="cuda",
                 cloud_device="cuda"):
    """Unsplit port parameters -> ``{"edge": ..., "cloud": ...}``.

    The edge holds the embedding and layers ``[0, half)``, the cloud the
    layers from ``half`` on, the final norm and the head (and the
    embedding too when it is tied to the head).  A tensor already on its
    stage's device is referenced, not copied."""
    _check_supported(cfg)
    edge = T.resolve_device(edge_device)
    cloud = T.resolve_device(cloud_device)
    half, _ = stage_layout(cfg)
    layers = params["layers"]
    out = {"edge": {"embed": _to(params["embed"], edge),
                    "layers": [_to(p, edge) for p in layers[:half]]},
           "cloud": {"final_norm": _to(params["final_norm"], cloud),
                     "layers": [_to(p, cloud) for p in layers[half:]]}}
    if "head" in params:
        out["cloud"]["head"] = _to(params["head"], cloud)
    if cfg.tie_embeddings:
        out["cloud"]["embed"] = _to(params["embed"], cloud)
    return out


def init_split_params(cfg: ModelConfig, generator: torch.Generator, *,
                      edge_device="cuda", cloud_device="cuda"):
    """Random parameters (:func:`~repro_torch.models.init_params` on the
    edge device, which ``generator`` must live on), split into stages."""
    _check_supported(cfg)
    params = T.init_params(cfg, generator, device=edge_device)
    return split_params(cfg, params, edge_device=edge_device,
                        cloud_device=cloud_device)


def init_split_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
                     edge_device="cuda", cloud_device="cuda"):
    """(edge caches, cloud caches): one ``{"k", "v"}`` dict per layer of
    each stage, on that stage's device."""
    _check_supported(cfg)
    half, tail = stage_layout(cfg)
    dtype = T.torch_dtype(cfg)
    spec = cfg.pattern[0]

    def caches(n, device):
        return [T._init_spec_cache(spec, cfg, batch, max_seq, dtype,
                                   T.resolve_device(device))
                for _ in range(n)]

    return caches(half, edge_device), caches(half + tail, cloud_device)


def make_split_decode_step(cfg: ModelConfig, codec: FeatureCodec | None, *,
                           transport: str = "packed", edge_device="cuda",
                           cloud_device="cuda"):
    """Returns ``step(params, token, caches, pos) -> (logits, caches,
    rate_bits)`` over split parameters and caches.

    transport: 'packed' (quantized uint8 lanes cross), 'quantized_f16'
    (the reference's name for its ablation: quantized, but the int32
    indices cross at full width), or 'raw' (the activations cross;
    ``codec`` may be None).  ``token`` is (B,) int, ``pos`` the absolute
    position; caches are written in place.  Logits are (B, V) float32,
    rounded through bfloat16 as the reference returns them.
    """
    _check_supported(cfg)
    if transport not in TRANSPORTS:
        raise ValueError(f"transport {transport!r} not in {TRANSPORTS}")
    if transport != "raw" and codec is None:
        raise ValueError(f"transport {transport!r} needs a codec")
    edge = T.resolve_device(edge_device)
    cloud = T.resolve_device(cloud_device)
    half, tail = stage_layout(cfg)
    spec = cfg.pattern[0]
    edge_layers = [(spec, i) for i in range(half)]
    cloud_layers = [(spec, i) for i in range(half + tail)]
    # the quantizer packs its own indices: one launch, no int32 indices
    fused_pack = transport == "packed" and codec.packs_in_quantizer()

    def cross(y):
        """Boundary activations on the edge -> (cloud input, rate bits)."""
        if transport == "raw":
            return y.to(cloud), torch.tensor(RAW_RATE_BITS)
        if fused_pack:
            packed, rate_bits = codec.quantize_packed_with_rate(y)
        else:
            idx, _, rate_bits = codec.quantize_with_rate(y)
            if transport != "packed":
                return codec.dequantize(idx.to(cloud), dtype=y.dtype), \
                    rate_bits
            packed = codec.pack(idx.reshape(-1))
        idx_r = codec.unpack(packed.to(cloud), y.numel()).reshape(y.shape)
        return codec.dequantize(idx_r, dtype=y.dtype), rate_bits

    @torch.inference_mode()
    def step(params, token, caches, pos: int):
        edge_cache, cloud_cache = caches
        ep, cp = params["edge"], params["cloud"]
        x = T._embed_in(cfg, ep, token.to(edge)[:, None], pos0=pos)
        y = T._apply_group(x, ep, edge_layers, cfg, pos=pos,
                           gcache=edge_cache, positions=T._positions(x, pos))
        x_b, rate_bits = cross(y)
        y_b = T._apply_group(x_b, cp, cloud_layers, cfg, pos=pos,
                             gcache=cloud_cache,
                             positions=T._positions(x_b, pos))
        logits = T._logits_out(cfg, cp, y_b)[:, 0]
        # bfloat16 is plenty for the sampler and halves the return path
        return logits.to(torch.bfloat16).to(torch.float32), caches, rate_bits

    return step
