"""Collaborative-intelligence split runtime: the paper's edge/cloud system
as one decode step.

The *edge* stage -- embedding and the first ``half`` layers -- lives on
``edge_device``; the *cloud* stage -- the next ``half`` layers, the tail
layer of an odd layer count, the final norm and the head -- on
``cloud_device``.  At the boundary the activations are clipped and
coarsely quantized (paper eq. 1), bit-packed to uint8 lanes (8x1b / 4x2b
/ 2x4b per byte) and moved to the cloud, which unpacks and dequantizes
them and finishes the step.

The codec ops route through the codec's backend: on the card the
quantize is the clip+quant kernel (the ECSQ kernel for an ECSQ codec),
which for a per-tensor codec, uniform or ECSQ, and for a uniform
per-channel one with channels last and groups of 8-256 channels (e.g.
``granularity="channel"`` over the d_model axis at g=8), also counts the
indices for the rate estimate in the same launch and writes no
reconstruction; on the packed transport, at a 1/2/4-bit wire width, the
same launch writes the packed bytes in place of the indices
(``quantize_packed_with_counts``), so the edge's stage is one launch.
Other tiled codecs take the per-tile quantizer, then the per-tile index
histogram kernel, and on the packed transport the pack kernel.  On the
CPU the torch formulas.

The reference (``repro/compression/split_runtime.py``) writes the flow
as SPMD over a shard_map'd ``pod`` axis, where both pods run both
supersteps, each keeps its own half's result, the payload crosses with
``lax.ppermute`` and pod 1's bfloat16 logits come back the same way.
This module runs it two ways.

*In one process* (no ``ctx``): both stages are placed on explicit
devices and each half runs once; the crossing is the payload's
``.to(cloud_device)``.  With both stages on one card it moves no bytes,
and the payload's size is what a link would carry.

*Across ranks* (``ctx``, a :class:`~repro_torch.models.DistContext`
whose mesh has a ``pod`` axis of two ranks, built with ``dp_axes=
("data",)`` and ``tp_axis="model"`` as the reference's inner context
is): pod 0's ranks are the edge, pod 1's the cloud, and a rank holds
only its stage -- with its experts of each MoE layer, expert-parallel
over its pod's ``model`` ranks -- and the caches of its ``data`` block
of rows (:func:`~repro_torch.models.context.dp_rows`: B/dp rows, or the
whole batch where dp does not divide it).  Each step the edge rank runs
its stage, quantizes (and packs) its rows and sends the wire bytes to
its peer, the cloud rank with the same ``data`` and ``model``
coordinates (``ctx.pod_peer``), with ``torch.distributed.send``; the
cloud rank receives them, dequantizes, finishes the step, all-gathers
the bfloat16 logits over ``data`` (only where the rows were split) and
sends them back to its edge peer.  Every rank returns the whole batch's
logits and ``rate_bits``, and its own stage's caches.

The crossing's sizes are static: the receiver knows the payload's
element count, dtype and lane width from ``cfg``, the codec and the
batch (:func:`payload_bytes`), so no size header crosses.  The message is the payload's bytes
(``raw``: the activations in the model's dtype; ``quantized_f16``: int32
indices; ``packed``: uint8 lanes) followed, unless ``raw``, by the rate
as 4 float32 bytes; the return path is the (B, V) bfloat16 logits.  The
rate is the whole batch's, as the reference's: the edge ranks sum their
index counts over the ``data`` group before the rate is taken.  A tiled
codec whose tiles span rows (``plan.spatial_extent`` set) cannot be cut
by rows: where the rows are split, the edge ranks of a ``data`` group
all-gather their boundary rows and each quantizes the whole batch's
tiles, as the reference does under GSPMD, and sends its peer the whole
batch's payload and rate; the cloud rank dequantizes it and keeps its
own rows (:func:`gathers_rows`).

On NCCL the device tensors are sent as they are.  Gloo sends and
receives CPU tensors only, so on gloo the device's bytes are staged
explicitly through host buffers (a device-to-host copy before each send,
host-to-device after each receive); any other backend, or NCCL with CPU
tensors, raises.  Two ranks on one card run over gloo (NCCL refuses
them), so their crossing prices that staging, not a link.

Both ways run the same two halves of a step (:func:`_stage_parts`),
and each part of a step is a tracing span (:mod:`repro_torch.obs.tracing`,
named in :func:`make_split_decode_step`), which a caller timing the
parts turns on with a device sync as its hook.

Supported for homogeneous (period-1) architectures with >= 2 layers;
the boundary falls after ``num_layers // 2`` layers (:func:`stage_layout`),
not at the model's configured split point.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..configs.base import ModelConfig
from ..core.codec import FeatureCodec
from ..models import transformer as T
from ..models.context import DistContext, dp_rows, gather_rows
from ..models.convert import shard_experts
from ..obs.tracing import span

TRANSPORTS = ("packed", "quantized_f16", "raw")
RAW_RATE_BITS = 16.0    # bfloat16 activations cross, whatever the model dtype
_RATE_BYTES = 4         # the rate, float32, after a quantized payload


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
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _check_ranks(ctx: DistContext) -> None:
    if ctx.pod_peer is None:
        raise ValueError("the split runtime across ranks needs a mesh with "
                         "a 'pod' axis of two ranks")
    if "pod" in ctx.dp_axes:
        raise ValueError("the split runtime's pods are its stages: build "
                         "its context with dp_axes=('data',)")


def _stage(ctx: DistContext) -> str:
    return "edge" if ctx.pod_rank == 0 else "cloud"


def _splits_rows(batch: int, ctx: DistContext) -> bool:
    """Whether this rank holds a block of the batch's rows (else all)."""
    return ctx.dp_size > 1 and batch % ctx.dp_size == 0


def split_params(cfg: ModelConfig, params, *, edge_device="cuda",
                 cloud_device="cuda", ctx: DistContext | None = None):
    """Unsplit port parameters -> ``{"edge": ..., "cloud": ...}``.

    The edge holds the embedding and layers ``[0, half)``, the cloud the
    layers from ``half`` on, the final norm and the head (and the
    embedding too when it is tied to the head).  A tensor already on its
    stage's device is referenced, not copied.  Under ``ctx`` the result
    holds this rank's stage alone (``{"edge": ...}`` on pod 0, ``{"cloud":
    ...}`` on pod 1) with its experts of each MoE layer, copied, so the
    caller can free the rest."""
    _check_supported(cfg)
    edge = T.resolve_device(edge_device)
    cloud = T.resolve_device(cloud_device)
    half, _ = stage_layout(cfg)
    layers = params["layers"]
    stages = {"edge": {"embed": params["embed"], "layers": layers[:half]},
              "cloud": {"final_norm": params["final_norm"],
                        "layers": layers[half:]}}
    if "head" in params:
        stages["cloud"]["head"] = params["head"]
    if cfg.tie_embeddings:
        stages["cloud"]["embed"] = params["embed"]
    devices = {"edge": edge, "cloud": cloud}
    if ctx is None:
        return {k: _to(tree, devices[k]) for k, tree in stages.items()}
    _check_ranks(ctx)
    stage = _stage(ctx)
    return {stage: _to(shard_experts(cfg, stages[stage], ctx),
                       devices[stage])}


def init_split_params(cfg: ModelConfig, generator: torch.Generator, *,
                      edge_device="cuda", cloud_device="cuda",
                      ctx: DistContext | None = None):
    """Random parameters (:func:`~repro_torch.models.init_params` on the
    edge device -- under ``ctx`` on this rank's stage's device -- which
    ``generator`` must live on), split into stages.  Under ``ctx`` every
    rank draws the whole model from the generator's seed and keeps its
    stage."""
    _check_supported(cfg)
    device = edge_device
    if ctx is not None:
        _check_ranks(ctx)
        device = edge_device if _stage(ctx) == "edge" else cloud_device
    params = T.init_params(cfg, generator, device=device)
    return split_params(cfg, params, edge_device=edge_device,
                        cloud_device=cloud_device, ctx=ctx)


def init_split_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
                     edge_device="cuda", cloud_device="cuda",
                     ctx: DistContext | None = None):
    """(edge caches, cloud caches): one ``{"k", "v"}`` dict per layer of
    each stage, on that stage's device.  Under ``ctx`` this rank's stage
    only, the other ``None``, each cache of its ``data`` block's rows."""
    _check_supported(cfg)
    half, tail = stage_layout(cfg)
    dtype = T.torch_dtype(cfg)
    spec = cfg.pattern[0]

    def caches(n, device, rows=batch):
        return [T._init_spec_cache(spec, cfg, rows, max_seq, dtype,
                                   T.resolve_device(device))
                for _ in range(n)]

    if ctx is None:
        return caches(half, edge_device), caches(half + tail, cloud_device)
    _check_ranks(ctx)
    rows = batch // ctx.dp_size if _splits_rows(batch, ctx) else batch
    if _stage(ctx) == "edge":
        return caches(half, edge_device, rows), None
    return None, caches(half + tail, cloud_device, rows)


def gathers_rows(codec: FeatureCodec | None, transport: str) -> bool:
    """Whether a data split's edge ranks gather the whole batch's
    boundary before quantizing: a quantized transport with a tiled codec
    whose tiles span rows (:meth:`FeatureCodec.tiles_span_rows`), which
    cannot be cut by rows."""
    return transport != "raw" and codec.tiles_span_rows()


def payload_bytes(cfg: ModelConfig, codec: FeatureCodec | None,
                  transport: str, rows: int) -> int:
    """Bytes the edge sends the cloud in a step across ranks, for ``rows``
    rows: the activations in the model's dtype (``raw``), the int32
    indices (``quantized_f16``) or the packed lanes (``packed``), then,
    unless ``raw``, the rate as 4 float32 bytes.  The receiver sizes its
    buffer so: no size header crosses."""
    n = rows * cfg.d_model
    if transport == "raw":
        return n * T.torch_dtype(cfg).itemsize
    if transport == "quantized_f16":
        return 4 * n + _RATE_BYTES
    bits = codec.bits_per_index()
    return (-(-n // (8 // bits)) if bits in (1, 2, 4) else n) + _RATE_BYTES


def make_split_decode_step(cfg: ModelConfig, codec: FeatureCodec | None, *,
                           transport: str = "packed", edge_device="cuda",
                           cloud_device="cuda",
                           ctx: DistContext | None = None):
    """Returns ``step(params, token, caches, pos) -> (logits, caches,
    rate_bits)`` over split parameters and caches.

    transport: 'packed' (quantized uint8 lanes cross), 'quantized_f16'
    (the reference's name for its ablation: quantized, but the int32
    indices cross at full width), or 'raw' (the activations cross;
    ``codec`` may be None).  ``token`` is (B,) int, ``pos`` the absolute
    position; caches are written in place.  Logits are (B, V) float32,
    rounded through bfloat16 as the reference returns them.

    Under ``ctx`` the step is this rank's part of the step across ranks
    (module docstring): ``token`` is the whole batch's on every rank, and
    every rank returns the whole batch's logits and rate.

    Each part of the step is an :mod:`~repro_torch.obs.tracing` span:
    ``edge_stage`` (the edge's layers and quantizer), ``crossing`` (the
    payload's ``.to``) and ``cloud_stage`` (dequantize, layers, head and,
    across ranks, the gather); across ranks ``payload_send`` and
    ``logits_recv`` on the edge, ``payload_recv`` and ``logits_send`` on
    the cloud in place of ``crossing``.
    """
    _check_supported(cfg)
    if transport not in TRANSPORTS:
        raise ValueError(f"transport {transport!r} not in {TRANSPORTS}")
    if transport != "raw" and codec is None:
        raise ValueError(f"transport {transport!r} needs a codec")
    edge = T.resolve_device(edge_device)
    cloud = T.resolve_device(cloud_device)
    if ctx is not None:
        return _ranked_step(cfg, codec, transport, ctx, edge, cloud)
    edge_part, cloud_part, rate_of = _stage_parts(cfg, codec, transport,
                                                  None)

    @torch.inference_mode()
    def step(params, token, caches, pos: int):
        edge_cache, cloud_cache = caches
        rows = token.shape[0]
        with span("edge_stage"):
            wire, counts = edge_part(params["edge"], token.to(edge),
                                     edge_cache, pos)
            rate_bits = rate_of(counts, rows)
        with span("crossing"):
            wire = wire.to(cloud)
        with span("cloud_stage"):
            logits = cloud_part(params["cloud"], wire, rows, cloud_cache,
                                pos)
        return logits.to(torch.float32), caches, rate_bits

    return step


def _stage_parts(cfg, codec, transport: str, ctx):
    """The two halves of a step, the crossing left to the caller:

    * ``edge_part(params, token, cache, pos, whole=False) -> (wire,
      counts)``: the embedding and the edge's layers on ``token``'s rows,
      then the boundary's wire tensor (:func:`_boundary`'s ``send``) --
      with ``whole``, of the whole batch's boundary, gathered from the
      ``data`` group's ranks first;
    * ``cloud_part(params, wire, rows, cache, pos, own=False)``: that
      wire tensor, on the cloud, as ``rows`` rows of input (``receive``)
      -- with ``own``, this rank's ``data`` block of them -- the cloud's
      layers and the head -> bfloat16 logits of the rows it ran (bfloat16
      is plenty for the sampler and halves the return path);
    * ``rate_of(counts, rows)``: the rate of ``rows`` rows' counts."""
    half, tail = stage_layout(cfg)
    spec = cfg.pattern[0]
    edge_layers = [(spec, i) for i in range(half)]
    cloud_layers = [(spec, i) for i in range(half + tail)]
    send, receive = _boundary(cfg, codec, transport)

    def edge_part(params, token, cache, pos, whole=False):
        x = T._embed_in(cfg, params, token[:, None], pos0=pos)
        y, _ = T._run_groups(x, params, cfg, [edge_layers], pos=pos,
                             caches=[cache], ctx=ctx)
        return send(gather_rows(y, ctx) if whole else y)

    def cloud_part(params, wire, rows, cache, pos, own=False):
        x = receive(wire, (rows, 1, cfg.d_model))
        if own:
            x = dp_rows(x, ctx)
        y, _ = T._run_groups(x, params, cfg, [cloud_layers], pos=pos,
                             caches=[cache], ctx=ctx)
        return T._logits_out(cfg, params, y)[:, 0].to(torch.bfloat16)

    def rate_of(counts, rows):
        if counts is None:
            return torch.tensor(RAW_RATE_BITS)
        return codec.rate_from_counts(counts, (rows, 1, cfg.d_model))

    return edge_part, cloud_part, rate_of


def _boundary(cfg, codec, transport: str):
    """The crossing's two ends.  ``send(y) -> (wire, index counts)`` on
    the edge: the packed bytes -- from the quantizer's own launch where it
    packs (one launch, no int32 indices), else packed after it -- or the
    int32 indices; ``raw`` sends ``y`` itself and counts nothing.
    ``receive(wire, shape)`` on the cloud: the wire tensor unpacked and
    dequantized (``raw``: the activations themselves) to a tensor of
    ``shape`` in the model's dtype."""
    dtype = T.torch_dtype(cfg)

    def quantize(y):
        idx, _, counts = codec.quantize_with_counts(y)
        return (codec.pack(idx.reshape(-1)) if transport == "packed"
                else idx), counts

    def unquantized(y):
        return y, None

    if transport == "raw":
        send = unquantized
    elif transport == "packed" and codec.packs_in_quantizer():
        send = codec.quantize_packed_with_counts
    else:
        send = quantize

    def receive(wire, shape):
        if transport == "packed":
            wire = codec.unpack(wire, math.prod(shape))
        x = wire.reshape(shape)
        return x if transport == "raw" else codec.dequantize(x, dtype=dtype)

    return send, receive


# ---------------------------------------------------------------------------
# the step across ranks
# ---------------------------------------------------------------------------

def _staged(device: torch.device) -> bool:
    """Whether the crossing stages ``device``'s bytes through the host:
    gloo with device tensors.  NCCL takes CUDA tensors as they are."""
    backend = dist.get_backend()
    if backend == "gloo":
        return device.type != "cpu"
    if backend == "nccl" and device.type == "cuda":
        return False
    raise ValueError(f"the split crossing runs on gloo, or on nccl with CUDA "
                     f"tensors, not on {backend} with {device.type} tensors")


def _send(msg: torch.Tensor, peer: int, staged: bool) -> None:
    dist.send(msg.cpu() if staged else msg, peer)


def _recv(n_bytes: int, peer: int, device: torch.device,
          staged: bool) -> torch.Tensor:
    buf = torch.empty(n_bytes, dtype=torch.uint8,
                      device="cpu" if staged else device)
    dist.recv(buf, peer)
    return buf.to(device)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def _ranked_step(cfg, codec, transport, ctx, edge, cloud):
    """The step of this rank's stage (module docstring): the halves of
    :func:`_stage_parts`, joined by ``send``/``recv`` with the peer."""
    _check_ranks(ctx)
    gathers = gathers_rows(codec, transport)
    on_edge = _stage(ctx) == "edge"
    device = edge if on_edge else cloud
    peer, staged = ctx.pod_peer, _staged(device)
    edge_part, cloud_part, rate_of = _stage_parts(cfg, codec, transport, ctx)

    def edge_step(params, token, cache, pos, split):
        batch = token.shape[0]
        with span("edge_stage"):
            wire, counts = edge_part(params, dp_rows(token.to(device), ctx),
                                     cache, pos, whole=split and gathers)
            if counts is not None and split and not gathers:
                dist.all_reduce(counts, group=ctx.dp_group)
            rate = rate_of(counts, batch)
            msg = _bytes(wire) if counts is None else torch.cat([
                _bytes(wire),
                _bytes(rate.to(device=wire.device, dtype=torch.float32))])
        with span("payload_send"):
            _send(msg, peer, staged)
        with span("logits_recv"):
            logits = _recv(2 * batch * cfg.vocab_size, peer, device, staged)
        return logits.view(torch.bfloat16).reshape(batch, -1), rate

    def cloud_step(params, token, cache, pos, split):
        batch = token.shape[0]
        rows = batch // ctx.dp_size if split else batch
        # the whole batch's payload where the edge gathered it
        sent = batch if gathers else rows
        with span("payload_recv"):
            msg = _recv(payload_bytes(cfg, codec, transport, sent), peer,
                        device, staged)
        with span("cloud_stage"):
            if transport == "raw":
                wire, rate = msg.view(T.torch_dtype(cfg)), \
                    torch.tensor(RAW_RATE_BITS)
            else:
                wire = msg[:-_RATE_BYTES]
                rate = msg[-_RATE_BYTES:].clone().view(torch.float32)[0]
                if transport == "quantized_f16":
                    wire = wire.view(torch.int32)
            logits = cloud_part(params, wire, sent, cache, pos,
                                own=split and gathers)
            if split:
                logits = gather_rows(logits, ctx)
        with span("logits_send"):
            _send(_bytes(logits), peer, staged)
        return logits, rate

    @torch.inference_mode()
    def step(params, token, caches, pos: int):
        split = _splits_rows(token.shape[0], ctx)
        if on_edge:
            logits, rate = edge_step(params["edge"], token, caches[0], pos,
                                     split)
        else:
            logits, rate = cloud_step(params["cloud"], token, caches[1], pos,
                                      split)
        return logits.to(torch.float32), caches, rate

    return step
