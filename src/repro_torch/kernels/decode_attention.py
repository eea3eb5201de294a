"""GQA decode attention over the written prefix of a KV cache, CUDA for
Hopper.

A decode step's query row attends over slots ``[0, n_valid)`` of its
layer's cache, ``n_valid = min(pos + 1, S_cache)``: for a linear cache
the slots written so far, for a ring cache of ``S_cache <= window``
slots exactly those whose positions the masked path
(:func:`repro_torch.models.layers.multi_head_attention` over the whole
cache with ``k_positions``) leaves valid.  Every other slot gets no
weight there, so attending over the prefix alone gives the same result
and reads only the bytes that matter.  Source:
``csrc/decode_attention.cu`` ``repro_decode_attention``; it replaces no
TPU kernel (the JAX package attends in plain jnp).

Bound by bytes: ``2 * B * n_valid * K * hd`` elements of K and V read
once a call.  The kernel splits the prefix (flash-decoding,
:func:`split_plan`): a block per (split, KV head, row) streams its slots
through shared memory once for all ``G = H / K`` query heads of its KV
head; a second launch combines the splits.
Logits, softmax and the value sums are float32, as on the plain path;
see the source's notes for where the probabilities are rounded.  The
kernel takes bf16 caches, the dtype of every configuration served; a
float32 or fp16 cache keeps the plain path.

The decode step routes here where :func:`takes` holds; a CPU tensor
takes the plain attention over the prefix, a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import functools
import math

import torch

from . import _build

HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 16          # query heads a KV head (one tensor-core tile)
BLOCKS_PER_SM = 16      # grid size the split length aims at


def fits(dtype, cache_dtype, h: int, kh: int, hd: int) -> bool:
    """Whether the kernel is built for these types and shapes: a bf16
    query and cache, ``hd`` in :data:`HEAD_DIMS` and at most
    :data:`MAX_GROUP` query heads a KV head.  A quantized (uint8) cache
    does not fit."""
    return (dtype == cache_dtype == torch.bfloat16 and hd in HEAD_DIMS
            and h % kh == 0 and h // kh <= MAX_GROUP)


def takes(q: torch.Tensor, k: torch.Tensor) -> bool:
    """Whether decode attention of ``q`` (B, 1, H, hd) over cache ``k``
    (B, S, K, hd) runs the kernel: a CUDA tensor that :func:`fits`."""
    return q.device.type == "cuda" and fits(
        q.dtype, k.dtype, q.shape[-2], k.shape[-2], q.shape[-1])


def tile_slots(hd: int) -> int:
    """Slots of K and V a pipeline stage holds (csrc ``Tile<HD>::TK``)."""
    return 32 if hd == 256 else 64


def split_plan(bk: int, n_valid: int, hd: int, sms: int) -> tuple[int, int]:
    """``(split_len, n_splits)`` for ``bk`` (row, KV head) pairs: splits
    of whole tiles, as short as gives ~:data:`BLOCKS_PER_SM` blocks an
    SM over the prefix, so even a small batch covers the card."""
    tk = tile_slots(hd)
    want = -(-n_valid * bk // (BLOCKS_PER_SM * sms))
    split_len = max(tk, -(-want // tk) * tk)
    return split_len, -(-n_valid // split_len)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               n_valid: int) -> None:
    """Raise unless q is (B, H, hd), k and v are (B, S, K, hd) of q's
    dtype and device with K dividing H, all contiguous, and
    ``1 <= n_valid <= S``."""
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"q must be (B, H, hd) and k (B, S, K, hd), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    b, h, hd = q.shape
    if v.shape != k.shape or k.shape[0] != b or k.shape[3] != hd \
            or h % k.shape[2]:
        raise ValueError(f"shapes do not fit: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if not (k.dtype == v.dtype == q.dtype):
        raise TypeError(f"dtypes differ: q {q.dtype}, k {k.dtype}, "
                        f"v {v.dtype}")
    if not (k.device == v.device == q.device):
        raise ValueError("q, k and v must lie on one device")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 1 <= n_valid <= k.shape[1]:
        raise ValueError(f"n_valid {n_valid} outside [1, {k.shape[1]}]")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     n_valid: int, softcap: float = 0.0) -> torch.Tensor:
    """q: (B, H, hd), one query row a sequence, after RoPE; k, v: the
    layer's cache (B, S, K, hd) as stored.  Attends over slots
    ``[0, n_valid)``; returns (B, 1, H, hd) in q's dtype."""
    check_args(q, k, v, n_valid)
    if q.device.type == "cpu":
        from ..models import layers as L
        return L.multi_head_attention(q[:, None], k[:, :n_valid],
                                      v[:, :n_valid], q_offset=n_valid - 1,
                                      softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, h, hd = q.shape
    s, kh = k.shape[1], k.shape[2]
    if not fits(q.dtype, k.dtype, h, kh, hd):
        raise ValueError(f"the kernel takes bfloat16 with "
                         f"head_dim in {HEAD_DIMS} and at most {MAX_GROUP} "
                         f"query heads a KV head; got {q.dtype}, head_dim "
                         f"{hd}, {h} / {kh} heads")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    g = h // kh
    split_len, n_splits = split_plan(b * kh, n_valid, hd,
                                     _sm_count(q.device.index))
    out = torch.empty((b, 1, h, hd), dtype=q.dtype, device=q.device)
    part_o = part_ml = None
    if n_splits > 1:    # each split's o (hd floats a head), then its (m, l)
        heads = b * kh * n_splits * g
        part = torch.empty(heads * (hd + 2), dtype=torch.float32,
                           device=q.device)
        part_o = part.data_ptr()
        part_ml = part_o + heads * hd * 4
    _build.launch("decode_attention", "repro_decode_attention",
                  q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  b, s, kh, g, hd, n_valid,
                  split_len, n_splits, 1.0 / math.sqrt(hd), float(softcap),
                  out.data_ptr(), part_o, part_ml)
    return out
