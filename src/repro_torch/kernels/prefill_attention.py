"""Causal GQA prefill attention over fresh keys and values, CUDA for
Hopper.

A prefill from scratch attends query row ``s`` of each head to the keys
``t <= s`` of its KV head, positions ``0..S-1`` (left padding included),
as :func:`repro_torch.models.layers.multi_head_attention` does with
``q_offset=0`` and no window or soft cap.  Source:
``csrc/prefill_attention.cu`` ``repro_prefill_attention``; it replaces
no TPU kernel (the JAX package attends in plain jnp).

Bound by operations: ``2 * B * H * hd * S * (S + 1)`` FLOPs a call (the
two products over the causal pairs).  The kernel is a FlashAttention
forward on Hopper's asynchronous units: a block of two warpgroups per
(tile of 128 query rows, query head, row), longest tiles first; Q, K and
V tiles land in shared memory through the tensor memory accelerator,
both products run as ``wgmma``, the tiles above the diagonal are
skipped and the softmax is online in float32; see the source's notes for
where the probabilities are rounded.

A model's prefill-with-cache routes here where :func:`takes` holds; a
CPU tensor takes the plain path, a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import math

import torch

from . import _build

HEAD_DIMS = (64, 128)
MAX_GROUP = 16          # query heads a KV head


def fits(dtype, h: int, kh: int, hd: int, window, softcap: float) -> bool:
    """Whether the kernel computes this attention: bf16, no sliding window
    and no soft cap, ``hd`` in :data:`HEAD_DIMS` and at most
    :data:`MAX_GROUP` query heads a KV head."""
    return (dtype == torch.bfloat16 and window is None and softcap == 0.0
            and hd in HEAD_DIMS and h % kh == 0 and h // kh <= MAX_GROUP)


def records_grad(*ts: torch.Tensor) -> bool:
    """Whether autograd would record a call on ``ts``: the kernel has no
    backward."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def takes(q: torch.Tensor, k: torch.Tensor, window, softcap: float) -> bool:
    """Whether prefill attention of ``q`` (B, S, H, hd) over ``k`` (B, S,
    K, hd) runs the kernel: CUDA tensors of one dtype that :func:`fits`,
    with no autograd recording."""
    return (q.device.type == "cuda" and k.dtype == q.dtype
            and fits(q.dtype, q.shape[-2], k.shape[-2], q.shape[-1], window,
                     softcap)
            and not records_grad(q, k))


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless q is (B, S, H, hd) and k, v are (B, S, K, hd) of q's
    dtype and device with K dividing H, S >= 1."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q must be (B, S, H, hd) and k (B, S, K, hd), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    b, s, h, hd = q.shape
    if v.shape != k.shape or k.shape[:2] != (b, s) or k.shape[3] != hd \
            or h % k.shape[2] or s < 1:
        raise ValueError(f"shapes do not fit: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if not (k.dtype == v.dtype == q.dtype):
        raise TypeError(f"dtypes differ: q {q.dtype}, k {k.dtype}, "
                        f"v {v.dtype}")
    if not (k.device == v.device == q.device):
        raise ValueError("q, k and v must lie on one device")


def kernel_view(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernel reads it in place (through a tensor map): the
    last dimension contiguous, every other stride positive and 16-byte
    aligned (bf16: multiples of 8 elements), the base 16-byte aligned;
    else a contiguous copy."""
    if t.stride(-1) == 1 and all(st > 0 and st % 8 == 0
                                 for st in t.stride()[:-1]) \
            and t.data_ptr() % 16 == 0:
        return t
    return t.contiguous()


def prefill_attention(q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    """q: (B, S, H, hd) after RoPE; k, v: (B, S, K, hd), the same
    positions.  Causal attention from position 0; returns (B, S, H, hd)
    in q's dtype, contiguous."""
    check_args(q, k, v)
    if q.device.type == "cpu":
        from ..models import layers as L
        return L.multi_head_attention(q, k, v, q_offset=0)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, s, h, hd = q.shape
    kh = k.shape[2]
    if not fits(q.dtype, h, kh, hd, None, 0.0):
        raise ValueError(f"the kernel takes bfloat16 with head_dim in "
                         f"{HEAD_DIMS} and at most {MAX_GROUP} query heads "
                         f"a KV head; got {q.dtype}, head_dim {hd}, {h} / "
                         f"{kh} heads")
    if records_grad(q, k, v):
        raise ValueError("the kernel has no backward; autograd is recording")
    q, k, v = (kernel_view(t) for t in (q, k, v))
    out = torch.empty((b, s, h, hd), dtype=q.dtype, device=q.device)
    _build.launch("prefill_attention", "repro_prefill_attention",
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), b, s, h, kh, hd,
                  *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                  1.0 / math.sqrt(hd), out.data_ptr())
    return out
