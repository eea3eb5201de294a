"""Bit-pack of quantizer indices to the wire width, CUDA for Hopper.

The packed split-runtime transport (:mod:`repro_torch.compression.
split_runtime`) crosses ``bits``-wide indices as uint8 lanes, ``8 //
bits`` indices per byte.  :func:`pack_bits` replaces the Pallas kernel
``repro/kernels/pack_bits.py`` ``_kernel`` (``pack_rows_2d``).  Source:
``csrc/pack_bits.cu`` ``repro_pack_bits``.

Bit layout (shared with ``TorchBackend.pack_indices``, ``FeatureCodec.
unpack`` and the encode megakernel): byte ``k`` holds index ``k * per +
j`` at bit offset ``j * bits`` -- little-end-first lanes -- and the last
byte is zero-padded.  The lanes are summed in int32 and the low byte
kept, as the reference's kernel does.

Bound by bytes on the card (a 4-byte read per index, a ``1 / per`` byte
write).  The reference's kernel took an (8, n_bytes) lane view padded to
the TPU's sublane tile; here a thread packs four bytes straight from the
flat tensor, from 16-byte loads, into one 32-bit store (see the source
notes).  Where the per-tensor quantizer makes the indices, it packs them
in its own launch instead
(:func:`~repro_torch.kernels.fused_clip_quant.clip_quant_pack`).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import torch

from . import _build

PACK_BITS = (1, 2, 4)


def pack_bits_plain(idx: torch.Tensor, bits: int) -> torch.Tensor:
    """Plain torch version of :func:`pack_bits`: the flat indices padded
    to whole bytes, shifted into their lanes and summed in int32."""
    per = 8 // bits
    flat = idx.reshape(-1).to(torch.int32)
    pad = (-flat.shape[0]) % per
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    shifts = torch.arange(per, dtype=torch.int32, device=flat.device) * bits
    return (flat.reshape(-1, per) << shifts).sum(-1, dtype=torch.int32) \
        .to(torch.uint8)


def pack_bits(idx: torch.Tensor, bits: int) -> torch.Tensor:
    """idx: int32 indices, any shape, ``bits`` in (1, 2, 4).  Returns the
    ``ceil(n / (8 // bits))`` packed uint8 bytes of the flat indices."""
    if bits not in PACK_BITS:
        raise ValueError(f"packable bit widths are 1/2/4, got {bits}")
    if idx.device.type == "cpu":
        return pack_bits_plain(idx, bits)
    if idx.device.type != "cuda":
        raise ValueError(f"unsupported device {idx.device}")
    _build.check_cuda("idx", idx, (torch.int32,))
    _build.check_numel("idx", idx)
    n = idx.numel()
    per = 8 // bits
    out = torch.empty((n + per - 1) // per, dtype=torch.uint8,
                      device=idx.device)
    if n:
        _build.launch("pack_bits", "repro_pack_bits", idx.data_ptr(), n,
                      bits, out.data_ptr())
    return out
