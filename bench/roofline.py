"""Frozen counts of the work a cell asks for, and the H100's peaks.

The counts come from the configuration file's ``model`` section and the
served schedule alone, never from the program, so a later change to the
program cannot change what its time is divided into.  Each layer kind
counts its own (``bench/layers``); here are the sums over the layers.

- ``forward_flops``: the useful operations of a forward pass: two per
  multiply-add of the active parameters (the experts a token is routed
  to, not the capacity slots a dispatch pads to) for every token, and
  what depends on each token's real context (the request's own tokens,
  not the padding or the unused cache slots), such as attention's two
  matrix products.
- ``codec_bytes``: the boundary quantizer's input read once and its
  outputs (the reconstruction and the rate) written once.
"""

from __future__ import annotations

from . import layers as L

# NVIDIA H100 SXM5 data sheet: dense bf16 tensor-core rate without
# sparsity, and the HBM3 bandwidth of the 80 GB part, at 700 W.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12

_DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def dtype_bytes(model: dict) -> int:
    return _DTYPE_BYTES[model.get("dtype", "bfloat16")]


def layer_params(model: dict, spec: dict) -> int:
    """Parameters one token multiplies by in a layer (norms left out)."""
    return sum(m.params(model, spec) for m in L.modules(spec))


def active_params(model: dict) -> int:
    """Parameters a token multiplies by in a whole forward, the head's
    included (the embedding is a lookup)."""
    return sum(layer_params(model, s) for s in L.layer_specs(model)) \
        + model["d_model"] * model["vocab_size"]


def context_flops(model: dict, contexts) -> int:
    """Operations that depend on the context, in every layer, over
    tokens whose context lengths run through each ``(first, last)``
    range of ``contexts``."""
    return sum(m.context_flops(model, spec, contexts)
               for spec in L.layer_specs(model) for m in L.modules(spec))


def forward_flops(model: dict, contexts) -> int:
    """Useful operations of forwarding the tokens whose real context
    lengths (the token itself and the request's tokens before it) run
    through each ``(first, last)`` range of ``contexts``."""
    tokens = sum(last - first + 1 for first, last in contexts)
    return 2 * active_params(model) * tokens + context_flops(model, contexts)


def codec_bytes(n_values: int, model: dict) -> int:
    """Bytes of one boundary quantizer call on ``n_values`` activations:
    the input read once, the reconstruction written once (both in the
    model's dtype) and the float32 rate."""
    return 2 * dtype_bytes(model) * n_values + 4
