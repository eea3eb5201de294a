"""Frozen counts of the work a cell asks for, and the H100's peaks.

The counts come from the configuration file's ``model`` section and the
served schedule alone, never from the program, so a later change to the
program cannot change what its time is divided into.

- ``forward_flops``: the useful operations of a forward pass: two per
  multiply-add of the active parameters (the experts a token is routed
  to, not the capacity slots a dispatch pads to) for every token, and
  attention's two matrix products over each token's real context (the
  request's own tokens, not the padding or the unused cache slots).
- ``codec_bytes``: the boundary quantizer's input read once and its
  outputs (the reconstruction and the rate) written once.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 data sheet: dense bf16 tensor-core rate without
# sparsity, and the HBM3 bandwidth of the 80 GB part, at 700 W.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12

_DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def layer_specs(model: dict) -> list[dict]:
    """The per-layer specs of a ``model`` section, the pattern repeated
    over ``num_layers`` (a remainder takes the pattern's head)."""
    pattern = model.get("pattern") or [{}]
    n = model["num_layers"]
    return [dict({"kind": "attn", "moe": False}, **pattern[i % len(pattern)])
            for i in range(n)]


def layer_params(model: dict, spec: dict) -> int:
    """Parameters one token multiplies by in a layer (norms left out)."""
    if spec["kind"] != "attn":
        raise NotImplementedError(f"no count for layer kind {spec['kind']}")
    d, hd = model["d_model"], model["head_dim"]
    h, kh = model["num_heads"], model["num_kv_heads"]
    attn = d * h * hd * 2 + d * kh * hd * 2
    if spec["moe"]:
        e, k, f = (model["num_experts"], model["experts_per_token"],
                   model["moe_d_ff"])
        return attn + d * e + k * 3 * d * f
    width = 3 if model.get("gated_mlp", True) else 2
    return attn + width * d * model["d_ff"]


def active_params(model: dict) -> int:
    """Parameters a token multiplies by in a whole forward, the head's
    included (the embedding is a lookup)."""
    return sum(layer_params(model, s) for s in layer_specs(model)) \
        + model["d_model"] * model["vocab_size"]


def attention_flops(model: dict, context_sum: int) -> int:
    """Attention's two products (scores and the weighted values) over
    ``context_sum`` query-key pairs in every attention layer."""
    n_attn = sum(s["kind"] == "attn" for s in layer_specs(model))
    return 4 * model["num_heads"] * model["head_dim"] * context_sum * n_attn


def forward_flops(model: dict, tokens: int, context_sum: int) -> int:
    """Useful operations of forwarding ``tokens`` tokens whose real
    contexts (the token itself and the request's tokens before it) add
    up to ``context_sum``."""
    return 2 * active_params(model) * tokens \
        + attention_flops(model, context_sum)


def prefill_context_sum(length: int) -> int:
    """Query-key pairs of a causal prefill of ``length`` tokens."""
    return length * (length + 1) // 2


def codec_bytes(n_values: int, model: dict) -> int:
    """Bytes of one boundary quantizer call on ``n_values`` activations:
    the input read once, the reconstruction written once (both in the
    model's dtype) and the float32 rate."""
    b = _DTYPE_BYTES[model.get("dtype", "bfloat16")]
    return 2 * b * n_values + 4
