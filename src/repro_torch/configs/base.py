"""Config schema for the model zoo and the assigned input shapes.

Every architecture is expressed as a repeating ``pattern`` of layer specs
(mixer kind + locality); the model builder groups repeated periods at
the split boundary and runs the layers of each group in order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal

MixerKind = Literal["attn", "rglru", "rwkv"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer of the repeating pattern: a mixer plus its MLP/channel-mix."""

    kind: MixerKind = "attn"
    window: int | None = None  # sliding-window size for local attention
    moe: bool = False          # MoE MLP instead of dense


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    pattern: tuple[LayerSpec, ...] = (LayerSpec(),)
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # --- attention details ---
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    use_qk_norm: bool = False
    rope_theta: float = 10_000.0
    pos_emb: str = "rope"       # rope | sinusoidal
    # --- recurrent details ---
    rnn_dim: int = 0            # RG-LRU width
    conv_width: int = 4
    rwkv_head_dim: int = 64
    rwkv_lora_rank: int = 64
    # --- misc ---
    act: str = "silu"           # silu | gelu
    gated_mlp: bool = True      # SwiGLU/GeGLU vs plain 2-matrix FFN
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    norm_eps: float = 1e-6
    input_mode: str = "tokens"  # tokens | embeddings (audio/vlm frontend stubs)
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # --- KV-cache compression (paper eq. 1 applied to K/V storage) ---
    kv_quant_bits: int = 0     # 0 = bf16 cache; 8 = uint8 quantized cache
    kv_clip: float = 8.0       # symmetric clip range for KV quantization
    # --- collaborative-intelligence split (paper integration) ---
    split_after_period: int = 0   # split boundary, in pattern periods (0 = mid)
    long_context_ok: bool = False  # may run the long_500k shape
    notes: str = ""

    def __post_init__(self):
        if self.num_layers % len(self.pattern) not in (0,) and \
                self.num_layers < len(self.pattern):
            raise ValueError("pattern longer than num_layers")

    # -- derived ---------------------------------------------------------------

    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def n_full_periods(self) -> int:
        return self.num_layers // self.period

    @property
    def remainder(self) -> tuple[LayerSpec, ...]:
        r = self.num_layers % self.period
        return self.pattern[:r]

    def layer_specs(self) -> list[LayerSpec]:
        return list(self.pattern) * self.n_full_periods + list(self.remainder)

    def param_count(self) -> int:
        """Total parameters (embedding included once if tied)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        h, k, hd = self.num_heads, self.num_kv_heads, self.head_dim
        norm_p = 2 * d if self.norm == "layernorm" else d  # scale (+ bias)
        total = v * d              # embedding
        if not self.tie_embeddings:
            total += d * v         # lm head
        total += norm_p            # final norm
        for spec in self.layer_specs():
            total += 2 * norm_p    # two norms
            if spec.kind == "attn":
                total += d * h * hd + 2 * d * k * hd + h * hd * d
                if self.use_qk_norm:
                    total += 2 * self.head_dim
            elif spec.kind == "rglru":
                r = self.rnn_dim
                # w_in,w_gate + conv(w,b) + wa,ba,wx,bx + lam + w_out
                total += 2 * d * r + self.conv_width * r + r \
                    + 2 * r * r + 2 * r + r + r * d
            elif spec.kind == "rwkv":
                m = self.num_heads * self.rwkv_head_dim
                # mu(5d) + wr/wk/wv/wg/wo + w0 + lora(A,B) + u + ln
                total += 5 * d + 5 * d * m + m \
                    + self.rwkv_lora_rank * (d + m) + m + m
            if spec.moe:
                e, ef = self.num_experts, self.moe_d_ff
                total += d * e + e * (2 * d * ef + ef * d)
            elif spec.kind == "rwkv":
                total += 2 * d + d * f + f * d + d * d  # channel mix
            else:
                total += (3 if self.gated_mlp else 2) * d * f
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if self.num_experts == 0:
            return self.param_count()
        d, ef = self.d_model, self.moe_d_ff
        e, kk = self.num_experts, self.experts_per_token
        per_layer_all = e * (2 * d * ef + ef * d)
        per_layer_active = kk * (2 * d * ef + ef * d)
        n_moe = sum(1 for s in self.layer_specs() if s.moe)
        return self.param_count() - n_moe * (per_layer_all - per_layer_active)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def reduced(cfg: ModelConfig, *, layers: int | None = None, d_model: int = 64,
            seq_len_cap: int = 128) -> ModelConfig:
    """Shrink a config to smoke-test size, preserving the family structure."""
    period = cfg.period
    if layers is not None:
        n_layers = layers
    else:
        # one full period + the true remainder, so both code paths are hit
        n_layers = (period if period > 1 else 2) + cfg.num_layers % period
    scale = d_model / cfg.d_model
    hd = 16
    heads = max(2, min(cfg.num_heads, 4))
    kv = max(1, min(cfg.num_kv_heads, heads))
    # shrink local windows so locality is exercised at tiny seq lens
    pattern = tuple(dataclasses.replace(
        s, window=(min(s.window, seq_len_cap // 2) if s.window else None))
        for s in cfg.pattern)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=n_layers,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=hd,
        d_ff=d_model * 3,
        vocab_size=min(cfg.vocab_size, 512),
        pattern=pattern,
        num_experts=min(cfg.num_experts, 8) if cfg.num_experts else 0,
        experts_per_token=min(cfg.experts_per_token, 2) if cfg.experts_per_token else 0,
        moe_d_ff=d_model * 2 if cfg.num_experts else 0,
        # drop-free at smoke scale so decode == forward exactly; the
        # capacity-dropping path is unit-tested separately in test_moe.py
        capacity_factor=float(min(cfg.num_experts, 8)) if cfg.num_experts else 1.25,
        rnn_dim=d_model if cfg.rnn_dim else 0,
        rwkv_head_dim=16,
        rwkv_lora_rank=8,
        dtype="float32",
    )
