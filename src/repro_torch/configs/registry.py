"""The 10 assigned architectures (public-literature configs) + registry.

Every entry is selectable via ``--arch <id>`` in the launchers.  Sources are
cited per config; ``long_context_ok`` marks archs that may run the
``long_500k`` decode shape (sub-quadratic or windowed+global mixes whose
500k KV cache fits when sharded) -- pure full-attention archs skip it, see
DESIGN.md §Arch-applicability.
"""

from __future__ import annotations

from .base import LayerSpec, ModelConfig

_A = LayerSpec  # shorthand


MUSICGEN_LARGE = ModelConfig(
    name="musicgen-large", family="audio",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=2048,
    pattern=(_A(),),
    act="gelu", gated_mlp=False, norm="layernorm", pos_emb="sinusoidal",
    input_mode="embeddings",  # EnCodec frame embeddings (frontend stubbed)
    notes="Decoder-only over EnCodec tokens [arXiv:2306.05284]; modality "
          "frontend stubbed per assignment: input_specs() provides "
          "precomputed frame embeddings.",
)

DBRX_132B = ModelConfig(
    name="dbrx-132b", family="moe",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=10752, vocab_size=100352,
    pattern=(_A(moe=True),),
    num_experts=16, experts_per_token=4, moe_d_ff=10752,
    act="silu", norm="layernorm",
    notes="16-expert top-4 fine-grained MoE [hf:databricks/dbrx-base].",
)

QWEN3_MOE_235B = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4, head_dim=128,
    d_ff=1536, vocab_size=151936,
    pattern=(_A(moe=True),),
    num_experts=128, experts_per_token=8, moe_d_ff=1536,
    use_qk_norm=True, rope_theta=1e6,
    notes="128-expert top-8 MoE with QK-norm [hf:Qwen/Qwen3-235B-A22B].",
)

DEEPSEEK_67B = ModelConfig(
    name="deepseek-67b", family="dense",
    num_layers=95, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=22016, vocab_size=102400,
    pattern=(_A(),),
    notes="Llama-architecture dense model [arXiv:2401.02954].",
)

GEMMA3_1B = ModelConfig(
    name="gemma3-1b", family="dense",
    num_layers=26, d_model=1152, num_heads=4, num_kv_heads=1, head_dim=256,
    d_ff=6912, vocab_size=262144,
    pattern=(_A(window=512), _A(window=512), _A(window=512),
             _A(window=512), _A(window=512), _A()),  # 5 local : 1 global
    rope_theta=1e6, tie_embeddings=True, act="gelu",
    long_context_ok=True,
    notes="5:1 local:global, 512 window, 128k context [hf:google/gemma-3-1b-pt]."
          " long_500k allowed: only 1/6 layers keep a full KV cache.",
)

CODEQWEN15_7B = ModelConfig(
    name="codeqwen1.5-7b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=32, head_dim=128,
    d_ff=13440, vocab_size=92416,
    rope_theta=1e6,
    notes="Qwen1.5 architecture (MHA) [hf:Qwen/CodeQwen1.5-7B].",
)

GEMMA2_9B = ModelConfig(
    name="gemma2-9b", family="dense",
    num_layers=42, d_model=3584, num_heads=16, num_kv_heads=8, head_dim=256,
    d_ff=14336, vocab_size=256000,
    pattern=(_A(window=4096), _A()),  # alternating local/global
    attn_logit_softcap=50.0, final_logit_softcap=30.0,
    act="gelu", tie_embeddings=True,
    long_context_ok=True,
    notes="Local+global alternating with logit softcaps [arXiv:2408.00118]."
          " long_500k allowed: half the layers cache only a 4k window.",
)

QWEN2_VL_2B = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2, head_dim=128,
    d_ff=8960, vocab_size=151936,
    rope_theta=1e6, tie_embeddings=True,
    input_mode="embeddings",  # ViT patch embeddings (frontend stubbed)
    notes="M-RoPE approximated by 1-D RoPE over provided patch/text embedding"
          " stream; dynamic-resolution ViT frontend stubbed per assignment"
          " [arXiv:2409.12191].",
)

RECURRENTGEMMA_2B = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1, head_dim=256,
    d_ff=7680, vocab_size=256000,
    pattern=(_A(kind="rglru"), _A(kind="rglru"), _A(window=2048)),  # 2 RG-LRU : 1 local attn
    rnn_dim=2560, conv_width=4, act="gelu", tie_embeddings=True,
    long_context_ok=True,
    notes="Griffin: RG-LRU recurrent blocks + 2k-window local attention"
          " [arXiv:2402.19427]; O(1) state per recurrent layer.",
)

RWKV6_3B = ModelConfig(
    name="rwkv6-3b", family="ssm",
    num_layers=32, d_model=2560, num_heads=40, num_kv_heads=40, head_dim=64,
    d_ff=8960, vocab_size=65536,
    pattern=(_A(kind="rwkv"),),
    rwkv_head_dim=64, rwkv_lora_rank=64, norm="layernorm",
    long_context_ok=True,
    notes="RWKV-6 Finch: data-dependent decay, attention-free, O(1) state"
          " [arXiv:2404.05892].",
)


ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in [
        MUSICGEN_LARGE, DBRX_132B, QWEN3_MOE_235B, DEEPSEEK_67B, GEMMA3_1B,
        CODEQWEN15_7B, GEMMA2_9B, QWEN2_VL_2B, RECURRENTGEMMA_2B, RWKV6_3B,
    ]
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
