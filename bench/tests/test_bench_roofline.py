"""The frozen counts against shapes computed by hand."""

import json

import pytest

from bench import roofline as RL
from bench import spec


def _model(name):
    return json.loads((spec.BENCH / "configs" / f"{name}.json")
                      .read_text())["model"]


def test_dense_active_parameters():
    # attention 4096*32*128*2 + 4096*4*128*2, MLP 3*4096*13440, 32
    # layers, head 4096*92416
    m = _model("codeqwen1.5-7b")
    assert RL.layer_params(m, RL.layer_specs(m)[0]) == 202_899_456
    assert RL.active_params(m) == 32 * 202_899_456 + 378_535_936


def test_moe_counts_the_routed_experts_only():
    # attention 6144*48*128*2 + 6144*8*128*2 = 88,080,384; router
    # 6144*16; 4 of 16 experts of 3*6144*10752
    m = _model("dbrx-132b-s8")
    assert RL.layer_params(m, RL.layer_specs(m)[0]) \
        == 88_080_384 + 98_304 + 4 * 3 * 6144 * 10752
    assert RL.active_params(m) == 8 * 880_902_144 + 6144 * 100_352


def test_attention_and_forward_flops():
    m = {"num_layers": 2, "d_model": 8, "num_heads": 2, "num_kv_heads": 1,
         "head_dim": 4, "d_ff": 16, "vocab_size": 10}
    # per layer: attention 8*2*4*2 + 8*1*4*2 = 192, MLP 3*8*16 = 384
    assert RL.active_params(m) == 2 * 576 + 80
    assert RL.prefill_context_sum(4) == 10
    # 4 * heads * head_dim * pairs * layers
    assert RL.attention_flops(m, 10) == 4 * 2 * 4 * 10 * 2
    assert RL.forward_flops(m, 4, 10) == 2 * 1232 * 4 + 640


def test_codec_bytes():
    # a (32, 1, 4096) bf16 boundary: read once, reconstruction written
    # once, one float32 rate
    assert RL.codec_bytes(32 * 4096, {"dtype": "bfloat16"}) \
        == 4 * 32 * 4096 + 4
    assert RL.codec_bytes(10, {"dtype": "float32"}) == 84


def test_unknown_layer_kind_is_refused():
    with pytest.raises(NotImplementedError):
        RL.layer_params({"d_model": 1, "head_dim": 1, "num_heads": 1,
                         "num_kv_heads": 1}, {"kind": "rwkv", "moe": False})


def test_peaks_are_the_data_sheets():
    assert RL.PEAK_BF16_FLOPS == 989e12
    assert RL.PEAK_HBM_BYTES_PER_S == 3.35e12
