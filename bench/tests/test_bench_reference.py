"""The plain reference against the port on the CPU at a tiny size: the
forward pass (dense, and experts with capacity drops), the quantizer and
the frozen clip calibration."""

import numpy as np
import pytest
import torch

from bench import spec
from bench import weights as W
from bench.reference import calibration as CAL
from bench.reference import codec as QC
from bench.reference.model import Item, Reference, moe
from tiny_cells import tiny_cell

CELLS = {"dense": "codeqwen1.5-7b.long-decode",
         "moe": "dbrx-132b-s8.moe-decode"}


def _port_logits(config, tokens, crange):
    from repro_torch.core import CodecConfig, FeatureCodec
    from repro_torch.models import forward
    cfg = spec.model_config(config)
    params = W.params(config["model"], 5, "cpu")
    codec = FeatureCodec(CodecConfig(n_levels=crange[2], backend="torch"),
                         cmin=crange[0], cmax=crange[1])
    with torch.no_grad():
        logits, _ = forward(cfg, params, tokens,
                            codec_fn=codec.apply_with_rate)
    return logits


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_forward_matches_the_port(kind):
    cell = tiny_cell(CELLS[kind])
    tokens = torch.randint(1, 512, (3, 20), generator=torch.Generator()
                           .manual_seed(0))
    crange = (-20.0, 20.0, 1 << 16)
    item = Item(tokens, first=0)
    Reference(cell.config, 5, "cpu").run([item], lambda edge: crange)
    port = _port_logits(cell.config, tokens, crange)
    assert item.logits.shape == port.shape
    torch.testing.assert_close(item.logits, port, atol=2e-3, rtol=1e-4)


def test_expert_layer_matches_the_ports_dispatch():
    # at the cell's capacity factor (experts / top-k) nothing is dropped
    from repro_torch.models.moe import moe_local
    cell = tiny_cell(CELLS["moe"])
    model = cell.config["model"]
    assert model["capacity_factor"] * model["experts_per_token"] \
        >= model["num_experts"]
    p = W.layer(model, 0, 9, "cpu")["moe"]
    x = torch.randn(40, model["d_model"],
                    generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(moe(x, p, model, lowp=False),
                               moe_local(x, p, spec.model_config(cell.config)),
                               atol=1e-5, rtol=1e-5)


def test_quantizer_matches_the_ports_plain_kernel():
    from repro_torch.kernels.fused_clip_quant import clip_quant_plain
    x = (torch.randn(64, 4096, generator=torch.Generator().manual_seed(2))
         * 3).to(torch.bfloat16)
    idx, deq = clip_quant_plain(x, -0.64, 16.77, 4)
    assert torch.equal(QC.indices(x, -0.64, 16.77, 4).to(torch.int32), idx)
    assert torch.equal(QC.fake_quant(x, -0.64, 16.77, 4)
                       .to(torch.bfloat16), deq)


@pytest.mark.parametrize("cmin_zero", [False, True])
@pytest.mark.parametrize("shift", [0.0, 1.5])
def test_calibration_matches_the_ports(cmin_zero, shift):
    from repro_torch.core import CodecConfig, calibrate
    rng = np.random.default_rng(3)
    samples = (rng.standard_normal(50_000) * 2 + shift).astype(np.float32)
    port = calibrate(CodecConfig(n_levels=4, clip_mode="model",
                                 constrain_cmin_zero=cmin_zero,
                                 backend="torch"), samples=samples)
    ref = CAL.clip_range(samples, 4, kappa=0.5, slope=0.1,
                         cmin_zero=cmin_zero)
    # the frozen copy keeps the port's arithmetic: equal to the bit
    assert ref == (port.cmin, port.cmax)


def test_weights_are_made_again_bit_for_bit():
    model = tiny_cell(CELLS["moe"]).config["model"]
    a = W.layer(model, 2, 11, "cpu")
    b = W.layer(model, 2, 11, "cpu")
    c = W.layer(model, 2, 12, "cpu")
    assert torch.equal(a["moe"]["w2"], b["moe"]["w2"])
    assert torch.equal(a["attn"]["wq"], b["attn"]["wq"])
    assert not torch.equal(a["attn"]["wq"], c["attn"]["wq"])
    assert a["moe"]["router"].dtype == torch.float32


def test_control_moves_the_logits_further():
    cell = tiny_cell(CELLS["dense"])
    tokens = torch.randint(1, 512, (2, 16), generator=torch.Generator()
                           .manual_seed(4))
    crange = (-20.0, 20.0, 1 << 16)
    ref, low = Item(tokens), Item(tokens)
    Reference(cell.config, 5, "cpu").run([ref], lambda e: crange)
    Reference(cell.config, 5, "cpu", lowp=True).run([low], lambda e: crange)
    port = _port_logits(cell.config, tokens, crange)
    assert (low.logits - ref.logits).abs().max() \
        > 100 * (port - ref.logits).abs().max()
