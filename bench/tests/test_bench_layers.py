"""The layer kinds as files (``bench/layers``): what moving the one
layer the reference knew into them had to keep, bit for bit; a kind
that a file alone adds, with the feed-forward it names; RWKV-6's
channel mix against the port's; draws about a mean; and the options a
configuration may not set where no module of its layers reads them."""

import dataclasses
import hashlib
import importlib
import json
import sys
import types

import pytest
import torch

import bench.layers as L
from bench import harness, spec
from bench import roofline as RL
from bench import weights as W
from bench.reference.model import Item, Reference
from tiny_cells import tiny_cell

CELLS = ["codeqwen1.5-7b.long-decode", "dbrx-132b-s8.moe-decode"]

# sha256 of the tiny cells' weight trees (seed 2**31 + 5) and of the
# reference's float32 logits and its float8 control's on fixed tokens,
# read from the benchmark before its layers moved into bench/layers
PINNED = {
    CELLS[0]: {
        "weights": "aa6320b2356eaa9d58edf02987d4bf752ab360fde8decba3f42cbbd4b5e885f4",
        "logits": "963a340e7890c92122cba06068139f4deee036d7bc9f41b5dae400a741b1c9ab",
        "logits_lowp": "0c23f02688dbfe16b23722e28e2fd25d50dbc71ecbf621cf7e172c5be5ec1296"},
    CELLS[1]: {
        "weights": "5bdc9ffe66f786d9ade51a56194553b051265b0087baf0a7a6151881415bb118",
        "logits": "d5e1845d1e116bb26c0d9bef49276380fd9f7ff6df2ab08fc70b7cc9ca0c80c5",
        "logits_lowp": "6f59690e0a00646c9b18b1804210f7f125723683cb663dd96b50d2c36ffc6025"},
}
# the counts of the shipped configurations, read alike
PINNED_COUNTS = {
    "codeqwen1.5-7b": {"forward_flops": 147490022621184,
                       "active_params": 6871318528,
                       "recorder_flops": 22201654837248},
    "dbrx-132b-s8": {"forward_flops": 151148505268224,
                     "active_params": 7663779840,
                     "recorder_flops": 24258215411712},
}
RANGES = [(1, 1000), (2000, 2100), (5, 5), (1021, 1149), (3, 8191)]
# (prompt length, n_open, n_end, t_admit) with the window open at 10 s
REQUESTS = [(1020, 0, 129, 11.0), (2000, 5, 300, 1.0), (16, 0, 1, 12.0),
            (33, 0, 0, 12.5), (500, 40, 41, 2.0), (700, 7, 7, 3.0),
            (80, 0, None, 4.0), (64, 3, 10, 10.0)]


def _hash(tree) -> str:
    h = hashlib.sha256()

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{path}/{k}")
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, f"{path}/{i}")
        else:
            h.update(f"{path}:{t.dtype}:{tuple(t.shape)}".encode())
            h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    walk(tree, "")
    return h.hexdigest()


@pytest.mark.parametrize("cell", CELLS)
def test_weights_and_logits_are_as_pinned(cell):
    config = tiny_cell(cell).config
    got = {"weights": _hash(W.params(config["model"], 2**31 + 5, "cpu"))}
    tokens = torch.randint(1, 512, (2, 24),
                           generator=torch.Generator().manual_seed(7))
    for lowp in (False, True):
        item = Item(tokens, first=3)
        Reference(config, 2**31 + 5, "cpu", lowp=lowp).run(
            [item], lambda edge: (-20.0, 20.0, 1 << 16))
        got["logits_lowp" if lowp else "logits"] = _hash(item.logits)
    assert got == PINNED[cell]


@pytest.mark.parametrize("name", sorted(PINNED_COUNTS))
def test_counts_are_as_pinned(name):
    m = json.loads((spec.BENCH / "configs" / f"{name}.json").read_text())[
        "model"]
    rec = types.SimpleNamespace(t_open=10.0, admitted=[
        types.SimpleNamespace(prompt=[0] * p, n_open=o, n_end=e, t_admit=t)
        for p, o, e, t in REQUESTS])
    assert {"forward_flops": RL.forward_flops(m, RANGES),
            "active_params": RL.active_params(m),
            "recorder_flops": harness.Recorder.flops(rec, m)} \
        == PINNED_COUNTS[name]


SCALED = '''
"""A mixer that multiplies the normed input by one matrix."""
from bench.layers import Matrix
from bench.reference import ops

OPTIONS = ("d_model", "norm", "norm_eps", "gain")
GROUP = "scaled"


def matrices(model, spec):
    d = model["d_model"]
    return [Matrix("w", (d, d), 0.5)]


def forward(x, p, spec, model, lowp):
    b, n, d = x.shape
    h = ops.norm(x, p["norm1"], model).reshape(b * n, d)
    return x + spec.get("gain", 1.0) * ops.lin(h, p[GROUP]["w"], lowp).view(
        b, n, d)


def params(model, spec):
    return model["d_model"] ** 2


def context_flops(model, spec, contexts):
    return 3 * sum(b - a + 1 for a, b in contexts)
'''


@pytest.fixture
def scaled_kind(tmp_path, monkeypatch):
    """A kind's mixer, outside bench/, on ``bench.layers``' search
    path."""
    (tmp_path / "scaled.py").write_text(SCALED)
    monkeypatch.setattr(L, "__path__", [*L.__path__, str(tmp_path)])
    importlib.invalidate_caches()
    yield
    sys.modules.pop("bench.layers.scaled", None)


def test_a_kind_is_a_file(scaled_kind):
    model = dict(tiny_cell(CELLS[0]).config["model"], pattern=[
        {"kind": "scaled", "gain": 2.0}, {"kind": "attn"}])
    L.check_options(model, "test", ())
    p = W.layer(model, 0, 3, "cpu")
    d, f = model["d_model"], model["d_ff"]
    assert set(p) == {"norm1", "norm2", "scaled", "mlp"}
    assert p["scaled"]["w"].shape == (d, d)
    assert set(p["mlp"]) == {"w1", "w2", "w3"}
    # one draw: the mixer's matrix first, then the MLP's
    drawn = torch.randn(d * d + 3 * d * f, dtype=p["scaled"]["w"].dtype,
                        generator=torch.Generator().manual_seed(
                            W.part_seed(3, "layer0")))
    assert torch.equal(p["scaled"]["w"].reshape(-1), drawn[:d * d] * 0.5)
    assert set(W.layer(model, 1, 3, "cpu")) == {"norm1", "norm2", "attn",
                                                "mlp"}
    item = Item(torch.randint(1, 512, (2, 10),
                              generator=torch.Generator().manual_seed(1)))
    Reference({"model": model}, 3, "cpu").run(
        [item], lambda edge: (-20.0, 20.0, 1 << 16))
    assert item.logits.shape == (2, 10, model["vocab_size"])
    assert torch.isfinite(item.logits).all()
    assert RL.layer_params(model, L.layer_specs(model)[0]) \
        == d * d + 3 * d * f
    # two scaled layers and two attention layers of 4 heads of 16
    assert RL.context_flops(model, [(1, 4)]) == 2 * 3 * 4 + 2 * 4 * 64 * 10


# the same mixer, naming its feed-forward: the channel mix, a module
# that is not there, or (``ones``) one whose matrices are drawn at a
# mean with no spread, in the layer's one draw and alone
NAMED = {"shifted": SCALED + 'FEED_FORWARD = "cmix"\n',
         "astray": SCALED + 'FEED_FORWARD = "nowhere"\n',
         "constant": SCALED + 'FEED_FORWARD = "ones"\n',
         "ones": """
from bench.layers import Matrix

OPTIONS = ("d_model",)
GROUP = "ones"


def matrices(model, spec):
    d = model["d_model"]
    return [Matrix("a", (d, 3), 0.0, mean=1.0),
            Matrix("b", (d,), 0.0, own="b", mean=1.0)]
"""}


@pytest.fixture
def named_kinds(tmp_path, monkeypatch):
    """The mixers of ``NAMED``, outside bench/, on ``bench.layers``'
    search path."""
    for name, text in NAMED.items():
        (tmp_path / f"{name}.py").write_text(text)
    monkeypatch.setattr(L, "__path__", [*L.__path__, str(tmp_path)])
    importlib.invalidate_caches()
    yield
    for name in NAMED:
        sys.modules.pop(f"bench.layers.{name}", None)


def test_a_mixer_names_its_feed_forward(named_kinds):
    model = dict(tiny_cell(CELLS[0]).config["model"], pattern=[
        {"kind": "shifted"}, {"kind": "attn"}])
    L.check_options(model, "test", ())
    p = W.layer(model, 0, 3, "cpu")
    d, f = model["d_model"], model["d_ff"]
    assert set(p) == {"norm1", "norm2", "scaled", "cmix"}
    assert set(W.layer(model, 1, 3, "cpu")) == {"norm1", "norm2", "attn",
                                                "mlp"}
    # one draw: the mixer's matrix first, then the channel mix's in order
    drawn = torch.randn(d * d + 2 * d + 2 * d * f + d * d,
                        dtype=p["scaled"]["w"].dtype,
                        generator=torch.Generator().manual_seed(
                            W.part_seed(3, "layer0")))
    parts = [("scaled", "w", (d, d), 0.5, 0.0),
             ("cmix", "mu", (2, d), 12 ** -0.5, 0.5),
             ("cmix", "wk", (d, f), d ** -0.5, 0.0),
             ("cmix", "wv", (f, d), f ** -0.5, 0.0),
             ("cmix", "wr", (d, d), d ** -0.5, 0.0)]
    off = 0
    for group, name, shape, scale, mean in parts:
        n = shape[0] * shape[1]
        want = (drawn[off:off + n] * scale + mean).view(shape)
        assert torch.equal(p[group][name], want), name
        off += n
    item = Item(torch.randint(1, 512, (2, 10),
                              generator=torch.Generator().manual_seed(1)))
    Reference({"model": model}, 3, "cpu").run(
        [item], lambda edge: (-20.0, 20.0, 1 << 16))
    assert item.logits.shape == (2, 10, model["vocab_size"])
    assert torch.isfinite(item.logits).all()
    assert RL.layer_params(model, L.layer_specs(model)[0]) \
        == d * d + 2 * d * f + d * d


def test_moe_in_the_spec_overrides_the_named_feed_forward(named_kinds):
    model = dict(tiny_cell("dbrx-132b-s8.moe-decode").config["model"],
                 pattern=[{"kind": "shifted", "moe": True}])
    L.check_options(model, "test", ())
    assert set(W.layer(model, 0, 3, "cpu")) == {"norm1", "norm2", "scaled",
                                                "moe"}
    assert [m.GROUP for m in L.modules(L.layer_specs(model)[0])] \
        == ["scaled", "moe"]


def test_a_feed_forward_no_module_gives_is_refused_at_load(tmp_path,
                                                           named_kinds,
                                                           monkeypatch):
    made = []
    monkeypatch.setattr(W, "_draw", lambda *a, **k: made.append(a))
    cell, path = _benchmark_with(tmp_path, pattern=[{"kind": "astray"}])
    with pytest.raises(NotImplementedError, match="bench/layers/nowhere.py"):
        spec.load_cell(cell, path)
    assert not made


def test_channel_mix_matches_the_port(named_kinds):
    # both sides in float32 on the CPU, the same products in the same
    # order; they differ only where the norms' reductions round apart
    from repro_torch.models.layers import apply_norm
    from repro_torch.models.rwkv6 import channel_mix_apply
    cmix = L.module("cmix")
    model = dict(tiny_cell(CELLS[0]).config["model"],
                 pattern=[{"kind": "shifted"}])
    spec_ = L.layer_specs(model)[0]
    p = W.layer(model, 0, 11, "cpu")
    x = torch.randn(3, 9, model["d_model"],
                    generator=torch.Generator().manual_seed(4))
    h = apply_norm(x, p["norm2"], model["norm"], model["norm_eps"])
    port = x + channel_mix_apply(h, p["cmix"])[0]
    got = cmix.forward(x, p, spec_, model, False)
    torch.testing.assert_close(got, port, atol=1e-5, rtol=1e-5)
    # the float8 control lands far further from the port
    low = cmix.forward(x, p, spec_, model, True)
    assert (low - port).abs().max() > 100 * max(
        float((got - port).abs().max()), 1e-6)


def test_a_matrix_is_drawn_at_its_mean(named_kinds):
    model = dict(tiny_cell(CELLS[0]).config["model"],
                 pattern=[{"kind": "constant"}])
    d = model["d_model"]
    p = W.layer(model, 0, 3, "cpu")["ones"]
    assert torch.equal(p["a"], torch.ones(d, 3))
    assert p["b"].dtype == torch.float32
    assert torch.equal(p["b"], torch.ones(d))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_a_zero_mean_leaves_the_draw_as_it_was(dtype):
    shapes, scales = [(4, 6), (5,), (3, 2, 2)], [0.3, 1.7, 0.02]
    drawn = torch.randn(24 + 5 + 12, dtype=dtype,
                        generator=torch.Generator().manual_seed(
                            W.part_seed(8, "p")))
    want = [drawn[:24].view(4, 6) * 0.3, drawn[24:29] * 1.7,
            drawn[29:].view(3, 2, 2) * 0.02]
    for means in (None, [0.0, 0.0, 0.0]):
        got = W._draw(shapes, scales, dtype, "cpu", 8, "p", means=means)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def _benchmark_with(tmp_path, **changes):
    """A BENCHMARK.json whose first cell runs its configuration with
    ``changes`` in the ``model`` section (``pattern`` too)."""
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    conf = bench["configs"][0]
    config = json.loads((spec.ROOT / conf["file"]).read_text())
    config["model"].update(changes)
    path = tmp_path / "config.json"
    path.write_text(json.dumps(config))
    conf["file"] = str(path)
    out = tmp_path / "BENCHMARK.json"
    out.write_text(json.dumps(bench))
    return bench["workloads"][0]["name"], out


REFUSED = [("attn_logit_softcap", 50.0, "bench/layers/attn.py"),
           ("final_logit_softcap", 30.0, "bench/reference/model.py"),
           ("use_qk_norm", True, "bench/layers/attn.py"),
           ("gated_mlp", False, "bench/layers/mlp.py"),
           ("tie_embeddings", True, "bench/weights.py"),
           ("pos_emb", "sinusoidal", "bench/layers/attn.py"),
           ("input_mode", "embeddings", "bench/reference/model.py"),
           ("kv_quant_bits", 8, "bench/layers/attn.py")]


@pytest.mark.parametrize("key,value,where", REFUSED)
def test_an_option_no_module_reads_is_refused_at_load(tmp_path, monkeypatch,
                                                      key, value, where):
    made = []
    monkeypatch.setattr(W, "_draw", lambda *a: made.append(a))
    cell, path = _benchmark_with(tmp_path, **{key: value})
    with pytest.raises(NotImplementedError, match=key) as err:
        spec.load_cell(cell, path)
    assert where in str(err.value) and str(tmp_path) in str(err.value)
    assert not made


@pytest.mark.parametrize("pattern,name", [
    ([{"kind": "rwkv"}], "bench/layers/rwkv.py"),
    ([{"kind": "rglru", "window": 8}], "bench/layers/rglru.py"),
    ([{"kind": "attn", "stride": 2}], "stride")])
def test_an_unknown_kind_or_spec_key_is_refused_at_load(tmp_path, pattern,
                                                        name):
    cell, path = _benchmark_with(tmp_path, pattern=pattern)
    with pytest.raises(NotImplementedError, match=name):
        spec.load_cell(cell, path)


def test_options_at_their_neutral_values_load(tmp_path):
    neutral = {k: v for k, (v, _) in L.NEUTRAL.items() if k != "window"}
    cell, path = _benchmark_with(tmp_path, pattern=[
        {"kind": "attn", "window": None}, {"kind": "attn", "window": 4096}],
        **neutral)
    assert spec.load_cell(cell, path).config["model"]["gated_mlp"] is True


def test_neutral_values_are_the_ports_defaults():
    # a key a configuration leaves out takes the port's default, so the
    # neutral value has to be that default to be refused when it is not
    from repro_torch.configs.base import LayerSpec, ModelConfig
    fields = {f.name: f.default for f in dataclasses.fields(ModelConfig)}
    fields.update({f.name: f.default for f in dataclasses.fields(LayerSpec)})
    assert {k: v for k, (v, _) in L.NEUTRAL.items()} \
        == {k: fields[k] for k in L.NEUTRAL}
