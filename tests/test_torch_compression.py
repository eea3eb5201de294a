"""Port vs reference: the packed split runtime and gradient compression.

The reference's split runtime is SPMD over a ``pod`` axis, so it runs in
one subprocess on two forced host devices, on a (2, 1, 1) ("pod",
"data", "model") mesh whose axes are all ``Auto``: under jax 0.9
``jax.make_mesh`` makes ``Explicit`` axes by default, which the model's
sharding hints reject.  Its codecs use ``backend="kernel_interpret"``,
so the reference path runs the Pallas clip+quant (#1, #2 for the
per-channel case) and pack (#9) kernels interpreted.  The subprocess
writes, per model and case, the split parameters, the tokens fed, the
split step's logits and rate, and each step's payload, recomputed from
the reference's own edge stage (the step keeps its payload inside the
shard_map).  The port loads the parameters with
``split_params_from_numpy`` and runs the same steps on the CPU.

With ``models221`` in its spec the same script also runs the reference
on a (2, 2, 1) mesh (four forced host devices), the batch split over
``data`` inside each pod; ``tests/test_torch_split_ranks.py`` holds the
split step across ranks against those runs, in ``CASES`` and in
``ROW_TILE_CASES`` (a tiled codec whose tiles span rows).

Tolerances: boundary activations within 1e-5 (float32, sums in another
order); payload bytes identical (an index may only differ where the
reference's boundary value sits at a bin edge, and the test shows it);
``rate_bits`` within 1e-6; logits within 1e-3 absolute (float32 model;
both sides round the logits through bfloat16, so two float32 values that
agree closely can still round one bfloat16 unit apart: where they do,
the port's unrounded logit must sit within 1e-3 of the rounding edge
between the two).  Gradient compression: see its test.
"""

import dataclasses
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compression import compress_grads as jcompress_grads
from repro.compression import init_error_feedback as jinit_ef
from repro.compression import GradCompressionConfig as JGradCfg
from repro_torch.compression import (GradCompressionConfig, compress_grads,
                                     init_error_feedback, split_runtime,
                                     wire_bytes_ratio)
from repro_torch.configs import get_config, reduced
from repro_torch.core import CodecConfig, calibrate
from repro_torch.core.codec import FeatureCodec
from repro_torch.kernels.ops import unpack_bytes
from repro_torch.models import split_params_from_numpy
from repro_torch.models import transformer as T

LAYERS = (4, 5)          # 5: the odd layer count puts a tail on the cloud
# period-1 MoE and RWKV-6 archs at the reduced size (2 layers, split 1 + 1)
# and the cases run on them
FAMILIES = ("qwen3-moe-235b-a22b", "rwkv6-3b")
FAMILY_CASES = ("raw", "packed-4")
VOCAB, BATCH, MAX_SEQ, STEPS = 64, 4, 16, 3
LOGIT_ATOL = 1e-3
RATE_ATOL = 1e-6
# case -> (transport, codec settings); every codec clips at +/-8 but the
# per-channel one, calibrated by min/max from seeded samples
CASES = {
    "raw": ("raw", dict(n_levels=4)),
    "quantized_f16": ("quantized_f16", dict(n_levels=4)),
    "packed-2": ("packed", dict(n_levels=2)),
    "packed-4": ("packed", dict(n_levels=4)),
    "packed-16": ("packed", dict(n_levels=16)),
    "packed-256": ("packed", dict(n_levels=256)),
    "packed-channel-g8": ("packed", dict(
        n_levels=4, granularity="channel", channel_axis=-1,
        channel_group_size=8, clip_mode="minmax")),
}
MANUAL = dict(clip_mode="manual", manual_cmin=-8.0, manual_cmax=8.0)
# a tiled codec whose tiles span rows: a range per 8 channels x 2 of the
# boundary's 4 rows, calibrated by min/max from seeded (4, 1, 64) samples
# (``_tile_samples``); tests/test_torch_split_ranks.py runs it on (2, 2, 1)
ROW_TILE_CASES = {
    "packed-tile-rows": ("packed", dict(
        n_levels=4, granularity="tile", channel_axis=-1,
        channel_group_size=8, spatial_block_size=2, clip_mode="minmax")),
}

_SCRIPT = textwrap.dedent("""
    import ast
    import dataclasses
    import os
    import sys
    from concurrent.futures import ThreadPoolExecutor
    out_path, spec = sys.argv[1], ast.literal_eval(sys.argv[2])
    # the (2, 2, 1) runs need four devices
    n_dev = 4 if spec.get("models221") else 2
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_dev}"
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.compression import split_runtime as SR
    from repro.configs import get_config, reduced
    from repro.core import CodecConfig, calibrate
    from repro.models import transformer as T

    meshes = {shape: jax.make_mesh(shape, ("pod", "data", "model"),
                                   axis_types=(AxisType.Auto,) * 3)
              for shape in ((2, 1, 1), (2, 2, 1))[:n_dev // 2]}
    b, v, max_seq, steps = (spec["batch"], spec["vocab"], spec["max_seq"],
                            spec["steps"])
    samples = np.load(spec["samples"])
    tile_samples = np.load(spec["tile_samples"])
    out = {"samples": samples}
    runs = []
    models = [(m, (2, 1, 1)) for m in spec["models"]] \
        + [(m, (2, 2, 1)) for m in spec.get("models221", [])]
    for (tag, arch, layers, cases), shape in models:
        cfg = dataclasses.replace(reduced(get_config(arch), layers=layers),
                                  vocab_size=v)
        sp = SR.init_split_params(cfg, jax.random.PRNGKey(0))
        for path, leaf in jax.tree_util.tree_flatten_with_path(sp)[0]:
            key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                           for k in path)
            out[f"{tag}/params/{key}"] = np.asarray(leaf)

        def edge(sp, tok, cache, pos, cfg=cfg):
            # the reference's own edge stage, outside the shard_map
            x = T._embed_in(cfg, sp, tok[:, None], pos0=pos)
            layers0 = jax.tree.map(lambda a: a[0], sp["stages"])
            return SR._stage_apply(cfg, layers0, x, cache, pos,
                                   jnp.full((1,), pos, dtype=jnp.int32),
                                   None)

        for case in cases:
            transport, kw = spec["cases"][case]
            data = {"channel": samples, "tile": tile_samples}.get(
                kw.get("granularity"))
            codec = calibrate(CodecConfig(backend="kernel_interpret", **kw),
                              samples=data)
            runs.append((tag, case, transport, cfg, sp, codec,
                         jax.jit(edge), meshes[shape]))

    def compiled(run):
        tag, case, transport, cfg, sp, codec, _, mesh = run
        step = jax.jit(SR.make_split_decode_step(cfg, mesh, codec,
                                                 transport=transport))
        caches = SR.init_split_cache(cfg, b, max_seq)
        tok = jnp.zeros((b,), jnp.int32)
        return step.lower(sp, tok, caches, jnp.int32(0)).compile()

    with ThreadPoolExecutor(4) as pool:     # XLA compiles off the GIL
        steps_of = list(pool.map(compiled, runs))
    for (tag, case, transport, cfg, sp, codec, edge_fn, _), step in zip(
            runs, steps_of):
        caches = SR.init_split_cache(cfg, b, max_seq)
        edge_cache = jax.tree.map(lambda a: a[0], caches[0])
        tok = jnp.arange(b, dtype=jnp.int32) * 7 % v
        rec = {"tokens": [], "logits": [], "rate": [], "y": [],
               "payload": []}
        for pos in range(steps):
            rec["tokens"].append(np.asarray(tok))
            logits, caches, rate = step(sp, tok, caches, jnp.int32(pos))
            rec["logits"].append(np.asarray(logits))
            rec["rate"].append(np.asarray(rate))
            if transport != "raw":
                y, edge_cache = edge_fn(sp, tok, edge_cache, jnp.int32(pos))
                idx = codec.quantize(y)
                wire = codec.pack(idx.reshape(-1)) \\
                    if transport == "packed" else idx
                rec["y"].append(np.asarray(y))
                rec["payload"].append(np.asarray(wire))
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
        for k, vals in rec.items():
            if vals:
                out[f"{tag}/{case}/{k}"] = np.stack(vals)
    np.savez(out_path, **out)
    print("REFERENCE_SPLIT_OK")
""")


def _samples() -> np.ndarray:
    """Seeded calibration samples with per-channel scales (tokens, d)."""
    rng = np.random.default_rng(0)
    return (rng.standard_normal((256, 64)) * np.linspace(0.5, 3.0, 64)) \
        .astype(np.float32)


def _tile_samples() -> np.ndarray:
    """Seeded calibration samples shaped as the boundary, (B, 1, 64)."""
    return np.random.default_rng(0).standard_normal(
        (BATCH, 1, 64)).astype(np.float32)


def _codec_kw(kw: dict) -> dict:
    return kw if "clip_mode" in kw else dict(kw, **MANUAL)


def run_reference(tmp, models, models221=()) -> dict:
    """One subprocess run of the reference split runtime (see above) on
    ``models`` ((tag, arch, layers, cases) each) at (2, 1, 1) and
    ``models221`` at (2, 2, 1); its npz as a dict."""
    np.save(tmp / "samples.npy", _samples())
    np.save(tmp / "tile_samples.npy", _tile_samples())
    path = tmp / "reference.npz"
    spec = dict(models=list(models), models221=list(models221), vocab=VOCAB,
                batch=BATCH, max_seq=MAX_SEQ, steps=STEPS,
                samples=str(tmp / "samples.npy"),
                tile_samples=str(tmp / "tile_samples.npy"),
                cases={k: (t, _codec_kw(kw)) for k, (t, kw)
                       in {**CASES, **ROW_TILE_CASES}.items()})
    out = subprocess.run([sys.executable, "-c", _SCRIPT, str(path),
                          repr(spec)], capture_output=True, text=True,
                         timeout=600)
    assert "REFERENCE_SPLIT_OK" in out.stdout, out.stdout + out.stderr
    return dict(np.load(path))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    models = [(f"L{n}", "codeqwen1.5-7b", n, list(CASES)) for n in LAYERS] \
        + [(arch, arch, 2, list(FAMILY_CASES)) for arch in FAMILIES]
    return run_reference(tmp_path_factory.mktemp("split"), models)


def _cfg(layers: int, arch: str = "codeqwen1.5-7b"):
    return dataclasses.replace(reduced(get_config(arch), layers=layers),
                               vocab_size=VOCAB)


def _tree(ref: dict, tag: str) -> dict:
    """The reference's split parameter tree from the npz's ``{tag}/params/
    a/0/b`` keys (numeric parts are list positions)."""
    prefix = f"{tag}/params/"
    tree: dict = {"tail": None}
    for key, arr in ref.items():
        if not key.startswith(prefix):
            continue
        *path, leaf = key[len(prefix):].split("/")
        node = tree
        for k in path:
            if node.get(k) is None:
                node[k] = {}
            node = node[k]
        node[leaf] = arr

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(tree)


@dataclasses.dataclass
class RecordingCodec(FeatureCodec):
    """The port's codec, keeping what its split step sends: the boundary
    activations it quantizes, the payload (packed bytes, or the indices
    at full width), and whether the quantizer packed them itself."""

    sent: list = dataclasses.field(default_factory=list)

    def quantize_with_counts(self, x, want_deq=False):
        idx, deq, hist = super().quantize_with_counts(x, want_deq)
        self.sent.append({"y": x.numpy().copy(), "payload": idx.numpy(),
                          "fused": False})
        return idx, deq, hist

    def quantize_packed_with_counts(self, x):
        packed, hist = super().quantize_packed_with_counts(x)
        self.sent.append({"y": x.numpy().copy(), "payload": packed.numpy(),
                          "fused": True})
        return packed, hist

    def pack(self, idx):
        out = super().pack(idx)
        self.sent[-1]["payload"] = out.numpy()
        return out


def _scaled(y: np.ndarray, codec) -> np.ndarray:
    """Boundary values in units of the quantizer's step (float64), the
    last axis the channel axis of a tiled codec."""
    if codec.plan is None:
        lo, hi = codec.cmin, codec.cmax
    elif codec.plan.n_sblocks == 1:
        lo, hi = codec.channel_ranges()
    else:
        # tiles over rows too: each element's tile's range
        ids = codec.plan.tile_ids(y.shape)
        lo, hi = (t.reshape(-1)[ids] for t in codec.tile_tables())
    lo, hi = np.float64(lo), np.float64(hi)
    n = codec.config.n_levels
    return (np.clip(y.astype(np.float64), lo, hi) - lo) * (n - 1) / (hi - lo)


def _indices(payload: np.ndarray, codec, n: int) -> np.ndarray:
    if payload.dtype != np.uint8:
        return payload.reshape(-1)
    return unpack_bytes(payload, codec.bits_per_index()).reshape(-1)[:n]


def _same_or_at_edge(got, want, y_ref, codec) -> bool:
    """Payloads identical -> True.  Otherwise every differing index must
    sit at a bin edge of the reference's boundary value (asserted), and
    the run has diverged from there on -> False."""
    if got.dtype == want.dtype and np.array_equal(got, want):
        return True
    n = y_ref.size
    diff = np.flatnonzero(_indices(got, codec, n) != _indices(want, codec, n))
    s = _scaled(y_ref, codec).reshape(-1)[diff]
    assert diff.size and np.all(np.abs(s - np.floor(s) - 0.5) < 1e-4), \
        f"payload indices {diff} differ away from a bin edge"
    return False


def _bf16_rounding_apart(got, want, unrounded) -> np.ndarray:
    """Where the bf16-rounded logits differ by more than the tolerance,
    whether the port's float32 logit sits within the tolerance of the
    rounding edge between the two adjacent bfloat16 values."""
    bad = np.abs(got - want) > LOGIT_ATOL
    mid = (got[bad].astype(np.float64) + want[bad]) / 2
    return np.abs(unrounded[bad] - mid) <= LOGIT_ATOL


@pytest.mark.parametrize("layers", LAYERS)
@pytest.mark.parametrize("case", list(CASES))
def test_split_runtime_matches_reference(reference, monkeypatch, layers,
                                         case):
    _check_split(reference, monkeypatch, f"L{layers}", _cfg(layers), case)


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("case", FAMILY_CASES)
def test_split_runtime_on_moe_and_rwkv6_matches_reference(
        reference, monkeypatch, arch, case):
    """The archs whose MoE and recurrent layers the split conversion used
    to refuse: reduced qwen3-moe-235b-a22b (MoE, local dispatch on the
    mesh's model axis of one device) and rwkv6-3b, split 1 + 1."""
    _check_split(reference, monkeypatch, arch, _cfg(2, arch), case)


def _check_split(reference, monkeypatch, tag: str, cfg, case: str):
    transport, kw = CASES[case]
    data = reference["samples"] if kw.get("granularity") == "channel" \
        else None
    base = calibrate(CodecConfig(backend="torch", **_codec_kw(kw)),
                     samples=data)
    codec = RecordingCodec(**{f.name: getattr(base, f.name)
                              for f in dataclasses.fields(base)})
    params = split_params_from_numpy(cfg, _tree(reference, tag),
                                     edge_device="cpu", cloud_device="cpu")
    step = split_runtime.make_split_decode_step(
        cfg, codec, transport=transport, edge_device="cpu",
        cloud_device="cpu")
    caches = split_runtime.init_split_cache(
        cfg, BATCH, MAX_SEQ, edge_device="cpu", cloud_device="cpu")
    unrounded = []
    logits_out = T._logits_out
    monkeypatch.setattr(T, "_logits_out", lambda *a: unrounded.append(
        logits_out(*a)) or unrounded[-1])
    ref = {k.split("/")[-1]: v for k, v in reference.items()
           if k.startswith(f"{tag}/{case}/")}
    for pos in range(STEPS):
        logits, caches, rate = step(params, torch.from_numpy(
            ref["tokens"][pos]), caches, pos)
        if transport != "raw":
            sent = codec.sent[pos]
            # uniform codecs of a 1/2/4-bit width, per tensor or per
            # group of 8 channels last, pack in the quantizer's pass; the
            # others pack after it, or not at all
            assert sent["fused"] == (case in ("packed-2", "packed-4",
                                              "packed-16",
                                              "packed-channel-g8"))
            np.testing.assert_allclose(sent["y"], ref["y"][pos], rtol=0,
                                       atol=1e-5)
            if not _same_or_at_edge(sent["payload"], ref["payload"][pos],
                                    ref["y"][pos], codec):
                return      # an index crossed a bin edge: the runs part
        assert abs(float(rate) - float(ref["rate"][pos])) <= RATE_ATOL
        if transport != "raw":
            # the rate counted in the quantizer's pass is the two-pass one
            y = torch.from_numpy(codec.sent[pos]["y"])
            assert float(rate) == float(codec.rate_from_indices(
                codec.quantize(y), y.shape))
        got, want = logits.numpy(), ref["logits"][pos]
        assert np.all(_bf16_rounding_apart(
            got, want, unrounded[-1][:, 0].numpy())), \
            f"logits differ by {np.abs(got - want).max()}"
    assert len(codec.sent) == (0 if transport == "raw" else STEPS)


def test_split_params_share_unsplit_tensors():
    """Both stages on one device: the split view copies no tensor."""
    cfg = _cfg(5)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    sp = split_runtime.split_params(cfg, params, edge_device="cpu",
                                    cloud_device="cpu")
    assert sp["edge"]["embed"]["table"] is params["embed"]["table"]
    assert [p["attn"]["wq"] for p in sp["edge"]["layers"]
            + sp["cloud"]["layers"]] == \
        [p["attn"]["wq"] for p in params["layers"]]
    assert len(sp["edge"]["layers"]) == 2 and len(sp["cloud"]["layers"]) == 3
    caches = split_runtime.init_split_cache(cfg, 2, 8, edge_device="cpu",
                                            cloud_device="cpu")
    assert [len(c) for c in caches] == [2, 3]


@pytest.mark.parametrize("arch,kept", [
    ("qwen3-moe-235b-a22b", [("moe", "router")]),
    ("rwkv6-3b", [("tmix", "w0"), ("tmix", "u")])])
def test_split_params_keep_the_reference_float32_leaves(arch, kept):
    """A bfloat16 split tree of the reference (``init_split_params``): the
    leaves it keeps in float32 come out float32 with its values, as
    ``params_from_numpy`` gives them; the others bfloat16 with its bits."""
    from repro.compression import split_runtime as jsr
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    jcfg = dataclasses.replace(jreduced(jget_config(arch), layers=2),
                               vocab_size=VOCAB, dtype="bfloat16")
    cfg = dataclasses.replace(_cfg(2, arch), dtype="bfloat16")
    tree = jax.tree.map(np.asarray,
                        jsr.init_split_params(jcfg, jax.random.PRNGKey(0)))
    params = split_params_from_numpy(cfg, tree, edge_device="cpu",
                                     cloud_device="cpu")
    (stack,) = tree["stages"]
    for i, stage in enumerate(("edge", "cloud")):
        layer = params[stage]["layers"][0]
        for block, leaf in kept:
            want = stack[block][leaf][i, 0]
            assert want.dtype == np.float32
            assert layer[block][leaf].dtype == torch.float32
            np.testing.assert_array_equal(layer[block][leaf].numpy(), want)
        scale = layer["norm1"]["scale"]
        assert scale.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            scale.view(torch.int16).numpy(),
            stack["norm1"]["scale"][i, 0].view(np.int16))


@pytest.mark.parametrize("arch", ["gemma3-1b", "codeqwen1.5-7b"])
def test_split_support_matches_reference(arch):
    from repro.compression import split_runtime as jsr
    from repro.configs import get_config as jget_config
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert split_runtime.split_supported(cfg) == jsr.split_supported(jcfg)
    assert split_runtime.stage_layout(cfg) == jsr.stage_layout(jcfg)
    if jsr.split_supported(jcfg):
        return
    with pytest.raises(ValueError, match="period-1"):
        jsr.init_split_params(jcfg, jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="period-1"):
        split_runtime.init_split_params(cfg, torch.Generator(),
                                        edge_device="cpu",
                                        cloud_device="cpu")


def test_split_step_refuses_bad_arguments():
    cfg = _cfg(4)
    with pytest.raises(ValueError, match="transport"):
        split_runtime.make_split_decode_step(cfg, None, transport="bf16",
                                             edge_device="cpu",
                                             cloud_device="cpu")
    with pytest.raises(ValueError, match="needs a codec"):
        split_runtime.make_split_decode_step(cfg, None, edge_device="cpu",
                                             cloud_device="cpu")


# -- gradient compression ------------------------------------------------------

def _grads(seed: int):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((64, 48)).astype(np.float32) * 0.1,
            "layers": [{"b": rng.standard_normal(200).astype(np.float32)},
                       {"b": rng.laplace(size=(7, 9)).astype(np.float32)}],
            "h": rng.standard_normal((32, 16)).astype(np.float32) * 3}


BF16 = {"h"}     # gradient leaves carried in bfloat16


def _to_jax(tree, path=""):
    if isinstance(tree, dict):
        return {k: _to_jax(v, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_jax(v, path) for v in tree]
    return jnp.asarray(tree, jnp.bfloat16 if path in BF16 else jnp.float32)


def _to_torch(tree, path="", bf16=BF16):
    if isinstance(tree, dict):
        return {k: _to_torch(v, k, bf16) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v, path, bf16) for v in tree]
    t = torch.tensor(np.asarray(tree, np.float32))
    return t.to(torch.bfloat16) if path in bf16 else t


def _flat(tree):
    """Leaves in the reference's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _flat(v)]
    return [tree]


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("n_levels", [4, 16])
def test_compress_grads_matches_reference(n_levels):
    """Three steps of error feedback.  Each step both packages take the
    same gradients and the reference's error buffer.  The clip range
    comes from a float32 standard deviation that the two libraries sum in
    another order (torch's is the correctly rounded one here, jnp's one
    unit off), so the reconstruction levels may sit a few float32 units
    apart: compressed values agree within one unit of the gradient's
    dtype at the range's scale, except where an element sits at a bin
    edge.  The port's own feedback chain takes ``new_e = gf - cg`` after
    the cast (bit-exact), so ``cg + new_e`` misses ``gf`` by no more than
    the float32 rounding of that subtraction."""
    cfg, jcfg = GradCompressionConfig(n_levels=n_levels), \
        JGradCfg(n_levels=n_levels)
    g0 = _grads(0)
    je, te = jinit_ef(_to_jax(g0)), init_error_feedback(_to_torch(g0))
    for step in range(3):
        g = _grads(step)
        jcg, je_new, jm = jcompress_grads(jcfg, _to_jax(g), je)
        tcg, _, tm = compress_grads(cfg, _to_torch(g), _to_torch(
            jax.tree.map(np.asarray, je), bf16=()))
        for jg, tg, gl, e in zip(_flat(jcg), _flat(tcg), _flat(_to_jax(g)),
                                 _flat(je)):
            bf16 = jg.dtype == jnp.bfloat16
            assert tg.dtype == (torch.bfloat16 if bf16 else torch.float32)
            gf = (_np(gl) + _np(e)).astype(np.float64)
            c = cfg.clip_sigmas * gf.std()
            s = (np.clip(gf, -c, c) + c) * (n_levels - 1) / (2 * c)
            at_edge = np.abs(s - np.floor(s) - 0.5) < 1e-4
            unit = c * (2.0 ** -7 if bf16 else 2.0 ** -20)
            close = np.abs(_np(jg) - _np(tg)) <= unit
            assert np.all(close | at_edge), \
                f"step {step}: {np.sum(~close & ~at_edge)} values apart"
        # the mean squared residual: float32 sums in two orders
        assert np.isclose(float(tm["grad_compress_mse"]),
                          float(jm["grad_compress_mse"]), rtol=1e-5, atol=0)
        # the port's own chain
        tg_in = _to_torch(g)
        cg, te_next, _ = compress_grads(cfg, tg_in, te)
        for gl, e, c_, ne in zip(_flat(tg_in), _flat(te), _flat(cg),
                                 _flat(te_next)):
            gf = gl.to(torch.float32) + e
            assert c_.dtype == gl.dtype
            assert torch.equal(ne, gf - c_.to(torch.float32))
            # cg + new_e == gf up to the float32 rounding of the residual
            # itself (a residual taken before the cast would miss by the
            # cast's rounding, up to 2**-9 of cg under bf16)
            miss = np.abs(_np(c_).astype(np.float64) + _np(ne) - _np(gf))
            assert np.all(miss <= np.spacing(np.abs(_np(ne))) / 2)
        je, te = je_new, te_next


def test_compress_grads_disabled_and_wire_ratio():
    g = {"w": torch.arange(8.0)}
    cg, e, m = compress_grads(GradCompressionConfig(enabled=False), g,
                              init_error_feedback(g))
    assert cg is g and float(m["grad_compress_mse"]) == 0.0
    for n in (2, 4, 16, 256):
        from repro.compression import wire_bytes_ratio as jratio
        assert wire_bytes_ratio(GradCompressionConfig(n_levels=n)) == \
            jratio(JGradCfg(n_levels=n))
