"""The split runtime across ranks (``make_split_decode_step(...,
ctx=...)``): edge and cloud stages as gloo CPU processes of a ("pod",
"data", "model") mesh, the payload crossing with send/recv.

Ranks are spawned as ``tests/test_torch_context.py`` spawns them (a
deadline on the join, a 60 s collective timeout).  Each rank writes what
it computed to an npz the test reads; the one-process runtime runs in
the test's own process.  Reduced configs, vocabulary 64, float32, batch
4, 3 decode steps on seeded tokens.

* (2, 1, 1), reduced codeqwen1.5-7b at 2 and 3 layers (3 puts a tail
  layer on the cloud), every transport and codec case of
  ``tests/test_torch_compression.py``'s ``CASES``: logits, caches,
  payload bytes and ``rate_bits`` identical in every bit to the
  one-process runtime on the same weights, on both ranks.
* (2, 2, 1), reduced codeqwen1.5-7b at 4 layers on the reference's
  weights, every case: each data rank's payload, caches and logits rows
  identical in every bit to the one-process runtime run on its block of
  rows alone; the logits whole and identical on all four ranks;
  ``rate_bits`` equal to the rate of the two blocks' index counts summed
  (exact), and against the reference's (2, 2, 1) SPMD run (the existing
  reference subprocess, given ``models221``): rate within 1e-6, logits
  within 1e-3 with the bfloat16 rounding-edge rule of
  ``test_torch_compression.py``, payload indices equal but where the
  reference's boundary value sits at a bin edge (the runs then part and
  the comparison stops, as there).
* (2, 1, 2), reduced qwen3-moe-235b-a22b (8 experts, top-2), 1 + 1
  layers, 4 experts a rank in each stage, ``raw`` and ``packed`` N=4:
  the two ``model`` ranks of each stage give identical payloads and
  logits in every bit; the unrounded logits within the expert-parallel
  MoE's tolerance (rtol = atol = 1e-5, ``tests/test_torch_moe_ep.py``)
  of the one-process runtime; payload indices equal except where the
  one-process boundary value lies within 1e-5 of a bin edge (counted).
* In one process: ``payload_bytes`` (the size a cloud rank receives)
  is the wire tensor's bytes plus the rate's, for every case; the
  step's parts are tracing spans, in order, each syncing through the
  tracer's hook as it opens and closes.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.compression import split_runtime as SR
from repro_torch.configs import get_config, reduced
from repro_torch.core.codec import FeatureCodec
from repro_torch.kernels.ops import unpack_bytes
from repro_torch.launch.mesh import Mesh, device_mesh
from repro_torch.models import DistContext, split_params_from_numpy
from repro_torch.models import transformer as T
from repro_torch.models.convert import to_numpy
from repro_torch.tree import leaves
from test_torch_context import spawn

pytestmark = pytest.mark.timeout(300)

VOCAB, BATCH, MAX_SEQ, STEPS = 64, 4, 16, 3
NAMES = ("pod", "data", "model")
# the codec cases of test_torch_compression.py (checked there against
# its CASES; that module imports JAX, which the ranks do not need)
CASE_NAMES = ("raw", "quantized_f16", "packed-2", "packed-4", "packed-16",
              "packed-256", "packed-channel-g8")
LAYERS_211 = (2, 3)
MOE_ARCH, MOE_CASES = "qwen3-moe-235b-a22b", ("raw", "packed-4")
EP_TOL = dict(rtol=1e-5, atol=1e-5)
EDGE_TOL = 1e-5          # a boundary value this close to a bin edge


def _cfg(layers: int, arch: str = "codeqwen1.5-7b"):
    return dataclasses.replace(reduced(get_config(arch), layers=layers),
                               vocab_size=VOCAB)


def _tokens(seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, VOCAB, (STEPS, BATCH)).astype(np.int64)


def _codecs() -> dict:
    """Every case's transport and calibrated torch-backend codec (None
    for ``raw``), as test_torch_compression.py builds them."""
    import test_torch_compression as TC
    from repro_torch.core import CodecConfig, calibrate
    assert tuple(TC.CASES) == CASE_NAMES
    out = {}
    for case, (transport, kw) in TC.CASES.items():
        data = TC._samples() if kw.get("granularity") == "channel" else None
        out[case] = (transport, None if transport == "raw" else calibrate(
            CodecConfig(backend="torch", **TC._codec_kw(kw)), samples=data))
    return out


@dataclasses.dataclass
class Recording(FeatureCodec):
    """A codec keeping what its split step sends: the boundary
    activations it quantizes, its index counts and the payload (packed
    bytes, or the indices at full width)."""

    sent: list = dataclasses.field(default_factory=list)

    def quantize_with_counts(self, x, want_deq=False):
        idx, deq, hist = super().quantize_with_counts(x, want_deq)
        self.sent.append({"y": x.numpy().copy(), "payload": idx.numpy(),
                          "counts": hist.numpy().copy()})
        return idx, deq, hist

    def quantize_packed_with_counts(self, x):
        packed, hist = super().quantize_packed_with_counts(x)
        self.sent.append({"y": x.numpy().copy(), "payload": packed.numpy(),
                          "counts": hist.numpy().copy()})
        return packed, hist

    def pack(self, idx):
        out = super().pack(idx)
        self.sent[-1]["payload"] = out.numpy()
        return out


def _recording(codec):
    return None if codec is None else Recording(
        **{f.name: getattr(codec, f.name)
           for f in dataclasses.fields(FeatureCodec)})


def _run(cfg, params, codec, transport, tokens, ctx=None, unrounded=None):
    """STEPS split steps on ``tokens`` (STEPS, B): {"logits", "rate",
    "payload"(, "y", "counts")} per step, stacked, and the caches (flat
    ``cache/<stage>/...`` keys).  ``unrounded``: a list that takes the
    unrounded logits of each step's head, where this process runs one."""
    codec = _recording(codec)
    step = SR.make_split_decode_step(cfg, codec, transport=transport,
                                     edge_device="cpu", cloud_device="cpu",
                                     ctx=ctx)
    caches = SR.init_split_cache(cfg, tokens.shape[1], MAX_SEQ,
                                 edge_device="cpu", cloud_device="cpu",
                                 ctx=ctx)
    logits_out = T._logits_out

    def record(*a):
        out = logits_out(*a)
        if unrounded is not None:
            unrounded.append(out[:, 0].numpy().copy())
        return out

    T._logits_out = record
    try:
        rec = {"logits": [], "rate": []}
        for pos in range(STEPS):
            logits, caches, rate = step(params, torch.from_numpy(tokens[pos]),
                                        caches, pos)
            rec["logits"].append(logits.numpy())
            rec["rate"].append(np.float32(rate))
    finally:
        T._logits_out = logits_out
    out = {k: np.stack(v) for k, v in rec.items()}
    if codec is not None and codec.sent:
        for k in ("payload", "y", "counts"):
            out[k] = np.stack([s[k] for s in codec.sent])
    for stage, cache in zip(("edge", "cloud"), caches):
        if cache is not None:
            out.update({f"cache/{stage}/" + "/".join(map(str, p)): to_numpy(t)
                        for p, t in leaves(cache)})
    return out


def _ctx(sizes):
    return DistContext(device_mesh(Mesh(sizes, NAMES), "cpu"), ("data",))


def _save(out_dir, rank: int, res: dict) -> None:
    np.savez(out_dir / f"rank{rank}.npz", **res)


def _load(out_dir, world: int) -> list[dict]:
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(world)]


def _part(res: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in res.items()
            if k.startswith(prefix)}


def _assert_same(got: dict, want: dict, keys) -> None:
    for k in keys:
        assert got[k].dtype == want[k].dtype and np.array_equal(
            got[k], want[k]), k


# -- (2, 1, 1): every transport and codec case, in every bit -------------------------

def _ranks_211(rank, out_dir, codecs, tokens):
    _refusals(rank, out_dir)
    ctx = _ctx((2, 1, 1))
    with pytest.raises(ValueError, match="dp_axes"):
        SR.init_split_cache(_cfg(2), 4, 8, edge_device="cpu",
                            cloud_device="cpu", ctx=DistContext(
                                ctx.mesh, ("pod", "data")))
    res = {}
    for layers in LAYERS_211:
        cfg = _cfg(layers)
        params = SR.init_split_params(cfg, torch.Generator().manual_seed(0),
                                      edge_device="cpu", cloud_device="cpu",
                                      ctx=ctx)
        assert list(params) == [("edge", "cloud")[rank]]
        for case, (transport, codec) in codecs.items():
            run = _run(cfg, params, codec, transport, tokens, ctx)
            res.update({f"L{layers}/{case}/{k}": v for k, v in run.items()})
    _save(out_dir, rank, res)


@pytest.fixture(scope="module")
def ranks_211(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks211")
    codecs = _codecs()
    spawn(_ranks_211, 2, tmp, tmp, codecs, _tokens())
    return codecs, _load(tmp, 2), tmp


@pytest.mark.parametrize("layers", LAYERS_211)
@pytest.mark.parametrize("case", CASE_NAMES)
def test_ranked_split_211_equals_one_process(ranks_211, layers, case):
    codecs, ranks, _ = ranks_211
    transport, codec = codecs[case]
    cfg = _cfg(layers)
    params = SR.init_split_params(cfg, torch.Generator().manual_seed(0),
                                  edge_device="cpu", cloud_device="cpu")
    want = _run(cfg, params, codec, transport, _tokens())
    edge, cloud = (_part(r, f"L{layers}/{case}/") for r in ranks)
    for res in (edge, cloud):
        _assert_same(res, want, ("logits", "rate"))
    if transport == "raw":
        assert "payload" not in edge and "payload" not in want
    else:
        # only the edge quantizes: the cloud's payload is the edge's bytes
        assert "payload" not in cloud
        _assert_same(edge, want, ("payload", "counts"))
    for stage, res in (("edge", edge), ("cloud", cloud)):
        keys = [k for k in want if k.startswith(f"cache/{stage}/")]
        assert keys and {k for k in res if k.startswith("cache/")} \
            == set(keys)
        _assert_same(res, want, keys)


def _refusals(rank, out_dir) -> None:
    """The contexts and codecs the step across ranks refuses; every rank
    builds the same contexts in the same order."""
    cfg = _cfg(2)
    # no pod axis
    ctx = DistContext(device_mesh(Mesh((2, 1), ("data", "model")), "cpu"))
    with pytest.raises(ValueError, match="'pod' axis of two"):
        SR.make_split_decode_step(cfg, None, transport="raw",
                                  edge_device="cpu", cloud_device="cpu",
                                  ctx=ctx)
    # the pods split the batch
    ctx = DistContext(device_mesh(Mesh((1, 2, 1), NAMES), "cpu"),
                      ("pod", "data"))
    with pytest.raises(ValueError, match="'pod' axis of two"):
        SR.init_split_cache(cfg, 4, 8, edge_device="cpu",
                            cloud_device="cpu", ctx=ctx)
    (out_dir / f"refused{rank}").touch()


def test_ranked_split_refuses_bad_contexts(ranks_211, tmp_path_factory):
    """Without a pod axis of two ranks, and with the pods splitting the
    batch (both checked on the (2, 1, 1) ranks before their runs)."""
    _, _, out_dir = ranks_211
    assert all((out_dir / f"refused{r}").exists() for r in range(2))


# -- (2, 2, 1): row blocks, and the reference's SPMD run -----------------------------

TAG_221 = "R221"
# the tiled codec whose tiles span rows (test_torch_compression.py's
# ROW_TILE_CASES): the edge ranks of a data group gather their rows
TILE_CASE = "packed-tile-rows"


def _tile_codec():
    import test_torch_compression as TC
    from repro_torch.core import CodecConfig, calibrate
    transport, kw = TC.ROW_TILE_CASES[TILE_CASE]
    return transport, calibrate(CodecConfig(backend="torch", **kw),
                                samples=TC._tile_samples())


def _ranks_221(rank, out_dir, tree, codecs, tokens):
    ctx = _ctx((2, 2, 1))
    cfg = _cfg(4)
    params = split_params_from_numpy(cfg, tree, edge_device="cpu",
                                     cloud_device="cpu", ctx=ctx)
    res = {}
    for case, (transport, codec) in codecs.items():
        unrounded = []
        run = _run(cfg, params, codec, transport, tokens[case], ctx,
                   unrounded=unrounded)
        if case == TILE_CASE and unrounded:
            run["unrounded"] = np.stack(unrounded)
        res.update({f"{case}/{k}": v for k, v in run.items()})
    _save(out_dir, rank, res)


@pytest.fixture(scope="module")
def ranks_221(tmp_path_factory):
    """The reference's (2, 2, 1) runs (one subprocess), then the four
    ranks on its weights and tokens."""
    import test_torch_compression as TC
    tmp = tmp_path_factory.mktemp("ranks221")
    names = list(CASE_NAMES) + [TILE_CASE]
    ref = TC.run_reference(tmp, [], [(TAG_221, "codeqwen1.5-7b", 4, names)])
    codecs = {**_codecs(), TILE_CASE: _tile_codec()}
    tokens = {c: ref[f"{TAG_221}/{c}/tokens"].astype(np.int64)
              for c in names}
    spawn(_ranks_221, 4, tmp, tmp, TC._tree(ref, TAG_221), codecs, tokens)
    return ref, codecs, tokens, _load(tmp, 4)


@pytest.mark.parametrize("case", CASE_NAMES)
def test_ranked_split_221_rows_and_reference(ranks_221, case):
    import test_torch_compression as TC
    ref, codecs, tokens, ranks = ranks_221
    transport, codec = codecs[case]
    cfg = _cfg(4)
    params = split_params_from_numpy(cfg, TC._tree(ref, TAG_221),
                                     edge_device="cpu", cloud_device="cpu")
    n = BATCH // 2
    blocks, unrounded = [], [[], []]
    for d in range(2):
        blocks.append(_run(cfg, params, codec, transport,
                           tokens[case][:, d * n:(d + 1) * n],
                           unrounded=unrounded[d]))
    got = [_part(r, f"{case}/") for r in ranks]
    # the logits whole and identical on every rank, each block's rows its
    # one-process run's
    for res in got:
        _assert_same(res, got[0], ("logits", "rate"))
    logits = got[0]["logits"]
    for d, block in enumerate(blocks):
        assert np.array_equal(logits[:, d * n:(d + 1) * n], block["logits"])
        edge, cloud = got[d], got[2 + d]       # pod-major global ranks
        for stage, res in (("edge", edge), ("cloud", cloud)):
            keys = [k for k in block if k.startswith(f"cache/{stage}/")]
            _assert_same(res, block, keys)
        if transport != "raw":
            _assert_same(edge, block, ("payload",))
    want = ref[f"{TAG_221}/{case}/logits"]
    for pos in range(STEPS):
        if transport != "raw":
            # the whole batch's rate: the blocks' counts summed
            counts = torch.from_numpy(blocks[0]["counts"][pos]
                                      + blocks[1]["counts"][pos])
            whole = (BATCH,) + blocks[0]["y"].shape[2:]
            assert got[0]["rate"][pos] == np.float32(float(
                codec.rate_from_counts(counts, whole)))
            idx = torch.from_numpy(np.concatenate([
                TC._indices(b["payload"][pos], codec, b["y"][pos].size)
                for b in blocks]).astype(np.int32))
            ref_wire = ref[f"{TAG_221}/{case}/payload"][pos]
            wire = idx.numpy() if transport == "quantized_f16" \
                else codec.pack(idx).numpy()
            if not TC._same_or_at_edge(
                    wire.reshape(ref_wire.shape), ref_wire,
                    ref[f"{TAG_221}/{case}/y"][pos], codec):
                # an index crossed a bin edge: the runs part
                print(f"(2, 2, 1) {case}: held to the reference for {pos} "
                      f"of {STEPS} steps, then an index at a bin edge")
                return
        assert abs(float(got[0]["rate"][pos])
                   - float(ref[f"{TAG_221}/{case}/rate"][pos])) \
            <= TC.RATE_ATOL
        port_unrounded = np.concatenate([u[pos] for u in unrounded])
        assert np.all(TC._bf16_rounding_apart(
            logits[pos], want[pos], port_unrounded)), \
            f"logits differ by {np.abs(logits[pos] - want[pos]).max()}"


def test_ranked_split_221_tiles_spanning_rows(ranks_221):
    """A tiled codec whose tiles span rows under a data split: each edge
    rank gathers its data group's boundary rows and quantizes the whole
    batch's tiles, as the reference does under GSPMD, and sends its peer
    the whole batch's payload.  Both edge ranks send the same bytes, the
    bytes of the one-process runtime's quantizer on the gathered boundary;
    every rank returns the same logits and rate.  Against the reference's
    (2, 2, 1) SPMD run by the rule of the other cases: payload indices
    equal but where the reference's boundary value sits at a bin edge,
    ``rate_bits`` within 1e-6, logits within 1e-3 with the bfloat16
    rounding-edge rule."""
    import test_torch_compression as TC
    ref, codecs, tokens, ranks = ranks_221
    transport, codec = codecs[TILE_CASE]
    assert SR.gathers_rows(codec, transport)
    got = [_part(r, f"{TILE_CASE}/") for r in ranks]
    for res in got:
        _assert_same(res, got[0], ("logits", "rate"))
    edge = got[0]
    assert "payload" not in got[2] and "payload" not in got[3]
    _assert_same(got[1], edge, ("payload", "y", "counts"))
    assert edge["y"].shape[1] == BATCH
    for pos in range(STEPS):
        y = torch.from_numpy(edge["y"][pos])
        # the whole boundary's one-process quantizer, pack and rate
        idx = codec.quantize(y)
        assert np.array_equal(edge["payload"][pos],
                              codec.pack(idx.reshape(-1)).numpy())
        assert edge["rate"][pos] == np.float32(float(
            codec.rate_from_indices(idx, y.shape)))
        assert SR.payload_bytes(_cfg(4), codec, transport, BATCH) \
            == edge["payload"][pos].size + 4
        ref_wire = ref[f"{TAG_221}/{TILE_CASE}/payload"][pos]
        if not TC._same_or_at_edge(
                edge["payload"][pos].reshape(ref_wire.shape), ref_wire,
                ref[f"{TAG_221}/{TILE_CASE}/y"][pos], codec):
            print(f"(2, 2, 1) {TILE_CASE}: held to the reference for {pos} "
                  f"of {STEPS} steps, then an index at a bin edge")
            return
        assert abs(float(edge["rate"][pos])
                   - float(ref[f"{TAG_221}/{TILE_CASE}/rate"][pos])) \
            <= TC.RATE_ATOL
        # each cloud rank's unrounded logits are its block's rows
        port_unrounded = np.concatenate([got[2]["unrounded"][pos],
                                         got[3]["unrounded"][pos]])
        want = ref[f"{TAG_221}/{TILE_CASE}/logits"][pos]
        assert np.all(TC._bf16_rounding_apart(
            edge["logits"][pos], want, port_unrounded)), \
            f"logits differ by {np.abs(edge['logits'][pos] - want).max()}"


# -- (2, 1, 2): expert parallelism inside each stage ---------------------------------

def _ranks_212(rank, out_dir, codecs, tokens):
    ctx = _ctx((2, 1, 2))
    cfg = _cfg(2, MOE_ARCH)
    params = SR.init_split_params(cfg, torch.Generator().manual_seed(0),
                                  edge_device="cpu", cloud_device="cpu",
                                  ctx=ctx)
    (stage,) = params
    (moe,) = [p["moe"] for p in params[stage]["layers"]]
    assert moe["w1"].shape[0] == cfg.num_experts // 2
    res = {}
    for case in MOE_CASES:
        transport, codec = codecs[case]
        unrounded = []
        run = _run(cfg, params, codec, transport, tokens, ctx,
                   unrounded=unrounded)
        if unrounded:
            run["unrounded"] = np.stack(unrounded)
        res.update({f"{case}/{k}": v for k, v in run.items()})
    _save(out_dir, rank, res)


@pytest.fixture(scope="module")
def ranks_212(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks212")
    codecs = {c: v for c, v in _codecs().items() if c in MOE_CASES}
    spawn(_ranks_212, 4, tmp, tmp, codecs, _tokens(1))
    return codecs, _load(tmp, 4)


def _at_edge(y: np.ndarray, codec) -> np.ndarray:
    """Whether each boundary value lies within EDGE_TOL of a bin edge of
    the per-tensor quantizer."""
    lo, hi = np.float64(codec.cmin), np.float64(codec.cmax)
    step = (hi - lo) / (codec.config.n_levels - 1)
    s = (np.clip(y.astype(np.float64), lo, hi) - lo) / step
    return np.abs(s - np.floor(s) - 0.5) * step <= EDGE_TOL


@pytest.mark.parametrize("case", MOE_CASES)
def test_ranked_split_212_expert_parallel(ranks_212, case):
    codecs, ranks = ranks_212
    transport, codec = codecs[case]
    cfg = _cfg(2, MOE_ARCH)
    params = SR.init_split_params(cfg, torch.Generator().manual_seed(0),
                                  edge_device="cpu", cloud_device="cpu")
    unrounded = []
    want = _run(cfg, params, codec, transport, _tokens(1),
                unrounded=unrounded)
    got = [_part(r, f"{case}/") for r in ranks]
    # replicas: the model ranks of each stage, and every rank's logits
    for res in got:
        _assert_same(res, got[0], ("logits", "rate"))
    edge, cloud = got[:2], got[2:]
    _assert_same(cloud[1], cloud[0], ("unrounded",))
    if transport != "raw":
        _assert_same(edge[1], edge[0], ("payload",))
        n = want["y"][0].size
        apart = 0
        for pos in range(STEPS):
            a = unpack_bytes(edge[0]["payload"][pos],
                             codec.bits_per_index())[:n]
            b = unpack_bytes(want["payload"][pos],
                             codec.bits_per_index())[:n]
            diff = a != b
            assert np.all(_at_edge(want["y"][pos].reshape(-1)[diff],
                                   codec)), \
                f"step {pos}: indices differ away from a bin edge"
            apart += int(diff.sum())
        print(f"(2, 1, 2) {case}: {apart} of {STEPS * n} payload indices "
              f"differ from the one-process runtime's, all at bin edges")
        assert got[0]["rate"].shape == want["rate"].shape
    np.testing.assert_allclose(cloud[0]["unrounded"], np.stack(unrounded),
                               **EP_TOL)


# -- what crosses, and the step's spans ----------------------------------------------

@pytest.mark.parametrize("case", CASE_NAMES)
def test_payload_bytes_is_what_crosses(case):
    """``payload_bytes``, the size a cloud rank receives into, is the
    bytes of the one-process step's wire tensor -- the activations, the
    int32 indices or the packed lanes -- plus the rate's 4 bytes unless
    ``raw``, at every batch of the cases' boundary."""
    transport, codec = _codecs()[case]
    cfg = _cfg(2)
    params = SR.init_split_params(cfg, torch.Generator().manual_seed(0),
                                  edge_device="cpu", cloud_device="cpu")
    for batch in (1, BATCH):
        out = _run(cfg, params, codec, transport, _tokens()[:, :batch])
        if transport == "raw":
            wire = batch * cfg.d_model * T.torch_dtype(cfg).itemsize
        else:
            wire = out["payload"][0].nbytes + 4
        assert SR.payload_bytes(cfg, codec, transport, batch) == wire


def test_split_step_parts_are_traced():
    """With tracing on, each one-process step records its parts as spans
    in order -- ``edge_stage``, ``crossing``, ``cloud_stage`` -- and a
    tracer's ``sync`` runs as each span opens and closes; with tracing
    off the step records nothing."""
    from repro_torch.obs.tracing import tracer
    transport, codec = _codecs()["packed-4"]
    cfg = _cfg(2)
    params = SR.init_split_params(cfg, torch.Generator().manual_seed(0),
                                  edge_device="cpu", cloud_device="cpu")
    tr = tracer()
    was = tr.enabled
    syncs = []
    tr.configure(enabled=False)
    tr.reset()
    _run(cfg, params, codec, transport, _tokens())
    assert tr.snapshot_events() == []
    tr.configure(enabled=True, sync=lambda: syncs.append(1))
    try:
        _run(cfg, params, codec, transport, _tokens())
        events = tr.snapshot_events()
    finally:
        tr.configure(enabled=was, sync=None)
        tr.reset()
    assert [e["stage"] for e in events] == \
        ["edge_stage", "crossing", "cloud_stage"] * STEPS
    assert len(syncs) == 2 * len(events)
    for a, b in zip(events, events[1:]):
        assert a["t_start"] + a["dur_s"] <= b["t_start"] + 1e-3
