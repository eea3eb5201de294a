"""The port's distribution context (``repro_torch.models.context``) on
gloo CPU ranks: the process groups of a mesh, the collectives of the
expert-parallel MoE with their backward, the train step's reductions,
the dp x tp train step against the one-device step, the trainer's
checkpoints across tp sizes and the JAX package, and ``launch.train
--distributed``.

Ranks are processes spawned by the test (:func:`spawn`): a ``file://``
rendezvous under the test's ``tmp_path``, collectives that time out
after 60 s, a deadline on the join, and ``destroy_process_group`` at the
end of every rank.  Each rank writes what it computed to an npz the test
reads.

Tolerances: layouts, routes and the collectives' values exact; the
global norm over sharded leaves within rtol 1e-6 of the whole tree's
(float32 sums in another order); the dp=2 x tp=2 train step's loss and
norm within rtol 1e-5, its first moments within rtol 1e-5, atol 1e-7,
and its parameters within rtol 1e-5, atol 1e-6 (the port's trainer
tests' tolerance; see ``ATOL``) of the one-device step on the same
global batch; trainer states after a checkpoint crossed tp
sizes within rtol 1e-5, atol 1e-6 of the run that never did; gradient
compression under tp=2: see its test.
"""

import dataclasses
import datetime
import os
import shutil
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import models as tm
from repro_torch import serving as tm_serving
from repro_torch.configs import get_config, reduced
from repro_torch.data import DataConfig
from repro_torch.launch.mesh import Mesh, device_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import DistContext
from repro_torch.models import context as C
from repro_torch.models import moe as MOE
from repro_torch.models.convert import to_numpy
from repro_torch.optim import global_norm, init_opt_state
from repro_torch.train import Trainer, TrainerConfig
from repro_torch.train import checkpoint as ckpt
from repro_torch.tree import leaves

pytestmark = pytest.mark.timeout(300)

SPAWN_DEADLINE_S = 240
PG_TIMEOUT = datetime.timedelta(seconds=60)


# -- ranks ---------------------------------------------------------------------------

def _rank_main(rank, world, init, fn, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world, timeout=PG_TIMEOUT)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, tmp_path, *args) -> None:
    """Run ``fn(rank, *args)`` on ``world`` gloo CPU ranks (``fn`` a
    module-level function); fails if a rank raises or the ranks are not
    done within SPAWN_DEADLINE_S."""
    init = tmp_path / f"pg-{fn.__name__}-{world}"
    pc = torch.multiprocessing.start_processes(
        _rank_main, args=(world, str(init), fn, args), nprocs=world,
        join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_DEADLINE_S
    try:
        while not pc.join(timeout=5):
            if time.monotonic() > deadline:
                raise AssertionError(f"{fn.__name__}: {world} ranks not done "
                                     f"in {SPAWN_DEADLINE_S} s")
    finally:
        for p in pc.processes:
            if p.is_alive():
                p.kill()
            p.join(10)
    assert not any(p.is_alive() for p in pc.processes)


def _flat(tree, prefix: str) -> dict:
    return {prefix + "/".join(str(k) for k in path): to_numpy(t)
            for path, t in leaves(tree)}


def _moe_cfg(**kw):
    """Reduced qwen3-moe-235b-a22b, float32: 8 experts, top-2, d_model 64,
    two MoE layers (drop-free: capacity factor 8)."""
    return dataclasses.replace(reduced(get_config("qwen3-moe-235b-a22b")),
                               **kw)


# -- no mesh -------------------------------------------------------------------------

def test_context_without_a_mesh_is_one_device():
    for ctx in (DistContext(), None):
        assert not C.sharded(ctx)
        assert C.expert_slice(ctx, 8) == slice(0, 8)
    ctx = DistContext()
    assert (ctx.tp_size, ctx.dp_size, ctx.tp_rank, ctx.dp_rank, ctx.size) \
        == (1, 1, 0, 0, 1)
    assert ctx.tp_group is None and ctx.dp_group is None
    assert (ctx.pod_rank, ctx.pod_peer) == (0, None)
    t = torch.arange(6.0).reshape(3, 2)
    assert C.dp_rows(t, ctx) is t and C.dp_rows(None, ctx) is None
    g = {"w": t}
    assert C.average_grads(g, ctx) is g and C.gather_experts(g, ctx) is g
    assert C.mesh_mean(t, ctx) is t and C.tp_sum(t, ctx) is t


@pytest.mark.parametrize("path,want", [
    (("layers", 0, "moe", "w1"), True), (("opt", "mu", "layers", 3, "moe",
                                          "w2"), True),
    (("layers", 0, "moe", "router"), False), (("layers", 0, "mlp", "w1"),
                                              False),
    (("embed", "table"), False)])
def test_expert_leaves(path, want):
    assert C.is_expert_leaf(path) is want
    assert C.is_expert_leaf("/".join(map(str, path)).split("/")) is want


def test_moe_apply_without_a_mesh_is_moe_local():
    cfg = _moe_cfg()
    p = MOE.init_moe(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.randn((2, 8, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    want = MOE.moe_local(x.reshape(16, -1), p, cfg).reshape(x.shape)
    for ctx in (None, DistContext()):
        assert torch.equal(MOE.moe_apply(x, p, cfg, ctx), want)


# -- groups and collectives on a (pod, data, model) = (2, 1, 2) mesh -----------------

E, CAP, D = 4, 3, 2          # the all_to_all's dispatch slots


def _context_ranks(rank, out_dir):
    ctx = DistContext(device_mesh(Mesh((2, 1, 2), ("pod", "data", "model")),
                                  "cpu"), ("pod", "data"))
    res = {"tp_ranks": dist.get_process_group_ranks(ctx.tp_group),
           "dp_ranks": dist.get_process_group_ranks(ctx.dp_group),
           "coord": [ctx.dp_rank, ctx.tp_rank, ctx.dp_size, ctx.tp_size,
                     ctx.size],
           "pod": [ctx.pod_rank, ctx.pod_peer]}
    gen = torch.Generator().manual_seed(100 + rank)
    # the tiled all_to_all and its backward
    buf = (1000.0 * rank + torch.arange(E * CAP * D, dtype=torch.float32)
           ).reshape(E, CAP, D).requires_grad_()
    h = C.to_experts(buf, ctx)
    r = torch.randn(h.shape, generator=gen)
    (res["g_buf"],) = torch.autograd.grad((h * r).sum(), buf)
    res["h"], res["r"] = h.detach(), r
    res["back"] = C.to_tokens(h.detach(), ctx)
    # chunk and gather along the sequence; partial sums; replica gradients
    x = torch.randn((2, 4, 3), generator=torch.Generator().manual_seed(0)) \
        .requires_grad_()
    w = torch.randn((2, 4, 3), generator=torch.Generator().manual_seed(1))
    j = ctx.tp_rank
    y = C.gather_chunks(C.take_chunk(x, ctx, 1) * (j + 1), ctx, 1)
    (res["g_chunk"],) = torch.autograd.grad((y * w).sum(), x)
    res["y"] = y.detach()
    s = C.sum_partials(C.replica_grad(x, ctx) * (j + 1), ctx)
    (res["g_sum"],) = torch.autograd.grad((s * w).sum(), x)
    res["s"] = s.detach()
    res["rows4"] = C.dp_rows(torch.arange(4), ctx)
    res["rows3"] = C.dp_rows(torch.arange(3), ctx)
    # each rank's block, tagged by its rank, gathered over dp
    res["gathered_rows"] = C.gather_rows(
        (100 * rank + C.dp_rows(torch.arange(4), ctx)).reshape(2, 1), ctx)
    # the train step's reductions
    full = torch.randn((4, 3), generator=torch.Generator().manual_seed(2))
    rep = torch.randn((5,), generator=torch.Generator().manual_seed(3))
    mine = full[C.expert_slice(ctx, 4)].clone()
    tree = {"layers": [{"moe": {"w1": mine}, "mlp": {"w1": rep}}]}
    res["norm"] = global_norm(tree, ctx)
    res["gathered"] = C.gather_experts(tree, ctx)["layers"][0]["moe"]["w1"]
    g = {"layers": [{"moe": {"w1": torch.full((2, 2), float(rank))},
                     "mlp": {"w1": torch.full((2,), float(rank))}}]}
    avg = C.average_grads(g, ctx)["layers"][0]
    res["avg_expert"], res["avg_rep"] = avg["moe"]["w1"], avg["mlp"]["w1"]
    res["mean"] = C.mesh_mean(torch.tensor(float(rank)), ctx)
    np.savez(out_dir / f"ctx{rank}.npz",
             **{k: np.asarray(v) for k, v in res.items()})


@pytest.fixture(scope="module")
def context_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ctx")
    spawn(_context_ranks, 4, tmp, tmp)
    return [dict(np.load(tmp / f"ctx{r}.npz")) for r in range(4)]


def test_mesh_groups_order_dp_axes_pod_major(context_ranks):
    for rank, res in enumerate(context_ranks):
        pod, j = divmod(rank, 2)
        assert res["tp_ranks"].tolist() == [2 * pod, 2 * pod + 1]
        assert res["dp_ranks"].tolist() == [j, 2 + j]
        assert res["coord"].tolist() == [pod, j, 2, 2, 4]
        # the peer on the other pod: the same data and model coordinates
        assert res["pod"].tolist() == [pod, 2 * (1 - pod) + j]
        assert res["rows4"].tolist() == [2 * pod, 2 * pod + 1]
        assert res["rows3"].tolist() == [0, 1, 2]


def test_gather_rows_inverts_dp_rows(context_ranks):
    """``gather_rows`` concatenates the dp group's blocks in dp-rank order
    (pod-major): the global batch from every rank's ``dp_rows``."""
    for rank, res in enumerate(context_ranks):
        j = rank % 2
        # the dp group of model coordinate j holds global ranks j, 2 + j
        assert res["gathered_rows"].reshape(-1).tolist() == \
            [100 * j, 100 * j + 1, 100 * (2 + j) + 2, 100 * (2 + j) + 3]


def test_all_to_all_is_the_tiled_layout_and_its_own_adjoint(context_ranks):
    """Rank j's (E/M, M*cap, d) holds, at slot ``src*cap + c`` of its
    expert ``e``, sender ``src``'s slot ``c`` of expert ``j*E/M + e``
    (the reference's tiled ``all_to_all(split_axis=0, concat_axis=1)``);
    the backward sends each gradient back to the slot it came from."""
    e_loc = E // 2
    for pod in range(2):
        bufs = [(1000.0 * (2 * pod + s) + np.arange(E * CAP * D,
                                                     dtype=np.float32)
                 ).reshape(E, CAP, D) for s in range(2)]
        for j in range(2):
            res = context_ranks[2 * pod + j]
            want = np.concatenate([b[j * e_loc:(j + 1) * e_loc]
                                   for b in bufs], axis=1)
            np.testing.assert_array_equal(res["h"], want)
            np.testing.assert_array_equal(res["back"], bufs[j])
            rs = [context_ranks[2 * pod + t]["r"] for t in range(2)]
            want_g = np.concatenate([r[:, j * CAP:(j + 1) * CAP]
                                     for r in rs], axis=0)
            np.testing.assert_array_equal(res["g_buf"], want_g)


def test_chunk_gather_and_partial_sums_count_gradients_once(context_ranks):
    x = torch.randn((2, 4, 3), generator=torch.Generator().manual_seed(0))
    w = torch.randn((2, 4, 3), generator=torch.Generator().manual_seed(1))
    scale = torch.tensor([1.0, 1.0, 2.0, 2.0])[None, :, None]
    for res in context_ranks:
        np.testing.assert_array_equal(res["y"], (x * scale).numpy())
        np.testing.assert_array_equal(res["g_chunk"], (w * scale).numpy())
        np.testing.assert_array_equal(res["s"], (x * 3).numpy())
        np.testing.assert_array_equal(res["g_sum"], (w * 3).numpy())


def test_train_step_reductions(context_ranks):
    full = torch.randn((4, 3), generator=torch.Generator().manual_seed(2))
    rep = torch.randn((5,), generator=torch.Generator().manual_seed(3))
    want = global_norm({"a": full, "b": rep})
    for rank, res in enumerate(context_ranks):
        pod, j = divmod(rank, 2)
        np.testing.assert_allclose(res["norm"], want.numpy(), rtol=1e-6)
        np.testing.assert_array_equal(res["gathered"], full.numpy())
        # experts over the dp group (ranks j, 2 + j), the rest over all
        np.testing.assert_array_equal(res["avg_expert"],
                                      np.full((2, 2), j + 1.0))
        np.testing.assert_array_equal(res["avg_rep"], np.full((2,), 1.5))
        assert float(res["mean"]) == 1.5
    assert len({float(r["norm"]) for r in context_ranks}) == 1


# -- the dp x tp train step ----------------------------------------------------------

# parameters: AdamW's first step moves each element by about lr whatever
# its gradient's size, so a near-zero gradient summed in another order
# can move it by up to lr * 1e-3 more; first moments are linear in the
# gradients
ATOL = {"p": 1e-6, "mu": 1e-7}


def _train_step_ranks(rank, out_dir, tokens):
    cfg = _moe_cfg()
    ctx = DistContext(device_mesh(Mesh((2, 2), ("data", "model")), "cpu"))
    params = tm.shard_experts(cfg, tm.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"), ctx)
    new_p, new_o, m = make_train_step(cfg, ctx=ctx)(
        params, init_opt_state(params), {"tokens": torch.from_numpy(tokens)})
    np.savez(out_dir / f"step{rank}.npz", loss=m["loss"].numpy(),
             grad_norm=m["grad_norm"].numpy(), **_flat(new_p, "p/"),
             **_flat(new_o["mu"], "mu/"))


def test_dp_tp_train_step_equals_the_one_device_step(tmp_path):
    """dp=2 x tp=2 over the global batch of 4 rows: each rank trains its 2
    rows with its 4 of 8 experts; the update equals the one-device step's
    and every replicated leaf is identical in every bit on all ranks."""
    cfg = _moe_cfg()
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 16)).astype(np.int32)
    spawn(_train_step_ranks, 4, tmp_path, tmp_path, tokens)
    params = tm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    want_p, want_o, want_m = make_train_step(cfg)(
        params, init_opt_state(params), {"tokens": torch.from_numpy(tokens)})
    want = {**_flat(want_p, "p/"), **_flat(want_o["mu"], "mu/")}
    got = [dict(np.load(tmp_path / f"step{r}.npz")) for r in range(4)]
    for rank, res in enumerate(got):
        j = rank % 2
        np.testing.assert_allclose(res["loss"], want_m["loss"].numpy(),
                                   rtol=1e-5)
        np.testing.assert_allclose(res["grad_norm"],
                                   want_m["grad_norm"].numpy(), rtol=1e-5)
        for key, arr in want.items():
            if C.is_expert_leaf(key.split("/")):
                n = arr.shape[0] // 2
                arr = arr[j * n:(j + 1) * n]
            else:
                assert np.array_equal(res[key], got[0][key]), key
            np.testing.assert_allclose(res[key], arr, rtol=1e-5,
                                       atol=ATOL[key.split("/")[0]],
                                       err_msg=key)
    assert len({float(r["loss"]) for r in got}) == 1


# -- gradient compression under tp > 1 -----------------------------------------------

GC_LEVELS = 16           # 4-bit gradients


def _compressed_step(cfg, ctx, tokens, ckpt_dir) -> dict:
    """One ``Trainer`` step with 4-bit gradient compression on the global
    batch ``tokens``: the grad_compress_mse, the new parameters, and each
    stacked leaf's clip range, compressor input and reconstruction (this
    rank's slice of an expert stack), recorded at the quantizer."""
    from repro_torch.compression import GradCompressionConfig
    from repro_torch.compression import grad_compression as GC
    from repro_torch.models.convert import stack_layers
    tr = Trainer(cfg, TrainerConfig(
        steps=1, warmup_steps=1, ckpt_dir=str(ckpt_dir),
        grad_compression=GradCompressionConfig(n_levels=GC_LEVELS)),
        DataConfig(vocab_size=cfg.vocab_size, batch=tokens.shape[0],
                   seq_len=tokens.shape[1]), ctx=ctx, device="cpu")
    state = tr.init_state()
    seen = []
    quantize = GC._quantize_dequantize

    def record(x, c, n_levels):
        out = quantize(x, c, n_levels)
        seen.append((c.clone(), x.clone(), out))
        return out

    GC._quantize_dequantize = record
    try:
        params, _, _, m = tr._step(state["params"], state["opt"],
                                   state["ef"], {"tokens": tokens}, 0)
    finally:
        GC._quantize_dequantize = quantize
    paths = ["/".join(map(str, p)) for p, _ in
             leaves(stack_layers(cfg, state["params"]))]
    assert len(paths) == len(seen)
    res = {"mse": m["grad_compress_mse"].numpy(), **_flat(params, "p/")}
    for path, (c, x, deq) in zip(paths, seen):
        res.update({f"c/{path}": c.numpy(), f"x/{path}": x.numpy(),
                    f"deq/{path}": deq.numpy()})
    return res


def _compressed_step_ranks(rank, out_dir, dp, tokens):
    ctx = DistContext(device_mesh(Mesh((dp, 2), ("data", "model")), "cpu"))
    res = _compressed_step(_moe_cfg(), ctx, tokens, out_dir / f"ck{rank}")
    np.savez(out_dir / f"gc{rank}.npz", **res)


def _reference_compression(want: dict) -> dict:
    """The JAX package's ``compress_grads`` on the one-device trainer's
    whole stacked compressor inputs (zero error feedback: the first
    step's): each leaf's clip range, as the reference's quantizer is
    given it, its reconstruction, and the grad_compress_mse."""
    import jax
    from repro.compression import GradCompressionConfig as JGradCfg
    from repro.compression import grad_compression as JGC
    from repro.compression import init_error_feedback as jinit_ef

    xs = {k[2:]: v for k, v in want.items() if k.startswith("x/")}
    ranges = {}
    quantize = JGC.uniform.quantize_dequantize

    def record(x, lo, hi, n_levels):
        ranges[len(ranges)] = np.asarray(hi)
        return quantize(x, lo, hi, n_levels)

    JGC.uniform.quantize_dequantize = record
    try:
        cg, _, m = JGC.compress_grads(JGradCfg(n_levels=GC_LEVELS), xs,
                                      jinit_ef(xs))
    finally:
        JGC.uniform.quantize_dequantize = quantize
    # jax.tree visits a dict's keys sorted, as the ranges were recorded
    order = jax.tree_util.tree_flatten_with_path(xs)[0]
    ref = {"mse": np.asarray(m["grad_compress_mse"])}
    for i, (kp, _) in enumerate(order):
        path = kp[0].key
        ref.update({f"c/{path}": ranges[i],
                    f"deq/{path}": np.asarray(cg[path])})
    return ref


@pytest.mark.parametrize("dp", [1, 2])
def test_grad_compression_under_tp_equals_the_one_device_trainer(tmp_path,
                                                                 dp):
    """dp x tp=2 with 4-bit gradient compression: each expert leaf's clip
    range is the whole stack's (its statistics reduced over the tp
    group), so clip ranges and grad_compress_mse agree within rtol 1e-6
    (sums in another order) with the one-device trainer's on the same
    global batch, and each rank's slice of the reconstructions within one
    float32 unit at the range's scale (c * 2^-20: ranges a few units
    apart) except where the compressor input sits at a bin edge (counted);
    parameters within rtol 1e-5, atol 1e-6.  Against the JAX package's
    ``compress_grads`` run on the whole stacked gradients: clip ranges
    and grad_compress_mse within rtol 1e-5, the tolerance of
    test_torch_train.py's comparison with it (its float32 ``jnp.std`` of a
    2^18-element expert stack is up to 4.4e-6 from the float64 value,
    while each rank's range is within rtol 1e-6 of that value, also
    checked), and the reconstructions within one float32 unit at the
    range's scale plus the two ranges' difference (a reconstruction moves
    by at most that much with its range) except at bin edges."""
    cfg = _moe_cfg()
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (4, 16)).astype(np.int32)
    spawn(_compressed_step_ranks, 2 * dp, tmp_path, tmp_path, dp, tokens)
    want = _compressed_step(cfg, None, tokens, tmp_path / "ck")
    ref = _reference_compression(want)
    assert len(ref) == 1 + 2 * sum(k.startswith("x/") for k in want)
    at_edge = {"port": 0, "reference": 0}

    def slice_of(arr, path, j, axis):
        if not C.is_expert_leaf(path.split("/")):
            return arr
        n = arr.shape[axis] // 2
        return np.take(arr, range(j * n, (j + 1) * n), axis=axis)

    def same_deq(key, got, arr, c, x, who, apart=0.0):
        s = (np.clip(x, -c, c) + c) * (GC_LEVELS - 1) / (2 * c)
        edge = np.abs(s - np.floor(s) - 0.5) < 1e-4
        close = np.abs(got.astype(np.float64) - arr) \
            <= c * 2.0 ** -20 + apart
        assert np.all(close | edge), \
            f"{key} against the {who}: {np.sum(~close & ~edge)} values apart"
        at_edge[who] += int(np.sum(~close & edge))

    for rank in range(2 * dp):
        got = dict(np.load(tmp_path / f"gc{rank}.npz"))
        j = rank % 2
        np.testing.assert_allclose(got["mse"], want["mse"], rtol=1e-6)
        np.testing.assert_allclose(got["mse"], ref["mse"], rtol=1e-5)
        for key, arr in want.items():
            if key == "mse":
                continue
            kind, path = key.split("/", 1)
            if kind == "c":
                np.testing.assert_allclose(got[key], arr, rtol=1e-6,
                                           err_msg=key)
                np.testing.assert_allclose(got[key], ref[key], rtol=1e-5,
                                           err_msg=key)
                x = want[f"x/{path}"].astype(np.float64)
                np.testing.assert_allclose(
                    got[key], 4.0 * (x.std() + 1e-12), rtol=1e-6,
                    err_msg=f"{key} against the float64 std")
            elif kind == "p":
                # stacked leaves (L, E, ...), the port's (E, ...)
                np.testing.assert_allclose(got[key], slice_of(arr, path, j, 0),
                                           rtol=1e-5, atol=ATOL["p"],
                                           err_msg=key)
            elif kind == "deq":
                x = slice_of(want[f"x/{path}"], path, j, 1)
                same_deq(key, got[key], slice_of(arr, path, j, 1),
                         np.float64(want[f"c/{path}"]), x, "port")
                c_ref = np.float64(ref[f"c/{path}"])
                same_deq(key, got[key], slice_of(ref[key], path, j, 1),
                         c_ref, x, "reference",
                         abs(np.float64(got[f"c/{path}"]) - c_ref))
    print(f"dp={dp} x tp=2: compressed values that differ at bin edges "
          f"{at_edge}")


# -- the trainer's checkpoints across tp sizes ---------------------------------------

TRAIN_STEPS = 4


def _trainer(cfg, d, ctx=None, **kw):
    return Trainer(cfg, TrainerConfig(steps=TRAIN_STEPS, ckpt_every=2,
                                      ckpt_dir=str(d), warmup_steps=1),
                   DataConfig(vocab_size=cfg.vocab_size, batch=2,
                              seq_len=16),
                   ctx=ctx, device="cpu", **kw)


def _trainer_ranks(rank, root):
    cfg = _moe_cfg()
    ctx = DistContext(device_mesh(Mesh((1, 2), ("data", "model")), "cpu"))
    # from scratch at tp=2, stopped after the step-2 checkpoint (the
    # 4-step run's schedule)
    with pytest.raises(RuntimeError, match="injected failure at step 2"):
        _trainer(cfg, root / "tp2", ctx, fail_at_step=2).run(resume=False)
    # resume tp=1's step 2 at tp=2, in the port's layout and in the
    # reference's
    for d in ("tp1_port", "tp1_ref"):
        state = _trainer(cfg, root / d, ctx).run(resume=True)
        w1 = state["params"]["layers"][0]["moe"]["w1"]
        np.save(root / f"{d}-w1-rank{rank}.npy", w1.numpy())


def _state(d, step):
    return {k: v for k, v in np.load(d / f"step_{step:08d}" /
                                      "arrays.npz").items()}


def _close(a: dict, b: dict, rtol=1e-5, atol=1e-6):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def test_trainer_checkpoints_cross_tp_sizes_and_the_reference(tmp_path):
    """tp=1 trains 4 steps (checkpoints at 2 and 4).  On two ranks: tp=2
    trains 2 steps from scratch and checkpoints whole expert stacks; tp=2
    resumes tp=1's step 2 (the port's layout, and converted to the
    reference's) to step 4.  Then tp=1 resumes tp=2's step 2 to step 4,
    and the reference's ``checkpoint.restore`` reads tp=2's step 2.
    Every step-4 state equals the uninterrupted tp=1 run's."""
    import jax

    from repro.configs import ARCHS, reduced as jreduced
    from repro.train import checkpoint as jckpt
    from test_torch_train import _jstate

    cfg = _moe_cfg()
    _trainer(cfg, tmp_path / "tp1").run(resume=False)
    for d in ("tp1_port", "tp1_ref"):
        os.makedirs(tmp_path / d)
    shutil.copytree(tmp_path / "tp1" / "step_00000002",
                    tmp_path / "tp1_port" / "step_00000002")
    ckpt.save(str(tmp_path / "tp1_ref"), 2, tm.train_state_to_numpy(
        cfg, ckpt.load_tree(str(tmp_path / "tp1"), 2)))
    spawn(_trainer_ranks, 2, tmp_path, tmp_path)

    want2, want4 = _state(tmp_path / "tp1", 2), _state(tmp_path / "tp1", 4)
    _close(_state(tmp_path / "tp2", 2), want2)
    _close(_state(tmp_path / "tp1_port", 4), want4)
    _close(_state(tmp_path / "tp1_ref", 4), want4)
    for rank in range(2):
        for d in ("tp1_port", "tp1_ref"):
            w1 = np.load(tmp_path / f"{d}-w1-rank{rank}.npy")
            np.testing.assert_allclose(
                w1, want4["params/layers/0/moe/w1"][4 * rank:4 * rank + 4],
                rtol=1e-5, atol=1e-6)
    # tp=2's step 2 resumed at tp=1
    shutil.copytree(tmp_path / "tp2", tmp_path / "tp2_then_tp1")
    _trainer(cfg, tmp_path / "tp2_then_tp1").run(resume=True)
    _close(_state(tmp_path / "tp2_then_tp1", 4), want4)
    # ... and read by the reference, converted to its layout
    jcfg = jreduced(ARCHS["qwen3-moe-235b-a22b"])
    ckpt.save(str(tmp_path / "tp2_ref"), 2, tm.train_state_to_numpy(
        cfg, ckpt.load_tree(str(tmp_path / "tp2"), 2)))
    got = jckpt.restore(str(tmp_path / "tp2_ref"), 2, _jstate(jcfg))
    ref_layout = tm.train_state_to_numpy(
        cfg, ckpt.load_tree(str(tmp_path / "tp2"), 2))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref_layout),
                    strict=True):
        assert np.array_equal(np.asarray(a), b)


# -- the engine's slots over dp ranks -----------------------------------------------

ENGINE_LAYERS, ENGINE_MAX_SEQ = 4, 32
# case -> (slots, hookup, codec, (prompt length, new tokens) per request,
# refill_align): ragged requests give epochs and mid-epoch refills; the
# tiled codec's tiles span the boundary's 4 rows in blocks of 2 and pin
# its extent to 4, so its prompts are one token and refills wait for
# position 4 (a (1, 4) prefill); 3 slots do not split over 2 ranks
_RAGGED = [(5, 4), (7, 2), (3, 6), (6, 3), (4, 5), (2, 2)]
ENGINE_CASES = {
    "codec": (4, "codec", "tensor", _RAGGED, 1),
    "tiles_spanning_rows": (4, "codec", "tiles",
                            [(1, 3), (1, 6), (1, 2), (1, 7), (1, 4),
                             (1, 3)], 4),
    "codec_host_fn": (4, "codec_host_fn", "tensor", _RAGGED, 1),
    "undivided": (3, "codec", "tensor", _RAGGED, 1),
}
# logits of the engine on dp = 2 against the one-rank engine's: float32
# matmuls over 2 rows against 4 may round differently (the dp x tp train
# step's tolerance above)
ENGINE_RTOL, ENGINE_ATOL = 1e-5, 1e-6


class _RecordingEngine(tm_serving.ServeEngine):
    """Keeps the whole batch's logits of every prefill and decode step."""

    logits: list
    cache_rows: int | None = None

    def _run(self, fn, toks, cache, *args):
        out = super()._run(fn, toks, cache, *args)
        self.logits.append(out[0].cpu().numpy().copy())
        return out

    def _new_cache(self, batch):
        cache = super()._new_cache(batch)
        if batch == self.slots:
            self.cache_rows = next(leaves(cache))[1].shape[0]
        return cache


def _engine_codec(kind: str, d_model: int, backend: str = "torch"):
    from repro_torch.core import CodecConfig, calibrate
    if kind == "tensor":
        return calibrate(CodecConfig(backend=backend, n_levels=4,
                                     clip_mode="manual", manual_cmin=-2.0,
                                     manual_cmax=2.0))
    return calibrate(CodecConfig(
        backend=backend, n_levels=4, granularity="tile", channel_axis=-1,
        channel_group_size=8, spatial_block_size=2, clip_mode="minmax"),
        samples=np.random.default_rng(0).standard_normal(
            (4, 1, d_model)).astype(np.float32))


def _host_roundtrip_fn(codec):
    def roundtrip(x):
        payloads = list(codec.encode_stream(x, chunk_elems=96))
        recon = codec.decode_stream(payloads).reshape(x.shape)
        return recon, 8.0 * sum(map(len, payloads)) / x.size
    return roundtrip


def _engine_run(case: str, ctx=None, device="cpu") -> dict:
    """One ENGINE_CASES case through the engine on ``device`` (the codec
    on its backend): tokens, rates, counters, retirements, the logits of
    every step and the rows of an epoch's caches."""
    slots, hookup, kind, spec, align = ENGINE_CASES[case]
    dev = torch.device(device)
    cfg = reduced(get_config("codeqwen1.5-7b"), layers=ENGINE_LAYERS)
    params = tm.init_params(cfg, torch.Generator(dev).manual_seed(0),
                            device=dev)
    codec = _engine_codec(kind, cfg.d_model,
                          "cuda" if dev.type == "cuda" else "torch")
    hook = {hookup: codec if hookup == "codec" else _host_roundtrip_fn(codec)}
    eng = _RecordingEngine(cfg, params, slots=slots, max_seq=ENGINE_MAX_SEQ,
                           ctx=ctx, refill_align=align, device=dev, **hook)
    eng.logits = []
    rng = np.random.default_rng(0)
    reqs = [tm_serving.Request(
        prompt=rng.integers(0, cfg.vocab_size, p).astype(np.int32),
        max_new_tokens=n) for p, n in spec]
    eng.generate(reqs)
    counters = {k: v for k, v in eng.counters.items() if "latency" not in k}
    return {"tokens": [r.out_tokens for r in reqs],
            "rate_log": list(eng.rate_log), "counters": counters,
            "retired": [{k: v for k, v in d.items() if k != "latency_s"}
                        for d in eng.latency_log],
            "logits": eng.logits, "cache_rows": eng.cache_rows}


def _engine_ranks(rank, out_dir):
    import pickle
    ctx = DistContext(device_mesh(Mesh((2, 1), ("data", "model")), "cpu"),
                      ("data",))
    res = {case: _engine_run(case, ctx) for case in ENGINE_CASES}
    (out_dir / f"engine{rank}.pkl").write_bytes(pickle.dumps(res))


@pytest.fixture(scope="module")
def engine_ranks(tmp_path_factory):
    import pickle
    tmp = tmp_path_factory.mktemp("engine")
    spawn(_engine_ranks, 2, tmp, tmp)
    return [pickle.loads((tmp / f"engine{r}.pkl").read_bytes())
            for r in range(2)]


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_on_dp_ranks_equals_the_one_rank_engine(engine_ranks, case):
    """``ServeEngine(ctx=)`` on a gloo world of dp = 2: each rank prefills
    and decodes its block of the slots, all-gathers the logits and samples
    the whole batch, so tokens, ``rate_log``, counters and retirements
    equal the one-rank engine's on both ranks, and the logits are within
    ENGINE_RTOL / ENGINE_ATOL; a rank holds caches of its block's rows
    only where dp divides the slots."""
    want = _engine_run(case)
    slots = ENGINE_CASES[case][0]
    for got in (r[case] for r in engine_ranks):
        assert got["tokens"] == want["tokens"]
        assert got["rate_log"] == want["rate_log"] and want["rate_log"]
        assert got["counters"] == want["counters"]
        assert got["counters"]["refills"] > 0
        assert got["retired"] == want["retired"]
        assert len(got["logits"]) == len(want["logits"])
        for a, b in zip(got["logits"], want["logits"]):
            np.testing.assert_allclose(a, b, rtol=ENGINE_RTOL,
                                       atol=ENGINE_ATOL)
        assert got["cache_rows"] == (slots // 2 if slots % 2 == 0
                                     else slots)
    assert want["cache_rows"] == slots


# -- launch.train --distributed ------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_launch_train_distributed_on_a_gloo_world_of_one(tmp_path):
    env = dict(os.environ, MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), RANK="0", WORLD_SIZE="1",
               LOCAL_RANK="0")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--distributed",
         "--device", "cpu", "--arch", "gemma3-1b", "--steps", "1",
         "--batch", "2", "--seq-len", "16", "--ckpt-dir",
         str(tmp_path / "ckpt")], capture_output=True, text=True,
        timeout=240, env=env)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "distributed: rank 0 of 1, backend gloo, device cpu" in out.stdout
    assert "final loss:" in out.stdout
    assert ckpt.latest_step(str(tmp_path / "ckpt")) == 1
