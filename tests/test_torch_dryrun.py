"""Port vs reference: the dry run (``repro_torch.launch.{cost_analysis,
dryrun,rescore}`` against ``repro.launch.{hlo_analysis,dryrun}``).

FLOPs: the port's meta-device count of its prefill, decode and train
(remat) steps equals the reference's loop-aware ``analyze()`` of its
1-device CPU compile, for five families at ``reduced`` size, batch
2 x 16.  Exact, but for one pinned gap: the RWKV-6 train step, whose
backward takes the gradient of each time step's ``einsum("bhi,bhij->
bhj")`` with respect to the matrix as an outer product.  Torch runs it
as a batched product with a contraction of length 1, which
``FlopCounterMode`` counts (2 x B x H x n x n a step and layer); XLA
rewrites a dot without contracting dimensions into a broadcast multiply,
which ``analyze()`` does not count.  Both do the same n x n products.
Also: the meta pass counts what a CPU pass counts; the RWKV-6 loop
counted one step times S counts the FLOPs (and matrix ops) of the full
loop; gathers and in-place scatters move only the rows they touch; a
train step's modelled all-gathers; the production cells' records; and
``rescore`` reproduces a record from its saved op table.
"""

import functools
import gzip
import json
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from repro import models as jm
from repro.configs import ARCHS as JARCHS
from repro.configs import reduced as jreduced
from repro.launch import steps as jsteps
from repro.launch.hlo_analysis import analyze
from repro.optim import init_opt_state as jinit_opt
from repro_torch import models as tm
from repro_torch.configs import ARCHS, SHAPES, InputShape, get_config, reduced
from repro_torch.launch import dryrun, rescore
from repro_torch.launch.cost_analysis import (analyze_step,
                                              modelled_collectives,
                                              trace_ops)
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.optim import init_opt_state

FAMILIES = ["codeqwen1.5-7b", "gemma3-1b", "dbrx-132b", "rwkv6-3b",
            "recurrentgemma-2b"]
STEPS = ["prefill", "decode", "train"]
B, S = 2, 16
MATMULS = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm")


def _ref_flops(arch, kind):
    """``analyze()`` FLOPs of the reference's step, compiled for 1 CPU."""
    cfg = jreduced(JARCHS[arch])
    params = jax.eval_shape(functools.partial(jm.init_params, cfg),
                            jax.random.PRNGKey(0))
    tokens = jax.ShapeDtypeStruct((B, S), jnp.int32)
    if kind == "train":
        opt = jax.eval_shape(jinit_opt, params)
        lowered = jax.jit(jsteps.make_train_step(cfg)).lower(
            params, opt, {"tokens": tokens})
    else:
        cache = jax.eval_shape(functools.partial(jm.init_cache, cfg, B, S))
        if kind == "prefill":
            lowered = jax.jit(jsteps.make_prefill_step(cfg)).lower(
                params, {"tokens": tokens}, cache)
        else:
            lowered = jax.jit(jsteps.make_decode_step(cfg)).lower(
                params, jax.ShapeDtypeStruct((B,), jnp.int32), cache,
                jax.ShapeDtypeStruct((), jnp.int32))
    return analyze(lowered.compile().as_text(), 1).flops


def _port_step(arch, kind, device="meta", s=S):
    """The port's step at ``reduced`` size, then its arguments."""
    cfg = reduced(get_config(arch))
    gen = None if device == "meta" else torch.Generator().manual_seed(0)
    params = tm.init_params(cfg, gen, device=device)
    tokens = torch.zeros((B, s), dtype=torch.int32, device=device)
    if kind == "train":
        return make_train_step(cfg), params, init_opt_state(params), \
            {"tokens": tokens}
    cache = tm.init_cache(cfg, B, s, device=device)
    if kind == "prefill":
        return make_prefill_step(cfg), params, {"tokens": tokens}, cache
    return make_decode_step(cfg), params, tokens[:, 0], cache, s - 1


def _rwkv_outer_product_flops(arch):
    """The pinned gap: one (B*H, n, 1) x (B*H, 1, n) product a time step
    (the sequence padded to the scan's chunk) and layer."""
    cfg = reduced(get_config(arch))
    steps = S + (-S) % 16
    return cfg.num_layers * steps * 2 * B * cfg.num_heads \
        * cfg.rwkv_head_dim ** 2


@pytest.mark.parametrize("kind", STEPS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_meta_flops_match_reference_analyze(arch, kind):
    port = analyze_step(*_port_step(arch, kind)).flops
    ref = _ref_flops(arch, kind)
    gap = _rwkv_outer_product_flops(arch) \
        if (arch, kind) == ("rwkv6-3b", "train") else 0
    assert port - ref == gap, (port, ref)
    assert port > 0


def test_rwkv_train_gap_is_the_outer_product():
    """The pinned gap is 131,072 FLOPs at this size, and the port's
    backward holds exactly that many FLOPs of contraction-1 products."""
    assert _rwkv_outer_product_flops("rwkv6-3b") == 131_072
    rows, _ = trace_ops(*_port_step("rwkv6-3b", "train"))
    outer = 0.0
    for r in rows:
        if r["op"] == "aten::bmm":
            (a, b), _, _ = r["args"]
            if a["shape"][2] == 1:
                outer += r["count"] * 2 * a["shape"][0] * a["shape"][1] \
                    * b["shape"][2]
    assert outer == 131_072


@pytest.mark.parametrize("kind", STEPS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_meta_pass_counts_what_a_cpu_pass_counts(arch, kind):
    meta = analyze_step(*_port_step(arch, kind))
    cpu = analyze_step(*_port_step(arch, kind, device="cpu"))
    assert meta.flops == cpu.flops
    assert {k: meta.op_counts.get(k) for k in MATMULS} \
        == {k: cpu.op_counts.get(k) for k in MATMULS}


@pytest.mark.parametrize("s", [S, 37])     # one chunk; three, padded
@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_rwkv_loop_counted_per_step_equals_the_full_loop(kind, s):
    step, *args = _port_step("rwkv6-3b", kind, s=s)
    once = analyze_step(step, *args)
    full = analyze_step(step, *args, per_step_loops=False)
    assert once.flops == full.flops
    assert {k: once.op_counts.get(k) for k in MATMULS} \
        == {k: full.op_counts.get(k) for k in MATMULS}
    # the eager traffic of the loop is modelled a step at a time
    assert once.traffic_bytes == pytest.approx(full.traffic_bytes, rel=0.02)


_IDX = torch.tensor([3, 7, 7, 1])
_ROWS = 4 * 8 * 4                      # four float32 rows of eight


# each case: the op, its arguments, and the bytes it moves -- the
# indices, and the rows it gathers or writes (twice where it reads them
# too), never the whole (1000, 8) table
@pytest.mark.parametrize("fn, args, moved", [
    (lambda t, i: t[i], (torch.zeros(1000, 8), _IDX), 32 + 2 * _ROWS),
    (lambda t, i: torch.nn.functional.embedding(i, t),
     (torch.zeros(1000, 8), _IDX), 32 + 2 * _ROWS),
    (lambda d, i, v: d.index_put_((i,), v),
     (torch.zeros(1000, 8), _IDX, torch.ones(4, 8)), 32 + 2 * _ROWS),
    (lambda d, i, v: d.index_add_(0, i, v),
     (torch.zeros(1000, 8), _IDX, torch.ones(4, 8)), 32 + 3 * _ROWS),
], ids=["index", "embedding", "index_put_", "index_add_"])
def test_traffic_counts_the_rows_an_index_op_touches(fn, args, moved):
    assert analyze_step(fn, *args).traffic_bytes == moved


@pytest.mark.parametrize("microbatches", [1, 4])
def test_train_step_gathers_twice_a_microbatch(microbatches):
    """The dry run traces the train step with remat: the backward
    gathers the parameters again."""
    # one 1 MB shard of a parameter FSDP-sharded 16 ways, dp 16
    leaves = [[1 << 20, 16, 16, 3]]
    train = modelled_collectives(leaves, "train", microbatches=microbatches)
    assert train["all-gather"] == 3 * 2 * microbatches * (1 << 20) * 15
    assert train["reduce-scatter"] == 3 * (1 << 20) * 15
    assert modelled_collectives(leaves, "prefill") == {
        "all-gather": 3 * (1 << 20) * 15}


def test_production_train_cell():
    rec = dryrun.run_cell("gemma3-1b", "train_4k", save_ops=False)
    assert rec["status"] == "ok", rec.get("traceback")
    cfg, shape = get_config("gemma3-1b"), SHAPES["train_4k"]
    assert rec["model_flops_global"] == \
        6 * cfg.active_param_count() * shape.global_batch * shape.seq_len
    rl = rec["roofline"]
    assert set(rl) == {"compute_s", "memory_s", "collective_s", "bound",
                       "step_time_lower_bound_s", "model_flops_ratio",
                       "mfu_bound"}
    assert 0 < rl["mfu_bound"] <= 1
    assert rl["step_time_lower_bound_s"] == max(
        rl["compute_s"], rl["memory_s"], rl["collective_s"])
    assert set(rec["ops"]) >= {"flops", "traffic_bytes", "collective_bytes",
                               "total_collective_bytes", "op_counts"}
    coll = rec["ops"]["collective_bytes"]
    assert coll["all-gather"] > 0 and coll["reduce-scatter"] > 0
    mem = rec["memory"]
    assert 0 < mem["argument_bytes"] < mem["peak_bytes_est"]


@pytest.mark.parametrize("arch", sorted(a for a in ARCHS
                                        if not ARCHS[a].long_context_ok))
def test_long_context_skipped_for_full_attention(arch):
    rec = dryrun.run_cell(arch, "long_500k", save_ops=False)
    assert rec["status"] == "skipped"
    assert "full-attention" in rec["reason"]


def test_rescore_reproduces_a_record(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "OUT_DIR", str(tmp_path))
    dryrun.main(["--arch", "codeqwen1.5-7b", "--shape", "decode_32k"])
    (jpath,) = tmp_path.glob("*.json")
    rec = json.loads(jpath.read_text())
    assert rec["status"] == "ok" and os.path.exists(rec["ops_path"])
    with gzip.open(rec["ops_path"], "rt") as f:
        table = json.load(f)
    bare = {k: v for k, v in rec.items()
            if k not in ("ops", "roofline", "model_flops_global")}
    assert rescore.rescore_record(bare, table) == rec
    rescore.main(base=str(tmp_path))
    assert json.loads(jpath.read_text()) == rec


def test_run_cell_on_the_one_card_mesh():
    """The form ``chip_smoke.py`` calls: an ``InputShape`` and a mesh."""
    mesh = make_smoke_mesh(1)
    rec = dryrun.run_cell("codeqwen1.5-7b", InputShape("decode", 64, 4,
                                                       "decode"),
                          mesh=mesh, save_ops=False, microbatches=1)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["mesh"] == "mesh1x1"
    assert rec["ops"]["total_collective_bytes"] == 0
    cfg = get_config("codeqwen1.5-7b")
    # one device holds every parameter, the cache and the tokens
    n_kv = 2 * cfg.num_layers * 4 * 64 * cfg.num_kv_heads * cfg.head_dim
    assert rec["memory"]["argument_bytes"] == \
        2 * cfg.param_count() + 2 * n_kv + 4 * 4
