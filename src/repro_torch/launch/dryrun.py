"""Dry run: cost every (arch x shape x mesh) cell on the ``meta`` device.

The port's counterpart of ``repro.launch.dryrun``.  Where the reference
lowers and compiles each cell's step on placeholder host devices and
reads the compiled HLO, this module builds the cell's parameters, inputs
and caches as ``meta`` tensors (no memory, no card), runs the port's own
step once under ``launch.cost_analysis`` and prices the counts with an
H100 roofline (:data:`H100`).  Per device means the global step's counts
over the mesh's device count; the memory block comes from the sharding
rules (``launch.sharding``), exactly for the arguments.  The reference's
``xla_cost`` block (XLA's own loop-unaware cost analysis) has no
counterpart: there is no compiler here to ask.

Usage:
    python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k
    python -m repro_torch.launch.dryrun --arch all --shape all [--multipod]
Writes one JSON per cell under experiments/dryrun_torch/ and, beside it,
the cell's op table (``.ops.json.gz``) that ``launch.rescore`` re-prices.
"""

from __future__ import annotations

import argparse
import dataclasses
import gzip
import json
import math
import os
import time
import traceback

import torch

from ..configs import ARCHS, SHAPES, get_config
from ..configs.base import InputShape, ModelConfig
from ..models import init_cache, init_params
from ..models.convert import stack_cache, stack_layers
from ..models.transformer import torch_dtype
from ..optim import init_opt_state
from . import sharding as SH
from .cost_analysis import (NOT_COUNTED, modelled_collectives,
                            stats_of_table, trace_ops)
from .mesh import Mesh, dp_axes_of, make_production_mesh
from .steps import make_decode_step, make_prefill_step, make_train_step

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

#: Hardware model, per card: NVIDIA H100 SXM5 80 GB (NVIDIA H100 Tensor
#: Core GPU datasheet: dense bf16 tensor-core rate, HBM3 bandwidth) and
#: the link a 16-wide mesh axis crosses, which spans two 8-card nodes:
#: one 400 Gb/s ConnectX-7 port per card (NVIDIA DGX H100 datasheet).
H100 = {"peak_flops": 989e12, "hbm_bytes_per_s": 3.35e12,
        "link_bytes_per_s": 400e9 / 8}


def input_specs(cfg: ModelConfig, shape: InputShape, device="meta"):
    """Every model input of a cell, as tensors on ``device``.

    train/prefill: {'tokens': (B,S) i32[, 'inputs': (B,S,d) model dtype]}
    decode:        {'token': (B,) i32, 'pos': the last cache slot (int)}
    """
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"token": torch.zeros((b,), dtype=torch.int32, device=device),
                "pos": s - 1}
    specs = {"tokens": torch.zeros((b, s), dtype=torch.int32, device=device)}
    if cfg.input_mode == "embeddings":
        specs["inputs"] = torch.zeros((b, s, cfg.d_model),
                                      dtype=torch_dtype(cfg), device=device)
    return specs


def cell_applicable(cfg: ModelConfig, shape: InputShape) -> tuple[bool, str]:
    if shape.name == "long_500k" and not cfg.long_context_ok:
        return False, ("pure full-attention arch: 500k KV cache/quadratic "
                       "prefill out of scope (see DESIGN.md)")
    return True, ""


def _bytes(specs: dict, tree, mesh: Mesh) -> int:
    return sum(SH.shard_bytes(tuple(t.shape), t.dtype, specs[p], mesh)
               for p, t in SH.tree_paths(tree))


def _collective_leaves(specs: dict, tree, mesh: Mesh) -> list[list]:
    """``[shard_bytes, fsdp_group, dp_size, count]`` rows of a stacked
    params tree (equal rows merged), for ``modelled_collectives``."""
    dp_axes = dp_axes_of(mesh)
    dp = math.prod(mesh.shape[a] for a in dp_axes)
    rows: dict[tuple, int] = {}
    for p, t in SH.tree_paths(tree):
        spec = specs[p]
        group = math.prod(mesh.shape[a] for e in spec if e is not None
                          for a in ((e,) if isinstance(e, str) else e)
                          if a in dp_axes)
        key = (SH.shard_bytes(tuple(t.shape), t.dtype, spec, mesh), group, dp)
        rows[key] = rows.get(key, 0) + 1
    return [[*k, n] for k, n in rows.items()]


def model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """(6 for a train step, else 2) x active parameters x tokens."""
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    return float((6 if shape.kind == "train" else 2)
                 * cfg.active_param_count() * tokens)


def roofline(st, mf: float, n_dev: int) -> dict:
    """Roofline terms per device of a cell's per-device ``CostStats``
    under :data:`H100`.  ``step_time_lower_bound_s`` (the reference's
    key) is the *eager roofline*: the largest of the counted FLOPs at
    peak, the eager traffic at the HBM rate and the modelled collectives
    at the link rate.  It bounds a step that moves what eager PyTorch
    moves; a fused step moves less, so it does not bound that."""
    flops_t = st.flops / H100["peak_flops"]
    mem_t = st.traffic_bytes / H100["hbm_bytes_per_s"]
    coll_t = st.total_collective_bytes / H100["link_bytes_per_s"]
    dom = max((flops_t, "compute"), (mem_t, "memory"), (coll_t, "collective"))
    lb = dom[0]
    return {
        "compute_s": flops_t, "memory_s": mem_t, "collective_s": coll_t,
        "bound": dom[1], "step_time_lower_bound_s": lb,
        "model_flops_ratio": mf / (st.flops * n_dev) if st.flops else 0.0,
        "mfu_bound": (mf / n_dev / H100["peak_flops"]) / lb if lb else 0.0,
    }


def cell_step(cfg: ModelConfig, shape: InputShape, microbatches: int = 4,
              *, device="meta", generator=None):
    """A cell's step and its arguments, made on ``device`` (parameters
    from ``generator``, which must live there; ``None`` on ``meta``)."""
    params = init_params(cfg, generator, device=device)
    batch = input_specs(cfg, shape, device)
    if shape.kind == "train":
        return make_train_step(cfg, microbatches=microbatches), \
            (params, init_opt_state(params), batch)
    cache = init_cache(cfg, shape.global_batch, shape.seq_len, device=device)
    if shape.kind == "prefill":
        return make_prefill_step(cfg), (params, batch, cache)
    return make_decode_step(cfg), (params, batch["token"], cache,
                                   batch["pos"])


def _argument_trees(cfg: ModelConfig, kind: str, args):
    """A step's arguments as the trees the sharding rules read: the
    stacked parameters, the stacked optimizer state or cache, and the
    input tensors by name."""
    params = stack_layers(cfg, args[0])
    if kind == "train":
        opt = args[1]
        return params, {"mu": stack_layers(cfg, opt["mu"]),
                        "nu": stack_layers(cfg, opt["nu"]),
                        "step": opt["step"]}, args[2]
    inputs = args[1] if kind == "prefill" else {"token": args[1]}
    return params, stack_cache(cfg, args[2]), inputs


def run_cell(arch: str, shape: str | InputShape, multi_pod: bool = False,
             save_ops: bool = True, overrides: dict | None = None,
             tag: str = "", microbatches: int = 4, kv_bits: int = 0,
             mesh: Mesh | None = None, out_dir: str = OUT_DIR) -> dict:
    """Cost one cell.  ``shape`` names a ``SHAPES`` entry or is an
    ``InputShape``; ``mesh`` defaults to the production mesh
    (``multi_pod`` picks which)."""
    cfg = get_config(arch)
    if kv_bits:
        cfg = dataclasses.replace(cfg, kv_quant_bits=kv_bits)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    rec: dict = {"arch": arch, "shape": shape.name, "mesh": mesh.name,
                 "tag": tag or "baseline", "microbatches": microbatches}
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    t0 = time.time()
    try:
        n_dev = mesh.size
        step, args = cell_step(cfg, shape, microbatches)
        params, state, batch = _argument_trees(cfg, shape.kind, args)
        p_specs = SH.param_shardings(mesh, params)
        if shape.kind == "train":
            s_specs = SH.opt_shardings(mesh, state)
        else:
            s_specs = SH.cache_shardings(mesh, state)
        b_specs = {k: SH.batch_sharding(mesh, tuple(v.shape))
                   for k, v in batch.items()}
        arg_bytes = (_bytes(p_specs, params, mesh)
                     + _bytes(s_specs, state, mesh)
                     + _bytes(b_specs, batch, mesh))

        t1 = time.time()
        rows, peak = trace_ops(step, *args)
        rec["trace_s"] = round(time.time() - t1, 2)
        table = {"devices": n_dev, "kind": shape.kind,
                 "microbatches": microbatches,
                 "collective_leaves": _collective_leaves(p_specs, params,
                                                         mesh),
                 "rows": rows}
        dp = math.prod(mesh.shape[a] for a in dp_axes_of(mesh))
        rec["memory"] = {
            "argument_bytes": arg_bytes,
            "peak_bytes_est": int(arg_bytes + peak / dp),
            "peak_note": "estimate: the arguments plus the meta run's "
                         "peak of bytes the step held at once over the "
                         "data-parallel size",
        }
        if save_ops:
            os.makedirs(out_dir, exist_ok=True)
            opath = os.path.join(out_dir, f"{arch}_{shape.name}_{mesh.name}"
                                 f"{tag and '_' + tag}.ops.json.gz")
            with gzip.open(opath, "wt") as f:
                json.dump(table, f)
            rec["ops_path"] = opath
        score(rec, table, cfg, shape)
        rec["status"] = "ok"
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = round(time.time() - t0, 2)
    return rec


def score(rec: dict, table: dict, cfg: ModelConfig,
          shape: InputShape) -> dict:
    """Fill ``rec``'s ``ops``, ``model_flops_global`` and ``roofline``
    from a cell's op table under :data:`H100`."""
    coll = modelled_collectives(table["collective_leaves"], table["kind"],
                                microbatches=table["microbatches"])
    st = stats_of_table(table["rows"], table["devices"], coll)
    rec["ops"] = st.to_json()
    rec["ops"]["not_counted"] = NOT_COUNTED
    mf = model_flops(cfg, shape)
    rec["model_flops_global"] = mf
    rec["roofline"] = roofline(st, mf, table["devices"])
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--no-ops", action="store_true",
                    help="do not save the cells' op tables")
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--kv-bits", type=int, default=0)
    args = ap.parse_args(argv)
    archs = sorted(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    os.makedirs(OUT_DIR, exist_ok=True)
    mesh_name = make_production_mesh(multi_pod=args.multipod).name
    for a in archs:
        for s in shapes:
            fname = f"{a}_{s}_{mesh_name}{args.tag and '_' + args.tag}.json"
            fpath = os.path.join(OUT_DIR, fname)
            if os.path.exists(fpath):
                print(f"[skip existing] {fname}", flush=True)
                continue
            print(f"[dryrun] {a} x {s} on {mesh_name} ...", flush=True)
            rec = run_cell(a, s, multi_pod=args.multipod,
                           save_ops=not args.no_ops, tag=args.tag,
                           microbatches=args.microbatches,
                           kv_bits=args.kv_bits, out_dir=OUT_DIR)
            with open(fpath, "w") as f:
                json.dump(rec, f, indent=1)
            status = rec["status"]
            extra = rec.get("reason", rec.get("error", ""))[:120]
            rl = rec.get("roofline", {})
            print(f"  -> {status} ({rec.get('total_s', 0)}s) "
                  f"bound={rl.get('bound', '-')} {extra}", flush=True)


if __name__ == "__main__":
    main()
