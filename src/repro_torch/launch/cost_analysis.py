"""Cost analysis of one step, counted on the ``meta`` device.

The port's counterpart of ``repro.launch.hlo_analysis``.  Torch has no
HLO to parse, so a step is run once -- on ``meta`` tensors for the dry
run, which allocate nothing and compute nothing -- under one
``TorchDispatchMode`` (:func:`trace_ops`) that writes every aten op it
sees into an *op table*: the op, its tensor inputs and outputs (shapes
and dtypes), and for the ops that do matrix work their other arguments.
:func:`stats_of_table` turns a table into :class:`CostStats`:

  * flops         -- FLOPs by ``torch.utils.flop_counter``'s formulas
                     (matrix products, convolutions, attention; the
                     ones ``FlopCounterMode`` counts, which are the
                     reference's dot and convolution FLOPs);
  * traffic_bytes -- the input plus output bytes of each op.  This is
                     what *eager* PyTorch moves, op by op: views move
                     nothing, an argument written in place counts once,
                     an op that only allocates moves nothing, a gather
                     (embedding, index) reads only the rows it picks
                     and an in-place scatter writes (and, adding, reads)
                     only its source's elements.  It is not XLA's bytes
                     across fusion boundaries (the reference's count),
                     so it is an upper bound on what a fused step needs;
  * collective_bytes -- *modelled, not counted*: a meta pass runs the
                     whole (unsharded) step on one device and sees no
                     collective.  :func:`modelled_collectives` derives
                     them from the sharding rules with the reference's
                     ring factors: each FSDP-sharded parameter's
                     all-gather (once in the forward; a train step,
                     always traced with remat, gathers again in the
                     backward, per microbatch), a train step's gradient
                     reduce-scatter of those parameters and all-reduce
                     of the ones the data-parallel axes replicate.
                     Collectives on tensor-parallel activations are not
                     modelled (:data:`NOT_COUNTED`);
  * op_counts     -- ops by aten name (views not listed).

The pass counts the global step; per device is the global count over
the device count, the work split evenly (the reference's SPMD program
also counts the work a sharding replicates).

The RWKV-6 time loop (one Python step a token and layer) runs one step
per call, through ``models.rwkv6.time_loop``, and counts it times the
padded sequence length (``per_step_loops``), as the reference multiplies
while-loop bodies by their ``known_trip_count``: a million Python steps
at ``prefill_32k`` would take hours on ``meta``.  The step's FLOPs, and
its backward's, count exactly; its eager traffic counts the step's own
ops, the full-size gradient of each per-step slice and one gradient
accumulation a step; the tensors it saves for the backward are counted
once, not once a step, in the peak.

:func:`trace_ops` also returns the most bytes the step itself
allocated and held at once (its arguments not included): an estimate
of activation memory.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import weakref
from collections import defaultdict

import torch
import torch.utils.flop_counter as _fc
from torch.utils._python_dispatch import TorchDispatchMode

from ..models.rwkv6 import time_loop

#: collectives a dry-run record does not count
NOT_COUNTED = ("collectives on tensor-parallel activations (attention, "
               "MLP and MoE outputs over the 'model' axis, sequence-"
               "parallel K/V)")

# ops that allocate and move nothing
_ALLOC_ONLY = {"aten::empty", "aten::empty_strided", "aten::empty_like",
               "aten::new_empty", "aten::new_empty_strided"}
# ops that read, of their first input, only the elements they gather:
# their output's
_GATHERS = {"aten::index", "aten::index_select", "aten::gather",
            "aten::embedding"}
# ops that write in place, into their first input, only their source's
# (last tensor argument's) elements; the adding ones read them too
_SCATTERS = {"aten::index_put_": 1, "aten::index_copy_": 1,
             "aten::scatter_": 1, "aten::index_add_": 2,
             "aten::scatter_add_": 2}


def _desc(t: torch.Tensor) -> list:
    return [list(t.shape), str(t.dtype).removeprefix("torch.")]


def _nbytes(desc) -> int:
    shape, dtype = desc[0], desc[1]
    n = 1
    for d in shape:
        n *= d
    return n * getattr(torch, dtype).itemsize


def _rle(descs: list) -> list:
    """Run-length form ``[[desc, repeat], ...]`` of a list of descs (a
    stack of 32,768 same-shaped slices is one entry)."""
    out: list = []
    for d in descs:
        if out and out[-1][0] == d:
            out[-1][1] += 1
        else:
            out.append([d, 1])
    return out


def _jsonable(x):
    if isinstance(x, torch.Tensor):
        return {"shape": list(x.shape)}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    return str(x)


def _shapes(x):
    """Inverse of :func:`_jsonable` for the flop formulas: a tensor's
    entry becomes its ``torch.Size``."""
    if isinstance(x, dict):
        if set(x) == {"shape"}:
            return torch.Size(x["shape"])
        return {k: _shapes(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_shapes(v) for v in x]
    return x


def _packet(name: str):
    ns, op = name.split("::")
    return getattr(getattr(torch.ops, ns), op)


# aten ops with a FLOP formula ("aten::mm", ...)
_FLOP_OPS = {p._qualified_op_name for p in _fc.flop_registry
             if isinstance(p, torch._ops.OpOverloadPacket)}


class _OpTable(TorchDispatchMode):
    """Counts every op that runs under it into ``table`` (key -> count),
    times ``mult``; tracks the bytes of the storages ops create."""

    def __init__(self, held=()):
        super().__init__()
        self.table: dict[tuple, float] = defaultdict(float)
        self.mult = 1.0
        # storages that exist before the run (the step's arguments)
        self._live: dict[int, int] = {t.untyped_storage()._cdata: 0
                                      for t in held}
        self.live_bytes = 0
        self.peak_bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view:
            return out
        if self.mult:
            self._record(func, args, kwargs, out)
        for t in _tensors(out):
            self._hold(t)
        return out

    def _record(self, func, args, kwargs, out):
        schema = func._schema
        ins, written = [], []
        for i, a in enumerate(schema.arguments):
            val = args[i] if i < len(args) else kwargs.get(a.name)
            w = a.alias_info is not None and a.alias_info.is_write
            for t in _tensors(val):
                ins.append(_desc(t))
                if w:
                    written.append(t)
        outs = [_desc(t) for t in _tensors(out)
                if not any(t is w for w in written)]
        name = func._schema.name
        extra = None
        if name in _FLOP_OPS:
            extra = json.dumps([_jsonable(list(args)), _jsonable(kwargs),
                                _jsonable(out)])
        key = (name, json.dumps(_rle(ins)), json.dumps(_rle(outs)), extra)
        self.table[key] += self.mult

    def _hold(self, t: torch.Tensor):
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._release, key)

    def _release(self, key):
        self.live_bytes -= self._live.pop(key, 0)

    def rows(self) -> list[dict]:
        return [{"op": name, "in": json.loads(ins), "out": json.loads(outs),
                 "args": None if extra is None else json.loads(extra),
                 "count": n}
                for (name, ins, outs, extra), n in self.table.items()]


def _tensors(x):
    """The tensors in ``x``, a tensor or nested lists, tuples, dicts."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


class _Repeat:
    """Scales what runs inside ``with`` by ``n`` on the active table."""

    def __init__(self, table: _OpTable, n: float):
        self.table, self.n = table, n

    def __enter__(self):
        self.prev = self.table.mult
        self.table.mult = self.prev * self.n

    def __exit__(self, *exc):
        self.table.mult = self.prev


class _WkvSteps(torch.autograd.Function):
    """``steps`` RWKV-6 time steps (``step`` a time step) as one step
    counted ``steps`` times."""

    @staticmethod
    def forward(ctx, table, step, steps, r, k, v, w, u, state0):
        ctx.table, ctx.step, ctx.steps = table, step, steps
        ctx.save_for_backward(r, k, v, w, u, state0)
        with _Repeat(table, steps):
            o, state = step(r[:, 0], k[:, 0], v[:, 0], w[:, 0], u, state0)
        return torch.stack([o] * r.shape[1], dim=1), state

    @staticmethod
    def backward(ctx, g_o, g_state):
        r, k, v, w, u, state0 = ctx.saved_tensors
        table, steps = ctx.table, ctx.steps
        with torch.enable_grad():
            with _Repeat(table, 0):          # the rebuild is not the loop's
                xs = [a[:, 0].detach().requires_grad_()
                      for a in (r, k, v, w)] \
                    + [a.detach().requires_grad_() for a in (u, state0)]
                o, state = ctx.step(*xs)
            with _Repeat(table, steps):
                gs = torch.autograd.grad((o, state), xs,
                                         (g_o[:, 0], g_state))
                # each step's slice gradient at full size, and its
                # accumulation into the input's gradient
                full = [torch.ops.aten.select_backward(g, a.shape, 1, 0)
                        for g, a in zip(gs[:4], (r, k, v, w))]
                for g in full:
                    torch.add(g, g)
        return (None, None, None, *full, gs[4],
                gs[5] if state0.requires_grad else None)


def _per_step_loop(table: _OpTable):
    def loop(step, r, k, v, w, u, state):
        return _WkvSteps.apply(table, step, r.shape[1], r, k, v, w, u,
                               state)
    return loop


def trace_ops(fn, *args, per_step_loops: bool = True):
    """Run ``fn(*args)`` once under the op table.  Returns ``(rows,
    peak_bytes)``: the table's rows (see :func:`stats_of_table`) and the
    most bytes the run held at once of storages it created.  With
    ``per_step_loops`` the RWKV-6 time loop runs one step counted once a
    step of the padded sequence."""
    table = _OpTable(_tensors(args))
    loop = time_loop(_per_step_loop(table)) if per_step_loops \
        else contextlib.nullcontext()
    with loop, table:
        fn(*args)
    return table.rows(), table.peak_bytes


@dataclasses.dataclass
class CostStats:
    flops: float = 0.0
    traffic_bytes: float = 0.0
    collective_bytes: dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    op_counts: dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    def to_json(self) -> dict:
        return {"flops": self.flops, "traffic_bytes": self.traffic_bytes,
                "collective_bytes": dict(self.collective_bytes),
                "total_collective_bytes": self.total_collective_bytes,
                "op_counts": dict(self.op_counts)}


def _row_flops(row: dict) -> float:
    """FLOPs of one call of a table row's op (0 for ops without a
    formula)."""
    if row["args"] is None:
        return 0.0
    args, kwargs, out = _shapes(row["args"])
    f = _fc.flop_registry[_packet(row["op"])]
    return float(f(*args, **kwargs, out_val=out))


def _row_bytes(row: dict) -> float:
    """Eager bytes of one call of a table row's op."""
    op = row["op"]
    if op in _ALLOC_ONLY:
        return 0.0
    ins = [d for d, rep in row["in"] for _ in range(rep)]
    out = sum(_nbytes(d) * rep for d, rep in row["out"])
    if op in _GATHERS:
        return float(sum(map(_nbytes, ins[1:])) + 2 * out)
    if op in _SCATTERS:
        touched = _nbytes([ins[-1][0], ins[0][1]])
        return float(sum(map(_nbytes, ins[1:])) + _SCATTERS[op] * touched
                     + out)
    return float(sum(map(_nbytes, ins)) + out)


def stats_of_table(rows: list[dict], devices: int = 1,
                   collectives: dict[str, float] | None = None) -> CostStats:
    """Per-device :class:`CostStats` of a step's op table (the global
    counts over ``devices``), with ``collectives`` (per device) as
    :func:`modelled_collectives` gives them."""
    st = CostStats()
    for row in rows:
        n = row["count"]
        st.flops += n * _row_flops(row) / devices
        st.traffic_bytes += n * _row_bytes(row) / devices
        st.op_counts[row["op"]] += n
    for k, v in (collectives or {}).items():
        st.collective_bytes[k] += v
    return st


def analyze_step(fn, *args, per_step_loops: bool = True) -> CostStats:
    """:class:`CostStats` of one global step ``fn(*args)`` on the
    arguments' device (``meta`` for the dry run; elsewhere the loop
    counted a step at a time also gives wrong values, not counts)."""
    return stats_of_table(trace_ops(fn, *args,
                                    per_step_loops=per_step_loops)[0])


def modelled_collectives(leaves: list[list], kind: str, *,
                         microbatches: int = 1) -> dict[str, float]:
    """Wire bytes per device of a step's parameter collectives, by the
    reference's ring model (all-gather and reduce-scatter (n-1)/n of the
    gathered size, all-reduce 2(n-1)/n).  ``leaves``: ``[shard_bytes,
    fsdp_group, dp_size, count]`` rows -- one device's bytes of a
    parameter, the devices its FSDP dimension spans (1: none) and the
    data-parallel size.  ``kind``: train, prefill or decode."""
    gathers = 1
    if kind == "train":
        # the dry run traces the train step with remat: the backward
        # gathers each microbatch's parameters again
        gathers = 2 * microbatches
    out: dict[str, float] = defaultdict(float)
    for shard, group, dp, count in leaves:
        if group > 1:
            out["all-gather"] += count * gathers * shard * (group - 1)
            if kind == "train":
                out["reduce-scatter"] += count * shard * (group - 1)
        elif kind == "train" and dp > 1:
            out["all-reduce"] += count * 2.0 * shard * (dp - 1) / dp
    return dict(out)
