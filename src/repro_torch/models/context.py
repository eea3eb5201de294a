"""Distribution context threaded through model code.

The port's counterpart of ``repro.models.context``.  A
:class:`DistContext` holds a ``torch.distributed`` ``DeviceMesh`` with
named axes; ``None`` (or a context without a mesh) is one device.

The JAX package runs one program over the mesh and lets GSPMD place it:
``constrain`` pins activations with sharding hints and ``shard_map``
opens the manual regions (the expert-parallel MoE).  Here every rank
runs the same eager program on the data it holds, so neither has a
counterpart: a hint changes no value, and inside a "manual region" each
rank already holds its own shard.  What a rank holds:

  * the batch rows of its data-parallel coordinate: a contiguous block
    of B/dp rows, where dp is the product of the ``dp_axes`` sizes and
    several dp axes order the blocks pod-major, as ``P(("pod", "data"))``
    does (:func:`dp_rows`; a batch that dp does not divide is held whole
    by every rank, ``constrain``'s fallback);
  * of each MoE layer, the ``E/M`` experts of its coordinate on the
    ``tp_axis`` (M ranks): leading-axis slices of ``w1``, ``w3`` and
    ``w2`` (:func:`expert_slice`).  The router and every other leaf are
    replicated.

The collectives the expert-parallel MoE and the train step need are
``torch.autograd.Function``\\ s with their backward written out.  Every
rank of a tp group computes the same loss from the same replicated
output, so a collective's backward must not sum gradients over the ranks
where each rank already holds the whole gradient:
``torch.distributed.nn.functional.all_reduce`` / ``all_gather`` sum
there, which would multiply the gradient by M, and are not used.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from ..tree import leaves, rebuild

#: (block, leaf) names of the layer leaves a rank holds a tp slice of
EXPERT_LEAVES = {("moe", "w1"), ("moe", "w3"), ("moe", "w2")}


@dataclasses.dataclass(frozen=True)
class DistContext:
    """Mesh + axis-name conventions.  ``None`` context = single device.

    mesh: a ``DeviceMesh`` with ``mesh_dim_names`` spanning every rank
    of the default process group.
    dp_axes: axes the batch is split over (('pod','data') or ('data',)).
    tp_axis: the expert-parallel axis ('model').

    The process groups are made when the context is: every rank must
    build its context at the same point of its program.  A mesh with a
    ``pod`` axis also gives this rank's coordinate on it (``pod_rank``)
    and, where that axis has two ranks, its peer on the other pod: the
    rank with the same coordinates on every other axis (``pod_peer``, a
    global rank; the split runtime's edge and cloud stage send to each
    other on the default group, so no group is made for it).
    """

    mesh: Any = None
    dp_axes: tuple[str, ...] = ("data",)
    tp_axis: str = "model"
    _groups: dict = dataclasses.field(default=None, init=False,
                                      compare=False, repr=False)

    def __post_init__(self):
        if self.mesh is None:
            return
        names = self.mesh.mesh_dim_names
        if names is None:
            raise ValueError("DistContext needs a DeviceMesh with "
                             "mesh_dim_names")
        if self.mesh.size() != dist.get_world_size():
            raise ValueError(f"the mesh holds {self.mesh.size()} ranks, the "
                             f"process group {dist.get_world_size()}")
        coord = self.mesh.get_coordinate()
        shape = dict(zip(names, self.mesh.mesh.shape))
        groups = {"tp": None, "tp_rank": 0, "dp": None, "dp_rank": 0,
                  "pod_rank": 0, "pod_peer": None}
        if "pod" in names:
            i = names.index("pod")
            groups["pod_rank"] = coord[i]
            if shape["pod"] == 2:
                other = list(coord)
                other[i] = 1 - coord[i]
                groups["pod_peer"] = int(self.mesh.mesh[tuple(other)])
        if shape.get(self.tp_axis, 1) > 1:
            groups["tp"] = self.mesh.get_group(self.tp_axis)
            groups["tp_rank"] = coord[names.index(self.tp_axis)]
        dp = [a for a in self.dp_axes if a in names]
        if self.dp_size > 1:
            if len(dp) == 1:
                groups["dp"] = self.mesh.get_group(dp[0])
                groups["dp_rank"] = coord[names.index(dp[0])]
            else:
                # one group a coordinate of the other axes, its ranks in
                # the order of the dp axes as listed (pod-major)
                rest = [a for a in names if a not in dp]
                ranks = self.mesh.mesh.permute(
                    *[names.index(a) for a in dp + rest]).reshape(
                    self.dp_size, -1)
                groups["dp"], _ = dist.new_subgroups_by_enumeration(
                    [col.tolist() for col in ranks.T])
                mine = dist.get_process_group_ranks(groups["dp"])
                groups["dp_rank"] = mine.index(dist.get_rank())
        object.__setattr__(self, "_groups", groups)

    def _size(self, axis: str) -> int:
        names = self.mesh.mesh_dim_names
        return int(self.mesh.mesh.shape[names.index(axis)]) \
            if axis in names else 1

    @property
    def tp_size(self) -> int:
        if self.mesh is None:
            return 1
        return self._size(self.tp_axis)

    @property
    def dp_size(self) -> int:
        if self.mesh is None:
            return 1
        out = 1
        for a in self.dp_axes:
            out *= self._size(a)
        return out

    @property
    def tp_group(self):
        """This rank's process group along the tp axis (None at size 1)."""
        return None if self.mesh is None else self._groups["tp"]

    @property
    def tp_rank(self) -> int:
        return 0 if self.mesh is None else self._groups["tp_rank"]

    @property
    def dp_group(self):
        """This rank's process group over the dp axes (None at size 1)."""
        return None if self.mesh is None else self._groups["dp"]

    @property
    def dp_rank(self) -> int:
        return 0 if self.mesh is None else self._groups["dp_rank"]

    @property
    def pod_rank(self) -> int:
        """This rank's coordinate on the ``pod`` axis (0 without one)."""
        return 0 if self.mesh is None else self._groups["pod_rank"]

    @property
    def pod_peer(self) -> int | None:
        """The global rank of this rank's peer on the other pod of a
        two-pod mesh (None otherwise)."""
        return None if self.mesh is None else self._groups["pod_peer"]

    @property
    def size(self) -> int:
        return 1 if self.mesh is None else self.mesh.size()


def sharded(ctx: DistContext | None) -> bool:
    """Whether ``ctx`` splits anything: a mesh of more than one rank."""
    return ctx is not None and ctx.size > 1


# ---------------------------------------------------------------------------
# what a rank holds
# ---------------------------------------------------------------------------

def is_expert_leaf(path) -> bool:
    """Whether a leaf at ``path`` (of a parameter, gradient, moment or
    error-feedback tree) is an expert stack a rank holds a tp slice of."""
    return len(path) >= 2 and tuple(path[-2:]) in EXPERT_LEAVES


def expert_slice(ctx: DistContext | None, n_experts: int) -> slice:
    """The leading-axis slice of an expert stack this rank holds."""
    m = 1 if ctx is None else ctx.tp_size
    if n_experts % m:
        raise ValueError(f"{n_experts} experts not divisible by axis "
                         f"{ctx.tp_axis}={m}")
    n = n_experts // m
    r = 0 if ctx is None else ctx.tp_rank
    return slice(r * n, (r + 1) * n)


def dp_rows(t: torch.Tensor | None, ctx: DistContext | None):
    """This rank's contiguous block of B/dp rows of a global batch; all
    rows where dp does not divide B."""
    if t is None or ctx is None or ctx.dp_size == 1 \
            or t.shape[0] % ctx.dp_size:
        return t
    n = t.shape[0] // ctx.dp_size
    return t[ctx.dp_rank * n:(ctx.dp_rank + 1) * n]


def gather_rows(t: torch.Tensor, ctx: DistContext) -> torch.Tensor:
    """The global batch from every dp rank's block of rows (the inverse of
    :func:`dp_rows` where dp divides B): an all-gather over the dp group,
    the blocks in dp-rank order.  Every rank of the group must call it."""
    parts = [torch.empty_like(t) for _ in range(ctx.dp_size)]
    dist.all_gather(parts, t.contiguous(), group=ctx.dp_group)
    return torch.cat(parts)


# ---------------------------------------------------------------------------
# collectives of the expert-parallel MoE, with their backward
# ---------------------------------------------------------------------------

def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` (M, ...) -> (M, ...) whose block ``src`` is rank ``src``'s
    block for this rank."""
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return out


def _to_experts(buf: torch.Tensor, ctx: DistContext) -> torch.Tensor:
    """(E, cap, d) dispatch slots -> (E/M, M*cap, d): each rank keeps its
    own experts' slots from every peer.

    The reference's tiled ``lax.all_to_all(split_axis=0, concat_axis=1)``:
    expert block ``j`` of the sender's (E, cap, d) goes to rank ``j``,
    and the receiver lays the blocks side by side along the slot axis in
    sender order.  ``all_to_all_single`` exchanges leading-axis blocks,
    so the slots go as (M, E/M, cap, d) -- block ``j`` = experts
    ``j*E/M ... (j+1)*E/M - 1`` -- and come back as (M_src, E/M, cap,
    d); moving the sender axis inside gives (E/M, M_src*cap, d), whose
    slot ``src*cap + c`` is sender ``src``'s slot ``c``."""
    m = ctx.tp_size
    e, cap, d = buf.shape
    got = _all_to_all(buf.reshape(m, e // m, cap, d), ctx.tp_group)
    return got.transpose(0, 1).reshape(e // m, m * cap, d)


def _to_tokens(y: torch.Tensor, ctx: DistContext) -> torch.Tensor:
    """Inverse of :func:`_to_experts`: (E/M, M*cap, d) expert outputs ->
    (E, cap, d) in the sender's own slot layout (the reference's
    ``lax.all_to_all(split_axis=1, concat_axis=0)``)."""
    m = ctx.tp_size
    e_loc, mc, d = y.shape
    send = y.reshape(e_loc, m, mc // m, d).transpose(0, 1)
    return _all_to_all(send, ctx.tp_group).reshape(m * e_loc, mc // m, d)


class _ToExperts(torch.autograd.Function):
    @staticmethod
    def forward(fctx, buf, ctx):
        fctx.dist = ctx
        return _to_experts(buf, ctx)

    @staticmethod
    def backward(fctx, g):
        # a permutation of slots across ranks: its adjoint is its inverse
        return _to_tokens(g, fctx.dist), None


class _ToTokens(torch.autograd.Function):
    @staticmethod
    def forward(fctx, y, ctx):
        fctx.dist = ctx
        return _to_tokens(y, ctx)

    @staticmethod
    def backward(fctx, g):
        return _to_experts(g, fctx.dist), None


def to_experts(buf: torch.Tensor, ctx: DistContext) -> torch.Tensor:
    """The tiled all_to_all to the experts' ranks (see
    :func:`_to_experts`); its backward is :func:`to_tokens`."""
    return _ToExperts.apply(buf, ctx)


def to_tokens(y: torch.Tensor, ctx: DistContext) -> torch.Tensor:
    """The reverse all_to_all back to the tokens' ranks; its backward is
    :func:`to_experts`."""
    return _ToTokens.apply(y, ctx)


def _gather(t: torch.Tensor, ctx: DistContext, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(ctx.tp_size)]
    dist.all_gather(parts, t.contiguous(), group=ctx.tp_group)
    return torch.cat(parts, dim=dim)


def _chunk(t: torch.Tensor, ctx: DistContext, dim: int) -> torch.Tensor:
    n = t.shape[dim] // ctx.tp_size
    return t.narrow(dim, ctx.tp_rank * n, n)


class _GatherChunks(torch.autograd.Function):
    @staticmethod
    def forward(fctx, t, ctx, dim):
        fctx.dist, fctx.dim = ctx, dim
        return _gather(t, ctx, dim)

    @staticmethod
    def backward(fctx, g):
        # every tp rank holds the whole gradient of the same loss: this
        # rank's chunk of it is its chunk's gradient (a sum over the ranks
        # would count it M times)
        return _chunk(g, fctx.dist, fctx.dim).contiguous(), None, None


class _TakeChunk(torch.autograd.Function):
    @staticmethod
    def forward(fctx, t, ctx, dim):
        fctx.dist, fctx.dim = ctx, dim
        return _chunk(t, ctx, dim).contiguous()

    @staticmethod
    def backward(fctx, g):
        # each rank has the gradient of its own chunk only; the replicated
        # input's gradient is every chunk's, side by side
        return _gather(g, fctx.dist, fctx.dim), None, None


def gather_chunks(t: torch.Tensor, ctx: DistContext,
                  dim: int = 1) -> torch.Tensor:
    """All-gather the tp ranks' chunks of ``dim`` (in rank order) into a
    tensor every tp rank holds.  Backward: this rank's slice."""
    return _GatherChunks.apply(t, ctx, dim)


def take_chunk(t: torch.Tensor, ctx: DistContext,
               dim: int = 1) -> torch.Tensor:
    """This tp rank's chunk of ``dim`` of a replicated tensor.  Backward:
    the all-gather of the chunks' gradients."""
    return _TakeChunk.apply(t, ctx, dim)


class _SumPartials(torch.autograd.Function):
    @staticmethod
    def forward(fctx, t, ctx):
        out = t.clone()
        dist.all_reduce(out, group=ctx.tp_group)
        return out

    @staticmethod
    def backward(fctx, g):
        # every rank's partial reaches the same replicated sum, whose
        # gradient every rank holds whole
        return g, None


class _ReplicaGrad(torch.autograd.Function):
    @staticmethod
    def forward(fctx, t, ctx):
        fctx.dist = ctx
        return t.view_as(t)

    @staticmethod
    def backward(fctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=fctx.dist.tp_group)
        return g, None


def sum_partials(t: torch.Tensor, ctx: DistContext) -> torch.Tensor:
    """The tp ranks' partial sums of one tensor, summed into a tensor every
    tp rank holds.  Backward: the identity."""
    return _SumPartials.apply(t, ctx)


def replica_grad(t: torch.Tensor, ctx: DistContext) -> torch.Tensor:
    """The identity on a tensor every tp rank holds that each rank uses for
    part of the work (its own chunk of tokens, its own experts).
    Backward: the sum of the ranks' partial gradients, so every rank holds
    the whole one (what ``shard_map`` does for a replicated input)."""
    return _ReplicaGrad.apply(t, ctx)


# ---------------------------------------------------------------------------
# the train step's reductions
# ---------------------------------------------------------------------------

def _mean_over(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """The mean of ``t`` over ``group`` (``n`` ranks), summed in float32,
    in ``t``'s dtype."""
    s = t.to(torch.float32, copy=True)
    dist.all_reduce(s, group=group)
    return (s / torch.full_like(s, float(n))).to(t.dtype)


def average_grads(grads, ctx: DistContext | None):
    """Gradients of this rank's dp rows -> the global batch's: expert
    leaves averaged over the dp group, the replicated leaves over the
    whole mesh.  Over the tp axis the latter is the identity in exact
    arithmetic (every tp rank holds the whole gradient); it also makes
    the replicas equal in every bit, which a backward of atomic adds on
    the card (the embedding's) does not."""
    if not sharded(ctx):
        return grads
    out = []
    for path, g in leaves(grads):
        if is_expert_leaf(path):
            out.append(g if ctx.dp_size == 1 else
                       _mean_over(g, ctx.dp_group, ctx.dp_size))
        else:
            out.append(_mean_over(g, None, ctx.size))
    return rebuild(grads, iter(out))


def mesh_mean(t: torch.Tensor, ctx: DistContext | None) -> torch.Tensor:
    """The mean of a scalar over the mesh: of a per-rank loss, the global
    batch's (the tp ranks of a dp block hold equal values)."""
    if not sharded(ctx):
        return t
    return _mean_over(t, None, ctx.size)


def tp_sum(t: torch.Tensor, ctx: DistContext | None) -> torch.Tensor:
    """The sum of ``t`` over the tp group (no gradient)."""
    if ctx is None or ctx.tp_size == 1:
        return t
    out = t.clone()
    dist.all_reduce(out, group=ctx.tp_group)
    return out


@torch.no_grad()
def gather_experts(tree, ctx: DistContext | None):
    """``tree`` with every expert leaf gathered whole over the tp group
    (the other leaves as they are), for a checkpoint in the one-device
    layout.  Every rank takes part."""
    if ctx is None or ctx.tp_size == 1:
        return tree
    return rebuild(tree, iter([_gather(t, ctx, 0) if is_expert_leaf(path)
                               else t for path, t in leaves(tree)]))
