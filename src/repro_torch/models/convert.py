"""Parameters of the JAX package's model as the port's parameter dict.

The JAX model keeps each group's layers as stacked ``(n_periods, ...)``
leaves under ``params["groups"][g]["layers"][j]`` (j = position in the
layer pattern); the port keeps one dict per layer in run order under
``params["layers"]``.  :func:`params_from_numpy` takes the JAX pytree
with its leaves as numpy arrays and unstacks it, so both packages
compute the same function from the same weights.
:func:`split_params_from_numpy` does the same for the split runtime's
tree (stage layers stacked (2, half, ...), tail layers (t, ...)).

Each leaf takes the dtype the reference gives it: the model's dtype,
except the leaves the reference keeps in float32 whatever the model's
dtype (:data:`FLOAT32_LEAVES`).

Under a :class:`~.context.DistContext` with a tp axis of M ranks, a
rank keeps only its E/M experts of each MoE leaf (a copy of its slice:
the whole stack is not held), as :func:`shard_experts` does for a tree
already in the port's layout.
"""

from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.backend import host_tensor
from ..tree import leaves, rebuild
from .context import expert_slice, is_expert_leaf
from .transformer import build_groups, resolve_device, torch_dtype

#: (block, leaf) names of the layer leaves that stay float32: the MoE
#: router, RWKV-6's base decay and first-token bonus, RG-LRU's Lambda
FLOAT32_LEAVES = {("moe", "router"), ("tmix", "w0"), ("tmix", "u"),
                  ("rec", "lam")}


def from_numpy(a, dtype=None, device=None) -> torch.Tensor:
    """Numpy leaf -> tensor (cast to ``dtype`` when given).  A bfloat16
    leaf, which numpy holds as two-byte void (``'<V2'``, what ``np.savez``
    writes for it) or as an extension dtype, keeps its bits."""
    arr = np.asarray(a)
    if arr.dtype.kind not in "fiub" and arr.dtype.itemsize == 2:
        bits = host_tensor(np.ascontiguousarray(arr).view(np.int16))
        t = bits.view(torch.bfloat16).to(device)
    else:
        if arr.dtype.kind not in "fiub":     # another extension dtype
            arr = arr.astype(np.float32)
        t = host_tensor(arr, device=device)
    return t if dtype is None else t.to(dtype)


def to_numpy(t) -> np.ndarray:
    """Tensor -> a numpy copy on the host; bfloat16 as ``'<V2'`` with the
    same bits (numpy has no bfloat16), as the reference's checkpoints
    store it."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _tree(node, fn, path=()):
    if isinstance(node, dict):
        return {k: _tree(v, fn, path + (k,)) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_tree(v, fn, path + (i,)) for i, v in enumerate(node)]
    return fn(node, path)


def _leaf_dtype(cfg: ModelConfig, path):
    """The dtype the reference gives a parameter leaf at ``path``."""
    return torch.float32 if tuple(path[-2:]) in FLOAT32_LEAVES \
        else torch_dtype(cfg)


def rank_part(a, path, ctx):
    """A numpy leaf, or this rank's slice of it if it is an expert stack
    (a copy: the stack is not kept alive by a view)."""
    if ctx is None or ctx.tp_size == 1 or not is_expert_leaf(path):
        return a
    a = np.asarray(a)
    return np.array(a[expert_slice(ctx, a.shape[0])], copy=True)


def shard_experts(cfg: ModelConfig, tree, ctx):
    """A port-layout tree (parameters, gradients, moments or error
    feedback) with each expert stack cut to this rank's slice, copied so
    the whole stack can be freed; the other leaves are the same
    objects."""
    if ctx is None or ctx.tp_size == 1:
        return tree
    return rebuild(tree, iter(
        [t[expert_slice(ctx, t.shape[0])].clone() if is_expert_leaf(path)
         else t for path, t in leaves(tree)]))


def _layout(cfg: ModelConfig, tree, conv):
    """A JAX-layout tree in the port's layout, ``conv(leaf, path)`` of
    every leaf: each group's stacked layer leaves cut into one dict a
    layer, in run order."""
    out = {k: _tree(v, conv) for k, v in tree.items() if k != "groups"}
    layers = []
    for group in tree["groups"]:
        specs = group["layers"]
        n_periods = int(np.shape(specs[0]["norm1"]["scale"])[0])
        for p in range(n_periods):
            for spec_params in specs:
                layers.append(_tree(spec_params, lambda a, path, p=p:
                                    conv(a[p], path)))
    if len(layers) != cfg.num_layers:
        raise ValueError(f"tree holds {len(layers)} layers, config "
                         f"{cfg.name} has {cfg.num_layers}")
    out["layers"] = layers
    return out


def _stacked(trees, stack):
    """One tree of ``stack``ed leaves from same-shaped trees, dict keys
    sorted as ``jax.tree`` orders them."""
    if isinstance(trees[0], dict):
        return {k: _stacked([t[k] for t in trees], stack)
                for k in sorted(trees[0])}
    return stack(trees)


def _restack(cfg: ModelConfig, tree, stack):
    """Port layout -> the JAX package's (unsplit) layout: each group's
    layers stacked over its periods by ``stack``, keys sorted."""
    groups, _ = build_groups(cfg)
    layers, i, gps = tree["layers"], 0, []
    for g in groups:
        n = len(g.specs)
        gps.append({"layers": [
            _stacked([layers[i + p * n + j] for p in range(g.n_periods)],
                     stack) for j in range(n)]})
        i += g.n_periods * n
    out = {k: v for k, v in tree.items() if k != "layers"}
    out["groups"] = gps
    return {k: out[k] for k in sorted(out)}


def stack_layers(cfg: ModelConfig, tree):
    """A port-layout tree of tensors in the JAX package's stacked layout
    (dict keys sorted, so its leaves come in ``jax.tree``'s order)."""
    return _restack(cfg, tree, torch.stack)


def stack_cache(cfg: ModelConfig, cache):
    """A port cache (unsplit ``init_cache``: a list a group of per-layer
    dicts) in the JAX package's layout: a list a group of one dict per
    pattern position, each leaf stacked over the group's periods."""
    groups, _ = build_groups(cfg)
    out = []
    for g, layers in zip(groups, cache):
        n = len(g.specs)
        out.append([_stacked([layers[p * n + j] for p in range(g.n_periods)],
                             torch.stack) for j in range(n)])
    return out


def unstack_layers(cfg: ModelConfig, tree):
    """Inverse of :func:`stack_layers`: per-layer views of the stacks."""
    return _layout(cfg, tree, lambda a, path: a)


def params_from_numpy(cfg: ModelConfig, tree, *, device="cuda", ctx=None):
    """JAX-layout parameter tree (numpy leaves) -> port parameter dict on
    ``device`` (the card unless the CPU is asked for); under ``ctx`` with
    this rank's experts only."""
    device = resolve_device(device)

    def conv(a, path):
        return from_numpy(rank_part(a, path, ctx), _leaf_dtype(cfg, path),
                          device)

    return _layout(cfg, tree, conv)


def train_state_from_numpy(cfg: ModelConfig, tree, *, device="cuda",
                           ctx=None):
    """The JAX package's training state ``{"params", "opt": {"mu", "nu",
    "step"}, "ef"}`` (numpy leaves, stacked layout, bfloat16 leaves as
    ``'<V2'`` bits or an extension dtype) -> the port's, on ``device``.
    Parameters take :func:`params_from_numpy`'s dtypes; moments and
    error feedback stay float32, the step count int32.  Under ``ctx``
    every expert leaf is this rank's slice."""
    device = resolve_device(device)

    def f32(t):
        return _layout(cfg, t, lambda a, path: from_numpy(
            rank_part(a, path, ctx), torch.float32, device))

    opt = tree["opt"]
    return {"params": params_from_numpy(cfg, tree["params"], device=device,
                                        ctx=ctx),
            "opt": {"mu": f32(opt["mu"]), "nu": f32(opt["nu"]),
                    "step": from_numpy(opt["step"], torch.int32, device)},
            "ef": f32(tree["ef"])}


def train_state_to_numpy(cfg: ModelConfig, state):
    """The port's training state -> the JAX package's unsplit stacked
    layout with numpy leaves (bfloat16 as ``'<V2'`` bits), for
    ``repro.train.checkpoint`` or ``jax.tree.map(jnp.asarray, ...)``."""
    def host(tree):
        host_tree = _tree(tree, lambda t, path: to_numpy(t))
        return _restack(cfg, host_tree, np.stack)

    opt = state["opt"]
    return {"ef": host(state["ef"]),
            "opt": {"mu": host(opt["mu"]), "nu": host(opt["nu"]),
                    "step": to_numpy(opt["step"])},
            "params": host(state["params"])}


def split_params_from_numpy(cfg: ModelConfig, tree, *, edge_device="cuda",
                            cloud_device="cuda", ctx=None):
    """JAX split-runtime parameter tree (``init_split_params``, numpy
    leaves) -> the port's split parameters, each stage's tensors made on
    its own device, each leaf in :func:`params_from_numpy`'s dtype.
    Under ``ctx`` (the split runtime's context across ranks) only this
    rank's stage is made, and of each expert stack only this rank's slice
    is kept (:func:`~repro_torch.compression.split_runtime.split_params`).
    """
    from ..compression.split_runtime import split_params
    edge = resolve_device(edge_device)
    cloud = resolve_device(cloud_device)
    # under a context: the stage this rank holds (the other is not made)
    mine = None if ctx is None else ("edge" if ctx.pod_rank == 0
                                     else "cloud")

    def conv(device, stage):
        def leaf(a, path=()):
            if mine not in (None, stage):
                return None
            return from_numpy(a, _leaf_dtype(cfg, path), device)
        return leaf

    def unstack(stacks, lead, device, stage):
        """Layer dicts of a stacked tree (a one-entry list for the one
        pattern position of a period-1 model), indexed ``lead + (i,)``."""
        (stack,) = stacks
        n = np.asarray(stack["norm1"]["scale"]).shape[len(lead)]
        return [_tree(stack, lambda a, path, i=i: conv(device, stage)(
            np.asarray(a)[lead + (i,)], path)) for i in range(n)]

    layers = unstack(tree["stages"], (0,), edge, "edge") \
        + unstack(tree["stages"], (1,), cloud, "cloud")
    if tree.get("tail") is not None:
        layers += unstack(tree["tail"], (), cloud, "cloud")
    if len(layers) != cfg.num_layers:
        raise ValueError(f"tree holds {len(layers)} layers, config "
                         f"{cfg.name} has {cfg.num_layers}")
    # a rank of the cloud holds the embedding only when the head is tied
    # to it
    tied_cloud = mine == "cloud" and cfg.tie_embeddings
    params = {"embed": _tree(tree["embed"], conv(cloud, "cloud")
                             if tied_cloud else conv(edge, "edge")),
              "final_norm": _tree(tree["final_norm"], conv(cloud, "cloud")),
              "layers": layers}
    if tree.get("head") is not None:
        params["head"] = _tree(tree["head"], conv(cloud, "cloud"))
    return split_params(cfg, params, edge_device=edge, cloud_device=cloud,
                        ctx=ctx)
