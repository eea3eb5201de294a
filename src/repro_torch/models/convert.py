"""Parameters of the JAX package's model as the port's parameter dict.

The JAX model keeps each group's layers as stacked ``(n_periods, ...)``
leaves under ``params["groups"][g]["layers"][j]`` (j = position in the
layer pattern); the port keeps one dict per layer in run order under
``params["layers"]``.  :func:`params_from_numpy` takes the JAX pytree
with its leaves as numpy arrays and unstacks it, so both packages
compute the same function from the same weights.
:func:`split_params_from_numpy` does the same for the split runtime's
tree (stage layers stacked (2, half, ...), tail layers (t, ...)).
"""

from __future__ import annotations

import numpy as np

from ..configs.base import ModelConfig
from ..core.backend import host_tensor
from .transformer import _check_dense, resolve_device, torch_dtype


def _tensor(a, dtype, device):
    arr = np.asarray(a)
    if arr.dtype.kind not in "fiub":     # e.g. a bfloat16 extension dtype
        arr = arr.astype(np.float32)
    return host_tensor(arr, device=device).to(dtype)


def _tree(node, fn):
    if isinstance(node, dict):
        return {k: _tree(v, fn) for k, v in node.items()}
    return fn(node)


def params_from_numpy(cfg: ModelConfig, tree, *, device="cuda"):
    """JAX-layout parameter tree (numpy leaves) -> port parameter dict on
    ``device`` (the card unless the CPU is asked for)."""
    _check_dense(cfg)
    device = resolve_device(device)
    dtype = torch_dtype(cfg)
    conv = lambda a: _tensor(a, dtype, device)  # noqa: E731
    out = {k: _tree(tree[k], conv)
           for k in ("embed", "final_norm", "head") if k in tree}
    layers = []
    for group in tree["groups"]:
        specs = group["layers"]
        n_periods = int(np.asarray(specs[0]["norm1"]["scale"]).shape[0])
        for p in range(n_periods):
            for spec_params in specs:
                layers.append(_tree(spec_params,
                                    lambda a: conv(np.asarray(a)[p])))
    if len(layers) != cfg.num_layers:
        raise ValueError(f"tree holds {len(layers)} layers, config "
                         f"{cfg.name} has {cfg.num_layers}")
    out["layers"] = layers
    return out


def split_params_from_numpy(cfg: ModelConfig, tree, *, edge_device="cuda",
                            cloud_device="cuda"):
    """JAX split-runtime parameter tree (``init_split_params``, numpy
    leaves) -> the port's split parameters, each stage's tensors made on
    its own device."""
    from ..compression.split_runtime import split_params
    _check_dense(cfg)
    edge = resolve_device(edge_device)
    cloud = resolve_device(cloud_device)
    dtype = torch_dtype(cfg)

    def conv(device):
        return lambda a: _tensor(a, dtype, device)

    def unstack(stacks, lead, device):
        """Layer dicts of a stacked tree (a one-entry list for the one
        pattern position of a period-1 model), indexed ``lead + (i,)``."""
        (stack,) = stacks
        n = np.asarray(stack["norm1"]["scale"]).shape[len(lead)]
        return [_tree(stack, lambda a, i=i: conv(device)(
            np.asarray(a)[lead + (i,)])) for i in range(n)]

    layers = unstack(tree["stages"], (0,), edge) \
        + unstack(tree["stages"], (1,), cloud)
    if tree.get("tail") is not None:
        layers += unstack(tree["tail"], (), cloud)
    if len(layers) != cfg.num_layers:
        raise ValueError(f"tree holds {len(layers)} layers, config "
                         f"{cfg.name} has {cfg.num_layers}")
    params = {"embed": _tree(tree["embed"], conv(edge)),
              "final_norm": _tree(tree["final_norm"], conv(cloud)),
              "layers": layers}
    if tree.get("head") is not None:
        params["head"] = _tree(tree["head"], conv(cloud))
    return split_params(cfg, params, edge_device=edge, cloud_device=cloud)
