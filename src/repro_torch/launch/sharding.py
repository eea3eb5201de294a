"""Sharding rules: parameter, optimizer, cache and input specs.

The port's counterpart of ``repro.launch.sharding``, with the same rule
tables.  Strategy:
  * 2-D parameter sharding: tensor-parallel ("model") on one contraction
    dimension, FSDP (("pod", "data")) on another -- ZeRO-3 style.
  * attention heads shard over "model" when divisible, else the (small)
    attention weights are replicated over it -- decided per tensor.
  * MoE experts shard over "model" (expert parallelism).
  * KV caches: batch over the data-parallel axes; heads over "model"
    when divisible, else the sequence dimension (sequence-parallel KV);
    batch=1 long context shards the sequence over ("data", "model").

A spec is a tuple with one entry per dimension: ``None`` (replicated), an
axis name, or a tuple of axis names (the dimension split over their
product).  Every rule is checked for divisibility against the mesh, so
the same rules serve the (16, 16) pod mesh, the (2, 16, 16) multi-pod
mesh and small meshes.

The rules read the JAX package's *stacked* layout, which
``models.convert.stack_layers`` (parameters, optimizer moments) and
``models.convert.stack_cache`` (caches) give the port's trees: paths
such as ``groups/0/layers/0/attn/wq`` with a leading ``(n_periods,)``
dimension on every layer leaf.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from .mesh import Mesh

Spec = tuple


def _size(mesh: Mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(mesh.shape[a] for a in axes)


def _fits(dim: int, mesh: Mesh, axes) -> bool:
    return axes is not None and dim % _size(mesh, axes) == 0


def _replicated(shape) -> Spec:
    return (None,) * len(shape)


def _canonical(spec: Spec) -> Spec:
    """A one-axis tuple entry as the axis name (as ``PartitionSpec``
    stores it)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def param_spec(path_s: str, shape: tuple[int, ...], mesh: Mesh,
               fsdp: Any = ("pod", "data"), tp: str = "model") -> Spec:
    """Rule table keyed by the trailing parameter name."""
    return _canonical(_param_rule(path_s, shape, mesh, fsdp, tp))


def _param_rule(path_s, shape, mesh, fsdp, tp) -> Spec:
    fsdp = tuple(a for a in (fsdp if isinstance(fsdp, tuple) else (fsdp,))
                 if a in mesh.axis_names) or None
    if tp not in mesh.axis_names:
        tp = None
    name = path_s.rsplit("/", 2)
    leaf = name[-1]
    parent = name[-2] if len(name) > 1 else ""

    def ax(dim, axes):
        return axes if _fits(dim, mesh, axes) else None

    # ---- top level ----
    if path_s.endswith("embed/table"):        # (V, d)
        return (ax(shape[0], tp), ax(shape[1], fsdp))
    if path_s.endswith("head/w"):             # (d, V)
        return (ax(shape[0], fsdp), ax(shape[1], tp))
    if "final_norm" in path_s or parent in ("norm1", "norm2"):
        return _replicated(shape)

    # ---- stacked layer params: shape[0] = n_periods ----
    if parent == "attn":
        # head-indivisible archs replicate the attention weights over tp
        if leaf in ("wq", "wk", "wv"):        # (L, d, H|K, hd)
            heads = tp if _fits(shape[2], mesh, tp) else None
            return (None, ax(shape[1], fsdp), heads, None)
        if leaf == "wo":                      # (L, H, hd, d)
            heads = tp if _fits(shape[1], mesh, tp) else None
            return (None, heads, None, ax(shape[3], fsdp))
        return _replicated(shape)             # q_norm / k_norm
    if parent == "mlp":
        if leaf in ("w1", "w3"):              # (L, d, f)
            return (None, ax(shape[1], fsdp), ax(shape[2], tp))
        return (None, ax(shape[1], tp), ax(shape[2], fsdp))  # w2 (L, f, d)
    if parent == "moe":
        if leaf == "router":                  # (L, d, E)
            return (None, ax(shape[1], fsdp), None)
        if leaf in ("w1", "w3"):              # (L, E, d, ef)
            return (None, ax(shape[1], tp), ax(shape[2], fsdp), None)
        return (None, ax(shape[1], tp), None, ax(shape[3], fsdp))  # w2
    if parent == "rec":
        r_rules = {
            "w_in": lambda s: (None, ax(s[1], fsdp), ax(s[2], tp)),
            "w_gate": lambda s: (None, ax(s[1], fsdp), ax(s[2], tp)),
            "conv_w": lambda s: (None, None, ax(s[2], tp)),
            "wa": lambda s: (None, ax(s[1], tp), None),
            "wx": lambda s: (None, ax(s[1], tp), None),
            "w_out": lambda s: (None, ax(s[1], tp), ax(s[2], fsdp)),
        }
        if leaf in r_rules:
            return r_rules[leaf](shape)
        if len(shape) == 2:                   # conv_b, ba, bx, lam (L, r)
            return (None, ax(shape[1], tp))
        return _replicated(shape)
    if parent == "tmix":
        t_rules = {
            "wr": lambda s: (None, ax(s[1], fsdp), ax(s[2], tp)),
            "wk": lambda s: (None, ax(s[1], fsdp), ax(s[2], tp)),
            "wv": lambda s: (None, ax(s[1], fsdp), ax(s[2], tp)),
            "wg": lambda s: (None, ax(s[1], fsdp), ax(s[2], tp)),
            "wo": lambda s: (None, ax(s[1], tp), ax(s[2], fsdp)),
            "wa": lambda s: (None, ax(s[1], fsdp), None),
            "wb": lambda s: (None, None, ax(s[2], tp)),
        }
        if leaf in t_rules:
            return t_rules[leaf](shape)
        if leaf in ("w0", "ln"):              # (L, m)
            return (None, ax(shape[1], tp))
        return _replicated(shape)             # mu, u
    if parent == "cmix":
        c_rules = {
            "wk": lambda s: (None, ax(s[1], fsdp), ax(s[2], tp)),
            "wv": lambda s: (None, ax(s[1], tp), ax(s[2], fsdp)),
            "wr": lambda s: (None, ax(s[1], fsdp), ax(s[2], tp)),
        }
        if leaf in c_rules:
            return c_rules[leaf](shape)
        return _replicated(shape)
    return _replicated(shape)


def tree_paths(tree, prefix: str = ""):
    """``(path, leaf)`` of every tensor leaf of nested dicts and lists,
    the path's parts joined by "/" (list entries by their index), in the
    tree's own order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_paths(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_paths(v, f"{prefix}{i}/")
    elif tree is not None:
        yield prefix[:-1], tree


def param_shardings(mesh: Mesh, params_tree, fsdp=("pod", "data")
                    ) -> dict[str, Spec]:
    """Path -> spec of every leaf of a stacked params tree."""
    return {p: param_spec(p, tuple(t.shape), mesh, fsdp=fsdp)
            for p, t in tree_paths(params_tree)}


def opt_shardings(mesh: Mesh, opt_tree, fsdp=("pod", "data")
                  ) -> dict[str, Spec]:
    """mu / nu mirror the params; the step count is replicated."""
    out = {}
    for p, t in tree_paths(opt_tree):
        if p.endswith("step"):
            out[p] = ()
        else:
            stripped = p.split("/", 1)[1] if "/" in p else p  # drop mu|nu
            out[p] = param_spec(stripped, tuple(t.shape), mesh, fsdp=fsdp)
    return out


# -- caches & inputs -----------------------------------------------------------

def _dp_axes(mesh: Mesh):
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def cache_spec(path_s: str, shape: tuple[int, ...], mesh: Mesh,
               tp: str = "model") -> Spec:
    return _canonical(_cache_rule(path_s, shape, mesh, tp))


def _cache_rule(path_s, shape, mesh, tp) -> Spec:
    dp = _dp_axes(mesh)
    if tp not in mesh.axis_names:
        tp = None
    leaf = path_s.rsplit("/", 1)[-1]
    batch_ok = len(shape) >= 2 and _fits(shape[1], mesh, dp)
    b_ax = dp if batch_ok else None
    if leaf in ("k", "v"):                   # (L, B, S, K, hd)
        if _fits(shape[3], mesh, tp):
            return (None, b_ax, None, tp, None)
        if not batch_ok:
            # batch=1 long context: spread sequence over everything usable
            seq_axes = tuple(a for a in ("data", tp) if a in mesh.axis_names)
            if _fits(shape[2], mesh, seq_axes):
                return (None, None, seq_axes, None, None)
        if _fits(shape[2], mesh, tp):
            return (None, b_ax, tp, None, None)
        return (None, b_ax, None, None, ax_last(shape, mesh, tp))
    if leaf == "state":                      # rwkv (L, B, H, n, n)
        return (None, b_ax, None, None,
                tp if _fits(shape[4], mesh, tp) else None)
    if leaf == "shift":                      # (L, B, d)
        return (None, b_ax, tp if _fits(shape[2], mesh, tp) else None)
    if leaf == "h":                          # rglru (L, B, r)
        return (None, b_ax, tp if _fits(shape[2], mesh, tp) else None)
    if leaf == "conv":                       # (L, B, cw-1, r)
        return (None, b_ax, None, tp if _fits(shape[3], mesh, tp) else None)
    return _replicated(shape)


def ax_last(shape, mesh: Mesh, tp):
    return tp if _fits(shape[-1], mesh, tp) else None


def cache_shardings(mesh: Mesh, cache_tree) -> dict[str, Spec]:
    """Path -> spec of every leaf of a stacked cache tree."""
    return {p: cache_spec(p, tuple(t.shape), mesh)
            for p, t in tree_paths(cache_tree)}


def batch_sharding(mesh: Mesh, shape: tuple[int, ...]) -> Spec:
    """Tokens (B,S) / embeddings (B,S,d) / decode tokens (B,)."""
    dp = _dp_axes(mesh)
    b_ax = dp if _fits(shape[0], mesh, dp) else None
    return _canonical((b_ax, *([None] * (len(shape) - 1))))


def replicated(mesh: Mesh) -> Spec:
    return ()


def shard_bytes(shape: tuple[int, ...], dtype: torch.dtype, spec: Spec,
                mesh: Mesh) -> int:
    """Bytes one device holds of a ``shape``/``dtype`` array laid out by
    ``spec`` on ``mesh`` (a spec shorter than the shape replicates the
    rest).  Every split dimension must divide evenly, as the rules make
    it."""
    n = math.prod(shape)
    for dim, axes in zip(shape, spec):
        k = _size(mesh, axes)
        if dim % k:
            raise ValueError(f"dimension {dim} does not split over {axes} "
                             f"({k} devices)")
        n //= k
    return n * dtype.itemsize
