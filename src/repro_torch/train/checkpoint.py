"""Fault-tolerant checkpointing in the JAX package's on-disk layout.

Layout: ``step_%08d/arrays.npz`` (one array per leaf, keyed by the leaf's
path joined by ``/``) and ``manifest.json``; writes go to a temporary
directory that is renamed atomically, so a crash mid-save never corrupts
the latest checkpoint, and the oldest checkpoints beyond ``keep`` are
removed.  Async mode snapshots to host memory and writes on a background
thread, so the train loop never blocks on disk.

bfloat16 leaves are stored as ``'<V2'`` arrays with the same bits, as the
reference's ``np.savez`` of an ``ml_dtypes`` array stores them (numpy has
no bfloat16), so each package reads the other's arrays.  Their trees
differ (the reference stacks a group's layers): the training state
crosses packages through ``models.convert.train_state_{from,to}_numpy``.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np

from ..models.convert import from_numpy, to_numpy
from ..tree import leaves, rebuild


def _flat_with_paths(tree):
    """(key, leaf) pairs, keys joined by ``/``, in ``jax.tree``'s order."""
    return [("/".join(str(e) for e in path), leaf)
            for path, leaf in leaves(tree, sort_keys=True)]


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3,
         async_: bool = False):
    """Save ``tree`` (tensors, numpy arrays or numbers; gathered to the
    host) as checkpoint ``step``.  With ``async_`` the write runs on a
    daemon thread, which is returned."""
    host = {k: to_numpy(v) for k, v in _flat_with_paths(tree)}

    def _write():
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **host)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "keys": sorted(host)}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _gc(ckpt_dir, keep)

    if async_:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_")
                   and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def manifest(ckpt_dir: str, step: int) -> dict:
    """Checkpoint ``step``'s manifest: its step and sorted keys."""
    with open(os.path.join(ckpt_dir, f"step_{step:08d}",
                           "manifest.json")) as f:
        return json.load(f)


def _arrays(ckpt_dir: str, step: int):
    return np.load(os.path.join(ckpt_dir, f"step_{step:08d}", "arrays.npz"))


def restore(ckpt_dir: str, step: int, target_tree, *, select=None):
    """Restore into the structure of ``target_tree`` (tensors): each leaf
    takes its target's dtype and device.  ``select(key, array)``, where
    given, picks the part of a stored array the target holds (a rank's
    slice of an expert stack)."""
    out = []
    with _arrays(ckpt_dir, step) as data:
        for k, ref in _flat_with_paths(target_tree):
            arr = data[k] if select is None else select(k, data[k])
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"{k}: ckpt shape {arr.shape} != target "
                                 f"{tuple(ref.shape)}")
            out.append(from_numpy(arr, ref.dtype, ref.device))
    return rebuild(target_tree, iter(out), sort_keys=True)


def load_tree(ckpt_dir: str, step: int):
    """Checkpoint ``step`` as a nested tree of numpy arrays, rebuilt from
    its keys (a numeric key part is a list position): how a checkpoint
    of the other package is read before ``train_state_from_numpy``."""
    root: dict = {}
    with _arrays(ckpt_dir, step) as data:
        for k in data.files:
            *parts, last = k.split("/")
            node = root
            for part in parts:
                node = node.setdefault(part, {})
            node[last] = data[k]
    return _lists(root)


def _lists(node):
    """Dicts keyed 0..n-1 become lists."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(k.isdigit() for k in out):
        return [out[str(i)] for i in range(len(out))]
    return out
