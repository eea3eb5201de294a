"""Port vs reference: the sharding rules (``repro_torch.launch.sharding``
against ``repro.launch.sharding``) and the abstract meshes.

The reference's rules run on a ``jax.sharding.AbstractMesh`` over
``jax.eval_shape`` of its full-size trees (no devices); the port's over
``stack_layers`` / ``stack_cache`` of ``meta`` trees of the same configs.
For all 10 archs on five meshes -- (16, 16), (2, 16, 16), (1, 1), (4, 2),
(2, 4) -- every parameter, optimizer, cache and batch spec must equal
the reference's, and the bytes one device holds must equal the sum
computed from the reference's specs.  Tolerance: exact.
"""

import functools
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import models as jm
from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.launch import sharding as JSH
from repro.optim import init_opt_state as jinit_opt
from repro_torch import models as tm
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.launch import mesh as M
from repro_torch.launch import sharding as SH
from repro_torch.models.convert import stack_cache, stack_layers
from repro_torch.optim import init_opt_state

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "1x1": ((1, 1), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "2x4": ((2, 4), ("data", "model"))}
CACHE_SHAPES = [s for s in SHAPES if SHAPES[s].kind != "train"]


def _meshes(name):
    sizes, axes = MESHES[name]
    return AbstractMesh(sizes, axes), M.Mesh(sizes, axes)


# -- the two packages' trees ----------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return jax.eval_shape(functools.partial(jm.init_params, JARCHS[arch]),
                          jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return tm.init_params(get_config(arch), None, device="meta")


@functools.lru_cache(maxsize=None)
def _ref_cache(arch, shape):
    s = JSHAPES[shape]
    return jax.eval_shape(functools.partial(
        jm.init_cache, JARCHS[arch], s.global_batch, s.seq_len))


@functools.lru_cache(maxsize=None)
def _port_cache(arch, shape):
    s = SHAPES[shape]
    cfg = get_config(arch)
    return stack_cache(cfg, tm.init_cache(cfg, s.global_batch, s.seq_len,
                                          device="meta"))


def _port_opt(arch):
    cfg = get_config(arch)
    opt = init_opt_state(_port_params(arch))
    return {"mu": stack_layers(cfg, opt["mu"]),
            "nu": stack_layers(cfg, opt["nu"]), "step": opt["step"]}


def _ref_specs(tree, rule):
    """Path -> spec tuple of every leaf of a reference tree, by ``rule``
    (a reference ``*_shardings`` function of the tree)."""
    shardings = rule(tree)
    flat = jax.tree_util.tree_flatten_with_path(shardings)[0]
    return {JSH._path_str(p): tuple(s.spec) for p, s in flat}


def _ref_bytes(tree, specs, amesh):
    """One device's bytes of a reference tree under its specs."""
    total = 0
    for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        n = math.prod(leaf.shape)
        for axes in specs[JSH._path_str(p)]:
            if axes is not None:
                axes = (axes,) if isinstance(axes, str) else axes
                n //= math.prod(amesh.shape[a] for a in axes)
        total += n * np.dtype(leaf.dtype).itemsize
    return total


def _port_bytes(tree, specs, mesh):
    return sum(SH.shard_bytes(tuple(t.shape), t.dtype, specs[p], mesh)
               for p, t in SH.tree_paths(tree))


# -- specs ------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_match_reference(arch, mesh_name):
    amesh, mesh = _meshes(mesh_name)
    ref = _ref_specs(_ref_params(arch), functools.partial(
        JSH.param_shardings, JARCHS[arch], amesh))
    port = SH.param_shardings(mesh, stack_layers(get_config(arch),
                                                 _port_params(arch)))
    assert port == ref


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_opt_specs_match_reference(arch, mesh_name):
    amesh, mesh = _meshes(mesh_name)
    ref = _ref_specs(jax.eval_shape(jinit_opt, _ref_params(arch)),
                     functools.partial(JSH.opt_shardings, JARCHS[arch],
                                       amesh))
    assert SH.opt_shardings(mesh, _port_opt(arch)) == ref


@pytest.mark.parametrize("shape", CACHE_SHAPES)
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_specs_match_reference(arch, mesh_name, shape):
    amesh, mesh = _meshes(mesh_name)
    ref = _ref_specs(_ref_cache(arch, shape), functools.partial(
        JSH.cache_shardings, JARCHS[arch], amesh))
    port = SH.cache_shardings(mesh, _port_cache(arch, shape))
    assert port == ref
    assert _port_bytes(_port_cache(arch, shape), port, mesh) \
        == _ref_bytes(_ref_cache(arch, shape), ref, amesh)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_specs_match_reference(mesh_name):
    amesh, mesh = _meshes(mesh_name)
    for s in SHAPES.values():
        for shape in [(s.global_batch, s.seq_len),
                      (s.global_batch, s.seq_len, 64), (s.global_batch,)]:
            assert SH.batch_sharding(mesh, shape) \
                == tuple(JSH.batch_sharding(amesh, shape).spec), shape
    assert SH.replicated(mesh) == tuple(JSH.replicated(amesh).spec) == ()


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_shard_bytes_match_reference(arch, mesh_name):
    """One device's bytes of the parameters and of the AdamW state."""
    amesh, mesh = _meshes(mesh_name)
    cfg = get_config(arch)
    params = stack_layers(cfg, _port_params(arch))
    ref_specs = _ref_specs(_ref_params(arch), functools.partial(
        JSH.param_shardings, JARCHS[arch], amesh))
    port = _port_bytes(params, SH.param_shardings(mesh, params), mesh)
    assert port == _ref_bytes(_ref_params(arch), ref_specs, amesh)
    opt_ref = jax.eval_shape(jinit_opt, _ref_params(arch))
    opt_specs = _ref_specs(opt_ref, functools.partial(
        JSH.opt_shardings, JARCHS[arch], amesh))
    opt = _port_opt(arch)
    assert _port_bytes(opt, SH.opt_shardings(mesh, opt), mesh) \
        == _ref_bytes(opt_ref, opt_specs, amesh)


def test_shard_bytes_refuses_an_uneven_split():
    mesh = M.Mesh((4, 2), ("data", "model"))
    assert SH.shard_bytes((8, 6), torch.bfloat16, ("data", "model"),
                          mesh) == 2 * 3 * 2
    assert SH.shard_bytes((8, 6), torch.float32, (("data", "model"),),
                          mesh) == 6 * 4
    with pytest.raises(ValueError):
        SH.shard_bytes((6, 6), torch.float32, ("data", None), mesh)


# -- meshes -----------------------------------------------------------------------

@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh(multi_pod):
    mesh = M.make_production_mesh(multi_pod=multi_pod)
    amesh = AbstractMesh(*MESHES["2x16x16" if multi_pod else "16x16"])
    assert mesh.shape == dict(amesh.shape)
    assert mesh.axis_names == tuple(amesh.axis_names)
    assert mesh.size == amesh.size == (512 if multi_pod else 256)
    assert mesh.name == ("pod2x16x16" if multi_pod else "pod16x16")
    assert M.dp_axes_of(mesh) == (("pod", "data") if multi_pod
                                  else ("data",))


@pytest.mark.parametrize("devices,model_axis,sizes", [
    (1, None, (1, 1)), (2, None, (1, 2)), (3, None, (3, 1)),
    (8, None, (4, 2)), (8, 4, (2, 4))])
def test_smoke_mesh_rule(devices, model_axis, sizes):
    mesh = M.make_smoke_mesh(devices, model_axis)
    assert mesh.sizes == sizes and mesh.axis_names == ("data", "model")
    assert mesh.name == "mesh" + "x".join(map(str, sizes))


def test_smoke_mesh_needs_a_card_or_a_count(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.make_smoke_mesh()
    with pytest.raises(ValueError):
        M.Mesh((2, 2), ("data", "data"))
