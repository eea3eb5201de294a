"""Abstract device meshes: axis names and sizes, no devices.

The port's counterpart of ``repro.launch.mesh``.  A :class:`Mesh` here is
what ``jax.sharding.AbstractMesh`` is to the JAX package: enough to
decide and size a sharding (``launch.sharding``) and to cost a step over
a mesh (``launch.dryrun``), with no device, process group or
``DeviceMesh`` behind it.  The production target is one pod of 16 x 16
= 256 cards; the multi-pod mesh stacks 2 pods (512 cards) along a
leading "pod" axis used for data parallelism and for the
collaborative-intelligence edge/cloud split.  Meshes are made by
functions, never held in module-level constants.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis sizes (``sizes``) under axis names (``axis_names``)."""
    sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.sizes) != len(self.axis_names):
            raise ValueError(f"{len(self.sizes)} sizes for "
                             f"{len(self.axis_names)} axis names")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")
        if any(n < 1 for n in self.sizes):
            raise ValueError(f"axis sizes must be positive: {self.sizes}")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, in axis order."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        """The number of devices."""
        return math.prod(self.sizes)

    @property
    def name(self) -> str:
        """The name a dry-run record gives the mesh: ``pod16x16`` and
        ``pod2x16x16`` for the production meshes, else ``mesh<sizes>``."""
        dims = "x".join(str(n) for n in self.sizes)
        prod = self in (make_production_mesh(),
                        make_production_mesh(multi_pod=True))
        return ("pod" if prod else "mesh") + dims


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def make_smoke_mesh(devices: int | None = None,
                    model_axis: int | None = None) -> Mesh:
    """A small ("data", "model") mesh over ``devices`` cards (default:
    every CUDA card here; there must be one).  The model axis is 2 when
    the count is even and above 1, else 1, as in the JAX package."""
    if devices is None:
        devices = torch.cuda.device_count()
        if devices == 0:
            raise RuntimeError("make_smoke_mesh: no CUDA device; pass "
                               "devices= for a mesh of a given size")
    m = model_axis or (2 if devices % 2 == 0 and devices > 1 else 1)
    if devices % m:
        raise ValueError(f"model axis {m} does not divide {devices} devices")
    return Mesh((devices // m, m), ("data", "model"))


def dp_axes_of(mesh: Mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def device_mesh(mesh: Mesh, device_type: str = "cuda"):
    """``mesh`` as a ``torch.distributed`` ``DeviceMesh`` over the ranks of
    the default process group (which must be initialised and hold
    ``mesh.size`` ranks), with the same axis names and sizes: rank ``r``
    sits at ``r``'s row-major coordinate.  A ``models.DistContext`` takes
    it."""
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(device_type,
                      torch.arange(mesh.size).reshape(mesh.sizes),
                      mesh_dim_names=mesh.axis_names)
