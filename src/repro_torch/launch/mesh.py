"""Production mesh shapes (``repro.launch.mesh``).

A mesh here is a ``MeshSpec``: the shape and the axis names, which is
all the sharding rules and the dry run's per-device accounting read.
``device_mesh`` turns one into a ``torch.distributed.device_mesh.
DeviceMesh`` when a world of ``prod(shape)`` ranks is up (a real one, or
the fake world of ``launch.dryrun``); nothing here touches a device at
import.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

from repro_torch.tuning.profile import get_profile as _get_profile


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} and axes "
                             f"{self.axis_names} differ in length")

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def axis_sizes(self) -> dict:
        return dict(zip(self.axis_names, self.shape))


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return MeshSpec(shape, axes)


def make_mesh(shape, axes) -> MeshSpec:
    return MeshSpec(tuple(int(s) for s in shape), tuple(axes))


def data_axes(mesh: MeshSpec) -> tuple:
    """The data-parallel axes of a mesh (everything but 'model')."""
    return tuple(a for a in mesh.axis_names if a != "model")


def device_mesh(spec: MeshSpec, device_type: str = "cuda"):
    """The ``DeviceMesh`` of ``spec`` over the initialised world, which
    must hold exactly ``spec.size`` ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized() or dist.get_world_size() != spec.size:
        have = dist.get_world_size() if dist.is_initialized() else 0
        raise RuntimeError(f"a {spec.shape} mesh needs a world of "
                           f"{spec.size} ranks; the world has {have}")
    return init_device_mesh(device_type, spec.shape,
                            mesh_dim_names=spec.axis_names)


# The roofline constants of the reference's target (a TPU v5e chip),
# read from the shared preset as the reference reads them.  Nothing in
# the port's dry run defaults to them: its roofline terms take an
# explicit ``--profile``.
_TPU = _get_profile("tpu")
PEAK_FLOPS_BF16 = _TPU.peak_flops   # FLOP/s
HBM_BW = _TPU.hbm_bw                # B/s
ICI_BW = _TPU.cross_bw              # B/s per link
