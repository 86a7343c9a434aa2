"""Meshes of the ConnectIt cells (mirrors ``repro.launch.mesh``).

Two kinds, with the reference's axis names:

  * a **real** mesh, a ``torch.distributed`` ``DeviceMesh`` over the world's
    ranks (``make_smoke_mesh``; 1 x 1 at one rank, 2 x 2 at four), on which
    a cell runs;
  * a **shape-only** mesh (``ShapeMesh``: the production 16 x 16 and
    2 x 16 x 16 of ``make_production_mesh``), on which a cell is built on
    the ``meta`` device and each rank's argument shapes are planned
    (``launch/dryrun.py``) without starting 256 processes. Its programs are
    never called: they would enter collectives.

Both answer what the cell builders and ``core/collectives.py``'s planning
helpers read: ``mesh_dim_names``, ``shape`` and ``size()``.
"""

from __future__ import annotations

import dataclasses
from math import prod

__all__ = ["ShapeMesh", "make_production_mesh", "make_smoke_mesh",
           "data_axes", "all_axes", "PEAK_FLOPS_BF16",
           "HBM_BW", "NVLINK_BW", "HBM_BYTES"]


@dataclasses.dataclass(frozen=True)
class ShapeMesh:
    """A mesh's shape and axis names, with no devices behind it."""

    shape: tuple
    mesh_dim_names: tuple
    device_type: str = "meta"

    def size(self) -> int:
        return prod(self.shape)


def make_production_mesh(*, multi_pod: bool = False) -> ShapeMesh:
    """The reference's production meshes, as shapes: 16 x 16 ``(data,
    model)``, or 2 x 16 x 16 ``(pod, data, model)``."""
    if multi_pod:
        return ShapeMesh((2, 16, 16), ("pod", "data", "model"))
    return ShapeMesh((16, 16), ("data", "model"))


def make_smoke_mesh(device_type: str = "cuda"):
    """A ``(data, model)`` ``DeviceMesh`` over every rank of the world (1 x 1
    at one rank, 2 x 2 at four), on ``device_type``. The process group must
    exist (``repro_torch.launch.multihost.initialize``)."""
    from ..core.execution import make_axis_mesh
    return make_axis_mesh(("data", "model"), device_type)


def data_axes(mesh) -> tuple:
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def all_axes(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names)


# NVIDIA H100 80GB HBM3, 700.00 W (SXM5; NVIDIA's H100 data sheet): the
# card's device memory, its HBM3 rate, its dense bf16 tensor-core peak (no
# structured sparsity), and one direction of its NVLink 4 (900 GB/s both
# ways), per card.
HBM_BYTES = 80 * 10**9
HBM_BW = 3.35e12            # bytes/s
PEAK_FLOPS_BF16 = 989e12    # flop/s
NVLINK_BW = 450e9           # bytes/s
