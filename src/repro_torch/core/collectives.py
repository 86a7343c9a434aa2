"""The JAX package's ``lax`` collectives over a tuple of mesh axes, on
``torch.distributed``.

The JAX package writes its mesh programs (``repro/core/distributed.py``)
under ``shard_map``: one controller, and collectives named by mesh axes.
Here every rank runs the same program and the ranks meet in collectives on
the process group of each axis, ``mesh.get_group(axis)`` of a
``torch.distributed.device_mesh.DeviceMesh``:

    lax.psum / pmin / pmax     all_reduce(SUM / MIN / MAX), an axis at a time
    lax.all_gather(tiled=True) all_gather_single (all_gather_into_tensor)
    lax.all_to_all             all_to_all_single
    lax.axis_index             mesh.get_local_rank(axis)

A group's ranks are ordered by their coordinate along its axis, as the
reference orders a mesh axis's devices, so a tiled gather concatenates in
coordinate order. Every function returns a new tensor and leaves its input
as it was.
"""

from __future__ import annotations

from math import prod
from typing import Sequence

import torch
import torch.distributed as dist

# all_gather_into_tensor is deprecated in favour of all_gather_single where
# the latter exists
_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor

__all__ = ["axis_size", "axis_index", "mesh_size", "shard_index", "psum",
           "pmin",
           "pmax", "all_gather", "all_to_all", "origin_rank",
           "broadcast_object"]


def axis_size(mesh, axis: str) -> int:
    return int(mesh.shape[mesh.mesh_dim_names.index(axis)])


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return int(mesh.get_local_rank(axis))


def mesh_size(mesh, axes: Sequence[str]) -> int:
    """The number of ranks along ``axes`` together."""
    return prod(axis_size(mesh, a) for a in axes)


def shard_index(mesh, axes: Sequence[str]) -> int:
    """This rank's block of an array split over ``axes``, row-major in the
    order the axes are named (``PartitionSpec(axes)``)."""
    idx = 0
    for a in axes:
        idx = idx * axis_size(mesh, a) + axis_index(mesh, a)
    return idx


def _reduce(x: torch.Tensor, mesh, axes: Sequence[str], op) -> torch.Tensor:
    out = x.clone()
    for a in axes:
        dist.all_reduce(out, op=op, group=mesh.get_group(a))
    return out


def psum(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """Elementwise sum over every rank of ``axes``."""
    return _reduce(x, mesh, axes, dist.ReduceOp.SUM)


def pmin(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """Elementwise minimum over every rank of ``axes``."""
    return _reduce(x, mesh, axes, dist.ReduceOp.MIN)


def pmax(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """Elementwise maximum over every rank of ``axes``."""
    return _reduce(x, mesh, axes, dist.ReduceOp.MAX)


def all_gather(x: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """Tiled gather: the ranks' ``x`` concatenated along dim 0, one axis
    after another (the last axis named varies slowest in the result)."""
    for a in axes:
        k = axis_size(mesh, a)
        out = x.new_empty((k * x.shape[0],) + tuple(x.shape[1:]))
        _all_gather(out, x.contiguous(), group=mesh.get_group(a))
        x = out
    return x


def all_to_all(chunks: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``lax.all_to_all(split_axis=0, concat_axis=0, tiled=False)`` over one
    axis: ``chunks`` is ``(k, c)`` with ``k`` the axis size; row ``j`` of the
    result is the chunk that the rank at coordinate ``j`` addressed to this
    one."""
    k = axis_size(mesh, axis)
    if chunks.shape[0] != k:
        raise ValueError(f"all_to_all over {axis!r} takes {k} chunks, got "
                         f"{chunks.shape[0]}")
    chunks = chunks.contiguous()  # the output takes its (dense) layout
    out = torch.empty_like(chunks)
    dist.all_to_all_single(out, chunks, group=mesh.get_group(axis))
    return out


def origin_rank(mesh) -> int:
    """The global rank at coordinate 0 on every axis of ``mesh``."""
    return int(mesh.mesh.flatten()[0])


def broadcast_object(obj, mesh, *, device=None):
    """The origin rank's ``obj`` on every rank of ``mesh``: a broadcast from
    coordinate 0 along each axis in turn. Every rank of the mesh makes this
    call with an ``obj`` of its own, and only the origin's is read."""
    box, coord = [obj], mesh.get_coordinate()
    for i, axis in enumerate(mesh.mesh_dim_names):
        if mesh.shape[i] > 1:
            at = list(coord)
            at[i] = 0
            dist.broadcast_object_list(box, src=int(mesh.mesh[tuple(at)]),
                                       group=mesh.get_group(axis),
                                       device=device)
    return box[0]
