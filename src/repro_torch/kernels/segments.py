"""Segment sums and gathers whose gradients add in a fixed order: the GNN
family's message passing (``legacy/models/gnn.py``, ``nequip.py``).

The reference aggregates with ``jax.ops.segment_sum`` and gathers with
``h[senders]``, whose transpose is a segment sum too. On the card every
library scatter-add (``index_add_``, ``scatter_add_``, the backward of
indexing) adds with atomics, in another order each run. Here:

  * ``Segments`` is the sorted layout of a fixed id array (the receivers,
    the senders, the graph ids): a stable sort of its entries by id
    (``order``) and each segment's start in it (``offsets``), built once
    with the graph. ``Segments.of`` keeps the last few, keyed by the id
    tensor itself (its address, version, shape and strides; the tensor is
    held, so that its storage cannot be reused by another), so a train step
    on the same graph never sorts again;
  * ``segment_sum(vals, segs)`` sums ``vals`` (m, ...) into ``segs``'
    segments through ``ops.segment_sum`` (the hand-written kernel on the
    card, ``index_add_`` on the CPU); ids outside ``[0, num_segments)``
    are dropped, as ``jax.ops.segment_sum`` drops them. Its backward is
    the gather ``g[ids]``, zero where an id was dropped;
  * ``gather(x, segs)`` is ``x[ids]``, whose backward is ``segment_sum``
    over the same layout.
"""

from __future__ import annotations

from collections import OrderedDict
from math import prod

import torch

from . import ops

CACHE_SIZE = 4


class Segments:
    """The sorted layout of ``ids`` (m,) int32 into ``num_segments``
    segments: ``order`` (m,) int32, the entries by segment, stably (the ids
    outside ``[0, num_segments)`` last), ``offsets`` (num_segments + 1,)
    int32, the segments' starts in ``order``."""

    _cache: "OrderedDict[tuple, Segments]" = OrderedDict()

    def __init__(self, ids: torch.Tensor, num_segments: int):
        if ids.dim() != 1:
            raise ValueError(f"segment ids must be 1-D, got shape "
                             f"{tuple(ids.shape)}")
        self.ids = ids.to(torch.int32)
        self.num_segments = int(num_segments)
        R = self.num_segments
        key = torch.where((self.ids >= 0) & (self.ids < R), self.ids, R)
        sorted_key, order = torch.sort(key, stable=True)
        self.order = order.to(torch.int32)
        self.offsets = torch.searchsorted(
            sorted_key, torch.arange(R + 1, dtype=torch.int32,
                                     device=ids.device), out_int32=True)
        self.all_valid = ids.shape[0] == 0 or int(sorted_key[-1]) < R

    @classmethod
    def of(cls, ids: torch.Tensor, num_segments: int) -> "Segments":
        """The layout of ``ids``, sorted at most once while it is among the
        last ``CACHE_SIZE`` asked for."""
        if ids.is_inference():  # no version counter: not cached
            return cls(ids, num_segments)
        # the held tensor keeps its storage alive, so no other tensor can
        # have its address, and an in-place write bumps the version that
        # its views share
        key = (ids.data_ptr(), ids._version, tuple(ids.shape), ids.stride(),
               ids.dtype, ids.device, int(num_segments))
        hit = cls._cache.get(key)
        if hit is not None:
            cls._cache.move_to_end(key)
            return hit
        segs = cls(ids, num_segments)
        segs.held = ids
        cls._cache[key] = segs
        while len(cls._cache) > CACHE_SIZE:
            cls._cache.popitem(last=False)
        return segs

    @classmethod
    def clear_cache(cls) -> None:
        cls._cache.clear()

    def sum(self, vals: torch.Tensor) -> torch.Tensor:
        """``segment_sum`` without autograd: (num_segments, ...)."""
        rest = tuple(vals.shape[1:])
        flat = vals.reshape(vals.shape[0], prod(rest)).contiguous()
        out = ops.segment_sum(flat, self.order, self.offsets)
        return out.reshape((self.num_segments,) + rest)

    def take(self, g: torch.Tensor) -> torch.Tensor:
        """``g[ids]``, zero where an id is outside ``[0, num_segments)``."""
        if self.all_valid:
            return g.index_select(0, self.ids)
        ok = (self.ids >= 0) & (self.ids < self.num_segments)
        picked = g.index_select(0, torch.where(ok, self.ids, 0))
        return picked * ok.reshape((-1,) + (1,) * (g.dim() - 1)).to(g.dtype)


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vals, segs):
        ctx.segs = segs
        return segs.sum(vals)

    @staticmethod
    def backward(ctx, g):
        return ctx.segs.take(g), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, segs):
        ctx.segs = segs
        return x.index_select(0, segs.ids)

    @staticmethod
    def backward(ctx, g):
        return ctx.segs.sum(g), None


def segment_sum(vals: torch.Tensor, segs: Segments) -> torch.Tensor:
    """``jax.ops.segment_sum(vals, ids, num_segments)`` over ``segs``'
    layout: (num_segments, ...) in ``vals``' dtype, differentiable in
    ``vals``."""
    if vals.shape[0] != segs.ids.shape[0]:
        raise ValueError(f"segment_sum: {vals.shape[0]} values for "
                         f"{segs.ids.shape[0]} ids")
    return _SegmentSum.apply(vals, segs)


def gather(x: torch.Tensor, segs: Segments) -> torch.Tensor:
    """``x[ids]`` (m, ...), every id in ``[0, x.shape[0])`` and
    ``segs.num_segments == x.shape[0]``; its gradient is ``segment_sum``
    over ``segs``."""
    if segs.num_segments != x.shape[0] or not segs.all_valid:
        raise ValueError(f"gather: ids into {segs.num_segments} segments "
                         f"(all in range: {segs.all_valid}) for "
                         f"{x.shape[0]} rows")
    return _Gather.apply(x, segs)
