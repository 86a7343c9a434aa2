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
    on the same graph never sorts again. The sort's one host sync also
    brings its counts, from which the layout makes its ``SegmentPlan`` on
    the card (``segment/kernel.py``: the chunks, rows and scratch of a
    kernel call, made once, shared by both entries) without another; and
    ``Segments.gathered`` keeps, a few a layout with the same key and
    invalidation, the ids of another array in its order (``idx[order]``, -1
    where masked), made without a host sync;
  * ``segment_sum(vals, segs)`` sums ``vals`` (m, ...) into ``segs``'
    segments through ``ops.segment_sum`` (the hand-written kernel on the
    card, ``index_add_`` on the CPU); ids outside ``[0, num_segments)``
    are dropped, as ``jax.ops.segment_sum`` drops them. Its backward is
    the gather ``g[ids]``, zero where an id was dropped;
  * ``gather(x, segs)`` is ``x[ids]``, whose backward is ``segment_sum``
    over the same layout;
  * ``gather_sum(x, idx, segs, limit)`` is ``segment_sum(where(idx <
    limit, x[idx], 0), segs)`` through ``ops.gather_sum``, which reads the
    gathered rows where they lie: neither it nor its gradient (the same sum
    over ``idx``'s layout, gathering by ``segs``' ids, the rows at or past
    ``limit`` zero) writes the (m, ...) messages. GIN's aggregation; on the
    card the same bits as ``segment_sum`` of ``where`` and ``gather``.
"""

from __future__ import annotations

from collections import OrderedDict
from math import prod

import torch

from . import ops
from .segment.kernel import SegmentPlan, layout_counts

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
        if ids.shape[0]:
            # the last key and the plan's counts: one host sync
            last, *self.counts = torch.stack([t.long() for t in (
                sorted_key[-1], *layout_counts(self.offsets,
                                               ids.shape[0]))]).tolist()
        else:
            last, self.counts = 0, [0, 0, 0]
        self.total = self.counts[0]
        self.all_valid = last < R
        self._plan = None
        self._gathered: "OrderedDict[tuple, Gathered]" = OrderedDict()

    @classmethod
    def of(cls, ids: torch.Tensor, num_segments: int) -> "Segments":
        """The layout of ``ids``, sorted at most once while it is among the
        last ``CACHE_SIZE`` asked for."""
        if ids.is_inference():  # no version counter: not cached
            return cls(ids, num_segments)
        key = _key(ids) + (int(num_segments),)
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

    @property
    def plan(self) -> SegmentPlan:
        """The kernel's plan of this layout, made at its first call."""
        if self._plan is None:
            self._plan = SegmentPlan(self.offsets, self.ids.shape[0],
                                     counts=self.counts)
        return self._plan

    def sum(self, vals: torch.Tensor) -> torch.Tensor:
        """``segment_sum`` without autograd: (num_segments, ...)."""
        rest = tuple(vals.shape[1:])
        flat = vals.reshape(vals.shape[0], prod(rest)).contiguous()
        plan = self.plan if flat.is_cuda else None
        out = ops.segment_sum(flat, self.order, self.offsets, plan=plan)
        return out.reshape((self.num_segments,) + rest)

    def gathered(self, idx: torch.Tensor, *, id_limit: int,
                 row_limit: int) -> "Gathered":
        """``idx`` (m,) in this layout's order, masked: the position of
        entry ``j`` keeps ``idx[j]`` where ``0 <= idx[j] < id_limit`` and
        its segment is below ``row_limit``, else -1, without a host sync
        (``idx`` is not checked: ``gather_sum`` checks it through its own
        layout). Made once while among
        this layout's last ``CACHE_SIZE`` (keyed by ``idx`` as ``of``
        keys, an in-place write to it makes it anew)."""
        key = _key(idx) + (int(id_limit), int(row_limit))
        hit = self._gathered.get(key)
        if hit is None:
            hit = self._gathered[key] = Gathered(self, idx, int(id_limit),
                                                 int(row_limit))
            while len(self._gathered) > CACHE_SIZE:
                self._gathered.popitem(last=False)
        return hit

    def take(self, g: torch.Tensor) -> torch.Tensor:
        """``g[ids]``, zero where an id is outside ``[0, num_segments)``."""
        if self.all_valid:
            return g.index_select(0, self.ids)
        ok = (self.ids >= 0) & (self.ids < self.num_segments)
        picked = g.index_select(0, torch.where(ok, self.ids, 0))
        return picked * ok.reshape((-1,) + (1,) * (g.dim() - 1)).to(g.dtype)


def _key(ids: torch.Tensor) -> tuple:
    # the held tensor keeps its storage alive, so no other tensor can have
    # its address, and an in-place write bumps the version that its views
    # share
    return (ids.data_ptr(), ids._version, tuple(ids.shape), ids.stride(),
            ids.dtype, ids.device)


class Gathered:
    """A layout's positions gathering from another id array: ``ids`` (m,)
    int32, ``idx[order]`` masked to -1 (``Segments.gathered``), every kept
    id below ``id_limit``; its kernel calls take the layout's plan."""

    def __init__(self, segs: Segments, idx: torch.Tensor, id_limit: int,
                 row_limit: int):
        if idx.shape != segs.ids.shape:
            raise ValueError(f"gathered ids: shape {tuple(idx.shape)} for a "
                             f"layout of {tuple(segs.ids.shape)}")
        self.segs, self.held, self.id_limit = segs, idx, id_limit
        i = idx.to(torch.int32).index_select(0, segs.order)
        # the rows below row_limit hold the positions before
        # offsets[row_limit]; the dropped entries come after offsets[R]
        end = segs.offsets[min(max(row_limit, 0), segs.num_segments)]
        live = ((i >= 0) & (i < id_limit) & (torch.arange(
            i.shape[0], dtype=torch.int32, device=i.device) < end))
        self.ids = torch.where(live, i, -1)

    @property
    def plan(self) -> SegmentPlan:
        return self.segs.plan

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``out[r] = sum of x[ids[k]]`` over segment ``r``'s positions with
        ``ids[k] >= 0``, without autograd: (num_segments, ...)."""
        rest = tuple(x.shape[1:])
        flat = x.reshape(x.shape[0], prod(rest)).contiguous()
        kw = dict(plan=self.plan, id_max=self.id_limit - 1) if (
            flat.is_cuda) else {}
        out = ops.gather_sum(flat, self.ids, self.segs.offsets, **kw)
        return out.reshape((self.segs.num_segments,) + rest)


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


class _GatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx, segs, limit, fwd):
        ctx.idx, ctx.segs, ctx.limit, ctx.rows = idx, segs, limit, x.shape[0]
        return fwd.sum(x)

    @staticmethod
    def backward(ctx, g):
        # the sum over idx's layout, gathering by the segment ids: the
        # dropped ids and the rows at or past limit take nothing
        back = Segments.of(ctx.idx, ctx.rows).gathered(
            ctx.segs.ids, id_limit=ctx.segs.num_segments,
            row_limit=ctx.limit)
        return back.sum(g), None, None, None, None


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


def gather_sum(x: torch.Tensor, idx: torch.Tensor, segs: Segments,
               limit: int | None = None) -> torch.Tensor:
    """``jax.ops.segment_sum(jnp.where((idx < limit)[:, None], x[idx], 0),
    ids, num_segments)`` over ``segs``' layout of ``ids``, ``idx`` (m,)
    every entry in ``[0, x.shape[0])`` (``limit`` None: all of them count),
    differentiable in ``x``: (num_segments, ...) in ``x``' dtype. ``idx``
    is checked by its own layout (``Segments.of(idx, x.shape[0])``, which
    the gradient sums over), so the check costs no host sync of its own."""
    rows = x.shape[0]
    limit = rows if limit is None else min(int(limit), rows)
    if not Segments.of(idx, rows).all_valid:
        raise ValueError(f"gather_sum: ids outside [0, {rows})")
    fwd = segs.gathered(idx, id_limit=limit, row_limit=segs.num_segments)
    return _GatherSum.apply(x, idx, segs, limit, fwd)
