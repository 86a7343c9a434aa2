"""Wrappers of the hand-written CUDA segment sums (``csrc/segment.cu``).

``segment_sum(vals, order, offsets)`` sums the rows of ``vals`` (m, d) into
the segments of a sorted layout; ``gather_sum(x, ids, offsets)`` sums rows
of ``x`` (rows_x, d) gathered by ``ids``, the gathered ids in the layout's
order with -1 where a position is masked. Both take contiguous float32 or
bfloat16 values and contiguous int32 ids and ``(R + 1,)`` offsets on one
CUDA device, and raise on anything else. Each wrapper's ``launches``
counts its calls.

A ``SegmentPlan`` is what a call needs besides its values and ids, made
once a layout (its offsets and count of positions): the chunk and chunk
count, the non-empty, empty and spanning rows, each chunk's first row and
the float32 scratch for the pieces of the rows that span chunks.
``kernels/segments.py`` keeps one with each cached layout, made from the
counts its sort already brought to the host, so that neither the plan nor
a call on it waits for the card; both entries on the layout share it. A
call is one launch where no row spans chunks, else two (the second adds
the spanning rows' pieces). Calls on one plan run on one stream (the
scratch is the plan's).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

_SEGMENT = {torch.float32: "segment_sum_f32",
            torch.bfloat16: "segment_sum_bf16"}
_GATHER = {torch.float32: "gather_sum_f32", torch.bfloat16: "gather_sum_bf16"}


def chunk_of(m: int) -> int:
    """Sorted positions a warp sums (``csrc/segment.cu``'s chunk): a power
    of two from 32 to 256, about m / 4096, so that a call of a few thousand
    positions still spreads over many warps and a hub row over many."""
    c = 32
    while c < 256 and 2 * c * 4096 <= m:
        c *= 2
    return c


def layout_counts(offsets: torch.Tensor, m: int) -> list:
    """A layout's counts as 0-d tensors, made without a host sync: the
    positions summed (``offsets[R]``), the non-empty rows, and the rows
    that span chunks of ``chunk_of(m)`` positions."""
    chunk = chunk_of(m)
    b, e = offsets[:-1], offsets[1:]
    filled = e > b
    spanning = filled & (b // chunk != (e - 1) // chunk)
    return [offsets[-1], filled.sum(), spanning.sum()]


def _check_ids(what: str, *tensors) -> None:
    for t in tensors:
        if t.dtype != torch.int32:
            raise TypeError(f"{what}: the CUDA kernel takes int32 ids and "
                            f"offsets, got {t.dtype}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{what}: needs 1-D contiguous ids and offsets, "
                             f"got shape {tuple(t.shape)}")


class _Layout(ctypes.Structure):
    """``csrc/segment.cu``'s ``Layout``: the device addresses and sizes a
    call reads besides its values and ids."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "coff", "nz", "first", "empty", "spans", "offsets", "scratch")] + [
            (name, ctypes.c_int64) for name in (
                "rows", "n_nz", "n_empty", "n_span", "chunk", "n_chunks",
                "d_max")]


class SegmentPlan:
    """A layout of ``m`` sorted positions into ``offsets`` (R + 1,), int32,
    checked once, with what the kernel keeps beside it: ``total`` (the
    positions summed, ``offsets[R]``), the chunk, the counts of non-empty
    rows and of rows that span chunks (``n_span``: 0 makes a call one
    launch), and made at the first call on the card (``prepare``): the
    non-empty rows ``nz`` with their starts ``coff`` (then ``total``), the
    empty rows, the spanning rows, each chunk's first non-empty row (an
    index into ``nz``) and the scratch (grown to the widest call).
    ``counts``: ``layout_counts``' values on the host, which the caller
    already has (one host sync makes them where it is None)."""

    def __init__(self, offsets: torch.Tensor, m: int, *,
                 counts: tuple | None = None):
        _check_ids("segment plan", offsets)
        if offsets.shape[0] < 1:
            raise ValueError("segment plan: no offsets")
        self.offsets, self.m = offsets, int(m)
        self.device = offsets.device
        self.rows = offsets.shape[0] - 1
        self.chunk = chunk_of(self.m)
        if counts is None:
            counts = torch.stack([c.long() for c in layout_counts(
                offsets, self.m)]).tolist()  # one sync
        self.total, self.n_nz, self.n_span = (int(c) for c in counts)
        if not 0 <= self.total <= self.m:
            raise ValueError(f"segment plan: {self.total} positions summed "
                             f"of {self.m}")
        self.n_chunks = max(1, -(-self.total // self.chunk))
        self.nz = self.coff = self.empty = self.spans = self.first = None
        self.scratch = None
        self._layout = _Layout()
        self._address = ctypes.addressof(self._layout)

    def prepare(self, d: int) -> int:
        """Make what a call of width ``d`` needs, once (the scratch grows
        to the widest), and return the address of the kernel's layout."""
        if self.scratch is not None and self.scratch.shape[-1] >= d:
            return self._address
        if self.nz is None:
            b, e = self.offsets[:-1], self.offsets[1:]
            filled = e > b
            spanning = filled & (b // self.chunk != (e - 1) // self.chunk)
            # the rows in order, the non-empty ones first (a stable sort
            # of a flag: no host sync)
            rows = torch.argsort((~filled).to(torch.int8), stable=True)
            self.nz = rows[: self.n_nz].to(torch.int32)
            self.empty = rows[self.n_nz:].to(torch.int32)
            self.spans = torch.argsort((~spanning).to(torch.int8),
                                       stable=True)[: self.n_span].to(
                                           torch.int32)
            self.coff = torch.cat([b[self.nz.long()], self.offsets[-1:]])
            # the non-empty row holding each chunk's first position
            cs = torch.arange(self.n_chunks, dtype=torch.int32,
                              device=self.device) * self.chunk
            self.first = (torch.searchsorted(self.coff, cs, right=True,
                                             out_int32=True) - 1)
        # a float32 row a chunk for the piece of a row that began before
        # it, and one for the piece of a row that goes on past it
        self.scratch = torch.empty((2, self.n_chunks, max(d, 1)),
                                   dtype=torch.float32, device=self.device)
        lay = self._layout
        for name in ("coff", "nz", "first", "empty", "spans", "offsets",
                     "scratch"):
            setattr(lay, name, getattr(self, name).data_ptr())
        lay.rows, lay.n_nz, lay.n_empty = (self.rows, self.n_nz,
                                           self.rows - self.n_nz)
        lay.n_span, lay.chunk, lay.n_chunks = (self.n_span, self.chunk,
                                               self.n_chunks)
        lay.d_max = self.scratch.shape[-1]
        return self._address


def _check_values(what: str, vals: torch.Tensor) -> None:
    if vals.dtype not in _SEGMENT:
        raise TypeError(f"{what}: the CUDA kernel takes float32 or bfloat16 "
                        f"values, got {vals.dtype}")
    if vals.dim() != 2 or not vals.is_contiguous():
        raise ValueError(f"{what}: needs contiguous (m, d) values, got shape "
                         f"{tuple(vals.shape)} strides {vals.stride()}")


def _plan_of(what: str, ids: torch.Tensor, offsets: torch.Tensor,
             plan: SegmentPlan | None) -> SegmentPlan:
    _check_ids(what, ids, offsets)
    if plan is None:
        return SegmentPlan(offsets, ids.shape[0])
    if plan.offsets is not offsets or plan.m != ids.shape[0]:
        raise ValueError(f"{what}: the plan was made for other offsets or "
                         f"another count of positions")
    return plan


def _check_device(what: str, vals: torch.Tensor, ids: torch.Tensor,
                  plan: SegmentPlan) -> None:
    if (not vals.is_cuda or ids.device != vals.device
            or plan.device != vals.device):
        raise ValueError(f"{what}: needs tensors on one CUDA device, got "
                         f"values on {vals.device}, ids on {ids.device}, "
                         f"offsets on {plan.device}")


def _launch(entries: dict, counter, what: str, vals: torch.Tensor,
            ids: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    rows, d = plan.rows, vals.shape[1]
    out = vals.new_empty((rows, d))
    if d == 0 or rows == 0:
        return out
    rc = getattr(_build.load("segment"), entries[vals.dtype])(
        vals.data_ptr(), ids.data_ptr(), out.data_ptr(), plan.prepare(d), d,
        _build.stream_of(vals))
    _build.check(rc, what)
    counter.launches += 1
    return out


def segment_sum(vals: torch.Tensor, order: torch.Tensor,
                offsets: torch.Tensor, *,
                plan: SegmentPlan | None = None) -> torch.Tensor:
    """``(R, d)`` sums in ``vals``' dtype, each row added in float32 in a
    fixed order and rounded once (``ref.segment_sum_ref`` on the card, the
    same bits every run). ``plan``: the layout's, made from these
    ``offsets`` and ``order``'s length (one is made for the call where it
    is None)."""
    what = "segment_sum"
    _check_values(what, vals)
    plan = _plan_of(what, order, offsets, plan)
    _check_device(what, vals, order, plan)
    if order.shape[0] != vals.shape[0]:
        raise ValueError(f"{what}: {order.shape[0]} sorted entries for "
                         f"{vals.shape[0]} values")
    return _launch(_SEGMENT, segment_sum, what, vals, order, plan)


def gather_sum(x: torch.Tensor, ids: torch.Tensor, offsets: torch.Tensor, *,
               plan: SegmentPlan | None = None,
               id_max: int | None = None) -> torch.Tensor:
    """``(R, d)``: ``out[r] = sum of x[ids[k]]`` over ``k`` in
    ``[offsets[r], offsets[r + 1])`` with ``ids[k] >= 0``, in ``x``' dtype,
    each row added in float32 in a fixed order and rounded once. ``plan``:
    the layout's, made from these ``offsets`` and ``ids``' length (one is
    made for the call where it is None). ``id_max``: the largest gathered
    id or a bound on it, which raises past ``x``' rows (where None, it is
    read from ``ids`` with a host sync)."""
    what = "gather_sum"
    _check_values(what, x)
    plan = _plan_of(what, ids, offsets, plan)
    if id_max is None:
        id_max = int(ids.max()) if ids.shape[0] else -1
    if id_max >= x.shape[0]:
        raise ValueError(f"{what}: gathered id {id_max} outside [0, "
                         f"{x.shape[0]})")
    _check_device(what, x, ids, plan)
    return _launch(_GATHER, gather_sum, what, x, ids, plan)


segment_sum.launches = 0
gather_sum.launches = 0
