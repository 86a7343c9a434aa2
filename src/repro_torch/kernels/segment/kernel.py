"""Wrapper of the hand-written CUDA segment_sum (``csrc/segment.cu``).

Takes a contiguous ``(m, d)`` float32 or bfloat16 ``vals``, a contiguous
``(m,)`` int32 ``order`` and a contiguous ``(R + 1,)`` int32 ``offsets``
on one CUDA device, and raises on anything else. A call is two launches
(the chunks' pieces, then the rows that span chunks and the empty rows)
and a float32 scratch of two rows a chunk; ``segment_sum.launches`` counts
one a call.
"""

from __future__ import annotations

import torch

from .. import _build

_ENTRY = {torch.float32: "segment_sum_f32",
          torch.bfloat16: "segment_sum_bf16"}


def segment_sum(vals: torch.Tensor, order: torch.Tensor,
                offsets: torch.Tensor) -> torch.Tensor:
    """``(R, d)`` sums in ``vals``' dtype, each row added in float32 in a
    fixed order and rounded once (``ref.segment_sum_ref`` on the card, the
    same bits every run)."""
    what = "segment_sum"
    if vals.dtype not in _ENTRY:
        raise TypeError(f"{what}: the CUDA kernel takes float32 or bfloat16 "
                        f"values, got {vals.dtype}")
    if vals.dim() != 2 or not vals.is_contiguous():
        raise ValueError(f"{what}: needs contiguous (m, d) values, got shape "
                         f"{tuple(vals.shape)} strides {vals.stride()}")
    _build.check_args(what, order)
    _build.check_args(what, offsets)
    if vals.device != order.device or order.device != offsets.device:
        raise ValueError(f"{what}: needs tensors on one CUDA device, got "
                         f"{[str(t.device) for t in (vals, order, offsets)]}")
    if order.shape[0] != vals.shape[0] or offsets.shape[0] < 1:
        raise ValueError(f"{what}: {order.shape[0]} sorted entries for "
                         f"{vals.shape[0]} values, {offsets.shape[0]} "
                         f"offsets")
    rows, d = offsets.shape[0] - 1, vals.shape[1]
    out = torch.empty((rows, d), dtype=vals.dtype, device=vals.device)
    if d == 0 or rows == 0:
        return out
    chunk = chunk_of(vals.shape[0])
    n_chunks = -(-vals.shape[0] // chunk)
    # a float32 row a chunk for the piece of a row that began before it,
    # and one for the piece of a row that goes on past it
    scratch = torch.empty((2, n_chunks, d), dtype=torch.float32,
                          device=vals.device)
    lib = _build.load("segment")
    rc = getattr(lib, _ENTRY[vals.dtype])(
        vals.data_ptr(), order.data_ptr(), offsets.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), rows, d, chunk, n_chunks,
        _build.stream_of(vals))
    _build.check(rc, what)
    segment_sum.launches += 1
    return out


def chunk_of(m: int) -> int:
    """Sorted positions a warp sums (``csrc/segment.cu``'s chunk): a power
    of two from 32 to 256, about m / 4096, so that a call of a few thousand
    positions still spreads over many warps and a hub row over many."""
    c = 32
    while c < 256 and 2 * c * 4096 <= m:
        c *= 2
    return c


segment_sum.launches = 0
