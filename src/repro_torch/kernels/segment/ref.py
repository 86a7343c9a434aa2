"""Plain PyTorch versions of the segment kernels.

``segment_sum_ref``: ``out[r] = sum of vals[order[k]]`` for ``k`` in
``[offsets[r], offsets[r + 1])``: ``index_add_`` of the sorted rows on a
zero buffer, in ``vals``' dtype. ``order`` is a stable sort of the entries
by segment id and ``offsets`` (R + 1,) the segments' starts in it
(``kernels/segments.py`` builds both); entries past ``offsets[R]`` (ids
outside ``[0, R)``) are dropped, as ``jax.ops.segment_sum`` drops them.

``gather_sum_ref``: the same sum over rows gathered from ``x``,
``out[r] = sum of x[ids[k]]`` with ``ids[k] >= 0``: ``index_select``, the
mask, and ``segment_sum_ref`` over positions already in the layout's order.
"""

from __future__ import annotations

import torch


def segment_sum_ref(vals: torch.Tensor, order: torch.Tensor,
                    offsets: torch.Tensor) -> torch.Tensor:
    """vals: (m, d); order: (m,) int; offsets: (R + 1,) int → (R, d)."""
    rows = offsets.shape[0] - 1
    counts = (offsets[1:] - offsets[:-1]).long()
    seg = torch.repeat_interleave(
        torch.arange(rows, device=vals.device), counts)
    picked = vals.index_select(0, order[: seg.shape[0]].long())
    out = torch.zeros((rows,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(0, seg, picked)


def gather_sum_ref(x: torch.Tensor, ids: torch.Tensor,
                   offsets: torch.Tensor) -> torch.Tensor:
    """x: (rows_x, d); ids: (m,) int, -1 where masked; offsets: (R + 1,)
    int → (R, d)."""
    live = ids >= 0
    rows = x.index_select(0, torch.where(live, ids, 0).long())
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    rows = torch.where(live.reshape((-1,) + (1,) * (x.dim() - 1)), rows,
                       zero)
    order = torch.arange(ids.shape[0], device=ids.device)
    return segment_sum_ref(rows, order, offsets)
