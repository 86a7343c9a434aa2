"""Plain PyTorch version of the segment_sum kernel.

``out[r] = sum of vals[order[k]]`` for ``k`` in ``[offsets[r], offsets[r +
1])``: ``index_add_`` of the sorted rows on a zero buffer, in ``vals``'
dtype. ``order`` is a stable sort of the entries by segment id and
``offsets`` (R + 1,) the segments' starts in it (``kernels/segments.py``
builds both); entries past ``offsets[R]`` (ids outside ``[0, R)``) are
dropped, as ``jax.ops.segment_sum`` drops them.
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
