"""Plain PyTorch version of the scatter_min kernel.

Semantics: ``out[i] = min(labels[i], min over {vals[j] : idx[j] == i})`` —
the paper's ``writeMin`` as one scatter with a min combiner. The contract is
*pre-sanitized*: ``idx`` entries are in ``[0, L)`` (the dispatch layer dumps
negative / masked / out-of-range targets onto the dump slot with a
max-sentinel value first). Takes any integer dtype.
"""

from __future__ import annotations

import torch


def scatter_min_ref(labels: torch.Tensor, idx: torch.Tensor,
                    vals: torch.Tensor) -> torch.Tensor:
    """labels: (L,) int; idx: (m,) int in [0, L); vals: (m,) int."""
    return labels.scatter_reduce(0, idx.long(), vals.to(labels.dtype), "amin",
                                 include_self=True)
