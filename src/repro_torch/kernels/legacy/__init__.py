"""ML-era kernels, whose consumer is the DLRM model (``repro_torch.legacy``).

``embedding_bag`` dispatches by the table's device, as ``kernels/ops.py``
does: a CPU tensor takes the plain version, a CUDA tensor the hand-written
kernel, which raises on what it cannot take. Nothing falls back.
"""

from __future__ import annotations

import torch

from ...device import on_cuda
from .embedding_bag import kernel as _embedding_bag_kernel
from .embedding_bag.ref import embedding_bag_ref

__all__ = ["embedding_bag"]


def embedding_bag(table: torch.Tensor, idx: torch.Tensor, *,
                  mode: str = "sum") -> torch.Tensor:
    """table: (rows, D) with dump row ``rows - 1``; idx: (B, L) int32 →
    (B, D) bags reduced by ``mode`` (``sum``, ``mean`` or ``max``)."""
    if on_cuda(table):
        return _embedding_bag_kernel.embedding_bag(table, idx, mode=mode)
    return embedding_bag_ref(table, idx, mode=mode)
