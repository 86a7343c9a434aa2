"""ML-era kernels, whose consumer is the DLRM model (``repro_torch.legacy``).

``embedding_bag`` dispatches by the table's device, as ``kernels/ops.py``
does: a CPU tensor takes the plain version, a CUDA tensor the hand-written
kernel, which raises on what it cannot take. Nothing falls back. It is a
``torch.autograd.Function``: where the table takes a gradient, its backward
is ``embedding_bag_backward`` by the same dispatch (on the CPU, the plain
``index_add_`` of each position's share).
"""

from __future__ import annotations

import torch

from ...device import on_cuda
from .embedding_bag import kernel as _embedding_bag_kernel
from .embedding_bag.ref import embedding_bag_backward_ref, embedding_bag_ref

__all__ = ["embedding_bag", "embedding_bag_backward"]


def embedding_bag_backward(table: torch.Tensor, idx: torch.Tensor,
                           grad_out: torch.Tensor, *,
                           mode: str = "sum") -> torch.Tensor:
    """The dense ``(rows, D)`` gradient of ``embedding_bag`` with respect to
    ``table`` given ``grad_out`` (B, D)."""
    if on_cuda(table):
        return _embedding_bag_kernel.embedding_bag_backward(
            table, idx, grad_out, mode=mode)
    return embedding_bag_backward_ref(table, idx, grad_out, mode=mode)


class _EmbeddingBag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx, mode):
        if on_cuda(table):
            out = _embedding_bag_kernel.embedding_bag(table, idx, mode=mode)
        else:
            out = embedding_bag_ref(table, idx, mode=mode)
        # a reference, not a copy: the backward reads the table's values for
        # max, its shape for sum and mean
        ctx.save_for_backward(table, idx)
        ctx.mode = mode
        return out

    @staticmethod
    def backward(ctx, grad_out):
        table, idx = ctx.saved_tensors
        grad = embedding_bag_backward(table, idx, grad_out.contiguous(),
                                      mode=ctx.mode)
        return grad, None, None


def embedding_bag(table: torch.Tensor, idx: torch.Tensor, *,
                  mode: str = "sum") -> torch.Tensor:
    """table: (rows, D) with dump row ``rows - 1``; idx: (B, L) int32 →
    (B, D) bags reduced by ``mode`` (``sum``, ``mean`` or ``max``)."""
    return _EmbeddingBag.apply(table, idx, mode)
