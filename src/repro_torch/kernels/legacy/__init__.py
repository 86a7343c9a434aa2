"""ML-era kernels, whose consumer is the DLRM model (``repro_torch.legacy``).

``embedding_bags`` and ``embedding_bags_backward`` dispatch by the tables'
device, as ``kernels/ops.py`` does: a CPU tensor takes the plain version, a
CUDA tensor the hand-written kernel, which raises on what it cannot take.
Nothing falls back. ``embedding_bags`` is T bags at once, as DLRM takes
them: on the card one forward launch for the T tables, whose bags are views
of one ``(T, B, D)`` tensor, and where a table takes a gradient (a
``torch.autograd.Function``) one backward call for all T gradients,
``embedding_bags_backward`` (on the CPU, the plain ``index_add_`` of each
position's share, table by table). ``embedding_bag`` and
``embedding_bag_backward`` are their one-table case.

``windows`` (``sum`` only): for each table ``(row_lo, rows_global)``, the
table being those rows of a larger one, as a rank of a mesh holds its
block of a row-sharded table; both routes take it (``embedding_bag/ref.py``,
``embedding_bag/kernel.py``), and the autograd function keeps it for the
backward. ``None`` is every table whole, the one-rank call.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ...device import on_cuda
from .embedding_bag import kernel as _embedding_bag_kernel
from .embedding_bag.ref import embedding_bag_backward_ref, embedding_bag_ref

__all__ = ["embedding_bag", "embedding_bag_backward", "embedding_bags",
           "embedding_bags_backward"]


def _each(windows, tables) -> list:
    """Each table's window as keywords of the plain versions."""
    if windows is None:
        return [{}] * len(tables)
    if len(windows) != len(tables):
        raise ValueError(f"embedding_bags: {len(windows)} windows for "
                         f"{len(tables)} tables")
    return [dict(row_lo=lo, rows_global=whole) for lo, whole in windows]


def embedding_bags_backward(tables: Sequence[torch.Tensor], idx: torch.Tensor,
                            grad_outs: Sequence[torch.Tensor], *,
                            mode: str = "sum", windows=None) -> list:
    """The T dense ``(rows_t, D)`` gradients of ``embedding_bags`` with
    respect to ``tables`` given ``grad_outs`` (T of (B, D))."""
    if on_cuda(tables[0]):
        return _embedding_bag_kernel.embedding_bags_backward(
            tables, idx, grad_outs, mode=mode, windows=windows)
    return [embedding_bag_backward_ref(t, i, g, mode=mode, **w)
            for t, i, g, w in zip(tables, idx, grad_outs,
                                  _each(windows, tables), strict=True)]


def _bags(tables: Sequence[torch.Tensor], idx: torch.Tensor,
          mode: str, windows=None) -> tuple:
    if on_cuda(tables[0]):
        return _embedding_bag_kernel.embedding_bags(
            tables, idx, mode=mode, windows=windows).unbind(0)
    return tuple(embedding_bag_ref(t, i, mode=mode, **w)
                 for t, i, w in zip(tables, idx, _each(windows, tables),
                                    strict=True))


def _columns_adjacent(g: torch.Tensor) -> torch.Tensor:
    # the backward kernel reads grad_out rows at any stride (the slices of
    # DLRM's stacked interaction input), columns adjacent
    return g if g.stride(-1) == 1 else g.contiguous()


class _EmbeddingBags(torch.autograd.Function):
    @staticmethod
    def forward(ctx, idx, mode, windows, *tables):
        outs = _bags(tables, idx, mode, windows)
        ctx.save_for_backward(idx, *tables)
        ctx.mode, ctx.windows = mode, windows
        return outs

    @staticmethod
    def backward(ctx, *grad_outs):
        idx, *tables = ctx.saved_tensors
        grads = embedding_bags_backward(
            tables, idx, [_columns_adjacent(g) for g in grad_outs],
            mode=ctx.mode, windows=ctx.windows)
        return (None, None, None, *grads)


def embedding_bags(tables: Sequence[torch.Tensor], idx: torch.Tensor, *,
                   mode: str = "sum", windows=None) -> list:
    """T tables ``(rows_t, D)`` (rows may differ), each with its dump row
    last; idx: (T, B, L) int32 → the T bags ``embedding_bag(tables[t],
    idx[t], mode=mode)``, (B, D) each, whose gradients one backward call
    computes. ``windows``: each table's ``(row_lo, rows_global)`` where it
    is a block of rows of a larger table (its share of the bags). Where no
    table takes a gradient (serving), the autograd function is skipped."""
    if len(tables) != idx.shape[0]:
        raise ValueError(f"embedding_bags: {len(tables)} tables for ids of "
                         f"shape {tuple(idx.shape)}")
    if windows is not None:
        windows = tuple((int(lo), int(whole)) for lo, whole in windows)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tables):
        return list(_EmbeddingBags.apply(idx, mode, windows, *tables))
    return list(_bags(tables, idx, mode, windows))


def embedding_bag(table: torch.Tensor, idx: torch.Tensor, *,
                  mode: str = "sum") -> torch.Tensor:
    """table: (rows, D) with dump row ``rows - 1``; idx: (B, L) int32 →
    (B, D) bags reduced by ``mode`` (``sum``, ``mean`` or ``max``): the
    one-table ``embedding_bags``."""
    return embedding_bags([table], idx[None], mode=mode)[0]


def embedding_bag_backward(table: torch.Tensor, idx: torch.Tensor,
                           grad_out: torch.Tensor, *,
                           mode: str = "sum") -> torch.Tensor:
    """The dense ``(rows, D)`` gradient of ``embedding_bag`` with respect to
    ``table`` given ``grad_out`` (B, D): the one-table
    ``embedding_bags_backward``."""
    return embedding_bags_backward([table], idx[None], [grad_out],
                                   mode=mode)[0]
