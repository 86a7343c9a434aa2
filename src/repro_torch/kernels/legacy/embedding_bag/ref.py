"""Plain PyTorch version of the embedding_bag kernel.

Multi-hot embedding lookup with an in-bag reduction, DLRM's hot path. Bags
are a dense ``(B, L)`` id matrix; the table's last row (``rows - 1``) is the
dump row, zero in DLRM's tables, onto which padded bag slots point.

The id contract is the reference's (``repro.kernels.legacy.embedding_bag``),
whose gather wraps and clamps instead of raising:

  * a negative id wraps once (``i + rows``), and an id still outside
    ``[0, rows - 1]`` is clamped into it: ``-1`` reads the dump row,
    ``rows + 3`` the dump row, ``-rows - 2`` row 0;
  * an id counts as valid for ``mean`` and ``max`` when the *raw* id is
    below ``rows - 1``: ``-1`` counts, an id too large does not;
  * ``mean`` divides the sum over all ``L`` gathered rows, dump rows
    included, by ``max(#valid, 1)``;
  * ``max`` takes the dtype's ``finfo.min`` where an id is not valid.
"""

from __future__ import annotations

import torch

MODES = ("sum", "mean", "max")


def wrap_and_clamp(idx: torch.Tensor, rows: int) -> torch.Tensor:
    """The rows that ``idx`` reads, as int64 indices into ``[0, rows)``."""
    i = idx.long()
    return torch.where(i < 0, i + rows, i).clamp_(0, rows - 1)


def embedding_bag_ref(table: torch.Tensor, idx: torch.Tensor,
                      mode: str = "sum") -> torch.Tensor:
    """table: (rows, D) float; idx: (B, L) int → (B, D) in table's dtype."""
    if mode not in MODES:
        raise ValueError(f"unknown embedding_bag mode {mode!r}; have {MODES}")
    rows = table.shape[0]
    gathered = table[wrap_and_clamp(idx, rows)]  # (B, L, D)
    if mode == "sum":
        return gathered.sum(dim=1)
    valid = idx < rows - 1
    if mode == "mean":
        cnt = valid.sum(dim=1).clamp(min=1)
        return gathered.sum(dim=1) / cnt[:, None].to(gathered.dtype)
    neg = torch.finfo(gathered.dtype).min
    return torch.where(valid[..., None], gathered,
                       gathered.new_tensor(neg)).amax(dim=1)


def embedding_bag_backward_ref(table: torch.Tensor, idx: torch.Tensor,
                               grad_out: torch.Tensor,
                               mode: str = "sum") -> torch.Tensor:
    """The gradient of ``embedding_bag_ref(table, idx, mode)`` with respect
    to ``table``, given ``grad_out`` (B, D): a dense ``(rows, D)`` tensor,
    each position's share ``index_add_``-ed into the row it reads.

      * ``sum``: every position passes ``grad_out[b]``, the dump row too;
      * ``mean``: ``grad_out[b] / max(#valid, 1)``;
      * ``max``: on each column, ``grad_out[b] / #ties`` to the positions
        with a valid id whose row holds the bag's max there (ties counted
        over the masked values, as ``jax.grad`` of a max splits them).

    Rows follow the forward's contract (``wrap_and_clamp``), so an id past
    the table passes its share to the row that the forward read."""
    if mode not in MODES:
        raise ValueError(f"unknown embedding_bag mode {mode!r}; have {MODES}")
    rows, d = table.shape
    b, l = idx.shape
    read = wrap_and_clamp(idx, rows)  # (B, L)
    g = grad_out.to(table.dtype)
    if mode == "sum":
        share = g[:, None, :].expand(b, l, d)
    elif mode == "mean":
        cnt = (idx < rows - 1).sum(dim=1).clamp(min=1)
        share = (g / cnt[:, None].to(g.dtype))[:, None, :].expand(b, l, d)
    else:
        valid = (idx < rows - 1)[..., None]
        masked = torch.where(valid, table[read],
                             table.new_tensor(torch.finfo(table.dtype).min))
        hit = masked == masked.amax(dim=1, keepdim=True)
        ties = hit.sum(dim=1, keepdim=True).to(g.dtype)
        share = torch.where(hit & valid, g[:, None, :] / ties,
                            g.new_zeros(()))
    grad = torch.zeros_like(table)
    return grad.index_add_(0, read.reshape(-1), share.reshape(b * l, d))
