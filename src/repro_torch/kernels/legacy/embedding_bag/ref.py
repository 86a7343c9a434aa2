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
