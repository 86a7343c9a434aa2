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

A table may be a window of rows of a larger one (``row_lo=``,
``rows_global=``: rows ``[row_lo, row_lo + rows)`` of a ``rows_global``-row
table, a rank's block of a table row-sharded over a mesh). The contract
above then reads the whole table's rows, and a row outside the window adds
nothing to a bag and takes no gradient; only ``sum`` bags take a window
that is not the whole table.
"""

from __future__ import annotations

import torch

MODES = ("sum", "mean", "max")


def wrap_and_clamp(idx: torch.Tensor, rows: int) -> torch.Tensor:
    """The rows that ``idx`` reads, as int64 indices into ``[0, rows)``."""
    i = idx.long()
    return torch.where(i < 0, i + rows, i).clamp_(0, rows - 1)


def _window(table: torch.Tensor, mode: str, row_lo: int,
            rows_global) -> int:
    """The whole table's rows, after checking the window."""
    if mode not in MODES:
        raise ValueError(f"unknown embedding_bag mode {mode!r}; have {MODES}")
    rows = table.shape[0]
    whole = rows if rows_global is None else int(rows_global)
    if row_lo < 0 or row_lo + rows > whole:
        raise ValueError(f"embedding_bag: a window of {rows} rows from row "
                         f"{row_lo} does not lie in a table of {whole} rows")
    if mode != "sum" and (row_lo, whole) != (0, rows):
        raise ValueError(f"embedding_bag: a window of rows takes sum bags "
                         f"only, got mode {mode!r}")
    return whole


def _window_rows(idx: torch.Tensor, rows: int, row_lo: int,
                 whole: int) -> tuple:
    """``(local rows, in window)``: each id's row in the whole table
    counted from ``row_lo``, and whether it lies in the window."""
    read = wrap_and_clamp(idx, whole) - row_lo
    return read, (read >= 0) & (read < rows)


def embedding_bag_ref(table: torch.Tensor, idx: torch.Tensor,
                      mode: str = "sum", *, row_lo: int = 0,
                      rows_global=None) -> torch.Tensor:
    """table: (rows, D) float; idx: (B, L) int → (B, D) in table's dtype.
    ``table`` holds rows ``[row_lo, row_lo + rows)`` of a table of
    ``rows_global`` rows (default: the whole table)."""
    whole = _window(table, mode, row_lo, rows_global)
    rows = table.shape[0]
    if whole != rows or row_lo:
        read, inside = _window_rows(idx, rows, row_lo, whole)
        gathered = table[read.clamp(0, rows - 1)]
        return torch.where(inside[..., None], gathered,
                           gathered.new_zeros(())).sum(dim=1)
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
                               mode: str = "sum", *, row_lo: int = 0,
                               rows_global=None) -> torch.Tensor:
    """The gradient of ``embedding_bag_ref(table, idx, mode)`` with respect
    to ``table``, given ``grad_out`` (B, D): a dense ``(rows, D)`` tensor,
    each position's share ``index_add_``-ed into the row it reads.

      * ``sum``: every position passes ``grad_out[b]``, the dump row too;
      * ``mean``: ``grad_out[b] / max(#valid, 1)``;
      * ``max``: on each column, ``grad_out[b] / #ties`` to the positions
        with a valid id whose row holds the bag's max there (ties counted
        over the masked values, as ``jax.grad`` of a max splits them).

    Rows follow the forward's contract (``wrap_and_clamp``), so an id past
    the table passes its share to the row that the forward read. With a
    window (``row_lo=``, ``rows_global=``, as the forward's) the gradient
    is the window's rows: a position whose row lies outside passes
    nothing."""
    whole = _window(table, mode, row_lo, rows_global)
    rows, d = table.shape
    b, l = idx.shape
    g = grad_out.to(table.dtype)
    if whole != rows or row_lo:
        read, inside = _window_rows(idx, rows, row_lo, whole)
        share = g[:, None, :].expand(b, l, d)[inside]
        return torch.zeros_like(table).index_add_(0, read[inside], share)
    read = wrap_and_clamp(idx, rows)  # (B, L)
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


CHUNK = 128  # sorted positions a warp of the CUDA backward sums (kChunk)


def embedding_bags_backward_chunked_ref(tables, idx: torch.Tensor, grad_outs,
                                        windows=None) -> list:
    """The ``sum`` gradients of T tables (``embedding_bag_backward_ref`` of
    each, windows as its ``row_lo=``/``rows_global=``) added in the order of
    the CUDA backward (``csrc/embedding_bag.cu``), so with its bits: the
    T * B * L positions sorted stably by flat row (T tables' rows one after
    another, a position outside its window after every row), cut into
    chunks of ``CHUNK`` sorted positions; each run of one row within a
    chunk a float32 sum from 0 in sorted order, and each row the sum of its
    runs' pieces in chunk order, the first as it is. A restatement of the
    kernel's order, to hold its bits against; ``index_add_`` is the plain
    version."""
    n_tables, b, l = idx.shape
    rows = [t.shape[0] for t in tables]
    d = tables[0].shape[1]
    total = sum(rows)
    windows = windows or [(0, r) for r in rows]
    keys, base = [], 0
    for t in range(n_tables):
        lo, whole = windows[t]
        whole = _window(tables[t], "sum", lo, whole)
        read, inside = _window_rows(idx[t], rows[t], lo, whole)
        keys.append(torch.where(inside, base + read,
                                torch.full_like(read, total)).reshape(-1))
        base += rows[t]
    sorted_keys, perm = torch.sort(torch.cat(keys), stable=True)
    n = int((sorted_keys < total).sum())
    sorted_keys = sorted_keys[:n]
    # position p = (t * B + b) * L + l passes grad_outs[t][b]
    vals = torch.stack([g.to(torch.float32) for g in grad_outs]).reshape(
        n_tables * b, d)[perm[:n] // l]
    dev = vals.device
    pos = torch.arange(n, device=dev)
    new = torch.ones(n, dtype=torch.bool, device=dev)
    new[1:] = sorted_keys[1:] != sorted_keys[:-1]
    starts = new | (pos % CHUNK == 0)
    ends = torch.ones(n, dtype=torch.bool, device=dev)
    ends[:-1] = starts[1:]
    chunks = -(-n // CHUNK)
    acc = torch.zeros((chunks, d), dtype=torch.float32, device=dev)
    running = torch.empty((n, d), dtype=torch.float32, device=dev)
    for j in range(CHUNK):
        i = torch.arange(chunks, device=dev) * CHUNK + j
        c = torch.nonzero(i < n).flatten()
        i = i[c]
        acc[c] = torch.where(starts[i][:, None], 0.0, acc[c]) + vals[i]
        running[i] = acc[c]
    at = torch.nonzero(ends).flatten()
    piece_keys, pieces = sorted_keys[at], running[at]
    first = torch.ones_like(piece_keys, dtype=torch.bool)
    first[1:] = piece_keys[1:] != piece_keys[:-1]
    heads = torch.nonzero(first).flatten()
    rank = torch.arange(len(piece_keys), device=dev) - heads[
        torch.cumsum(first.long(), 0) - 1]
    grad = torch.zeros((total, d), dtype=torch.float32, device=dev)
    for r in range(int(rank.max()) + 1 if len(rank) else 0):
        m = rank == r
        k = piece_keys[m].long()
        grad[k] = pieces[m] if r == 0 else grad[k] + pieces[m]
    return list(grad.split(rows))
