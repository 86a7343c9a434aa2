"""Wrappers of the hand-written CUDA embedding_bag and its backward
(``csrc/embedding_bag.cu``).

``embedding_bags`` takes T contiguous ``(rows_t, D)`` tables of one dtype
(float32 or bfloat16) and one D on one CUDA device, their ids as one
contiguous ``(T, B, L)`` int32 tensor, and computes the T bags in one
launch, into one ``(T, B, D)`` tensor; ``embedding_bag`` is its one-table
case. ``embedding_bags_backward`` takes T float32 tables of one width D
(read for ``max`` only; their shapes set the gradients'), their ids as one
contiguous ``(T, B, L)`` int32 tensor and T float32 ``(B, D)`` ``grad_out``
tensors whose columns are adjacent, and computes the T gradients in one
call of the backward kernel; ``embedding_bag_backward`` is its one-table
case. Each raises on anything else.

Both grouped wrappers take ``windows``: for each table ``(row_lo,
rows_global)``, the table being rows ``[row_lo, row_lo + rows)`` of a
``rows_global``-row table (a rank's block of a table row-sharded over a
mesh). Ids are read against the whole table, and a row outside the window
adds nothing (``sum`` only): the forward's bags are this window's share of
the whole table's, the backward's gradients the window's rows. ``None`` is
every table whole (``(0, rows)``).

``.launches`` counts launches:
``embedding_bag``'s of the forward, one a call through either forward
wrapper; ``embedding_bag_backward``'s of the backward kernel, one a call
through either backward wrapper.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ... import _build
from .ref import MODES

_ENTRY = {torch.float32: "embedding_bags_f32",
          torch.bfloat16: "embedding_bags_bf16"}


def embedding_bags(tables: Sequence[torch.Tensor], idx: torch.Tensor, *,
                   mode: str = "sum", windows=None) -> torch.Tensor:
    """The ``(T, B, D)`` bags of T tables reduced by ``mode``, in the tables'
    dtype: ``[t]`` is ``ref.embedding_bag_ref(tables[t], idx[t], mode)``
    (with ``windows``, at ``row_lo=`` and ``rows_global=``), the same bits
    as a launch a table. One check of the arguments, one allocation and one
    launch, whatever T is."""
    what = "embedding_bag"
    if mode not in MODES:
        raise ValueError(f"unknown embedding_bag mode {mode!r}; have {MODES}")
    _check_tables(what, tables, idx, tuple(_ENTRY))
    row_lo, rows_global = _windows(what, tables, windows, mode)
    n, b, l = idx.shape
    first = tables[0]
    dtype, d, dev = first.dtype, first.shape[1], first.device
    out = torch.empty((n, b, d), dtype=dtype, device=dev)
    if b == 0 or d == 0:
        return out
    ptrs = _int64s(t.data_ptr() for t in tables)
    rows = _int64s(t.shape[0] for t in tables)
    rc = getattr(_build.load("embedding_bag"), _ENTRY[dtype])(
        ctypes.addressof(ptrs), ctypes.addressof(rows),
        ctypes.addressof(row_lo), ctypes.addressof(rows_global), n,
        idx.data_ptr(), out.data_ptr(), b, l, d, MODES.index(mode),
        _build.stream_of(first))
    _build.check(rc, what)
    embedding_bag.launches += 1
    return out


def embedding_bag(table: torch.Tensor, idx: torch.Tensor, *,
                  mode: str = "sum") -> torch.Tensor:
    """``(B, D)`` bags of ``table`` rows reduced by ``mode``, in the table's
    dtype (the id contract of ``ref.embedding_bag_ref``): ``embedding_bags``
    of one table."""
    _build.check_table_args("embedding_bag", table, idx, dtypes=tuple(_ENTRY))
    return embedding_bags([table], idx[None], mode=mode)[0]


embedding_bag.launches = 0


def embedding_bag_backward(table: torch.Tensor, idx: torch.Tensor,
                           grad_out: torch.Tensor, *,
                           mode: str = "sum") -> torch.Tensor:
    """The dense ``(rows, D)`` float32 gradient of ``embedding_bag(table,
    idx, mode=mode)`` given ``grad_out`` (``ref.embedding_bag_backward_ref``
    on the card): ``embedding_bags_backward`` of one table."""
    _build.check_table_args("embedding_bag_backward", table, idx,
                            dtypes=(torch.float32,))
    return embedding_bags_backward([table], idx[None], [grad_out],
                                   mode=mode)[0]


def embedding_bags_backward(tables: Sequence[torch.Tensor], idx: torch.Tensor,
                            grad_outs: Sequence[torch.Tensor], *,
                            mode: str = "sum", windows=None) -> list:
    """The T dense float32 gradients, ``(rows_t, D)`` each, of the bags
    ``embedding_bag(tables[t], idx[t], mode=mode)`` given ``grad_outs[t]``
    (``ref.embedding_bag_backward_ref`` of each table, on the card; with
    ``windows``, the window's rows), the same bits from run to run. They
    are views of one ``(sum of rows_t, D)`` tensor that the kernel writes
    whole: three launches and one stable sort of the T * B * L positions by
    (table, row), a position outside its window after every row, whatever T
    is, and a memset of a bit a row and a counter a chunk of 128
    positions."""
    what = "embedding_bag_backward"
    if mode not in MODES:
        raise ValueError(f"unknown embedding_bag mode {mode!r}; have {MODES}")
    _check_tables(what, tables, idx, (torch.float32,))
    row_lo, rows_global = _windows(what, tables, windows, mode)
    T, b, l = idx.shape
    d = tables[0].shape[1]
    dev = tables[0].device
    grad_outs = list(grad_outs)
    if len(grad_outs) != T or any(
            g.dtype != torch.float32 or tuple(g.shape) != (b, d)
            or (g.stride(1) != 1 and d > 1) or g.device != dev
            for g in grad_outs):
        got = [(str(g.dtype), tuple(g.shape), g.stride(), str(g.device))
               for g in grad_outs]
        raise ValueError(f"{what}: grad_out must be {T} float32 {(b, d)} "
                         f"tensors with adjacent columns on {dev}, got {got}")
    n = T * b * l
    if n > INT32_MAX:
        raise ValueError(f"{what}: {n} positions, past the kernel's "
                         f"{INT32_MAX}")
    rows = [table.shape[0] for table in tables]
    total = sum(rows)
    grad = torch.empty((total, d), dtype=torch.float32, device=dev)
    if d == 0:
        return list(grad.split(rows))
    key_dtype = torch.int32 if total <= INT32_MAX else torch.int64
    is_max = mode == "max"
    count = torch.empty(T * b if mode == "mean" else 0, dtype=torch.float32,
                        device=dev)
    contrib = torch.empty((n, d) if is_max else (0,), dtype=torch.float32,
                          device=dev)
    per_table = [_int64s(x.data_ptr() for x in tables),
                 _int64s(g.data_ptr() for g in grad_outs),
                 _int64s(g.stride(0) for g in grad_outs), _int64s(rows),
                 row_lo, rows_global]
    args = [ctypes.addressof(a) for a in per_table] + [T]
    lib = _build.load("embedding_bag")
    stream = _build.stream_of(tables[0])
    m = MODES.index(mode)
    # zeroed int32 counters (the zeroing blocks' slices, one a chunk of 128
    # positions of the sums, whose pieces are two partial rows a chunk), then
    # a bit a gradient row, set for the rows some position reads
    chunks = -(-n // CHUNK)
    counters = torch.zeros(1 + chunks + -(-total // 32),
                           dtype=torch.int32, device=dev)
    pieces = torch.empty((2 * chunks, d), dtype=torch.float32, device=dev)
    keys = torch.empty(n, dtype=key_dtype, device=dev)
    _build.check(lib.embedding_bag_backward_keys_f32(
        *args, idx.data_ptr(), keys.data_ptr(), keys.element_size(),
        count.data_ptr(), contrib.data_ptr(), b, l, d, m, stream), what)
    sorted_keys, perm = torch.sort(keys, stable=True)
    _build.check(lib.embedding_bag_backward_f32(
        *args, sorted_keys.data_ptr(), keys.element_size(), perm.data_ptr(),
        counters.data_ptr(), pieces.data_ptr(), count.data_ptr(),
        contrib.data_ptr(), grad.data_ptr(), n, b, l, d, m, stream), what)
    embedding_bag_backward.launches += 1
    return list(grad.split(rows))


def _check_tables(what: str, tables: Sequence[torch.Tensor],
                  idx: torch.Tensor, dtypes: tuple) -> None:
    """Raise unless ``tables`` are 1 to MAX_TABLES contiguous 2-D tensors
    with rows, of one dtype of ``dtypes``, one width and one CUDA device,
    and ``idx`` is a contiguous ``(T, B, L)`` int32 tensor there. What the
    CPU's tensors could not take is checked before the device."""
    n = len(tables)
    if not 1 <= n <= MAX_TABLES:
        raise ValueError(f"{what}: takes 1 to {MAX_TABLES} tables, got {n}")
    first = tables[0]
    if first.dtype not in dtypes:
        raise TypeError(f"{what}: the CUDA kernel takes a table of "
                        f"{[str(d) for d in dtypes]}, got {first.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"{what}: the CUDA kernel takes int32 ids, got "
                        f"{idx.dtype}")
    if idx.dim() != 3 or idx.shape[0] != n or not idx.is_contiguous():
        raise ValueError(f"{what}: ids must be a contiguous (T, B, L) tensor "
                         f"for T = {n} tables, got shape {tuple(idx.shape)}")
    like = (first.dtype, first.shape[1:], first.device)
    for table in tables:
        if table.dim() != 2 or not table.is_contiguous() \
                or table.shape[0] == 0 \
                or (table.dtype, table.shape[1:], table.device) != like:
            raise ValueError(f"{what}: every table must be a contiguous 2-D "
                             f"{first.dtype} tensor with rows, of the first's "
                             f"width {tuple(first.shape[1:])}, on "
                             f"{first.device}, like the first, got "
                             f"{table.dtype} {tuple(table.shape)} on "
                             f"{table.device}")
    if first.device.type != "cuda" or idx.device != first.device:
        raise ValueError(f"{what}: needs tensors on one CUDA device, got "
                         f"tables on {first.device}, ids on {idx.device}")


def _windows(what: str, tables: Sequence[torch.Tensor], windows,
             mode: str) -> tuple:
    """Each table's ``(row_lo, rows_global)`` as two C arrays, checked:
    the window lies in ``[0, rows_global)``, and a window that is not the
    whole table takes ``sum`` bags only."""
    rows = [t.shape[0] for t in tables]
    if windows is None:
        return _int64s([0] * len(rows)), _int64s(rows)
    windows = [(int(lo), int(whole)) for lo, whole in windows]
    if len(windows) != len(rows):
        raise ValueError(f"{what}: {len(windows)} windows for "
                         f"{len(rows)} tables")
    for r, (lo, whole) in zip(rows, windows):
        if lo < 0 or lo + r > whole:
            raise ValueError(f"{what}: a window of {r} rows from row {lo} "
                             f"does not lie in a table of {whole} rows")
        if mode != "sum" and (lo, whole) != (0, r):
            raise ValueError(f"{what}: a window of rows takes sum bags only, "
                             f"got mode {mode!r}")
    return (_int64s(lo for lo, _ in windows),
            _int64s(whole for _, whole in windows))


def _int64s(values) -> ctypes.Array:
    values = list(values)
    return (ctypes.c_int64 * len(values))(*values)


MAX_TABLES = 64  # tables a call takes (csrc/embedding_bag.cu: kMaxTables)
CHUNK = 128      # sorted positions a warp sums (csrc/embedding_bag.cu: kChunk)
INT32_MAX = 2**31 - 1
embedding_bag_backward.launches = 0
