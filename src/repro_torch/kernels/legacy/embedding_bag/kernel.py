"""Wrappers of the hand-written CUDA embedding_bag and its backward
(``csrc/embedding_bag.cu``).

``embedding_bag`` takes a contiguous ``(rows, D)`` float32 or bfloat16 table
and a contiguous ``(B, L)`` int32 id matrix on one CUDA device.
``embedding_bags_backward`` takes T float32 tables of one width D (read
for ``max`` only; their shapes set the gradients'), their ids as one
contiguous ``(T, B, L)`` int32 tensor and T float32 ``(B, D)`` ``grad_out``
tensors whose columns are adjacent, and computes the T gradients in one
call of the backward kernel; ``embedding_bag_backward`` is its one-table
case. Each raises on anything else. ``.launches`` counts launches:
``embedding_bag``'s of the forward, ``embedding_bag_backward``'s of the
backward kernel, one a call through either backward wrapper.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ... import _build
from .ref import MODES

_ENTRY = {torch.float32: "embedding_bag_f32",
          torch.bfloat16: "embedding_bag_bf16"}


def embedding_bag(table: torch.Tensor, idx: torch.Tensor, *,
                  mode: str = "sum") -> torch.Tensor:
    """``(B, D)`` bags of ``table`` rows reduced by ``mode``, in the table's
    dtype (the id contract of ``ref.embedding_bag_ref``)."""
    _build.check_table_args("embedding_bag", table, idx, dtypes=tuple(_ENTRY))
    if mode not in MODES:
        raise ValueError(f"unknown embedding_bag mode {mode!r}; have {MODES}")
    rows, d = table.shape
    b, l = idx.shape
    out = torch.empty((b, d), dtype=table.dtype, device=table.device)
    if b == 0 or d == 0:
        return out
    lib = _build.load("embedding_bag")
    rc = getattr(lib, _ENTRY[table.dtype])(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), rows, d, b, l,
        MODES.index(mode), _build.stream_of(table))
    _build.check(rc, "embedding_bag")
    embedding_bag.launches += 1
    return out


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
                            mode: str = "sum") -> list:
    """The T dense float32 gradients, ``(rows_t, D)`` each, of the bags
    ``embedding_bag(tables[t], idx[t], mode=mode)`` given ``grad_outs[t]``
    (``ref.embedding_bag_backward_ref`` of each table, on the card), the
    same bits from run to run. They are views of one ``(sum of rows_t, D)``
    tensor that the kernel writes whole: three launches and one stable
    sort of the T * B * L positions by (table, row), whatever T is, and a
    memset of a bit a row and a counter a chunk of 128 positions."""
    what = "embedding_bag_backward"
    if mode not in MODES:
        raise ValueError(f"unknown embedding_bag mode {mode!r}; have {MODES}")
    tables = list(tables)
    if not 1 <= len(tables) <= MAX_TABLES:
        raise ValueError(f"{what}: takes 1 to {MAX_TABLES} tables, got "
                         f"{len(tables)}")
    if idx.dim() != 3 or idx.shape[0] != len(tables) \
            or not idx.is_contiguous():
        raise ValueError(f"{what}: ids must be a contiguous (T, B, L) tensor "
                         f"for T = {len(tables)} tables, got shape "
                         f"{tuple(idx.shape)}")
    T, b, l = idx.shape
    _build.check_table_args(what, tables[0], idx[0], dtypes=(torch.float32,))
    d = tables[0].shape[1]
    dev = tables[0].device
    for table in tables[1:]:
        if table.dtype != torch.float32 or table.dim() != 2 \
                or not table.is_contiguous() or table.shape[0] == 0 \
                or table.shape[1] != d or table.device != dev:
            raise ValueError(f"{what}: every table must be a contiguous "
                             f"float32 (rows >= 1, {d}) tensor on {dev}, like "
                             f"the first, got {table.dtype} "
                             f"{tuple(table.shape)} on {table.device}")
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
                 _int64s(g.stride(0) for g in grad_outs), _int64s(rows)]
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


def _int64s(values) -> ctypes.Array:
    values = list(values)
    return (ctypes.c_int64 * len(values))(*values)


MAX_TABLES = 64  # tables a call takes (csrc/embedding_bag.cu: kMaxTables)
CHUNK = 128      # sorted positions a warp sums (csrc/embedding_bag.cu: kChunk)
INT32_MAX = 2**31 - 1
embedding_bag_backward.launches = 0
