"""Wrappers of the hand-written CUDA embedding_bag and its backward
(``csrc/embedding_bag.cu``).

``embedding_bag`` takes a contiguous ``(rows, D)`` float32 or bfloat16 table
and a contiguous ``(B, L)`` int32 id matrix on one CUDA device;
``embedding_bag_backward`` a float32 table (read for ``max`` only; its
shape sets the gradient's), the ids and a contiguous ``(B, D)`` float32
``grad_out``. Both raise on anything else; ``.launches`` counts each one's
launches.
"""

from __future__ import annotations

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
    on the card), the same bits from run to run: the rows' shares are
    summed in an order fixed by a stable sort of the positions by row."""
    _build.check_table_args("embedding_bag_backward", table, idx,
                            dtypes=(torch.float32,))
    if mode not in MODES:
        raise ValueError(f"unknown embedding_bag mode {mode!r}; have {MODES}")
    rows, d = table.shape
    b, l = idx.shape
    if grad_out.dtype != torch.float32 or tuple(grad_out.shape) != (b, d) \
            or not grad_out.is_contiguous() or grad_out.device != table.device:
        raise ValueError(f"embedding_bag_backward: grad_out must be a "
                         f"contiguous float32 {(b, d)} tensor on "
                         f"{table.device}, got {grad_out.dtype} "
                         f"{tuple(grad_out.shape)} on {grad_out.device}")
    grad = torch.zeros_like(table)
    if b == 0 or l == 0 or d == 0:
        return grad
    dev, n = table.device, b * l
    keys = torch.empty(n, dtype=torch.int32, device=dev)
    is_max = mode == "max"
    contrib = torch.empty((n, d) if is_max else (0,), dtype=torch.float32,
                          device=dev)
    lib = _build.load("embedding_bag")
    stream = _build.stream_of(table)
    m = MODES.index(mode)
    _build.check(lib.embedding_bag_backward_keys_f32(
        table.data_ptr(), idx.data_ptr(), grad_out.data_ptr(),
        keys.data_ptr(), contrib.data_ptr(), rows, d, b, l, m, stream),
        "embedding_bag_backward")
    sorted_rows, perm = torch.sort(keys, stable=True)
    n_chunks = -(-n // CHUNK)
    head = torch.empty((n_chunks, d), dtype=torch.float32, device=dev)
    tail = torch.empty((n_chunks, d), dtype=torch.float32, device=dev)
    src = contrib if is_max else grad_out
    _build.check(lib.embedding_bag_backward_f32(
        src.data_ptr(), idx.data_ptr(), sorted_rows.data_ptr(),
        perm.data_ptr(), grad.data_ptr(), head.data_ptr(), tail.data_ptr(),
        rows, d, b, l, m, stream), "embedding_bag_backward")
    embedding_bag_backward.launches += 1
    return grad


CHUNK = 32  # sorted positions a warp sums (csrc/embedding_bag.cu: kChunk)
embedding_bag_backward.launches = 0
