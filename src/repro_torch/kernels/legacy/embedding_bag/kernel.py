"""Wrapper of the hand-written CUDA embedding_bag (``csrc/embedding_bag.cu``).

Takes a contiguous ``(rows, D)`` float32 or bfloat16 table and a contiguous
``(B, L)`` int32 id matrix on one CUDA device, and raises on anything else;
``embedding_bag.launches`` counts its launches.
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
