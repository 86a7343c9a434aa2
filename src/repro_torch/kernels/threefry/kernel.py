"""Wrappers of the hand-written CUDA threefry draws (``csrc/threefry.cu``).

``threefry_bits`` fills a contiguous int64 tensor on a CUDA device;
``threefry_randint`` takes a contiguous int32 ``maxval`` there. Both raise
on anything else; ``.launches`` counts each one's launches.
"""

from __future__ import annotations

import torch

from .. import _build


def _check(what: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{what}: the CUDA kernel takes {dtype}, got "
                        f"{t.dtype}")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{what}: needs a 1-D contiguous tensor, got "
                         f"shape {tuple(t.shape)}")
    if t.device.type != "cuda":
        raise ValueError(f"{what}: needs a tensor on a CUDA device, got "
                         f"{t.device}")


def threefry_bits(out: torch.Tensor, k1: int, k2: int,
                  start: int) -> torch.Tensor:
    """``ref.threefry_bits_ref`` on the card, into ``out``."""
    _check("threefry_bits", out, torch.int64)
    if out.numel() == 0:
        return out
    lib = _build.load("threefry")
    _build.check(lib.threefry_bits_i64(out.data_ptr(), out.numel(), start,
                                       k1, k2, _build.stream_of(out)),
                 "threefry_bits")
    threefry_bits.launches += 1
    return out


def threefry_randint(maxval: torch.Tensor, minval: int, higher_key: tuple,
                     lower_key: tuple, start: int = 0) -> torch.Tensor:
    """``ref.threefry_randint_ref`` on the card: int32 (n,)."""
    _check("threefry_randint", maxval, torch.int32)
    out = torch.empty_like(maxval)
    if maxval.numel() == 0:
        return out
    lib = _build.load("threefry")
    _build.check(lib.threefry_randint_i32(
        maxval.data_ptr(), out.data_ptr(), maxval.numel(), start, minval,
        *higher_key, *lower_key, _build.stream_of(maxval)),
        "threefry_randint")
    threefry_randint.launches += 1
    return out


threefry_bits.launches = 0
threefry_randint.launches = 0
