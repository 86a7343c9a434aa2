"""Plain PyTorch version of the threefry kernels (``csrc/threefry.cu``):
``jax.random``'s threefry2x32 block and the two draws the kernels make.

Every uint32 word is held in int64 and cut back with ``& 0xFFFFFFFF``
after each add and shift, so that one code path runs on both devices
(torch has no uint32 arithmetic on CUDA); ``threefry2x32`` also takes
Python ints, which is how ``repro_torch.random`` walks a key's schedule on
the host.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1, k2, x0, x1) -> tuple:
    """The threefry2x32 block (20 rounds) of key words ``k1, k2`` over the
    count words ``x0, x1`` → two words; Python ints or int64 tensors that
    broadcast. ``jax._src.prng._threefry2x32_lowering``, unrolled."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def threefry_bits_ref(out: torch.Tensor, k1: int, k2: int,
                      start: int) -> torch.Tensor:
    """Fill the int64 ``out`` (n,) with the bits of elements ``start`` ..
    ``start + n - 1`` under the key words ``(k1, k2)``: the XOR of the
    block's two words over the counter (i >> 32, i & MASK)."""
    i = torch.arange(start, start + out.shape[0], dtype=torch.int64,
                     device=out.device)
    b1, b2 = threefry2x32(k1, k2, i >> 32, i & MASK)
    return out.copy_(b1 ^ b2)


def _mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a * b mod 2**32`` of two words, without overflowing int64."""
    return ((((a >> 16) * b) & 0xFFFF) << 16) + (a & 0xFFFF) * b & MASK


def threefry_randint_ref(maxval: torch.Tensor, minval: int, higher_key: tuple,
                         lower_key: tuple) -> torch.Tensor:
    """``jax.random.randint`` of ``maxval.shape[0]`` int32 elements in
    ``[minval, maxval)`` (``minval`` where ``maxval <= minval``): the bits
    of ``higher_key`` and ``lower_key`` (``split(key)``'s words) reduced
    modulo the span in wrapping uint32 (``jax._src.random._randint``).
    ``maxval`` is int32 (n,), ``minval`` an int32 value."""
    n = maxval.shape[0]
    hi = maxval.to(torch.int64)
    higher = threefry_bits_ref(torch.empty(n, dtype=torch.int64,
                                           device=maxval.device),
                               *higher_key, 0)
    lower = threefry_bits_ref(torch.empty_like(higher), *lower_key, 0)
    span = (hi - minval) & MASK
    span = torch.where(hi <= minval, torch.ones_like(span), span)
    multiplier = torch.remainder(torch.full_like(span, 1 << 16), span)
    multiplier = torch.remainder(_mul32(multiplier, multiplier), span)
    offset = (_mul32(torch.remainder(higher, span), multiplier)
              + torch.remainder(lower, span)) & MASK
    out = (minval + torch.remainder(offset, span)) & MASK  # int32, wrapping
    return torch.where(out >= (1 << 31), out - (1 << 32), out).to(
        torch.int32)
