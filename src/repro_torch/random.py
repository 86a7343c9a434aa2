"""``jax.random``'s threefry2x32 draws in PyTorch (mirrors the functions of
``jax.random`` that the port's sampled paths and its DLRM training take).

The numbers are ``jax.random``'s under ``jax_threefry_partitionable=True``
(JAX's default from 0.5) with 64-bit types off: a seed, a key and a draw
give the same bits here as there, on the CPU and on the card alike.

  * A key is a ``(2,)`` int64 tensor holding two uint32 words, on the device
    where its draws are made. ``PRNGKey``, ``split`` and ``fold_in`` are
    ``jax.random``'s; ``key_from_numpy`` takes a key that the JAX package
    made (a ``(2,)`` uint32 array).
  * A key's own schedule (``split``, ``fold_in``, the words a draw is
    keyed by) runs on the host in Python ints, one read of the key a call.
    The draws themselves go through ``kernels.ops.threefry_bits`` and
    ``threefry_randint``: the hand-written CUDA kernels on the card, their
    plain versions (``kernels/threefry/ref.py``, uint32 words held in
    int64) on the CPU.
  * ``bits``, ``randint`` and ``uniform`` are bit for bit ``jax.random``'s.
    ``normal`` takes XLA's own ``erf_inv`` polynomial, and ``exponential``
    ``-log1p(-u)``; both go through torch's ``log1p``, which may differ from
    XLA's by an ulp, so a draw may differ by a few ulps
    (tests/test_torch_random.py states how many).
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

from .device import DEFAULT_DEVICE, resolve_device
from .kernels import ops
from .kernels.threefry.ref import MASK, threefry2x32

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> tuple:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def PRNGKey(seed: int, *, device=DEFAULT_DEVICE) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off: a seed in
    ``[-2**63, 2**63)`` gives the key ``(0, seed mod 2**32)``; one outside
    it raises ``OverflowError``, as there."""
    seed = int(seed)
    if not -(1 << 63) <= seed < (1 << 63):
        raise OverflowError(f"a seed is an int64; got {seed}")
    return torch.tensor([0, seed & MASK], dtype=torch.int64,
                        device=resolve_device(device))


def key_from_numpy(key, *, device=DEFAULT_DEVICE) -> torch.Tensor:
    """A key of the JAX package (a ``(2,)`` uint32 array) as a port key."""
    arr = np.asarray(key)
    if arr.shape != (2,) or arr.dtype != np.uint32:
        raise ValueError(f"a key is a (2,) uint32 array; got {arr.shape} "
                         f"{arr.dtype}")
    return torch.from_numpy(arr.astype(np.int64)).to(resolve_device(device))


def key_to_numpy(key: torch.Tensor) -> np.ndarray:
    """A port key as the JAX package's ``(2,)`` uint32 array."""
    return key.cpu().numpy().astype(np.uint32)


def check_key(key) -> torch.Tensor:
    if not isinstance(key, torch.Tensor) or tuple(key.shape) != (2,) or \
            key.dtype != torch.int64:
        raise TypeError(f"a key is a (2,) int64 tensor of two uint32 words "
                        f"(repro_torch.random.PRNGKey); got {key!r}")
    return key


def choose(key=None, generator=None):
    """The draws' source of an entry point that takes ``key=`` (the
    reference's) and ``generator=`` (torch's numbers): whichever was given,
    None for neither; both raise."""
    if key is not None and generator is not None:
        raise ValueError("pass key= or generator=, not both")
    return generator if generator is not None else key


def resolve(rng, device):
    """A sampler's source on ``device``: a ``torch.Generator`` as it is, a
    key moved to ``device``, and None as ``PRNGKey(0)`` there (the
    reference's default key)."""
    if isinstance(rng, torch.Generator):
        return rng
    if rng is None:
        return PRNGKey(0, device=device)
    return check_key(rng).to(device)


def _words(key: torch.Tensor) -> tuple:
    """A key's two words as Python ints (one read of the key)."""
    k1, k2 = check_key(key).tolist()
    return k1, k2


def _split_words(words: tuple, num: int) -> list:
    return [threefry2x32(*words, i >> 32, i & MASK) for i in range(num)]


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` → ``(num, 2)`` keys."""
    return torch.tensor(_split_words(_words(key), num), dtype=torch.int64,
                        device=key.device).reshape(num, 2)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: ``data`` is a uint32; one outside
    ``[0, 2**32)`` raises ``OverflowError``, as there."""
    data = int(data)
    if not 0 <= data <= MASK:
        raise OverflowError(f"fold_in data is a uint32; got {data}")
    b = threefry2x32(*_words(key), 0, data)
    return torch.tensor(b, dtype=torch.int64, device=key.device)


def bits(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) as int64 words in
    ``[0, 2**32)``."""
    return _draw(key, shape, lambda b: b, torch.int64)


# elements drawn at once: a draw is a function of each element's flat index,
# so a large one (a DLRM-RM2 table is 64M values) goes in slices of this
# many, which bounds the int64 temporaries of the rounds
_SLICE = 1 << 22


def _draw(key: torch.Tensor, shape: Shape, finish, dtype) -> torch.Tensor:
    """``finish(bits)`` of each element of ``shape``, in flat slices."""
    shape = _shape(shape)
    n = math.prod(shape)
    k1, k2 = _words(key)
    out = torch.empty(n, dtype=dtype, device=key.device)
    for lo in range(0, n, _SLICE):
        b = torch.empty(min(_SLICE, n - lo), dtype=torch.int64,
                        device=key.device)
        out[lo: lo + b.shape[0]] = finish(ops.threefry_bits(b, k1, k2, lo))
    return out.reshape(shape)


def randint(key: torch.Tensor, shape: Shape, minval: int, maxval,
            dtype=torch.int32, *, start: int = 0) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` for int32 output:
    ``minval`` an int, ``maxval`` an int or an int tensor broadcastable to
    ``shape``, both clipped to int32; where ``maxval <= minval`` the draw is
    ``minval``. Two bit draws (``split(key)``'s keys) reduced modulo the
    span in wrapping uint32. ``start`` > 0 draws the elements ``start`` ..
    ``start + prod(shape) - 1`` of a larger draw under the same key (a
    rank's block of a draw split over a mesh)."""
    shape = _shape(shape)
    imin, imax = -(1 << 31), (1 << 31) - 1
    lo = min(max(int(minval), imin), imax)
    hi = torch.as_tensor(maxval, device=key.device).to(torch.int64)
    hi = hi.clamp(imin, imax).to(torch.int32).expand(shape).reshape(-1)
    higher, lower = _split_words(_words(key), 2)
    out = ops.threefry_randint(hi.contiguous(), lo, higher, lower, start)
    return out.reshape(shape).to(dtype)


def _unit_floats(b: torch.Tensor) -> torch.Tensor:
    """The top 23 bits of each word as a mantissa in [1, 2), minus 1."""
    return ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def _scale(floats: torch.Tensor, minval: float,
           maxval: float) -> torch.Tensor:
    lo = torch.tensor(minval, dtype=torch.float32, device=floats.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=floats.device)
    # XLA contracts ``floats * span + lo`` into one fused multiply-add; the
    # product of two float32 is exact in float64, so one float64 add and one
    # rounding to float32 give the fused result
    fused = (floats.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, fused)


def uniform(key: torch.Tensor, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: the top
    23 bits as a mantissa in [1, 2), minus 1, scaled into the range."""
    return _draw(key, shape,
                 lambda b: _scale(_unit_floats(b), minval, maxval),
                 torch.float32)


# np.nextafter(-1, 0) in float32: normal's uniform range is (-1, 1)
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
# Giles' single-precision erfinv, as XLA decomposes ``erf_inv`` for float32:
# a degree-8 polynomial in w - 2.5 (w < 5) or sqrt(w) - 3, w = -log1p(-x²)
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                  -0.00367342844, 0.00573950773, -0.0076224613,
                  0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv``, step for step; its Horner steps are fused
    multiply-adds there, and are one float64 multiply-add rounded to float32
    here (the float32 product is exact in float64). Only ``log1p`` is
    torch's, so a result may differ from XLA's by a few ulps."""
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    coef = [torch.where(lt, np.float32(a), np.float32(b)).double()
            for a, b in zip(_ERFINV_W_LT_5, _ERFINV_W_GE_5)]
    p = coef[0]
    for c in coef[1:]:
        p = (p * w + c).float().double()
    out = p.float() * x
    return torch.where(x.abs() == 1.0, x * math.inf, out)


def normal(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` (float32): ``sqrt(2) *
    erfinv(u)`` for ``u = uniform(key, shape, nextafter(-1, 0), 1)``."""
    return _draw(key, shape, lambda b: erfinv(
        _scale(_unit_floats(b), _NORMAL_LO, 1.0)) * np.float32(np.sqrt(2)),
        torch.float32)


def exponential(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.exponential(key, shape)`` (float32): ``-log1p(-u)``."""
    return _draw(key, shape, lambda b: -torch.log1p(-_unit_floats(b)),
                 torch.float32)
