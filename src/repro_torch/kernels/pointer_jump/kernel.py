"""Wrapper of the hand-written CUDA pointer_jump (``csrc/pointer_jump.cu``).

Takes an int32 label tensor on a CUDA device and raises on anything else;
``pointer_jump.launches`` counts its launches.
"""

from __future__ import annotations

import torch

from .. import _build


def pointer_jump(labels: torch.Tensor, *, k: int = 1) -> torch.Tensor:
    """``k`` chained hops through the snapshot ``labels``, out of place."""
    _build.check_args("pointer_jump", labels)
    if k < 1:
        raise ValueError(f"pointer_jump needs k >= 1, got {k}")
    out = torch.empty_like(labels)
    lib = _build.load("pointer_jump")
    rc = lib.pointer_jump_i32(labels.data_ptr(), out.data_ptr(),
                              labels.numel(), k, _build.stream_of(labels))
    _build.check(rc, "pointer_jump")
    pointer_jump.launches += 1
    return out


pointer_jump.launches = 0
