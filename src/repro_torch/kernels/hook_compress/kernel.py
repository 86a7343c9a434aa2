"""Wrapper of the hand-written CUDA hook_compress (``csrc/hook_compress.cu``).

Takes int32 tensors on one CUDA device and raises on anything else;
``hook_compress.launches`` counts its calls, each of which launches the
hook kernel and, for ``k > 0``, the hop kernel after it.
"""

from __future__ import annotations

import torch

from .. import _build


def hook_compress(labels: torch.Tensor, senders: torch.Tensor,
                  receivers: torch.Tensor, *, k: int = 1) -> torch.Tensor:
    """One uf_sync round: root-masked min-hook, then ``k`` shortcut hops
    through the hooked array. Three buffers: input, hooked, output."""
    _build.check_args("hook_compress", labels, senders, receivers)
    if k < 0:
        raise ValueError(f"hook_compress needs k >= 0, got {k}")
    hooked = torch.empty_like(labels)
    out = torch.empty_like(labels) if k > 0 else hooked
    lib = _build.load("hook_compress")
    rc = lib.hook_compress_i32(
        labels.data_ptr(), senders.data_ptr(), receivers.data_ptr(),
        hooked.data_ptr(), out.data_ptr() if k > 0 else None,
        labels.numel(), senders.numel(), k, _build.stream_of(labels))
    _build.check(rc, "hook_compress")
    hook_compress.launches += 1
    return out


hook_compress.launches = 0
