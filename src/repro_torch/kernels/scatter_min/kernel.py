"""Wrapper of the hand-written CUDA scatter_min (``csrc/scatter_min.cu``).

Takes pre-sanitized int32 tensors on one CUDA device and raises on anything
else; ``scatter_min.launches`` counts its launches.
"""

from __future__ import annotations

import torch

from .. import _build


def scatter_min(labels: torch.Tensor, idx: torch.Tensor,
                vals: torch.Tensor) -> torch.Tensor:
    """``labels[idx] min= vals`` out of place; labels (L,), idx/vals (m,)."""
    _build.check_args("scatter_min", labels, idx, vals)
    out = torch.empty_like(labels)
    lib = _build.load("scatter_min")
    rc = lib.scatter_min_i32(labels.data_ptr(), idx.data_ptr(),
                             vals.data_ptr(), out.data_ptr(), labels.numel(),
                             idx.numel(), _build.stream_of(labels))
    _build.check(rc, "scatter_min")
    scatter_min.launches += 1
    return out


scatter_min.launches = 0
