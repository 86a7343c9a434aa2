"""Indexing as the JAX package's gathers index.

``jnp`` indexing ``x[i]`` reads a negative ``i`` from the end once (``i +
len(x)``) and clamps whatever is still outside ``[0, len(x))`` into it;
PyTorch raises there instead. Every gather of the port through an index
that a caller supplies (a vertex id of a query or an insert, an edge
endpoint) goes through ``take`` or ``wrap_index``, so that it answers what
the JAX package answers for every int32 id. The CUDA kernels read such an index through
``common.cuh``'s ``clamp_index``, which is the same map.
"""

from __future__ import annotations

import torch


def wrap_index(idx: torch.Tensor, size: int) -> torch.Tensor:
    """The int64 index into a ``(size,)`` array that ``x[idx]`` reads in
    the JAX package."""
    i = idx.long()
    return torch.where(i < 0, i + size, i).clamp_(0, size - 1)


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` as the JAX package's gather reads it."""
    return x[wrap_index(idx, x.shape[0])]
