"""Plain PyTorch version of the pointer_jump kernel.

Semantics: follow each slot's parent chain ``k`` hops through the
*round-start* (snapshot) array. One hop (``k=1``) is exactly one
``P ← P[P]`` shortcut round; chained hops compose as ``P^(k+1)``, so ``k=3``
equals two successive ``P ← P[P]`` rounds (FindHalve). Negative labels (the
``-1`` virtual minimum) are fixed points, and so are self-labeled slots.
"""

from __future__ import annotations

import torch


def pointer_jump_ref(labels: torch.Tensor, k: int = 1) -> torch.Tensor:
    """labels: (L,) int, values in {-1} ∪ [0, L)."""
    snap = labels
    out = labels
    for _ in range(k):
        out = torch.where(out < 0, out, snap[out.clamp_min(0).long()])
    return out
