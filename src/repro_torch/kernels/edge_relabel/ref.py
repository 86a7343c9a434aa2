"""Plain PyTorch versions of the edge_relabel kernel pair.

``edge_relabel_ref`` — one bulk-synchronous relabel round: gather the
round-start labels at both edge endpoints, propose each endpoint's label to
the other, merge with min. Jacobi semantics: every gather reads the *input*
labeling. A negative endpoint (Liu–Tarjan altered edges carry the ``-1``
virtual minimum) *proposes* its own value but is never a scatter target: it
is dumped onto the last slot with the dtype's max sentinel.

``edge_rewrite_ref`` — the Liu–Tarjan *alter* step: rewrite both endpoints
of every edge to their current parent (negative endpoints are fixed).

Out of contract, both answer as the JAX package's versions do: an endpoint
at or past ``L`` gathers the last slot (the JAX gather clamps) and is never
a target (the JAX scatter drops it).
"""

from __future__ import annotations

import torch

from ..index import take


def _gather_label(labels: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """``labels[e]`` with negative ``e`` kept as it is; ``e >= L`` reads
    the last slot."""
    return torch.where(e < 0, e.to(labels.dtype), take(labels, e))


def edge_relabel_ref(labels: torch.Tensor, senders: torch.Tensor,
                     receivers: torch.Tensor) -> torch.Tensor:
    """labels (L,); senders/receivers (m,) in {-1} ∪ [0, L).

    ``out = labels; out[r] min= labels[s]; out[s] min= labels[r]``; a
    negative target, or one at or past ``L``, is dumped."""
    big = torch.iinfo(labels.dtype).max
    L = labels.shape[0]
    ls = _gather_label(labels, senders)
    lr = _gather_label(labels, receivers)
    out = labels
    for tgt, val in ((receivers, ls), (senders, lr)):
        off = (tgt < 0) | (tgt >= L)
        out = out.scatter_reduce(0, torch.where(off, L - 1, tgt).long(),
                                 torch.where(off, big, val), "amin",
                                 include_self=True)
    return out


def edge_rewrite_ref(labels: torch.Tensor, senders: torch.Tensor,
                     receivers: torch.Tensor):
    """Rewrite edge endpoints to their parents: ``e ← P[e]`` (-1 fixed)."""
    return _gather_label(labels, senders), _gather_label(labels, receivers)
