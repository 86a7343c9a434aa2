"""Low-level primitives shared by the ConnectIt algorithms (PyTorch).

The connectivity labeling ``P`` is a ``(n + 1,)`` int32 tensor:
  * ``P[v]`` is vertex ``v``'s current label (a vertex id, or ``-1``);
  * row ``n`` is the *dump slot* for padded edges (``P[n] == n`` always);
  * ``-1`` is the *virtual minimum* label used to pin the most frequent
    sampled component ``L_max`` (paper §3.3.2). ``-1`` is a fixed point of
    every primitive below.

The hot-path primitives dispatch through ``repro_torch.kernels.ops``: the
plain PyTorch version for a CPU tensor, the CUDA kernel for a CUDA tensor.

Fixpoint loops run on the host: each round compares the old and new state
with ``torch.equal`` and counts rounds exactly as the JAX package's
on-device ``lax.while_loop`` does, the final unchanged round included.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels import ops
from ..kernels.index import take

INT_MAX = torch.iinfo(torch.int32).max
DEFAULT_MAX_ROUNDS = 1 << 20


def init_labels(n: int, *, device, dtype=torch.int32) -> torch.Tensor:
    return torch.arange(n + 1, dtype=dtype, device=device)


def parents_of(P: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Gather ``P[x]`` treating negative labels as fixed points; an ``x``
    past the end reads the last slot, as the JAX package's gather does (a
    mesh stream hands its finish raw batch ends)."""
    return torch.where(x < 0, x, take(P, x.clamp_min(0)))


def write_min(P: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``P[idx] = min(P[idx], vals)`` with negative/masked targets dumped."""
    return ops.scatter_min(P, idx, vals, mask)


def jump_round(P: torch.Tensor, k: int = 1) -> torch.Tensor:
    """``k`` chained shortcut hops in one call (``k=1`` is ``P ← P[P]``)."""
    return ops.pointer_jump(P, k=k)


def hook_compress(P: torch.Tensor, senders: torch.Tensor,
                  receivers: torch.Tensor, *, jumps: int = 1) -> torch.Tensor:
    """One fused uf_sync round (root-masked min-hook + ``jumps`` hops)."""
    return ops.hook_compress(P, senders, receivers, k=jumps)


def relabel_round(P: torch.Tensor, senders: torch.Tensor,
                  receivers: torch.Tensor) -> torch.Tensor:
    """One edge-relabel round: each endpoint proposes its label to the other
    (scatter-min merge). Negative endpoints propose ``-1`` but are dumped as
    targets — the Liu–Tarjan ParentConnect rule on (possibly altered) edges."""
    return ops.edge_relabel(P, senders, receivers)


def rewrite_edges(P: torch.Tensor, senders: torch.Tensor,
                  receivers: torch.Tensor):
    """Rewrite both edge endpoints to their parents, ``e ← P[e]`` (``-1``
    fixed) — the Liu–Tarjan alter step."""
    return ops.edge_rewrite(P, senders, receivers)


def _leaves(state):
    return state if isinstance(state, (tuple, list)) else (state,)


def _any_leaf_changed(old, new) -> bool:
    # a leaf the step handed back as it was (the edges of a Liu–Tarjan
    # variant without alter) has not changed: skip its comparison
    return any(a is not b and not torch.equal(a, b)
               for a, b in zip(_leaves(old), _leaves(new)))


def iterate_to_fixpoint(step, state, max_rounds: int = DEFAULT_MAX_ROUNDS,
                        *, changed_fn=None):
    """Run ``step: state -> state`` until nothing changes → (state, rounds).

    ``state`` is a tensor or a tuple of tensors. ``changed_fn(old, new)``
    returns a host bool; the default is "any tensor of the state changed".
    Rounds are counted as the reference's on-device loop counts them: the
    last round, which changed nothing, counts, and ``max_rounds`` caps."""
    changed_fn = _any_leaf_changed if changed_fn is None else changed_fn
    rounds = 0
    changed = True
    while changed and rounds < max_rounds:
        new = step(state)
        changed = bool(changed_fn(state, new))
        state = new
        rounds += 1
    return state, rounds


def full_compress(P: torch.Tensor, max_rounds: int = 64, *,
                  jumps: int = 1) -> torch.Tensor:
    """Pointer-jump to fixpoint: log2(longest path) rounds at ``jumps=1``."""
    P, _ = iterate_to_fixpoint(lambda P: jump_round(P, jumps), P, max_rounds)
    return P


def is_root(P: torch.Tensor) -> torch.Tensor:
    """Boolean per-vertex root mask (``P[v] == v``); ``-1``-labeled ⇒ False."""
    return P == torch.arange(P.shape[0], dtype=P.dtype, device=P.device)


def count_labels(P: torch.Tensor) -> torch.Tensor:
    """Histogram of labels over real vertices (length n); -1 counts as 0."""
    n = P.shape[0] - 1
    lab = P[:n].clamp_min(0)  # -1 never coexists with counting use
    return torch.bincount(lab.long(), minlength=n)[:n]


def most_frequent(P: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(label, count) of the most frequent component id (paper L_max);
    ties go to the smallest label, as ``argmax`` returns the first index."""
    counts = count_labels(P)
    lmax = torch.argmax(counts)
    return lmax.to(P.dtype), counts[lmax]


def num_components(P: torch.Tensor) -> torch.Tensor:
    """Number of distinct labels over real vertices (P must be compressed)."""
    return (count_labels(P) > 0).sum()


def relabel_lmax(P: torch.Tensor, lmax: torch.Tensor) -> torch.Tensor:
    """Pin component ``lmax`` to the virtual minimum label -1 (Theorem 4)."""
    n = P.shape[0] - 1
    pin = P == lmax
    pin[n] = False  # the dump row keeps its label
    return torch.where(pin, -1, P)


def restore_lmax(P: torch.Tensor) -> torch.Tensor:
    """Map the virtual -1 label back to the component's min vertex id."""
    n = P.shape[0] - 1
    ids = torch.arange(n + 1, dtype=P.dtype, device=P.device)
    cand = torch.where((P == -1) & (ids < n), ids, n)
    return torch.where(P == -1, cand.min(), P)


def min_vertex_labels(P: torch.Tensor) -> torch.Tensor:
    """Relabel every component to its minimum member vertex id: one
    scatter-min over real vertices + one gather."""
    n = P.shape[0] - 1
    ids = torch.arange(n + 1, dtype=P.dtype, device=P.device)
    real = (P >= 0) & (ids < n)
    reps = ops.scatter_min(torch.full_like(P, n), P, ids, real)
    safe = P.clamp(0, n).long()
    out = torch.where(P >= 0, reps[safe], P)
    out[n] = n
    return out


def canonical_labels(P: torch.Tensor, max_rounds: int = 64) -> torch.Tensor:
    P = full_compress(P, max_rounds)
    return min_vertex_labels(restore_lmax(P))


def hook_and_record(P, idx, vals, mask, eu, ev, fu, fv):
    """writeMin hook that also records the winning edge per hooked root.

    Root-based spanning forest rule (paper §3.4 / Theorem 6): when root
    ``x``'s label first decreases because of edge ``e = (eu[i], ev[i])``,
    store ``e`` at slot ``x``. Two passes of ``ops.scatter_min``: the values
    into ``P``, then the edge ids of the entries that reached the winning
    value into an ``INT_MAX`` buffer (the smallest id wins). A slot is
    written at most once. ``won`` compares the new labels with the untouched
    ``old``; the gathers clamp as the reference's do."""
    n = P.shape[0] - 1
    m = eu.shape[0]
    old = P
    P = write_min(P, idx, vals, mask)
    if m == 0:
        return P, fu, fv
    safe_idx = torch.where((idx >= 0) & (idx <= n), idx, n)
    si = safe_idx.long()
    Pi = P[si]
    won = (idx >= 0) & (vals.to(P.dtype) == Pi) & (Pi < old[si])
    if mask is not None:
        won = won & mask
    eid = torch.arange(m, dtype=torch.int32, device=P.device)
    ebuf = torch.full((n + 1,), INT_MAX, dtype=torch.int32, device=P.device)
    ebuf = ops.scatter_min(ebuf, safe_idx, eid, won)
    sel = (ebuf < INT_MAX) & (fu == -1)
    take = ebuf.clamp_max(m - 1).long()
    fu = torch.where(sel, eu[take], fu)
    fv = torch.where(sel, ev[take], fv)
    return P, fu, fv


def init_forest(n: int, *, device, dtype=torch.int32):
    """Empty forest slots ``(fu, fv)``, ``(n + 1,)`` each, ``-1`` = none."""
    return (torch.full((n + 1,), -1, dtype=dtype, device=device),
            torch.full((n + 1,), -1, dtype=dtype, device=device))
