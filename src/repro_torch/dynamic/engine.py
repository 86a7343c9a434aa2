"""Batch-dynamic connectivity engine (single device).

The dynamic state extends the streaming labeling with the two structures
deletions need:

  * a **spanning forest** recorded during inserts (``hook_and_record``,
    paper §3.4 / Theorem 6): one edge per hooked root, stored as the
    *original* endpoints so that a deletion can be matched against them;
  * a fixed-capacity **edge log** with tombstones: every surviving inserted
    edge, so that a forest-hitting deletion can search for a replacement.

Delete semantics per batch:

  1. tombstone every log entry matching a deleted pair (undirected pairs
     against the sorted delete batch: repeated inserts of one pair are all
     removed);
  2. deletions that miss the forest cost only the tombstone;
  3. forest hits mark the affected components, reset their vertices to
     singleton labels and clear their forest slots, then run a **bounded
     replacement search**: ``search_rounds`` forest rounds over the
     surviving affected log edges. If the bound is exhausted, the search
     goes on to convergence through ``uf_sync_forest`` (the fallback
     rebuild).

Labels between updates are fully compressed and every log and forest edge
has both endpoints in one component, so the affected mask is
endpoint-consistent and rebuilding the affected subgraph from singletons
recomputes exactly the post-deletion components.

Within one batch, deletes apply first, then inserts, then queries: a pair
deleted and re-inserted in one batch survives. Whether any forest edge was
hit, and whether the search exhausted its bound, are checked on the host,
as the port's fixpoint loops are; the rounds count as the reference's.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..core.driver import bucket_size
from ..core.finish import _labels_changed, forest_round, uf_sync_forest
from ..core.primitives import (
    DEFAULT_MAX_ROUNDS,
    INT_MAX,
    full_compress,
    iterate_to_fixpoint,
    num_components,
)
from ..kernels.index import take

__all__ = [
    "DynamicState", "init_dynamic", "default_log_cap", "make_update",
    "sanitize_pairs", "sorted_pairs", "pairs_member", "append_log",
    "affected_mask", "masked_log_edges", "forest_round", "query_state",
    "used_slots", "ncomp_state", "state_from_arrays", "DynamicOps",
    "dynamic_ops", "DynamicSnapshotOps", "dynamic_snapshot_ops",
    "DEFAULT_SEARCH_ROUNDS",
]

DEFAULT_SEARCH_ROUNDS = 4


class DynamicState(NamedTuple):
    """``P`` is the compressed ``(n + 1,)`` labeling (dump row ``n``);
    ``fu``/``fv`` the ``(n + 1,)`` forest slots (original endpoints, ``-1``
    = empty); ``log_u``/``log_v`` the fixed-capacity edge log (free and
    tombstoned slots hold the dump id ``n``)."""

    P: torch.Tensor
    fu: torch.Tensor
    fv: torch.Tensor
    log_u: torch.Tensor
    log_v: torch.Tensor


def default_log_cap(n: int) -> int:
    """Default edge-log capacity: the next power of two >= 4n (>= 1024)."""
    return 1 << max(max(4 * n - 1, 1023).bit_length(), 10)


def init_dynamic(n: int, cap: int, *, device,
                 dtype=torch.int32) -> DynamicState:
    def full(size, value):
        return torch.full((size,), value, dtype=dtype, device=device)

    return DynamicState(
        P=torch.arange(n + 1, dtype=dtype, device=device),
        fu=full(n + 1, -1), fv=full(n + 1, -1),
        log_u=full(cap, n), log_v=full(cap, n))


def state_from_arrays(P, fu, fv, log_u, log_v, *, device) -> DynamicState:
    """A ``DynamicState`` from another package's arrays (e.g. numpy taken
    from the JAX package's state), verbatim, on ``device``."""
    return DynamicState(*(
        torch.from_numpy(np.array(x, dtype=np.int32)).to(device)
        for x in (P, fu, fv, log_u, log_v)))


# ---------------------------------------------------------------------------
# Pair matching: undirected (lo, hi) pairs, sorted batch + binary search.
# Invalid and pad entries never match a real pair (real pairs have
# lo < hi < n; pads normalize to INT_MAX).
# ---------------------------------------------------------------------------

def sanitize_pairs(u, v, n: int):
    """Map out-of-range endpoints and self-loops to the dump pair (n, n)."""
    valid = (u >= 0) & (u < n) & (v >= 0) & (v < n) & (u != v)
    return torch.where(valid, u, n), torch.where(valid, v, n)


def _pair_key(lo, hi) -> torch.Tensor:
    # injective over int32 pairs and increasing in (lo, hi) lexicographic
    # order, so sorting keys sorts pairs
    return lo.long() * (1 << 32) + (hi.long() + (1 << 31))


def sorted_pairs(u, v, n: int):
    """Normalize a delete batch to lexicographically sorted (lo, hi) pairs;
    invalid entries (pads, self-loops) become (INT_MAX, INT_MAX)."""
    lo = torch.minimum(u, v)
    hi = torch.maximum(u, v)
    valid = (lo >= 0) & (hi < n) & (lo != hi)
    lo = torch.where(valid, lo, INT_MAX)
    hi = torch.where(valid, hi, INT_MAX)
    order = torch.sort(_pair_key(lo, hi), stable=True).indices
    return lo[order], hi[order]


def pairs_member(slo, shi, qu, qv) -> torch.Tensor:
    """Membership of the undirected pairs (qu, qv) in the sorted pair set
    (slo, shi): a lower-bound search on the pairs' keys. Sentinel queries
    ((n, n) free log slots, (-1, -1) empty forest slots) never match."""
    keys = _pair_key(slo, shi)
    q = _pair_key(torch.minimum(qu, qv), torch.maximum(qu, qv))
    d = keys.shape[0]
    if d == 0:
        return torch.zeros(q.shape, dtype=torch.bool, device=q.device)
    at = torch.searchsorted(keys, q)
    return (at < d) & (keys[at.clamp_max(d - 1)] == q)


# ---------------------------------------------------------------------------
# Edge-log maintenance.
# ---------------------------------------------------------------------------

def append_log(log_u, log_v, bu, bv, n: int):
    """Append a (sanitized) insert batch into free log slots: batch slot
    ``i`` lands in the i-th free slot. Pad entries (n, n) write the free
    sentinel back, so the caller guarantees capacity for the real prefix
    only."""
    free = log_u >= n
    rank = torch.cumsum(free, 0, dtype=torch.int32) - 1
    b = bu.shape[0]
    take = free & (rank < b)
    src = rank.clamp(0, b - 1).long()
    return (torch.where(take, bu[src], log_u),
            torch.where(take, bv[src], log_v))


def affected_mask(P, fu, hit) -> torch.Tensor:
    """Per-vertex mask of the components owning hit forest edges: one
    scatter at the hit edges' labels and one gather through the compressed
    ``P``. The dump row stays unaffected."""
    n1 = P.shape[0]
    lab = P[fu.clamp(0, n1 - 1).long()]
    tgt = torch.where(hit, lab, n1 - 1).long()
    aff_lab = torch.zeros(n1, dtype=torch.bool, device=P.device)
    aff_lab[tgt] = True
    aff_lab[n1 - 1] = False
    return aff_lab[P.clamp(0, n1 - 1).long()]


def masked_log_edges(log_u, log_v, aff, n: int):
    """Symmetrized surviving log edges of the affected components; every
    other slot points at the dump slot."""
    act = (log_u < n) & aff[log_u.clamp(0, n).long()]
    mu = torch.where(act, log_u, n)
    mv = torch.where(act, log_v, n)
    return torch.cat([mu, mv]), torch.cat([mv, mu])


# ---------------------------------------------------------------------------
# The update.
# ---------------------------------------------------------------------------

def make_update(n: int, *, compress: str = "full",
                search_rounds: int = DEFAULT_SEARCH_ROUNDS,
                max_rounds: int = DEFAULT_MAX_ROUNDS) -> Callable:
    """The mixed-batch update ``(state, du, dv, bu, bv) -> (state,
    rounds)``."""

    def rounds_of(st, s, r, cap):
        return iterate_to_fixpoint(
            lambda t: forest_round(t, s, r, compress=compress), st, cap,
            changed_fn=_labels_changed)

    def update(state: DynamicState, du, dv, bu, bv):
        P, fu, fv, log_u, log_v = state

        # -- delete phase: tombstone, then rebuild only on forest hits ------
        slo, shi = sorted_pairs(du, dv, n)
        dead = pairs_member(slo, shi, log_u, log_v)
        log_u = torch.where(dead, n, log_u)
        log_v = torch.where(dead, n, log_v)
        hit = pairs_member(slo, shi, fu, fv)
        drounds = 0
        if bool(hit.any()):
            aff = affected_mask(P, fu, hit)
            ids = torch.arange(n + 1, dtype=P.dtype, device=P.device)
            st = (torch.where(aff, ids, P), torch.where(aff, -1, fu),
                  torch.where(aff, -1, fv))
            s, r = masked_log_edges(log_u, log_v, aff, n)
            st, drounds = rounds_of(st, s, r, search_rounds)
            if drounds >= search_rounds:  # the bound is exhausted: rebuild
                st, k2 = uf_sync_forest(st[0], s, r, st[1], st[2],
                                        compress=compress,
                                        max_rounds=max_rounds)
                drounds += k2
            P, fu, fv = st

        # -- insert phase: log append + forest hook rounds ------------------
        bu2, bv2 = sanitize_pairs(bu, bv, n)
        log_u, log_v = append_log(log_u, log_v, bu2, bv2, n)
        s = torch.cat([bu2, bv2])
        r = torch.cat([bv2, bu2])
        (P, fu, fv), irounds = rounds_of((P, fu, fv), s, r, max_rounds)
        state = DynamicState(full_compress(P), fu, fv, log_u, log_v)
        return state, drounds + irounds

    return update


def query_state(state: DynamicState, qa, qb) -> torch.Tensor:
    """Connectivity answers against a compressed dynamic state. An id outside
    ``[0, n]`` reads ``P`` as ``streaming.query_batch`` reads it (as the
    JAX package's gather does)."""
    return take(state.P, qa) == take(state.P, qb)


def used_slots(state: DynamicState, n: int) -> torch.Tensor:
    """Live (non-tombstoned) log entries, shape (1,) for shard symmetry."""
    return (state.log_u < n).sum(dtype=torch.int32)[None]


def ncomp_state(state: DynamicState) -> torch.Tensor:
    return num_components(state.P)


class DynamicOps(NamedTuple):
    """The single-device batch-dynamic programs of one (n, variant) pair.
    ``update`` applies one mixed batch: deletes, then inserts, then
    queries."""

    init: Callable         # () -> DynamicState
    update: Callable       # (state, du, dv, u, v, qa, qb) -> (state, ans, k)
    query: Callable        # (state, qa, qb) -> ans
    labels: Callable       # (state) -> (n,) labels
    ncomp: Callable        # (state) -> component count (0-d tensor)
    used: Callable         # (state) -> (edge_shards,) live log entries
    forest: Callable       # (state) -> (fu, fv)
    edge_shards: int       # devices insert/query dispatches split across
    batch_size: Callable   # (k) -> padded insert/query dispatch size
    delete_size: Callable  # (k) -> padded delete dispatch size
    log_cap: int           # edge-log capacity


def dynamic_ops(n: int, *, device, compress: str = "full", log: int = 0,
                search_rounds: int = DEFAULT_SEARCH_ROUNDS) -> DynamicOps:
    cap = log or default_log_cap(n)
    upd = make_update(n, compress=compress, search_rounds=search_rounds)

    def update(state, du, dv, u, v, qa, qb):
        state, rounds = upd(state, du, dv, u, v)
        return state, query_state(state, qa, qb), rounds

    def pow2(k):
        return bucket_size(k, pad="pow2")

    return DynamicOps(
        init=lambda: init_dynamic(n, cap, device=device),
        update=update,
        query=query_state,
        labels=lambda st: st.P[:n],
        ncomp=ncomp_state,
        used=lambda st: used_slots(st, n),
        forest=lambda st: (st.fu, st.fv),
        edge_shards=1,
        batch_size=pow2,
        delete_size=pow2,
        log_cap=cap,
    )


class DynamicSnapshotOps(NamedTuple):
    """Snapshot-epoch programs for dynamic serving (``repro_torch.serve``):
    the state is a whole ``DynamicState`` and the commit applies deletes
    before inserts. ``log_cap`` is how the serve layer tells a dynamic
    bundle from a static one."""

    init: Callable         # () -> DynamicState (one epoch state)
    commit: Callable       # (committed, shadow, du, dv, u, v) -> (state, k)
    query: Callable        # (state, qa, qb) -> ans
    labels: Callable       # (state) -> (n,) labels
    ncomp: Callable        # (state) -> component count (0-d tensor)
    used: Callable         # (state) -> (edge_shards,) live log entries
    edge_shards: int
    batch_size: Callable
    delete_size: Callable
    log_cap: int
    device: torch.device   # where the state lives
    donate: bool           # drop the shadow before the commit allocates


def dynamic_snapshot_ops(n: int, *, device, compress: str = "full",
                         log: int = 0,
                         search_rounds: int = DEFAULT_SEARCH_ROUNDS,
                         donate: bool = False) -> DynamicSnapshotOps:
    cap = log or default_log_cap(n)
    upd = make_update(n, compress=compress, search_rounds=search_rounds)

    def commit(committed, shadow, du, dv, u, v):
        # every op of the update writes out of place: ``committed`` is read,
        # never written, and the dead ``shadow`` is not read
        del shadow
        return upd(committed, du, dv, u, v)

    def pow2(k):
        return bucket_size(k, pad="pow2")

    return DynamicSnapshotOps(
        init=lambda: init_dynamic(n, cap, device=device),
        commit=commit,
        query=query_state,
        labels=lambda st: st.P[:n],
        ncomp=ncomp_state,
        used=lambda st: used_slots(st, n),
        edge_shards=1,
        batch_size=pow2,
        delete_size=pow2,
        log_cap=cap,
        device=torch.device(device),
        donate=bool(donate),
    )
