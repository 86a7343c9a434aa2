"""Parallel batch-incremental connectivity (paper §3.5 / Appendix B.4).

``process_batch_fn`` applies one batch of edge insertions and connectivity
queries: the labeling is the persistent state, and queries are answered
against the post-insertion labeling (inserts linearize before the queries of
their batch).

The labeling is kept *fully compressed* between batches, so a query is two
gathers, and each incoming batch endpoint rewritten to its label (one
``edge_rewrite`` kernel call) is its component's root: the finish method
hooks roots directly instead of re-walking chains.

``stream_ops(n, finish_fn, device=...)`` bundles the single-device programs
behind ``repro_torch.api.Stream``, and ``snapshot_ops`` the double-buffered
epoch programs behind ``repro_torch.serve``.
"""

from __future__ import annotations

import warnings
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..kernels.index import take
from .driver import bucket_size
from .finish import resolve_finish
from .primitives import full_compress, init_labels, num_components, rewrite_edges


class StreamState(NamedTuple):
    P: torch.Tensor  # (n + 1,) compressed labeling


def init_stream(n: int, *, device, dtype=torch.int32) -> StreamState:
    return StreamState(init_labels(n, device=device, dtype=dtype))


def state_from_arrays(P, *, device) -> StreamState:
    """A ``StreamState`` from another package's labels (e.g. numpy taken
    from the JAX package's state), verbatim, on ``device``."""
    return StreamState(torch.from_numpy(np.array(P, dtype=np.int32)).to(device))


def insert_batch_rounds_fn(state: StreamState, batch_u, batch_v,
                           finish_fn: Callable):
    """Apply a batch of edge insertions → (state, finish rounds). The batch
    is symmetrized (min-based finish methods hook along the lower-endpoint
    direction, so both directions must be visible) and its endpoints
    rewritten to their labels. Padded slots must point at the dump id n."""
    u = torch.cat([batch_u, batch_v])
    v = torch.cat([batch_v, batch_u])
    u, v = rewrite_edges(state.P, u, v)
    P, rounds = finish_fn(state.P, u, v)
    return StreamState(full_compress(P)), rounds


def insert_batch_fn(state: StreamState, batch_u, batch_v,
                    finish_fn: Callable) -> StreamState:
    return insert_batch_rounds_fn(state, batch_u, batch_v, finish_fn)[0]


def query_batch(state: StreamState, qa, qb) -> torch.Tensor:
    """IsConnected for each (qa[i], qb[i]) against the compressed labeling.

    Every int32 id answers, as in the JAX package: an id reads ``P`` where
    ``jnp`` indexing reads it, so a negative id counts from the end of the
    ``(n + 1,)`` labeling once, and an id still outside ``[0, n]`` clamps
    into it (``n`` and above read the dump row)."""
    return take(state.P, qa) == take(state.P, qb)


def process_batch_rounds_fn(state: StreamState, batch_u, batch_v, qa, qb,
                            finish_fn: Callable):
    """Inserts then queries (paper Algorithm 3 ProcessBatch) → (state,
    answers, finish rounds)."""
    state, rounds = insert_batch_rounds_fn(state, batch_u, batch_v, finish_fn)
    return state, query_batch(state, qa, qb), rounds


def process_batch_fn(state: StreamState, batch_u, batch_v, qa, qb,
                     finish_fn: Callable):
    state, ans, _ = process_batch_rounds_fn(state, batch_u, batch_v, qa, qb,
                                            finish_fn)
    return state, ans


class StreamOps(NamedTuple):
    """The single-device streaming programs of one (n, finish) pair."""

    init: Callable        # () -> state
    insert: Callable      # (state, u, v) -> (state, rounds)
    process: Callable     # (state, u, v, qa, qb) -> (state, ans, rounds)
    query: Callable       # (state, qa, qb) -> ans
    labels: Callable      # (state) -> (n,) labels
    ncomp: Callable       # (state) -> component count (0-d tensor)
    edge_shards: int      # devices a batch dispatch splits across
    batch_size: Callable  # (k) -> padded dispatch size (pow2)


def stream_ops(n: int, finish_fn: Callable, *, device) -> StreamOps:
    return StreamOps(
        init=lambda: init_stream(n, device=device),
        insert=lambda st, u, v: insert_batch_rounds_fn(st, u, v, finish_fn),
        process=lambda st, u, v, qa, qb: process_batch_rounds_fn(
            st, u, v, qa, qb, finish_fn),
        query=query_batch,
        labels=lambda st: st.P[:n],
        ncomp=lambda st: num_components(st.P),
        edge_shards=1,
        batch_size=lambda k: bucket_size(k, pad="pow2"),
    )


# ---------------------------------------------------------------------------
# Snapshot plumbing (repro_torch.serve): double-buffered epochs.
#
# The serving layer keeps two label buffers per served vertex space: the
# *committed* snapshot, which every query gathers against, and the *shadow*,
# the previous epoch's labels, which no query can reach any more. A commit
# computes the next epoch's labels from the committed snapshot. Every op on
# the path writes out of place, so the committed buffer is never written
# and a query racing a commit reads a stable snapshot. Donation is the
# caching allocator's: with ``donate`` the store drops its reference to the
# shadow before the commit allocates, so the shadow's block is free for the
# commit's own buffers (serve/snapshot.py).
# ---------------------------------------------------------------------------


def snapshot_query(P: torch.Tensor, qa, qb) -> torch.Tensor:
    """IsConnected against a raw compressed label buffer (the snapshot
    read), as ``query_batch`` answers it."""
    return query_batch(StreamState(P), qa, qb)


def make_snapshot_commit(finish_fn: Callable) -> Callable:
    """The snapshot commit ``(committed, shadow, u, v) -> (labels,
    rounds)``. ``committed`` is read, never written; ``shadow`` is dead
    state and is not read (the store passes ``None`` under donation)."""

    def commit(committed, shadow, u, v):
        del shadow
        state, rounds = insert_batch_rounds_fn(StreamState(committed), u, v,
                                               finish_fn)
        return state.P, rounds

    return commit


class SnapshotOps(NamedTuple):
    """The single-device snapshot-epoch programs of one (n, finish) pair,
    behind ``repro_torch.serve``. The state is a raw ``(n + 1,)`` label
    buffer."""

    init: Callable        # () -> labels (one epoch buffer)
    commit: Callable      # (committed, shadow, u, v) -> (labels, rounds)
    query: Callable       # (labels, qa, qb) -> ans
    labels: Callable      # (labels) -> (n,) real-vertex labels
    ncomp: Callable       # (labels) -> component count (0-d tensor)
    edge_shards: int      # devices a batch dispatch splits across
    batch_size: Callable  # (k) -> padded dispatch size (pow2)
    device: torch.device  # where the buffers live
    donate: bool          # drop the shadow before the commit allocates


def snapshot_ops(n: int, finish_fn: Callable, *, device,
                 donate: bool = False) -> SnapshotOps:
    return SnapshotOps(
        init=lambda: init_labels(n, device=device),
        commit=make_snapshot_commit(finish_fn),
        query=snapshot_query,
        labels=lambda P: P[:n],
        ncomp=lambda P: num_components(P[: n + 1]),
        edge_shards=1,
        batch_size=lambda k: bucket_size(k, pad="pow2"),
        device=torch.device(device),
        donate=bool(donate),
    )


# ---------------------------------------------------------------------------
# Legacy string-keyed entrypoints (deprecation shims).
# ---------------------------------------------------------------------------

_DEPRECATION = ("%s with flat string finish keys is deprecated; use "
                "repro_torch.api.ConnectIt(spec).stream(n) or the *_fn "
                "variants with a resolved finish callable")


def insert_batch(state: StreamState, batch_u, batch_v,
                 finish: str = "uf_sync_full") -> StreamState:
    """Deprecated: use ``insert_batch_fn`` / ``repro_torch.api`` stream
    handles."""
    warnings.warn(_DEPRECATION % "insert_batch(..., finish=...)",
                  DeprecationWarning, stacklevel=2)
    return insert_batch_fn(state, batch_u, batch_v, resolve_finish(finish))


def process_batch(state: StreamState, batch_u, batch_v, qa, qb,
                  finish: str = "uf_sync_full"):
    """Deprecated: use ``process_batch_fn`` / ``repro_torch.api`` stream
    handles."""
    warnings.warn(_DEPRECATION % "process_batch(..., finish=...)",
                  DeprecationWarning, stacklevel=2)
    return process_batch_fn(state, batch_u, batch_v, qa, qb,
                            resolve_finish(finish))
