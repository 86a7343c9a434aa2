"""Mesh programs for distributed connectivity, on ``torch.distributed``.

The JAX package's programs (``repro/core/distributed.py``) run under
``shard_map``: one controller dispatches one program to every device. Here
every rank runs the same call on the same inputs and the ranks meet in the
collectives of ``core/collectives.py``. A program takes this rank's blocks,
as a ``shard_map`` body does: its edge block of the padded edge arrays, and
its labels (all ``n + 1`` under the replicated placement, its window of the
label axis under the sharded one). Two placements, each parameterized by a
finish callable of the variant space:

  * **replicated labels**: edges split over every mesh axis, labels whole on
    every rank. Per outer round each rank runs the finish to its local
    fixpoint on its edge block, then the labelings are merged with an
    elementwise min over the edge axes.

  * **sharded labels**: labels split over one axis (and replicated over the
    others), edges over the edge axes. Per outer round: gather the labels
    along the label axis → local finish → min-merge back into the windows.
    The merge is *frontier compacted* by default: each rank exchanges only
    the (index, value) pairs its finish lowered this round
    (``ops.compact_mask`` into fixed-cap buffers), gated on the
    mesh-reduced frontier count; rounds whose frontier exceeds the cap take
    the dense merge: a full min-reduce and a slice, or with
    ``reduce_scatter`` an all_to_all and a local min. With ``overlap`` the
    edge block splits in two halves that alternate per round, and round
    r's frontier exchange is applied at the top of round r + 1.

Each outer loop runs on the host. Every branch it takes is decided by a
value that is the same on every rank (merged labels, or a count reduced
over the mesh), so all ranks enter the same collectives in the same order;
the round counts are the reference's. The local finish runs its own
host-checked fixpoint, which calls no collective.

The AMSF bucket sweep and the batch-dynamic update record forest edges, one
per hooked root, so their hook round is merged every round
(``_global_forest_round``): the hook values, the winning global edge ids and
the winners' endpoints are each ``pmin``-merged over the edge axes before
any rank applies them, and the labels and forest buffers stay whole and
equal on every rank.
"""

from __future__ import annotations

import warnings
from typing import Callable, NamedTuple, Optional, Sequence

import torch

from ..dynamic import engine
from ..graphs.containers import round_up
from ..kernels import ops
from ..kernels.index import take
from . import collectives as coll
from .apps.amsf import _skip_lmax_mask
from .finish import _compress, _labels_changed
from .primitives import INT_MAX, full_compress, iterate_to_fixpoint, parents_of

# Fixpoint cap floor of the outer merge loop (rounds=0): label information
# crosses at least one shard boundary per outer round, so the cap is the
# edge-shard count plus slack, and never below this floor.
DEFAULT_OUTER_ROUNDS = 256


def _fixpoint_cap(mesh, edge_axes: Sequence[str],
                  max_rounds: Optional[int]) -> int:
    if max_rounds is not None:
        return max_rounds
    return max(DEFAULT_OUTER_ROUNDS, 2 * coll.mesh_size(mesh, edge_axes) + 8)


def _outer_loop(body, labels, rounds: int, max_rounds: int):
    """``body: labels -> labels`` for ``rounds`` fixed rounds, or to its
    fixpoint (``rounds=0``) capped at ``max_rounds`` → (labels, rounds).
    The labels carried are merged, so the same on every rank, and so is the
    host compare that ends the loop."""
    if rounds > 0:
        for _ in range(rounds):
            labels = body(labels)
        return labels, rounds
    return iterate_to_fixpoint(
        body, labels, max_rounds,
        changed_fn=lambda old, new: not torch.equal(old, new))


def _outer_loop_flagged(body, labels, rounds: int, cap: int):
    """``_outer_loop`` for a body that reports its own mesh-uniform continue
    flag, ``body: labels -> (labels, go)``: no compare of old and new."""
    if rounds > 0:
        for _ in range(rounds):
            labels = body(labels)[0]
        return labels, rounds
    go, k = True, 0
    while go and k < cap:
        labels, go = body(labels)
        k += 1
    return labels, k


def _mirror(s, r):
    return torch.cat([s, r]), torch.cat([r, s])


# ---------------------------------------------------------------------------
# Replicated labels.
# ---------------------------------------------------------------------------

def make_replicated_finish(mesh, axes: Sequence[str], finish_fn: Callable, *,
                           rounds: int = 0, max_rounds: Optional[int] = None,
                           symmetrize: bool = False):
    """Distributed finish with the labels whole on every rank and the edges
    split over ``axes`` → ``program(labels, s, r) -> (labels, rounds)`` on
    ``(n + 1,)`` labels and this rank's dump-padded edge block.

    ``symmetrize`` mirrors the block in place (stream batches carry one
    direction per edge; min-based hooks need both), keeping (u, v) and
    (v, u) on the same rank."""
    axes = tuple(axes)
    cap = _fixpoint_cap(mesh, axes, max_rounds)

    def program(labels, s, r):
        if symmetrize:
            s, r = _mirror(s, r)

        def body(L):
            L2, _ = finish_fn(L, s, r)
            return coll.pmin(L2, mesh, axes)

        return _outer_loop(body, labels, rounds, cap)

    return program


# ---------------------------------------------------------------------------
# Sharded labels.
# ---------------------------------------------------------------------------

def _auto_frontier(n1: int, ngather: int) -> int:
    """Auto per-rank frontier cap: the compacted exchange moves
    ``2 * ngather * F`` int32 per round against the dense merge's
    ``n1``-wide reduce, so the cap sits near ``n1 / (4 * ngather)``, rounded
    up to 128."""
    return min(n1, max(128, round_up(max(n1 // (4 * ngather), 1), 128)))


def make_sharded_finish(mesh, edge_axes: Sequence[str], label_axis: str,
                        finish_fn: Callable, *, reduce_scatter: bool = False,
                        rounds: int = 0, max_rounds: Optional[int] = None,
                        symmetrize: bool = False, frontier: int = -1,
                        overlap: bool = False):
    """Distributed finish with the labels split over ``label_axis`` →
    ``program(window, s, r) -> (window, rounds)``.

    The label array's length must divide by the label axis's size (the
    backend pads it with self-rooted slots above the dump row). On a 1-D
    mesh ``edge_axes`` may be ``(label_axis,)``; on a 2-D mesh the label
    axis may be one of the edge axes, and labels are replicated over the
    rest. ``frontier`` caps the compacted exchange per rank (-1 auto, 0
    dense only, N explicit). ``overlap`` runs the two-block pipeline, whose
    deferred exchange is sound because every finish is monotone: a finish
    on stale labels proposes only valid, possibly larger, labels, and the
    late exchange can only lower them. It stops after two consecutive
    clean rounds (both blocks checked on settled labels with no exchange
    in flight)."""
    edge_axes = tuple(edge_axes)
    extra_axes = tuple(a for a in edge_axes if a != label_axis)
    merge_axes = tuple(dict.fromkeys(edge_axes + (label_axis,)))
    nshards = coll.axis_size(mesh, label_axis)
    ngather = coll.mesh_size(mesh, merge_axes)
    # the continue flag reduces over every mesh axis, so that the host
    # branch is the same on every rank even on meshes with unused axes
    flag_axes = tuple(mesh.mesh_dim_names)
    cap = _fixpoint_cap(mesh, edge_axes, max_rounds)

    def gmax_of(diff) -> int:
        cnt = diff.sum(dtype=torch.int32).reshape(1)
        return int(coll.pmax(cnt, mesh, flag_axes))  # the round's host wait

    def window(full, shard_len):
        lo = coll.axis_index(mesh, label_axis) * shard_len
        return full[lo: lo + shard_len]

    def dense_candidate(full2, shard_len):
        """The dense merge: this window of the candidates, min-reduced."""
        if reduce_scatter:
            # min-reduce-scatter: all_to_all over the label chunks and a
            # local min move 1/|label axis| of a full reduce's bytes
            chunks = full2.reshape(nshards, shard_len)
            mine = coll.all_to_all(chunks, mesh, label_axis).amin(0)
            if extra_axes:
                mine = coll.pmin(mine, mesh, extra_axes)
            return mine
        return window(coll.pmin(full2, mesh, merge_axes), shard_len)

    def gather_frontier(fi, fv):
        return (coll.all_gather(fi, mesh, merge_axes),
                coll.all_gather(fv, mesh, merge_axes))

    def apply_frontier(shard, fi, fv):
        """Scatter an exchanged frontier into this window. Out-of-window
        targets and the unused ``-1`` slots land on an appended dump slot
        (``ops.scatter_min`` dumps every target outside ``[0, len)``)."""
        shard_len = shard.shape[0]
        offset = coll.axis_index(mesh, label_axis) * shard_len
        pad = torch.cat([shard, shard[-1:]])
        out = ops.scatter_min(pad, fi - offset, fv, fi >= 0)
        return out[:shard_len]

    def resolve_cap(shard_len: int) -> int:
        n1 = shard_len * nshards
        if frontier == 0:
            return 0
        if frontier > 0:
            return min(frontier, n1)
        return _auto_frontier(n1, ngather)

    def program(lab_shard, s, r):
        if symmetrize:
            s, r = _mirror(s, r)
        shard_len = lab_shard.shape[0]
        F = resolve_cap(shard_len)

        def body(shard):
            full = coll.all_gather(shard, mesh, (label_axis,))
            full2, _ = finish_fn(full, s, r)
            diff = full2 < full
            gmax = gmax_of(diff)
            # gmax <= F: no rank overflows its cap; the count is reduced
            # over the mesh, so every rank takes the same branch
            if 0 < F and gmax <= F:
                fi, fv = ops.compact_mask(diff, full2, F)
                shard2 = apply_frontier(shard, *gather_frontier(fi, fv))
            else:
                shard2 = torch.minimum(shard,
                                       dense_candidate(full2, shard_len))
            # gmax == 0 ⟺ no rank's finish lowered a label ⟺ every edge is
            # satisfied: the fixpoint flag comes free from the merge
            return shard2, gmax > 0

        return _outer_loop_flagged(body, lab_shard, rounds, cap)

    def program_overlap(lab_shard, s, r):
        shard_len = lab_shard.shape[0]
        F = resolve_cap(shard_len)
        m = s.shape[0]
        if m >= 2:
            blocks = ((s[: m // 2], r[: m // 2]), (s[m // 2:], r[m // 2:]))
        else:
            blocks = ((s, r), (s, r))
        if symmetrize:  # mirror per block: each block sees both directions
            blocks = tuple(_mirror(bs, br) for bs, br in blocks)
        empty_i = torch.full((ngather * F,), -1, dtype=torch.int32,
                             device=lab_shard.device)
        empty_v = torch.full((ngather * F,), INT_MAX, dtype=lab_shard.dtype,
                             device=lab_shard.device)

        def step(shard, pi, pv, pend, k):
            full = coll.all_gather(shard, mesh, (label_axis,))
            # the round's block reads the stale labels: it does not depend
            # on the exchange still to be applied below
            full2, _ = finish_fn(full, *blocks[k % 2])
            diff = full2 < full
            gmax = gmax_of(diff)
            # consume last round's exchange only now (nothing to apply
            # when none is in flight)
            mine = apply_frontier(shard, pi, pv) if pend else shard
            own = torch.minimum(mine, window(full2, shard_len))
            if 0 < F and gmax <= F:
                fi, fv = ops.compact_mask(diff, full2, F)
                pi2, pv2 = gather_frontier(fi, fv)
                # the gathered buffers hold an index >= 0 iff some rank's
                # count was positive: ``pend`` needs no read of them
                shard2, pend2 = own, gmax > 0
            else:
                shard2 = torch.minimum(own, dense_candidate(full2, shard_len))
                pi2, pv2, pend2 = empty_i, empty_v, False
            # clean ⟺ this block found nothing on settled labels and no
            # exchange was in flight; two clean rounds in a row cover both
            # blocks ⇒ the global fixpoint
            return shard2, pi2, pv2, pend2, (gmax == 0) and not pend

        shard, pi, pv, pend = lab_shard, empty_i, empty_v, False
        streak, k = 0, 0
        while (k < rounds) if rounds > 0 else (streak < 2 and k < cap):
            shard, pi, pv, pend, clean = step(shard, pi, pv, pend, k)
            streak = streak + 1 if clean else 0
            k += 1
        if pend:  # drain the trailing in-flight exchange
            shard = apply_frontier(shard, pi, pv)
        return shard, k

    return program_overlap if overlap else program


def make_sharded_compress(mesh, label_axis: str):
    """Full pointer-jump compression of a label-sharded array (one
    gather)."""

    def compress(lab_shard):
        shard_len = lab_shard.shape[0]
        full = full_compress(coll.all_gather(lab_shard, mesh, (label_axis,)))
        lo = coll.axis_index(mesh, label_axis) * shard_len
        return full[lo: lo + shard_len].clone()

    return compress


# ---------------------------------------------------------------------------
# Streams (paper §3.5 / Algorithm 3 on a mesh).
# ---------------------------------------------------------------------------

class StreamPrograms(NamedTuple):
    """Mesh programs behind ``repro_torch.api.Stream`` on a placement. The
    insert takes this rank's block of the batch; the query takes the whole
    query batch and answers it whole on every rank."""

    insert: Callable   # (labels, u, v) -> (labels, rounds)
    query: Callable    # (labels, qa, qb) -> bool[q]
    process: Callable  # (labels, u, v, qa, qb) -> (labels, ans, rounds)


def _stream_programs(run, compress, full_labels) -> StreamPrograms:
    def insert(labels, u, v):
        labels, k = run(labels, u, v)
        # keep the labeling fully compressed between batches (O(1) queries)
        return compress(labels), k

    def query(labels, qa, qb):
        # ids read the labels as the reference's gathers read them
        full = full_labels(labels)
        return take(full, qa) == take(full, qb)

    def process(labels, u, v, qa, qb):
        labels, k = insert(labels, u, v)
        return labels, query(labels, qa, qb), k

    return StreamPrograms(insert, query, process)


def make_replicated_stream(mesh, axes: Sequence[str], finish_fn: Callable, *,
                           rounds: int = 0, max_rounds: Optional[int] = None
                           ) -> StreamPrograms:
    """Batch insert+query with the labels replicated."""
    run = make_replicated_finish(mesh, axes, finish_fn, rounds=rounds,
                                 max_rounds=max_rounds, symmetrize=True)
    return _stream_programs(run, full_compress, lambda labels: labels)


def make_sharded_stream(mesh, edge_axes: Sequence[str], label_axis: str,
                        finish_fn: Callable, *, reduce_scatter: bool = False,
                        rounds: int = 0, max_rounds: Optional[int] = None,
                        frontier: int = -1, overlap: bool = False
                        ) -> StreamPrograms:
    """Batch insert+query with the labels sharded over ``label_axis``."""
    run = make_sharded_finish(mesh, edge_axes, label_axis, finish_fn,
                              reduce_scatter=reduce_scatter, rounds=rounds,
                              max_rounds=max_rounds, symmetrize=True,
                              frontier=frontier, overlap=overlap)
    return _stream_programs(
        run, make_sharded_compress(mesh, label_axis),
        lambda shard: coll.all_gather(shard, mesh, (label_axis,)))


# ---------------------------------------------------------------------------
# The AMSF bucket forest (paper §5) on a mesh.
#
# Forest recording across ranks needs one deterministic winner per hooked
# root (Theorem 6), so every forest hook round is merged: each rank proposes
# its local min-hooks, the winning (value, global edge id, endpoints) buffers
# are pmin-merged over the edge axes, and only then does every rank apply
# the hooks and record the one global winner.
# ---------------------------------------------------------------------------

def _global_forest_round(P, fu, fv, s, r, gid, active, mesh, axes, *,
                         compress: str = "full"):
    """One merged forest hook round (and its compression) on this rank's
    edge block → ``(P, fu, fv, changed)``.

    ``gid`` is the global edge id of each local slot. ``P``, ``fu`` and
    ``fv`` are whole and equal on every rank. Pass 1 (the hook value) alone
    decides whether any root hooks: its merged buffer is the same on every
    rank, so the host reads it with no further collective, and a round that
    hooks nothing skips the edge-id and endpoint passes."""
    n1 = P.shape[0]
    pu = P[s]  # int32 indices: no int64 copy of the edge block
    pv = P[r]
    act = active & (pu != pv)
    root_u = parents_of(P, pu) == pu
    mask = act & root_u & (pv < pu)

    def big(size):
        return torch.full((size,), INT_MAX, dtype=torch.int32,
                          device=P.device)

    # pass 1: the winning hook value of each root, merged over the ranks
    vbuf = coll.pmin(ops.scatter_min(big(n1), pu, pv, mask), mesh, axes)
    hooked = bool((vbuf < INT_MAX).any())  # the round's host wait
    if hooked:
        # pass 2: the winning global edge id among the value's achievers
        safe_pu = pu.clamp(0, n1 - 1).long()
        achieve = mask & (pv == vbuf[safe_pu])
        ebuf = coll.pmin(ops.scatter_min(big(n1), pu, gid, achieve), mesh,
                         axes)
        # pass 3: the one winning rank publishes both endpoints through one
        # stacked (2·n1 + 1,) buffer: targets pu and pu + n1, slot 2·n1
        # takes the masked entries
        mine = achieve & (gid == ebuf[safe_pu])
        uw = ops.scatter_min(big(2 * n1 + 1), torch.cat([pu, pu + n1]),
                             torch.cat([s, r]), torch.cat([mine, mine]))
        uw = coll.pmin(uw[: 2 * n1], mesh, axes)
        # apply: hook the roots, record first-time hooks
        sel = (ebuf < INT_MAX) & (fu == -1)
        fu = torch.where(sel, uw[:n1], fu)
        fv = torch.where(sel, uw[n1:], fv)
        P2 = _compress(torch.minimum(P, vbuf), compress)
        return P2, fu, fv, True
    if compress == "full":
        # P stays fully compressed between rounds: no hook is the fixpoint
        return P, fu, fv, False
    # partial compression can unlock hooks on a hook-free round, so it runs,
    # and the changed flag follows P
    P2 = _compress(P, compress)
    return P2, fu, fv, not torch.equal(P2, P)


def _shard_gid(mesh, axes: Sequence[str], m_local: int, device):
    """Global int32 edge ids of this rank's slots, in the block order of
    ``coll.shard_index``."""
    base = coll.shard_index(mesh, axes) * m_local
    return torch.arange(base, base + m_local, dtype=torch.int32,
                        device=device)


def _bucket_sweep(P, fu, fv, s, r, bids, gid, mesh, axes, *, compress: str,
                  skip: bool, cap: int):
    """The bucket sweep on whole labels → ``(P, fu, fv, buckets,
    rounds)``. Each bucket runs merged forest rounds until one changes
    nothing (that round counts), at most ``cap``."""
    local = torch.where(bids < INT_MAX, bids, -1)
    bmax_local = (local.max() if local.numel() else
                  torch.tensor(-1, dtype=torch.int32, device=P.device))
    bmax = int(coll.pmax(bmax_local.reshape(1).to(torch.int32), mesh,
                         axes))
    tot = 0
    for b in range(bmax + 1):
        active = bids == b
        if skip:
            active &= _skip_lmax_mask(P, s, r)
        go, k = True, 0
        while go and k < cap:
            P, fu, fv, go = _global_forest_round(
                P, fu, fv, s, r, gid, active, mesh, axes, compress=compress)
            k += 1
        tot += k
    return P, fu, fv, bmax + 1, tot


def make_replicated_amsf(mesh, axes: Sequence[str], *, compress: str = "full",
                         skip: bool = False,
                         max_rounds: Optional[int] = None):
    """The AMSF bucket sweep with the edges and their bucket ids split over
    ``axes`` and the labels and forest buffers whole on every rank →
    ``program(P, fu, fv, s, r, bids) -> (P, fu, fv, buckets, rounds)`` on
    this rank's edge blocks."""
    axes = tuple(axes)
    cap = _fixpoint_cap(mesh, axes, max_rounds)

    def program(labels, fu, fv, s, r, bids):
        gid = _shard_gid(mesh, axes, s.shape[0], labels.device)
        return _bucket_sweep(labels, fu, fv, s, r, bids, gid, mesh, axes,
                             compress=compress, skip=skip, cap=cap)

    return program


def make_sharded_amsf(mesh, edge_axes: Sequence[str], label_axis: str, *,
                      compress: str = "full", skip: bool = False,
                      max_rounds: Optional[int] = None):
    """The AMSF bucket sweep with the labels split over ``label_axis``: the
    window is gathered once, the sweep runs on the whole array with merges
    over the edge axes, and the rank takes its window back at the end. The
    forest buffers are whole on every rank."""
    edge_axes = tuple(edge_axes)
    cap = _fixpoint_cap(mesh, edge_axes, max_rounds)

    def program(lab_shard, fu, fv, s, r, bids):
        shard_len = lab_shard.shape[0]
        labels = coll.all_gather(lab_shard, mesh, (label_axis,))
        gid = _shard_gid(mesh, edge_axes, s.shape[0], labels.device)
        labels, fu, fv, b, tot = _bucket_sweep(
            labels, fu, fv, s, r, bids, gid, mesh, edge_axes,
            compress=compress, skip=skip, cap=cap)
        lo = coll.axis_index(mesh, label_axis) * shard_len
        return labels[lo: lo + shard_len].clone(), fu, fv, b, tot

    return program


# ---------------------------------------------------------------------------
# Batch-dynamic programs (``repro_torch.dynamic`` on a mesh).
#
# The delete and rebuild steps are the engine's; the forest hook round is
# the merged ``_global_forest_round``. The labels and forest buffers are
# whole and equal on every rank after each merge; the edge log is split
# like insert batches (each rank appends its own block); delete batches are
# whole on every rank, so each rank tombstones its own log slots and every
# rank finds the same forest hits with no collective.
# ---------------------------------------------------------------------------

class DynamicPrograms(NamedTuple):
    """Mesh programs behind ``repro_torch.api.DynamicStream`` on a
    placement. ``update`` takes the whole delete batch and this rank's block
    of the insert batch and log; ``query`` answers a whole query batch;
    ``used`` is the ``(edge_shards,)`` live log entries, on every rank."""

    update: Callable  # (P, fu, fv, log_u, log_v, du, dv, bu, bv) -> (...)
    query: Callable   # (labels, qa, qb) -> bool[q]
    used: Callable    # (log_u) -> (edge_shards,) live log entries


def _dynamic_body(labels, fu, fv, log_u, log_v, du, dv, bu, bv, *, n: int,
                  mesh, axes: Sequence[str], compress: str,
                  search_rounds: int, cap: int):
    """A mixed-batch update on whole labels: ``engine.make_update`` with its
    hook round swapped for the merged forest round. The host branches read
    the forest (whole and equal on every rank) and round counts, so every
    rank takes them alike."""
    dev = labels.device

    def round_(st, s, r, gid):
        P2, fu2, fv2, _ = _global_forest_round(
            st[0], st[1], st[2], s, r, gid, s < n, mesh, axes,
            compress=compress)
        return P2, fu2, fv2

    def fixpoint(st, s, r, gid, bound):
        return iterate_to_fixpoint(lambda t: round_(t, s, r, gid), st, bound,
                                   changed_fn=_labels_changed)

    # -- delete phase: tombstone, then rebuild only on forest hits ----------
    slo, shi = engine.sorted_pairs(du, dv, n)
    dead = engine.pairs_member(slo, shi, log_u, log_v)
    log_u = torch.where(dead, n, log_u)
    log_v = torch.where(dead, n, log_v)
    hit = engine.pairs_member(slo, shi, fu, fv)
    drounds = 0
    if bool(hit.any()):
        aff = engine.affected_mask(labels, fu, hit)
        ids = torch.arange(n + 1, dtype=labels.dtype, device=dev)
        st = (torch.where(aff, ids, labels), torch.where(aff, -1, fu),
              torch.where(aff, -1, fv))
        s, r = engine.masked_log_edges(log_u, log_v, aff, n)
        gid = _shard_gid(mesh, axes, s.shape[0], dev)
        st, drounds = fixpoint(st, s, r, gid, search_rounds)
        if drounds >= search_rounds:  # the bound is exhausted: go on
            st, k2 = fixpoint(st, s, r, gid, cap)
            drounds += k2
        labels, fu, fv = st

    # -- insert phase: log append, then merged forest rounds ----------------
    bu2, bv2 = engine.sanitize_pairs(bu, bv, n)
    log_u, log_v = engine.append_log(log_u, log_v, bu2, bv2, n)
    s = torch.cat([bu2, bv2])
    r = torch.cat([bv2, bu2])
    gid = _shard_gid(mesh, axes, s.shape[0], dev)
    (labels, fu, fv), irounds = fixpoint((labels, fu, fv), s, r, gid, cap)
    return (full_compress(labels), fu, fv, log_u, log_v,
            drounds + irounds)


def _dynamic_used(mesh, axes: Sequence[str], n: int):
    def used(log_u):
        local = (log_u < n).sum(dtype=torch.int32).reshape(1)
        # gather the last axis first: the result is in shard_index order
        return coll.all_gather(local, mesh, tuple(reversed(axes)))

    return used


def make_replicated_dynamic(mesh, axes: Sequence[str], n: int, *,
                            compress: str = "full", search_rounds: int = 4,
                            max_rounds: Optional[int] = None
                            ) -> DynamicPrograms:
    """Batch-dynamic programs with the labels and forest whole on every
    rank, the edge log and insert batches split over ``axes`` and delete
    batches whole."""
    axes = tuple(axes)
    cap = _fixpoint_cap(mesh, axes, max_rounds)

    def update(labels, fu, fv, log_u, log_v, du, dv, bu, bv):
        return _dynamic_body(labels, fu, fv, log_u, log_v, du, dv, bu, bv,
                             n=n, mesh=mesh, axes=axes, compress=compress,
                             search_rounds=search_rounds, cap=cap)

    def query(labels, qa, qb):
        return take(labels, qa) == take(labels, qb)

    return DynamicPrograms(update, query, _dynamic_used(mesh, axes, n))


def make_sharded_dynamic(mesh, edge_axes: Sequence[str], label_axis: str,
                         n: int, *, compress: str = "full",
                         search_rounds: int = 4,
                         max_rounds: Optional[int] = None
                         ) -> DynamicPrograms:
    """Batch-dynamic programs with the labels split over ``label_axis``: the
    window is gathered once an update, the body runs on the whole array with
    merges over the edge axes, and the rank takes its window back. The
    padded tail above the dump row is cut off before the body and rebuilt
    after: its slots are self-rooted and no edge reaches them."""
    edge_axes = tuple(edge_axes)
    cap = _fixpoint_cap(mesh, edge_axes, max_rounds)

    def full_labels(lab_shard):
        return coll.all_gather(lab_shard, mesh, (label_axis,))

    def update(lab_shard, fu, fv, log_u, log_v, du, dv, bu, bv):
        shard_len = lab_shard.shape[0]
        full = full_labels(lab_shard)
        length = full.shape[0]
        labels, fu, fv, log_u, log_v, rounds = _dynamic_body(
            full[: n + 1], fu, fv, log_u, log_v, du, dv, bu, bv, n=n,
            mesh=mesh, axes=edge_axes, compress=compress,
            search_rounds=search_rounds, cap=cap)
        if length > n + 1:
            tail = torch.arange(n + 1, length, dtype=labels.dtype,
                                device=labels.device)
            labels = torch.cat([labels, tail])
        lo = coll.axis_index(mesh, label_axis) * shard_len
        return (labels[lo: lo + shard_len].clone(), fu, fv, log_u, log_v,
                rounds)

    def query(lab_shard, qa, qb):
        full = full_labels(lab_shard)
        return take(full, qa) == take(full, qb)

    return DynamicPrograms(update, query, _dynamic_used(mesh, edge_axes, n))


# ---------------------------------------------------------------------------
# Legacy factories (deprecation shims; the reference's pre-ExecutionSpec
# programs, round for round).
#
# These hardwire ``jumps`` pointer-jump hops a round, run a fixed number of
# rounds, and share no stats with the session layer. Like every program
# above, each takes this rank's blocks: its edge block, and the whole labels
# (replicated) or its window of the label axis (sharded). The proposals go
# through ``ops.scatter_min`` and the ``P[P]`` hops through
# ``ops.pointer_jump``; the fused round's hops gather through the
# round-start labels (``take``), as the reference's do.
# New code builds a ``repro_torch.api.ExecutionSpec`` (or uses
# ``repro_torch.core.execution.make_backend``).
# ---------------------------------------------------------------------------

_DEPRECATION = (
    "%s is deprecated; declare the placement with "
    "repro_torch.api.ExecutionSpec (e.g. ConnectIt(spec, "
    "exec='replicated(x)')) or build programs via "
    "repro_torch.core.execution.make_backend")


def _warn_legacy(name: str) -> None:
    warnings.warn(_DEPRECATION % name, DeprecationWarning, stacklevel=3)


def _local_proposals(labels, s, r):
    """Scatter-min proposals of sender labels into receiver slots (and the
    reverse) on a buffer of the dtype's max."""
    buf = torch.full_like(labels, torch.iinfo(labels.dtype).max)
    buf = ops.scatter_min(buf, r, take(labels, s))
    return ops.scatter_min(buf, s, take(labels, r))


def _jump_min(labels):
    """One ``labels = min(labels, labels[labels])`` hop."""
    return torch.minimum(labels, ops.pointer_jump(labels, k=1))


def make_replicated_step(mesh, axes: Sequence[str], *, jumps: int = 2,
                         _warn: bool = True):
    """Deprecated: one fixed pointer-jump round; see
    ``make_replicated_finish``."""
    if _warn:
        _warn_legacy("make_replicated_step")
    axes = tuple(axes)

    def step(labels, s, r):
        prop = coll.pmin(_local_proposals(labels, s, r), mesh, axes)
        labels = torch.minimum(labels, prop)
        for _ in range(jumps):
            labels = _jump_min(labels)
        return labels

    return step


def _fixed_rounds(step, rounds: int):
    def run(labels, senders, receivers):
        for _ in range(rounds):
            labels = step(labels, senders, receivers)
        return labels

    return run


def make_replicated_connectivity(mesh, axes: Sequence[str], *, rounds: int,
                                 jumps: int = 2):
    """Deprecated: fixed-round replicated connectivity."""
    _warn_legacy("make_replicated_connectivity")
    return _fixed_rounds(
        make_replicated_step(mesh, axes, jumps=jumps, _warn=False), rounds)


def make_sharded_step(mesh, edge_axes: Sequence[str], label_axis: str, *,
                      jumps: int = 2, use_reduce_scatter: bool = False,
                      _warn: bool = True):
    """Deprecated: one sharded-label pointer-jump round."""
    if _warn:
        _warn_legacy("make_sharded_step")
    edge_axes = tuple(edge_axes)
    merge_axes = tuple(dict.fromkeys(edge_axes + (label_axis,)))
    nshards = coll.axis_size(mesh, label_axis)

    def window(full, shard_len):
        lo = coll.axis_index(mesh, label_axis) * shard_len
        return full[lo: lo + shard_len]

    def step(labels_shard, s, r):
        shard_len = labels_shard.shape[0]
        labels = coll.all_gather(labels_shard, mesh, (label_axis,))
        prop = _local_proposals(labels, s, r)
        if use_reduce_scatter:
            chunks = prop.reshape(nshards, shard_len)
            prop_local = coll.all_to_all(chunks, mesh, label_axis).amin(0)
            prop_local = coll.pmin(prop_local, mesh, edge_axes)
        else:
            prop_local = window(coll.pmin(prop, mesh, merge_axes), shard_len)
        new_shard = torch.minimum(labels_shard, prop_local)
        full = coll.all_gather(new_shard, mesh, (label_axis,))
        for _ in range(jumps):
            full = _jump_min(full)
        return window(full, shard_len).clone()

    return step


def make_sharded_connectivity(mesh, edge_axes: Sequence[str],
                              label_axis: str, *, rounds: int, jumps: int = 2,
                              use_reduce_scatter: bool = False):
    """Deprecated: fixed-round sharded connectivity."""
    _warn_legacy("make_sharded_connectivity")
    return _fixed_rounds(
        make_sharded_step(mesh, edge_axes, label_axis, jumps=jumps,
                          use_reduce_scatter=use_reduce_scatter,
                          _warn=False), rounds)


def make_sharded_step_fused(mesh, edge_axes: Sequence[str], label_axis: str,
                            *, jumps: int = 2, _warn: bool = True):
    """Deprecated: single-gather sharded round (use ExecutionSpec
    ``:fused``). Its hops read the round-start labels."""
    if _warn:
        _warn_legacy("make_sharded_step_fused")
    edge_axes = tuple(edge_axes)
    nshards = coll.axis_size(mesh, label_axis)

    def step(labels_shard, s, r):
        shard_len = labels_shard.shape[0]
        labels = coll.all_gather(labels_shard, mesh, (label_axis,))
        jumped = torch.minimum(labels, _local_proposals(labels, s, r))
        for _ in range(jumps):
            jumped = torch.minimum(jumped, take(labels, jumped))
        chunks = jumped.reshape(nshards, shard_len)
        prop_local = coll.all_to_all(chunks, mesh, label_axis).amin(0)
        prop_local = coll.pmin(prop_local, mesh, edge_axes)
        return torch.minimum(labels_shard, prop_local)

    return step


def make_sharded_connectivity_fused(mesh, edge_axes: Sequence[str],
                                    label_axis: str, *, rounds: int,
                                    jumps: int = 2):
    """Deprecated: fixed-round fused sharded connectivity."""
    _warn_legacy("make_sharded_connectivity_fused")
    return _fixed_rounds(
        make_sharded_step_fused(mesh, edge_axes, label_axis, jumps=jumps,
                                _warn=False), rounds)


def make_streaming_ingest(mesh, axes: Sequence[str], *, rounds: int = 4,
                          jumps: int = 2):
    """Deprecated: folded into the execution-aware
    ``repro_torch.api.Stream`` (``ConnectIt(spec,
    exec='replicated(...)').stream(n)``). ``ingest(labels, bu, bv, qa, qb)
    -> (labels, answers)`` on this rank's batch and query blocks."""
    _warn_legacy("make_streaming_ingest")
    run = _fixed_rounds(make_replicated_step(mesh, axes, jumps=jumps,
                                             _warn=False), rounds)

    def ingest(labels, bu, bv, qa, qb):
        labels = run(labels, bu, bv)
        return labels, take(labels, qa) == take(labels, qb)

    return ingest
