"""Approximate minimum spanning forest via ConnectIt (paper §5.1).

Folklore algorithm: bucket the edges geometrically by weight, sweep the
buckets in increasing order, and grow a spanning forest of each bucket
against the running labeling. The bucket ids stay on the device; the sweep
is a host loop over ``b = 0 .. bmax`` whose bound is read once (the JAX
package's ``lax.while_loop``). Each bucket is one call of the session's
forest-capable finish (``core.finish.make_forest_finish``), whose rounds
each cost one host compare, as every finish loop of the port does.

``AppSpec`` (core/apps/spec.py) names the paper's variants:

    amsf               AMSF-NF:  every bucket masks the full edge list
    amsf(skip=lmax)    AMSF-NF-S: also skip the running L_max component
    amsf(mode=coo)     AMSF-COO: host-sorted COO, one compacted dispatch
                       per bucket
    msf                exact Borůvka (the GBBS-MSF stand-in baseline)

``repro_torch.api.ConnectIt(variant).amsf(g, w, spec)`` is the entry point.
"""

from __future__ import annotations

import warnings
from typing import Callable

import numpy as np
import torch

from ...graphs.containers import Graph
from ..driver import bucket_size, forest_edges  # noqa: F401  (re-exported)
from ..finish import make_forest_finish
from ..primitives import (
    INT_MAX,
    full_compress,
    init_forest,
    init_labels,
    most_frequent,
    write_min,
)

# size of the per-bucket stats histogram (stats only — the sweep itself is
# uncapped; buckets past the cap fold into the last slot)
STATS_BUCKET_CAP = 64


def bucket_ids(w: torch.Tensor, eps: float) -> torch.Tensor:
    """Geometric weight buckets ``floor(log(w / wmin) / log(1 + eps))`` in
    float32, as the JAX package computes them (``log1p(eps)`` in float32
    too). Non-finite weights (``with_weights``' padding) map to
    ``INT_MAX`` and are never swept."""
    finite = torch.isfinite(w)
    wmin = torch.where(finite, w, float("inf")).min()
    step = torch.log1p(torch.tensor(eps, dtype=w.dtype, device=w.device))
    b = torch.floor(torch.log(torch.clamp_min(w / wmin, 1.0)) / step)
    return torch.where(finite, b.to(torch.int32), INT_MAX)


def bucket_histogram(bids: torch.Tensor) -> torch.Tensor:
    """In-bucket candidate-edge histogram for stats (``STATS_BUCKET_CAP``
    slots, the last one folding the rest; ``INT_MAX`` entries excluded)."""
    cap = STATS_BUCKET_CAP
    # excluded entries count in an extra slot, dropped (a bincount over 65
    # slots, not an atomic add of every edge into 64)
    slot = torch.where(bids < INT_MAX, bids.clamp(0, cap - 1), cap)
    return torch.bincount(slot, minlength=cap + 1)[:cap].to(torch.int32)


def _skip_lmax_mask(P, senders, receivers):
    """AMSF-NF-S: mask out the edges internal to the running L_max
    component (the sampling optimization applied at the app level)."""
    Pc = full_compress(P)
    lmax, cnt = most_frequent(Pc)
    in_lmax = (Pc[senders] == lmax) & (Pc[receivers] == lmax)
    return ~(in_lmax & (cnt > 1))


def amsf_device(P, fu, fv, senders, receivers, weights, *, eps: float,
                skip: bool, forest_fn: Callable):
    """The AMSF bucket sweep → ``(P, fu, fv, buckets, rounds,
    bucket_counts)``. ``bmax`` is the one host read before the sweep;
    ``bucket_counts`` (the in-bucket histogram) stays on the device."""
    n = P.shape[0] - 1
    bids = bucket_ids(weights, eps)
    valid = (bids < INT_MAX) & (senders < n)
    bids = torch.where(valid, bids, INT_MAX)
    bmax = int(torch.where(valid, bids, -1).max()) if bids.numel() else -1
    counts = bucket_histogram(bids)
    tot = 0
    for b in range(bmax + 1):
        # int32 indices: no int64 copy of the edge list
        active = (bids == b) & (P[senders] != P[receivers])
        if skip:
            active &= _skip_lmax_mask(P, senders, receivers)
        s = torch.where(active, senders, n)
        r = torch.where(active, receivers, n)
        st, rounds = forest_fn(P, s, r, fu, fv)
        P, fu, fv = st.P, st.fu, st.fv
        tot += int(rounds)
    return P, fu, fv, bmax + 1, tot, counts


def amsf_coo_run(g: Graph, weights, *, eps: float, forest_fn: Callable):
    """AMSF-COO: a host-side stable sort by bucket and one compacted dispatch
    per bucket, padded to the pow2 buckets of ``driver.bucket_size``.
    Returns ``(P, fu, fv, buckets, rounds, counts, sizes)`` with host ints
    and lists."""
    w = weights[: g.m].cpu().numpy()
    s = g.senders[: g.m].cpu().numpy()
    r = g.receivers[: g.m].cpu().numpy()
    finite = np.isfinite(w)
    s, r, w = s[finite], r[finite], w[finite]
    if w.size:
        b = np.floor(np.log(np.maximum(w / w.min(), 1.0))
                     / np.log1p(eps)).astype(np.int64)
    else:
        b = np.zeros((0,), np.int64)
    # the ids are >= 0: on the narrowest unsigned type that holds them
    # numpy's stable sort is a radix sort (the same order, in linear time)
    narrow = np.min_scalar_type(int(b.max()) if b.size else 0)
    order = np.argsort(b.astype(narrow), kind="stable")
    s, r, b = s[order], r[order], b[order]
    P = init_labels(g.n, device=g.device)
    fu, fv = init_forest(g.n, device=g.device)
    n_buckets = int(b.max()) + 1 if b.size else 0
    bounds = np.searchsorted(b, np.arange(n_buckets + 1))
    counts, sizes, tot = [], [], 0
    for k in range(n_buckets):
        lo, hi = int(bounds[k]), int(bounds[k + 1])
        counts.append(hi - lo)
        if lo == hi:
            continue
        size = bucket_size(hi - lo, pad="pow2")
        sizes.append(size)
        bs = np.full((size,), g.n, np.int32)
        br = np.full((size,), g.n, np.int32)
        bs[: hi - lo] = s[lo:hi]
        br[: hi - lo] = r[lo:hi]
        st, rounds = forest_fn(P, torch.from_numpy(bs).to(g.device),
                               torch.from_numpy(br).to(g.device), fu, fv)
        P, fu, fv = st.P, st.fu, st.fv
        tot += int(rounds)
    return P, fu, fv, n_buckets, tot, counts, sizes


def edge_rank(weights: torch.Tensor, senders: torch.Tensor,
              receivers: torch.Tensor, n: int) -> torch.Tensor:
    """Dense rank of each edge in the strict order of undirected edges
    ``(w, lo, hi)``: both directions of an edge share a rank and distinct
    edges never tie. Two stable sorts on the edges' device, (lo, hi) then
    w, give the lexicographic order; int32 ranks."""
    s, r = senders.long(), receivers.long()
    key = torch.minimum(s, r) * (n + 1) + torch.maximum(s, r)
    del s, r
    by_key = torch.sort(key, stable=True).indices
    order = by_key[torch.sort(weights[by_key], stable=True).indices]
    del by_key
    ks, ws = key[order], weights[order]
    new = torch.ones_like(ks, dtype=torch.bool)
    new[1:] = (ks[1:] != ks[:-1]) | (ws[1:] != ws[:-1])
    rank = torch.empty_like(order, dtype=torch.int32)
    rank[order] = (torch.cumsum(new, 0) - 1).to(torch.int32)
    return rank


def boruvka_msf(g: Graph, weights: torch.Tensor, *, max_rounds: int = 64):
    """Exact MSF (Borůvka): each round, every component hooks along its
    minimum-rank outgoing edge. The GBBS-MSF stand-in baseline for Figure 6.
    Returns the host ``(k, 2)`` int32 forest edges (``lo < hi``, sorted)
    and the labels. Each round costs one host compare."""
    n, m = g.n, g.m_pad
    dev = g.device
    rank = edge_rank(weights, g.senders, g.receivers, n)
    eid = torch.arange(m, dtype=torch.int32, device=dev)
    P = init_labels(n, device=dev)
    in_forest = torch.zeros((m,), dtype=torch.bool, device=dev)
    valid = g.edge_mask & torch.isfinite(weights)
    changed, i = True, 0
    while changed and i < max_rounds:
        ls, lr = P[g.senders], P[g.receivers]
        inter = valid & (ls != lr)
        # min-weight outgoing edge per component: the rank, then the edge id
        rbuf = torch.full((n + 1,), INT_MAX, dtype=torch.int32, device=dev)
        rbuf = write_min(rbuf, ls, rank, inter)
        achieve = inter & (rank == rbuf[ls])
        buf = torch.full((n + 1,), INT_MAX, dtype=torch.int32, device=dev)
        buf = write_min(buf, ls, eid, achieve)
        has = buf[:n] < INT_MAX
        chosen = torch.where(has, buf[:n], 0).clamp_max(m - 1).long()
        # mark the chosen edges; hook each component's root onto the other
        # end's label
        mark = torch.zeros((m + 1,), dtype=torch.bool, device=dev)
        mark[torch.where(has, chosen, m)] = True
        in_forest = in_forest | (mark[:m] & inter)
        tgt = torch.where(has, P[g.senders[chosen]], n)
        val = torch.where(has, P[g.receivers[chosen]], n)
        P2 = full_compress(write_min(P, tgt, val, has))
        changed = not torch.equal(P2, P)
        P = P2
        i += 1
    # one row per undirected edge, sorted by (lo, hi), deduped on the
    # device: only the forest's keys cross to the host
    s, r = g.senders[in_forest].long(), g.receivers[in_forest].long()
    key = torch.unique(torch.minimum(s, r) * (n + 1) + torch.maximum(s, r))
    uniq = torch.stack([key // (n + 1), key % (n + 1)], 1).to(torch.int32)
    return uniq.cpu().numpy(), P


def forest_weight(edges: np.ndarray, g: Graph, weights) -> float:
    """Sum of the weights of (undirected) forest edges: each edge is looked
    up on the graph's device by its key, and the weights are summed on the
    host in float32."""
    edges = np.asarray(edges)
    if edges.size == 0:
        return 0.0
    dev = g.device
    key = (g.senders[: g.m].long() * (g.n + 1) + g.receivers[: g.m].long())
    skey, order = torch.sort(key, stable=True)
    e = torch.from_numpy(edges.astype(np.int64)).to(dev)
    qk = e[:, 0] * (g.n + 1) + e[:, 1]
    pos = torch.searchsorted(skey, qk)
    if bool((pos >= skey.shape[0]).any()) or bool(
            (skey[pos.clamp_max(skey.shape[0] - 1)] != qk).any()):
        raise KeyError("forest edge not present in the graph's edge list")
    w = weights[: g.m][order[pos]].cpu().numpy()
    return float(w.sum())


# ---------------------------------------------------------------------------
# Legacy entrypoints (deprecation shims over the spec path).
# ---------------------------------------------------------------------------

_DEPRECATION = ("%s is deprecated; use repro_torch.api.ConnectIt(variant)"
                ".amsf(g, weights, spec=%r)")


def _legacy_amsf(g: Graph, weights, *, eps: float, skip: bool):
    forest_fn = make_forest_finish("uf_sync", compress="full")
    P, fu, fv, _, _, _ = amsf_device(
        init_labels(g.n, device=g.device), *init_forest(g.n, device=g.device),
        g.senders, g.receivers, torch.as_tensor(weights, device=g.device),
        eps=float(eps), skip=skip, forest_fn=forest_fn)
    return forest_edges(fu, fv), P


def amsf_nf(g: Graph, weights, *, eps: float = 0.25):
    """Deprecated: ``ConnectIt(v).amsf(g, weights, "amsf")`` → (host forest
    edges, labels)."""
    warnings.warn(_DEPRECATION % ("amsf_nf", "amsf"),
                  DeprecationWarning, stacklevel=2)
    return _legacy_amsf(g, weights, eps=eps, skip=False)


def amsf_nf_s(g: Graph, weights, *, eps: float = 0.25):
    """Deprecated: ``ConnectIt(v).amsf(g, weights, "amsf(skip=lmax)")``."""
    warnings.warn(_DEPRECATION % ("amsf_nf_s", "amsf(skip=lmax)"),
                  DeprecationWarning, stacklevel=2)
    return _legacy_amsf(g, weights, eps=eps, skip=True)


def amsf_coo(g: Graph, weights, *, eps: float = 0.25):
    """Deprecated: ``ConnectIt(v).amsf(g, weights, "amsf(mode=coo)")``."""
    warnings.warn(_DEPRECATION % ("amsf_coo", "amsf(mode=coo)"),
                  DeprecationWarning, stacklevel=2)
    forest_fn = make_forest_finish("uf_sync", compress="full")
    P, fu, fv, _, _, _, _ = amsf_coo_run(g, weights, eps=eps,
                                         forest_fn=forest_fn)
    return forest_edges(fu, fv), P
