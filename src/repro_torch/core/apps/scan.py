"""Index-based SCAN clustering via ConnectIt (paper §5.2, GS*-Query).

GS*-Index (Wen et al.) precomputes each edge's structural similarity, so
that the clustering for any (eps, mu) is a quick query. The query runs on
ConnectIt: cores are vertices with at least ``mu`` eps-similar neighbours,
clusters are the connected components of the eps-similar core-core
subgraph, and non-core border vertices join an adjacent core's cluster:

    scan_pre(...)        similar / is_core / the core-core masked COO
    scan_attach(...)     compress + border attachment
    gs_query_device()    the whole query on the graph's device

The core-core connectivity is any finish method of the variant space.
``build_index`` stays on the host (the paper treats index construction as
offline); ``gs_query_sequential`` is the sequential baseline of Figure 7.
``repro_torch.api.ConnectIt(variant).scan(g, sims, spec)`` is the entry
point.
"""

from __future__ import annotations

import warnings
from typing import Callable

import numpy as np
import torch

from ...graphs.containers import Graph
from ..finish import resolve_finish
from ..primitives import full_compress, init_labels, write_min


def build_index(g: Graph) -> np.ndarray:
    """Per-directed-edge cosine structural similarity over closed
    neighbourhoods, ``|N[u] ∩ N[v]| / sqrt(d[u]+1) / sqrt(d[v]+1)``: a host
    ``(m_pad,)`` float32 array (a Python loop over the edges)."""
    s = g.senders[: g.m].cpu().numpy()
    r = g.receivers[: g.m].cpu().numpy()
    indptr = g.indptr.cpu().numpy()
    indices = g.indices.cpu().numpy()
    deg = indptr[1:] - indptr[:-1]
    adj = [set(indices[indptr[v]: indptr[v + 1]].tolist()) | {int(v)}
           for v in range(g.n)]
    sims = np.zeros((g.m_pad,), np.float32)
    for i in range(g.m):
        u, v = int(s[i]), int(r[i])
        common = len(adj[u] & adj[v])
        sims[i] = common / np.sqrt((deg[u] + 1.0) * (deg[v] + 1.0))
    return sims


def scan_pre(senders, receivers, edge_mask, sims, *, eps: float, mu: int,
             n: int):
    """Masks and the core-core COO → ``(s, r, is_core, core_pad, similar,
    edges_core)``; ``edges_core``, the directed core-core similar edges, is
    a device scalar (for stats)."""
    similar = (sims >= eps) & edge_mask
    cnt = torch.zeros((n + 1,), dtype=torch.int32, device=senders.device)
    cnt.index_add_(0, torch.where(similar, senders, n).long(),
                   similar.to(torch.int32))
    is_core = cnt[:n] >= mu
    core_pad = torch.cat([is_core, is_core.new_zeros((1,))])
    both_core = core_pad[senders] & core_pad[receivers] & similar
    s = torch.where(both_core, senders, n)
    r = torch.where(both_core, receivers, n)
    return s, r, is_core, core_pad, similar, both_core.sum()


def scan_attach(P, senders, receivers, core_pad, similar):
    """Compress the core labeling, then attach each border vertex to the
    minimum adjacent core cluster."""
    n = P.shape[0] - 1
    P = full_compress(P)
    att = similar & core_pad[receivers] & ~core_pad[senders]
    P = write_min(P, senders, P[receivers], att)
    return P[:n]


def gs_query_device(senders, receivers, edge_mask, sims, *, eps: float,
                    mu: int, finish_fn: Callable, n: int):
    """GS*-Query on the edges' device: masks → finish connectivity →
    compress + attach. Returns ``(labels, is_core, rounds, edges_core)``."""
    s, r, is_core, core_pad, similar, edges_core = scan_pre(
        senders, receivers, edge_mask, sims, eps=eps, mu=mu, n=n)
    P, rounds = finish_fn(init_labels(n, device=senders.device), s, r)
    labels = scan_attach(P, senders, receivers, core_pad, similar)
    return labels, is_core, rounds, edges_core


def gs_query_sequential(g: Graph, sims, eps: float, *, mu: int = 3):
    """Sequential GS*-Query (Algorithm 4 of Wen et al.) on the host: BFS
    from the cores over eps-similar edges. Baseline of the paper's Figure
    7."""
    s = g.senders[: g.m].cpu().numpy()
    sims = (sims.cpu().numpy() if isinstance(sims, torch.Tensor)
            else np.asarray(sims))[: g.m]
    indptr = g.indptr.cpu().numpy()
    indices = g.indices.cpu().numpy()
    similar = sims >= eps
    cnt = np.zeros(g.n, np.int64)
    np.add.at(cnt, s[similar], 1)
    is_core = cnt >= mu
    labels = np.arange(g.n, dtype=np.int64)
    visited = np.zeros(g.n, bool)
    # the similarity of CSR slot ei is edge ei's (indices sorted by sender)
    for v in range(g.n):
        if not is_core[v] or visited[v]:
            continue
        comp = [v]
        visited[v] = True
        cid = v
        while comp:
            u = comp.pop()
            labels[u] = min(labels[u], cid)
            for ei in range(indptr[u], indptr[u + 1]):
                w = int(indices[ei])
                if sims[ei] >= eps:
                    if is_core[w] and not visited[w]:
                        visited[w] = True
                        comp.append(w)
                    elif not is_core[w]:
                        labels[w] = min(labels[w], cid)
    return labels, is_core


# ---------------------------------------------------------------------------
# Legacy entrypoint (deprecation shim over the spec path).
# ---------------------------------------------------------------------------

def gs_query_parallel(g: Graph, sims, eps: float, *, mu: int = 3,
                      finish: str = "uf_sync_full"):
    """Deprecated: use ``repro_torch.api.ConnectIt(variant).scan(g, sims,
    "scan(eps=...,mu=...)")`` → (labels, is_core)."""
    warnings.warn(
        "gs_query_parallel is deprecated; use repro_torch.api.ConnectIt"
        "(variant).scan(g, sims, spec='scan(eps=...,mu=...)')",
        DeprecationWarning, stacklevel=2)
    labels, is_core, _, _ = gs_query_device(
        g.senders, g.receivers, g.edge_mask,
        torch.as_tensor(sims, device=g.device), eps=float(eps), mu=int(mu),
        finish_fn=resolve_finish(finish), n=g.n)
    return labels, is_core
