"""ConnectIt sampling phase (paper §3.2, Appendix C.5).

Three schemes, each returning a *partial* connectivity labeling (Def. 3.1):

  * k-out   — per-vertex edge selection, four variants (Appendix C.5):
              afforest | pure | hybrid (paper default, k=2) | maxdeg
  * BFS     — label-spreading BFS from ≤ num_sources random sources, accept
              when the discovered component covers > threshold of vertices
  * LDD     — one round of Miller–Peng–Xu with exponential shifts (β)

k-out selects about ``k`` edges per vertex and runs uf_sync(full) over them:

    afforest  the first k edges of each row (deterministic)
    pure      k uniformly random edges of each row
    hybrid    the first edge plus k - 1 random ones (the paper's default)
    maxdeg    the neighbor of maximum degree plus k - 1 random ones

``make_sampler(scheme, **params)`` returns the memoized sampler of one
parameterization; a sampler is called as ``sampler(g, generator)``, and with
``want_forest=True`` also returns the partial spanning forest it found
(Def. B.2) as a ``ForestState``: k-out records one edge per hooked root, BFS
each visited vertex's discovery edge, LDD each covered vertex's.

The random numbers (k-out columns, BFS sources, LDD shifts) come from a
``torch.Generator``, which gives other numbers than the JAX package's
``jax.random`` key; the labels after the finish phase are the same all the
same, since canonical min-vertex labels are unique for a partition. The
frontier loops check their condition on the host once a round, and scatter
through ``ops.scatter_min`` (``write_min``).
"""

from __future__ import annotations

import warnings
from typing import Callable, Optional

import torch

from ..graphs.containers import Graph
from .finish import ForestState, make_finish, memoized_factory, uf_sync_forest
from .primitives import (
    DEFAULT_MAX_ROUNDS,
    INT_MAX,
    full_compress,
    init_forest,
    init_labels,
    write_min,
)
from .registry import make_legacy_resolver

# (g, generator, *, want_forest=False) -> labels, or a ForestState
SamplerFn = Callable[..., object]

KOUT_VARIANTS = ("afforest", "pure", "hybrid", "maxdeg")


def _random_offsets(n: int, deg: torch.Tensor,
                    generator: torch.Generator) -> torch.Tensor:
    """One uniform offset into each row: ``[0, max(deg, 1))``."""
    draw = torch.randint(0, 1 << 62, (n,), generator=generator,
                         device=deg.device)
    return (draw % deg.clamp_min(1).long()).to(torch.int32)


def _select_kout_edges(g: Graph, generator: Optional[torch.Generator], k: int,
                       variant: str):
    """Return (senders, receivers) of the ~n*k selected directed edges."""
    n = g.n
    dev = g.device
    deg = g.indptr[1 : n + 1] - g.indptr[:n]  # (n,)
    base = g.indptr[:n]
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    has = deg > 0

    def take(offsets):  # offsets (n,) into each row; invalid rows → self edge
        pos = base + torch.minimum(offsets, (deg - 1).clamp_min(0))
        # clamp as the reference's gather does (it clamps silently)
        nbr = g.indices[pos.clamp_max(g.m_pad - 1).long()]
        return torch.where(has, nbr, ids)

    cols = []
    if variant == "afforest":
        for j in range(k):
            col = take(torch.full((n,), j, dtype=torch.int32, device=dev))
            cols.append(torch.where(j < deg, col, ids))
    elif variant in ("pure", "hybrid", "maxdeg"):
        n_rand = k if variant == "pure" else k - 1
        if variant == "hybrid":
            cols.append(take(torch.zeros((n,), dtype=torch.int32, device=dev)))
        elif variant == "maxdeg":
            # neighbor of maximum degree: two-pass segment-max (deg, then id)
            degs_all = g.indptr[1:] - g.indptr[:-1]
            s = g.senders.long()
            mask = g.edge_mask
            dnbr = torch.where(mask, degs_all[g.receivers.long()], -1)
            dbuf = torch.full((n + 1,), -1, dtype=torch.int32, device=dev)
            dbuf = dbuf.scatter_reduce(0, s, dnbr, "amax")
            hit = mask & (dnbr == dbuf[s])
            nbuf = torch.full((n + 1,), -1, dtype=torch.int32, device=dev)
            nbuf = nbuf.scatter_reduce(
                0, s, torch.where(hit, g.receivers, -1), "amax")
            cols.append(torch.where(nbuf[:n] >= 0, nbuf[:n], ids))
        for _ in range(n_rand):
            cols.append(take(_random_offsets(n, deg, generator)))
    else:
        raise ValueError(variant)
    receivers = torch.cat(cols)
    senders = ids.repeat(len(cols))
    # drop self-edges introduced for isolated vertices: point them at the dump
    bad = senders == receivers
    senders = torch.where(bad, n, senders)
    receivers = torch.where(bad, n, receivers)
    return senders, receivers


def make_kout(k: int = 2, variant: str = "hybrid") -> SamplerFn:
    if variant not in KOUT_VARIANTS:
        raise ValueError(
            f"unknown k-out variant {variant!r}; have {KOUT_VARIANTS}")
    if k < 1:
        raise ValueError(f"k-out needs k >= 1, got {k}")

    def kout(g: Graph, generator: Optional[torch.Generator] = None, *,
             want_forest: bool = False):
        s, r = _select_kout_edges(g, generator, k, variant)
        P = init_labels(g.n, device=g.device)
        if want_forest:
            st, _ = uf_sync_forest(P, s, r, compress="full")
            return ForestState(full_compress(st.P), st.fu, st.fv)
        P, _ = make_finish("uf_sync", compress="full")(P, s, r)
        return full_compress(P)

    kout.__name__ = f"kout_{variant}_k{k}"
    return kout


# ---------------------------------------------------------------------------
# BFS sampling (Algorithm 5): label-spreading BFS + coverage gate.
# ---------------------------------------------------------------------------

def _bfs_from(g: Graph, src: torch.Tensor, *,
              max_rounds: int = DEFAULT_MAX_ROUNDS):
    """Frontier BFS from the 0-d vertex tensor ``src`` → ``(visited,
    parent)``, both ``(n + 1,)``: the visited mask and, for each vertex
    visited after the source, the sender that discovered it (-1 else)."""
    n = g.n
    s, r = g.senders.long(), g.receivers.long()
    visited = init_labels(n, device=g.device) == src
    parent = torch.full((n + 1,), -1, dtype=torch.int32, device=g.device)
    frontier = visited
    rounds = 0
    while rounds < max_rounds and bool(frontier.any()):
        # discovery: the min sender reaches each new vertex first
        live = frontier[s] & ~visited[r]
        buf = write_min(torch.full((n + 1,), INT_MAX, dtype=torch.int32,
                                   device=g.device),
                        g.receivers, g.senders, live)
        frontier = (buf < INT_MAX) & ~visited
        parent = torch.where(frontier, buf.clamp_max(n), parent)
        visited = visited | frontier
        rounds += 1
    return visited, parent


def make_bfs(num_sources: int = 3, threshold: float = 0.1) -> SamplerFn:
    """BFS sampler: try up to ``num_sources`` random sources in the order
    drawn, accept the first whose component covers more than
    ``int(threshold * n)`` vertices; without one, the identity labeling.
    The forest is the accepted source's discovery edges."""
    if num_sources < 1:
        raise ValueError(f"bfs needs num_sources >= 1, got {num_sources}")
    if not 0.0 < threshold <= 1.0:
        raise ValueError(f"bfs threshold must be in (0, 1], got {threshold}")

    def bfs(g: Graph, generator: Optional[torch.Generator] = None, *,
            want_forest: bool = False):
        n = g.n
        ids = init_labels(n, device=g.device)
        min_cover = int(threshold * n)
        sources = torch.randint(0, n, (num_sources,), generator=generator,
                                device=g.device, dtype=torch.int32)
        P = ids
        fu, fv = init_forest(n, device=g.device)
        for src in sources:
            visited, parent = _bfs_from(g, src)
            if int(visited[:n].sum()) > min_cover:
                P = torch.where(visited, src, ids)
                P[n] = n
                sel = visited & (parent >= 0) & (ids < n) & (ids != src)
                fu = torch.where(sel, parent, fu)
                fv = torch.where(sel, ids, fv)
                break
        return ForestState(P, fu, fv) if want_forest else P

    bfs.__name__ = f"bfs_c{num_sources}"
    return bfs


# ---------------------------------------------------------------------------
# LDD sampling (Algorithm 6): MPX with exponential shifts, ties by min center.
# ---------------------------------------------------------------------------

def make_ldd(beta: float = 0.2, max_rounds: int = DEFAULT_MAX_ROUNDS
             ) -> SamplerFn:
    if not beta > 0.0:
        raise ValueError(f"ldd needs beta > 0, got {beta}")

    def ldd(g: Graph, generator: Optional[torch.Generator] = None, *,
            want_forest: bool = False):
        n = g.n
        dev = g.device
        s, r = g.senders.long(), g.receivers.long()
        shifts = torch.empty(n, dtype=torch.float32, device=dev).exponential_(
            generator=generator) / beta
        shifts = shifts.clamp_max(float(max_rounds - 2))
        # MPX: vertex v starts its own cluster at time δ_max − δ_v (the
        # LARGEST shift races first; most vertices are covered before they
        # ever wake)
        wake = torch.floor(shifts.max() - shifts).to(torch.int32)
        wake = torch.cat([wake, wake.new_tensor([INT_MAX])])
        P = torch.full((n + 1,), INT_MAX, dtype=torch.int32, device=dev)
        P[n] = n
        parent = torch.full((n + 1,), -1, dtype=torch.int32, device=dev)
        ids = init_labels(n, device=dev)
        real = ids < n
        frontier = torch.zeros(n + 1, dtype=torch.bool, device=dev)

        def empty():
            return torch.full((n + 1,), INT_MAX, dtype=torch.int32,
                              device=dev)

        rounds = 0
        while rounds < max_rounds and bool((P[:n] == INT_MAX).any()):
            # uncovered vertices whose shift has elapsed become centers
            start = (P == INT_MAX) & (wake <= rounds) & real
            P = torch.where(start, ids, P)
            frontier = frontier | start
            # grow all clusters one hop; the min center id wins a vertex
            act = frontier[s]
            Ps = P[s]
            buf = write_min(empty(), g.receivers, Ps, act & (P[r] == INT_MAX))
            frontier = (buf < INT_MAX) & (P == INT_MAX)
            if want_forest:
                # the discovery edge: min sender among achievers of buf
                pbuf = write_min(empty(), g.receivers, g.senders,
                                 act & frontier[r] & (Ps == buf[r]))
                parent = torch.where(frontier, pbuf.clamp_max(n), parent)
            P = torch.where(frontier, buf, P)
            rounds += 1
        if want_forest:
            sel = (parent >= 0) & real
            fu, fv = init_forest(n, device=dev)
            return ForestState(P, torch.where(sel, parent, fu),
                               torch.where(sel, ids, fv))
        return P

    ldd.__name__ = f"ldd_b{beta:g}"
    return ldd


# ---------------------------------------------------------------------------
# The registry: scheme name -> factory, memoized per parameterization.
# ---------------------------------------------------------------------------

_FACTORIES: dict = {"kout": make_kout, "bfs": make_bfs, "ldd": make_ldd}
# make_sampler(scheme, **params) -> the memoized sampler callable
make_sampler = memoized_factory("sampling scheme", _FACTORIES)


# ---------------------------------------------------------------------------
# Legacy string-keyed entrypoints (deprecation shims).
# ---------------------------------------------------------------------------

_LEGACY_SAMPLERS: dict[str, tuple[str, dict]] = {
    "kout": ("kout", {}),  # paper default: hybrid, k=2
    "kout_afforest": ("kout", {"variant": "afforest"}),
    "kout_pure": ("kout", {"variant": "pure"}),
    "kout_hybrid": ("kout", {"variant": "hybrid"}),
    "kout_maxdeg": ("kout", {"variant": "maxdeg"}),
    "bfs": ("bfs", {}),
    "ldd": ("ldd", {}),
}

# silent resolver (internal drivers never pass per-call kwargs)
resolve_sampler = make_legacy_resolver(_LEGACY_SAMPLERS, make_sampler,
                                       "sampler")

# the seed's sampler callables accepted per-call keyword parameters; the
# deprecation shim translates them onto the factory parameterization
_LEGACY_CALL_KW: dict[str, dict[str, str]] = {
    "kout": {},
    "bfs": {"c": "num_sources", "threshold": "threshold"},
    "ldd": {"beta": "beta", "max_rounds": "max_rounds"},
}


def get_sampler(name: str) -> SamplerFn:
    """Deprecated: use ``make_sampler(scheme, **params)`` or
    ``repro_torch.api``.

    Returns a wrapper preserving the seed's call surface, including its
    per-call keyword parameters (``c``/``threshold``/``beta``/...); the
    reference's ``key`` is a ``torch.Generator`` here."""
    warnings.warn(
        "get_sampler(name) with flat string keys is deprecated; use "
        "make_sampler(scheme, **params) or repro_torch.api.SamplingSpec/"
        "VariantSpec",
        DeprecationWarning, stacklevel=2)
    if name not in _LEGACY_SAMPLERS:
        raise KeyError(
            f"unknown sampler {name!r}; have {sorted(_LEGACY_SAMPLERS)}")
    scheme, base_params = _LEGACY_SAMPLERS[name]

    def legacy_sampler(g, generator=None, *, want_forest: bool = False,
                       **kw):
        params = dict(base_params)
        for k, v in kw.items():
            if k not in _LEGACY_CALL_KW[scheme]:
                raise TypeError(f"{name} sampler got an unexpected keyword "
                                f"argument {k!r}")
            params[_LEGACY_CALL_KW[scheme][k]] = v
        return make_sampler(scheme, **params)(g, generator,
                                              want_forest=want_forest)

    legacy_sampler.__name__ = name
    return legacy_sampler


def sampler_names() -> list[str]:
    """Legacy flat name list (kept for the string-keyed shim surface)."""
    return sorted(_LEGACY_SAMPLERS)
