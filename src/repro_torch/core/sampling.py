"""ConnectIt k-out sampling (paper §3.2, Algorithm 4, Appendix C.5).

A sampler returns a *partial* connectivity labeling (Def. 3.1): it selects
about ``k`` edges per vertex and runs uf_sync(full) over them.

Four selection variants:

    afforest  the first k edges of each row (deterministic)
    pure      k uniformly random edges of each row
    hybrid    the first edge plus k - 1 random ones (the paper's default)
    maxdeg    the neighbor of maximum degree plus k - 1 random ones

The random columns are drawn from a ``torch.Generator``, which gives other
numbers than the JAX package's ``jax.random`` key; the labels after the
finish phase are the same all the same, since canonical min-vertex labels
are unique for a partition.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..graphs.containers import Graph
from .finish import make_finish
from .primitives import full_compress, init_labels

SamplerFn = Callable[..., torch.Tensor]  # (g, generator) -> labels

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

    def kout(g: Graph, generator: Optional[torch.Generator] = None):
        s, r = _select_kout_edges(g, generator, k, variant)
        P = init_labels(g.n, device=g.device)
        P, _ = make_finish("uf_sync", compress="full")(P, s, r)
        return full_compress(P)

    kout.__name__ = f"kout_{variant}_k{k}"
    return kout
