"""Uniform-fanout neighbour sampling for minibatch GNN training (GraphSAGE)
(mirrors ``repro.graphs.sampler``).

``sample_neighbors`` draws, per frontier node, ``fanout`` neighbours
uniformly with replacement from the CSR rows (static shapes; degree-0 and
dump nodes emit dump edges). ``sample_subgraph`` chains hops and returns
the union edge list of the sampled computation graph: the ``minibatch_lg``
cell trains the full L-layer GNN on it with the loss on the seeds. The
draws are ``jax.random``'s (``repro_torch.random``: the threefry kernels on
the card), so a key gives the reference's edges bit for bit.
"""

from __future__ import annotations

import torch

from .. import random as trandom


def sample_neighbors(indptr: torch.Tensor, indices: torch.Tensor,
                     nodes: torch.Tensor, key: torch.Tensor,
                     fanout: int, *, start: int = 0) -> torch.Tensor:
    """nodes: (F,) int32 (may include the dump id n). Returns (F * fanout,)
    int32 neighbours, the dump id n where a node has none. ``nodes`` may be
    rows ``[start, start + F)`` of a larger frontier: the draws are then
    that block's of the whole frontier's draw."""
    n = indptr.shape[0] - 2
    safe = torch.clamp(nodes.long(), max=n)
    base = indptr[safe].long()
    deg = indptr[safe + 1].long() - base
    r = trandom.randint(key, (nodes.shape[0], fanout), 0, 2**31 - 1,
                        start=start * fanout)
    off = r.long() % torch.clamp(deg, min=1)[:, None]
    pos = torch.clamp(base[:, None] + off, max=indices.shape[0] - 1)
    nbr = indices[pos]
    ok = (deg > 0)[:, None] & (nodes < n)[:, None]
    return torch.where(ok, nbr, n).reshape(-1).to(torch.int32)


def sample_subgraph(indptr: torch.Tensor, indices: torch.Tensor,
                    seeds: torch.Tensor, key: torch.Tensor,
                    fanouts: tuple, *, start: int = 0) -> tuple:
    """Multi-hop uniform sampling: ``(senders, receivers)`` int32 of the
    union computation graph in global ids, edges pointing sampled neighbour
    → node; a hop's key is ``split``'s second of the key before it.

    On a mesh each rank passes its block of the seeds, rows ``[start,
    start + F)`` of the whole batch: each hop then draws its frontier's
    block (hop ``h``'s rows ``[start·f_0···f_(h-1), ...)``) with the bits
    that the whole draw has there, so the ranks' edges, hop by hop,
    are blocks of the one-rank sample's."""
    n = indptr.shape[0] - 2
    frontier = seeds
    s_parts, r_parts = [], []
    for f in fanouts:
        key, sub = trandom.split(key)
        nbrs = sample_neighbors(indptr, indices, frontier, sub, f,
                                start=start)
        start *= f
        r_parts.append(torch.repeat_interleave(frontier, f))
        s_parts.append(nbrs)
        frontier = nbrs
    senders = torch.cat(s_parts)
    receivers = torch.cat(r_parts)
    # orphaned directions (dump) stay masked by the models' valid check
    receivers = torch.where(senders >= n, n, receivers)
    return senders.to(torch.int32), receivers.to(torch.int32)
