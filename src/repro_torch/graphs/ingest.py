"""Out-of-core chunked ingest: connectivity without a resident edge list.

After the sampling phase most edges are already intra-component and die
without reaching the finish method, so the full graph never has to exist,
on the host or the device, at once:

  1. **Sample** on the stream's head: build a small ``Graph`` from the first
     chunk(s), run the session's sampling phase on it, fully compress.
     L_max is *not* pinned to the virtual label -1: the survivors are stored
     as rewritten endpoints, so labels must stay vertex indices. An edge
     dies on representative *equality*, which L_max-internal edges have
     either way.
  2. **Stream** every chunk (the head again too) through ``rewrite_edges``
     against the compressed labeling. An edge whose ends map to one
     representative (intra-component, a self-loop, or dump padding) is
     dropped on the device; the survivors are cumsum-compacted into a
     bounded *survivor buffer*.
  3. **Flush** when a chunk's survivors would overflow the buffer: run the
     finish method on the symmetrized buffer, fully compress, empty the
     buffer. Each flush is a *spill*. The flush comes before the chunk's
     append, and the chunk's survivors keep the endpoints they were
     rewritten to against the pre-flush labels: they join the same
     components under any newer labeling.
  4. **Finalize**: one last finish over the buffer, then the
     ``min_vertex_labels`` canonicalization of every other path, so the
     labels equal the one-shot path's.

The JAX package keeps the flush decision on the device (``lax.cond``). Here
it is a host check: each chunk reads its survivor count once, the one host
sync a chunk costs outside the finish's own rounds. ``survivors`` and
``spills`` follow from that read exactly; ``streamed`` and ``lmax_count``
stay on the device until the end. Each chunk is dump-padded to the pow2
buckets of ``driver.bucket_size``. A chunk that is a tensor (a decoded
``CompressedEdgeBlocks`` block) stays on its device.

Resident peak: ``O(n)`` labels + one padded chunk + the survivor buffer,
independent of m. Surfaced as ``ConnectIt(...).from_chunks``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from .. import random as trandom
from ..core.driver import ConnectivityStats, bucket_size
from ..core.primitives import (
    full_compress,
    init_labels,
    min_vertex_labels,
    most_frequent,
    rewrite_edges,
)
from .containers import ChunkedEdgeSource, build_graph


@dataclasses.dataclass(frozen=True)
class IngestResult:
    """Labels + accounting from one chunked ingest run."""

    labels: torch.Tensor     # (n,) int32 canonical min-vertex-id labels
    n: int
    chunks: int              # chunks streamed (incl. the sampled head)
    streamed: int            # real edges streamed through the rewrite
    survivors: int           # edges that reached the survivor buffer
    spills: int              # buffer-overflow flushes mid-stream
    finish_rounds: int       # finish rounds across all flushes + finalize
    lmax_count: int          # L_max size after the sampling phase
    survivor_cap: int        # buffer capacity the run used

    @property
    def survivor_ratio(self) -> float:
        return self.survivors / self.streamed if self.streamed else 0.0


def _sample_prep(P: torch.Tensor):
    # compress only, no relabel_lmax: the survivor buffer holds rewritten
    # endpoints, which must stay vertex indices (a -1 would become a
    # scatter index inside the finish)
    P = full_compress(P)
    _, cnt = most_frequent(P)
    return P, cnt


def _flush(P, bu, bv, finish_fn):
    """The finish over the symmetrized buffer, then full compression →
    (P, rounds)."""
    P, rounds = finish_fn(P, torch.cat([bu, bv]), torch.cat([bv, bu]))
    return full_compress(P), rounds


def _chunk_step(P, bu, bv, count: int, u, v, finish_fn):
    """One padded chunk through rewrite → flush if needed → compact-append.

    ``count`` is the buffer's fill on the host. Returns ``(P, bu, bv, count,
    incoming, flushed, rounds)``: ``incoming`` the chunk's survivors (the
    one host read), ``flushed`` whether the buffer was flushed first,
    ``rounds`` that flush's finish rounds."""
    n = P.shape[0] - 1
    cap = bu.shape[0] - 1  # slot `cap` is the dump slot
    ru, rv = rewrite_edges(P, u, v)
    # equal representatives ⇔ dead: intra-component, self-loops and dump
    # padding (n → n) all collapse to ru == rv
    alive = ru != rv
    k = torch.cumsum(alive, 0)  # int64
    incoming = int(k[-1])
    flushed = count + incoming > cap
    rounds = 0
    if flushed:
        P, rounds = _flush(P, bu, bv, finish_fn)
        bu.fill_(n)
        bv.fill_(n)
        count = 0
    # the buffers are the run's own: appended in place
    pos = torch.where(alive, count + k - 1, cap)
    bu.index_put_((pos,), torch.where(alive, ru, n).to(bu.dtype))
    bv.index_put_((pos,), torch.where(alive, rv, n).to(bv.dtype))
    return P, bu, bv, count + incoming, incoming, flushed, rounds


def _finalize(P, bu, bv, finish_fn):
    P, rounds = _flush(P, bu, bv, finish_fn)
    return min_vertex_labels(P), rounds


def _as_edges(chunk, device) -> torch.Tensor:
    """A chunk as a ``(k, 2)`` int32 tensor on ``device``."""
    if isinstance(chunk, torch.Tensor):
        return chunk.reshape(-1, 2).to(device=device, dtype=torch.int32)
    arr = np.ascontiguousarray(np.asarray(chunk, dtype=np.int32).reshape(-1, 2))
    if not arr.flags.writeable:  # a read-only np.memmap chunk
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


def _pad_chunk(edges: torch.Tensor, n: int):
    """A ``(k, 2)`` chunk → dump-padded (u, v) on the pow2 bucket of k."""
    k = edges.shape[0]
    size = bucket_size(k, pad="pow2")
    u = torch.full((size,), n, dtype=torch.int32, device=edges.device)
    v = torch.full((size,), n, dtype=torch.int32, device=edges.device)
    u[:k] = edges[:, 0]
    v[:k] = edges[:, 1]
    return u, v


def ingest_chunks(
    source: ChunkedEdgeSource,
    sampler_fn: Optional[Callable],
    finish_fn: Callable,
    rng=None,
    *,
    device,
    survivor_cap: Optional[int] = None,
    sample_chunks: int = 1,
) -> IngestResult:
    """Out-of-core connectivity over a ``ChunkedEdgeSource`` on ``device``
    → labels equal to the one-shot ``build_graph`` path's.

    ``survivor_cap`` bounds the survivor buffer: 4× the first chunk's pow2
    bucket by default, and at least every chunk's bucket (one chunk's
    survivors must fit the empty buffer: the flush comes before the
    append). ``sample_chunks`` chunks of the head seed the sampling phase;
    the head is streamed again afterwards, so the sample changes speed,
    never labels. ``rng`` draws the sampler's random numbers: a threefry
    key (``PRNGKey(0)`` when None, the reference's default) or a
    ``torch.Generator``."""
    n = int(source.n)
    it = iter(source.chunks())
    head: list[torch.Tensor] = []
    for chunk in it:
        head.append(_as_edges(chunk, device))
        if len(head) >= max(sample_chunks, 1):
            break

    if sampler_fn is not None and sum(c.shape[0] for c in head):
        g0 = build_graph(torch.cat(head), n, device=device)
        P = sampler_fn(g0, trandom.resolve(rng, g0.device))
        del g0
    else:
        P = init_labels(n, device=device)
    P, cnt = _sample_prep(P)

    first_bucket = bucket_size(max((c.shape[0] for c in head), default=1),
                               pad="pow2")
    cap = 4 * first_bucket if survivor_cap is None else int(survivor_cap)
    bu = torch.full((cap + 1,), n, dtype=torch.int32, device=device)
    bv = torch.full((cap + 1,), n, dtype=torch.int32, device=device)
    count = survivors = spills = rounds = chunks_seen = 0
    streamed = torch.zeros((), dtype=torch.int64, device=device)

    def all_chunks():
        while head:  # the head's chunks go as they are streamed
            yield head.pop(0)
        for chunk in it:
            yield _as_edges(chunk, device)

    for edges in all_chunks():
        u, v = _pad_chunk(edges, n)
        if u.shape[0] > cap:
            raise ValueError(
                f"chunk bucket {u.shape[0]} exceeds survivor_cap={cap}; "
                f"a whole chunk must fit the empty buffer — raise "
                f"survivor_cap or lower the source chunk size")
        P, bu, bv, count, incoming, flushed, r = _chunk_step(
            P, bu, bv, count, u, v, finish_fn)
        survivors += incoming
        spills += int(flushed)
        rounds += r
        streamed += (u < n).sum()
        chunks_seen += 1

    P, r = _finalize(P, bu, bv, finish_fn)
    return IngestResult(
        labels=P[:n],
        n=n,
        chunks=chunks_seen,
        streamed=int(streamed),
        survivors=survivors,
        spills=spills,
        finish_rounds=rounds + r,
        lmax_count=int(cnt),
        survivor_cap=cap,
    )


def ingest_stats(result: IngestResult, *, variant: str = "",
                 exec_str: str = "single") -> ConnectivityStats:
    """Fold an ``IngestResult`` into the ``ConnectivityStats`` every other
    path reports."""
    return ConnectivityStats(
        variant=variant,
        exec=exec_str,
        placement="single",
        devices=1,
        edges_total=result.streamed,
        edges_finish=result.survivors,
        edges_finish_padded=2 * (result.survivor_cap + 1),
        edges_per_device=(result.survivors,),
        dispatch_sizes=(2 * (result.survivor_cap + 1),),
        lmax_count=result.lmax_count,
        finish_rounds=result.finish_rounds,
        chunks=result.chunks,
        spills=result.spills,
        survivor_ratio=result.survivor_ratio,
    )
