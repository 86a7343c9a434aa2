"""Host-side synthetic graph generators (numpy) → Graph containers on a device.

The edges are drawn with numpy exactly as the JAX package's
``repro.graphs.generators`` draws them, so one seed gives one edge list in
both packages; only the container is built on ``device``. The churn
schedules (``sliding_window``, ``flash_crowd``, ``partition_heal``) and the
streamed chunk sources (``rmat_chunks``, ``powerlaw_chunks``) yield host
arrays, the same ones as the JAX package's for one seed, and
``with_weights`` draws the same weights.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator

import numpy as np
import torch

from ..device import DEFAULT_DEVICE
from .containers import Graph, build_graph


def rmat_edges(n: int, m: int, *, a: float = 0.5, b: float = 0.1,
               c: float = 0.1, seed: int = 0) -> np.ndarray:
    """The ``(m, 2)`` int64 RMAT edge list before symmetrization/dedup.

    Each level draws ``rng.choice(4, size=m, p=[a, b, c, d])``'s uniforms
    and takes the quadrant from them by comparison with the cumulative
    ``p`` (the same draws and quadrants, without the choice's index
    arrays): the source's bit is quadrant 2 or 3, the destination's
    quadrant 1 or 3, shifted into the ids most significant bit first."""
    rng = np.random.default_rng(seed)
    scale = int(np.ceil(np.log2(max(n, 2))))
    cdf = np.array([a, b, c, 1.0 - a - b - c]).cumsum()
    cdf /= cdf[-1]
    acc = np.int32 if scale < 31 else np.int64
    src = np.zeros(m, dtype=acc)
    dst = np.zeros(m, dtype=acc)
    u = np.empty(m)
    hi, odd = np.empty(m, dtype=bool), np.empty(m, dtype=bool)
    for _ in range(scale):
        rng.random(out=u)
        np.greater_equal(u, cdf[1], out=hi)      # quadrant >= 2
        src <<= 1
        src |= hi
        np.greater_equal(u, cdf[0], out=odd)     # quadrant odd: the
        odd ^= hi                                # parity of the three
        np.greater_equal(u, cdf[2], out=hi)      # comparisons
        odd ^= hi
        dst <<= 1
        dst |= odd
    return np.stack([src.astype(np.int64) % n, dst.astype(np.int64) % n], 1)


def rmat(n: int, m: int, *, a: float = 0.5, b: float = 0.1, c: float = 0.1,
         seed: int = 0, device=DEFAULT_DEVICE) -> Graph:
    """RMAT generator with paper parameters (a,b,c) = (0.5, 0.1, 0.1)."""
    return build_graph(rmat_edges(n, m, a=a, b=b, c=c, seed=seed), n,
                       device=device)


def barabasi_albert(n: int, k: int, *, seed: int = 0,
                    device=DEFAULT_DEVICE) -> Graph:
    """BA preferential attachment: each new vertex draws k edges, its
    targets uniform over the endpoint history (a host loop, the
    reference's draws in the reference's order)."""
    rng = np.random.default_rng(seed)
    targets = np.zeros(n * k, dtype=np.int64)
    sources = np.zeros(n * k, dtype=np.int64)
    hist = np.zeros(2 * n * k, dtype=np.int64)
    hlen = 0
    e = 0
    for v in range(1, n):
        for _ in range(k):
            t = hist[rng.integers(0, hlen)] if hlen else 0
            sources[e] = v
            targets[e] = t
            hist[hlen] = v
            hist[hlen + 1] = t
            hlen += 2
            e += 1
    return build_graph(np.stack([sources[:e], targets[:e]], 1), n,
                       device=device)


def torus(dims: tuple, *, device=DEFAULT_DEVICE) -> Graph:
    """d-dimensional torus; each vertex joins its 2d neighbours (Fig. 4b)."""
    dims = tuple(int(d) for d in dims)
    n = int(np.prod(dims))
    coords = np.indices(dims).reshape(len(dims), -1)  # (d, n)
    strides = np.array([int(np.prod(dims[i + 1:])) for i in range(len(dims))])
    vid = (coords * strides[:, None]).sum(0)
    edges = []
    for axis, size in enumerate(dims):
        nxt = coords.copy()
        nxt[axis] = (nxt[axis] + 1) % size
        edges.append(np.stack([vid, (nxt * strides[:, None]).sum(0)], 1))
    return build_graph(np.concatenate(edges, 0), n, device=device)


def grid2d(rows: int, cols: int, *, device=DEFAULT_DEVICE) -> Graph:
    """2-D grid — a high-diameter road-network stand-in."""
    vid = np.arange(rows * cols).reshape(rows, cols)
    right = vid[:, :-1].ravel()
    down = vid[:-1, :].ravel()
    edges = np.concatenate(
        [np.stack([right, right + 1], 1), np.stack([down, down + cols], 1)], 0)
    return build_graph(edges, rows * cols, device=device)


def random_graph(n: int, m: int, *, seed: int = 0,
                 device=DEFAULT_DEVICE) -> Graph:
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, n, size=(m, 2))
    return build_graph(edges, n, device=device)


def planted_components(n: int, n_comp: int, avg_deg: float, *, seed: int = 0,
                       device=DEFAULT_DEVICE) -> Graph:
    """Union of n_comp random connected blobs — an oracle-friendly testbed."""
    rng = np.random.default_rng(seed)
    sizes = np.full(n_comp, n // n_comp)
    sizes[: n % n_comp] += 1
    edges = []
    start = 0
    for sz in sizes:
        ids = np.arange(start, start + sz)
        if sz > 1:
            # random spanning tree keeps each blob connected
            perm = rng.permutation(ids)
            parents = np.array(
                [perm[rng.integers(0, i)] for i in range(1, sz)])
            edges.append(np.stack([perm[1:], parents], 1))
            extra = int(sz * max(avg_deg / 2.0 - 1.0, 0.0))
            if extra:
                edges.append(rng.integers(start, start + sz, size=(extra, 2)))
        start += sz
    if not edges:
        edges = [np.zeros((0, 2), dtype=np.int64)]
    return build_graph(np.concatenate(edges, 0), n, device=device)


def star(n: int, *, device=DEFAULT_DEVICE) -> Graph:
    hub = np.zeros(n - 1, dtype=np.int64)
    leaves = np.arange(1, n, dtype=np.int64)
    return build_graph(np.stack([hub, leaves], 1), n, device=device)


def path(n: int, *, device=DEFAULT_DEVICE) -> Graph:
    ids = np.arange(n - 1, dtype=np.int64)
    return build_graph(np.stack([ids, ids + 1], 1), n, device=device)


def empty_graph(n: int, *, device=DEFAULT_DEVICE) -> Graph:
    return build_graph(np.zeros((0, 2), dtype=np.int64), n, device=device)


def with_weights(g: Graph, *, seed: int = 0, mean: float = 1.0) -> torch.Tensor:
    """Exponential edge weights (AMSF §5.1), the same for both directions of
    an edge: ``(m_pad,)`` float32 on the graph's device, with ``inf`` past
    ``m``. One draw per distinct undirected edge, in the order of its key
    ``min * (n + 1) + max``, as the JAX package draws them; the keys are
    ranked on the graph's device."""
    rng = np.random.default_rng(seed)
    s = g.senders[: g.m].long()
    r = g.receivers[: g.m].long()
    key = torch.minimum(s, r) * (g.n + 1) + torch.maximum(s, r)
    uniq, inverse = torch.unique(key, sorted=True, return_inverse=True)
    del key
    uniq_w = rng.exponential(mean, size=max(int(uniq.shape[0]), 1))
    w = torch.from_numpy(uniq_w.astype(np.float32)).to(g.device)[inverse]
    out = torch.full((g.m_pad,), float("inf"), dtype=torch.float32,
                     device=g.device)
    out[: g.m] = w
    return out


# ---------------------------------------------------------------------------
# Churn schedules (repro_torch.dynamic): host-side generators of mixed
# insert/delete/query steps for batch-dynamic streams and benchmarks.
# Each yields (inserts, deletes, queries) int32 arrays of shape (k, 2);
# deletions only ever target currently-live edges, so a scipy oracle can
# replay the schedule exactly.
# ---------------------------------------------------------------------------

def sliding_window(n: int, *, steps: int = 16, batch: int = 256,
                   window: int = 4, queries: int = 64, seed: int = 0):
    """Steady-state churn: every step inserts a random batch and deletes the
    batch inserted ``window`` steps ago — the live edge set is a sliding
    window over the insert stream (constant size after warmup), the classic
    graph-stream windowing workload."""
    rng = np.random.default_rng(seed)
    empty = np.zeros((0, 2), np.int32)
    recent: list = []
    for _ in range(steps):
        ins = rng.integers(0, n, size=(batch, 2)).astype(np.int32)
        dels = recent.pop(0) if len(recent) >= window else empty
        recent.append(ins)
        q = rng.integers(0, n, size=(queries, 2)).astype(np.int32)
        yield ins, dels, q


def flash_crowd(n: int, *, steps: int = 16, batch: int = 256,
                hub_frac: float = 0.25, queries: int = 64, seed: int = 0):
    """Adversarial churn for the replacement search: the first
    ``hub_frac`` of the steps pile star edges onto one hub (forming one
    giant component whose forest routes through the hub), then the
    remaining steps tear the hub edges back down in chunks — every delete
    batch hits the spanning forest and forces reconnection attempts."""
    rng = np.random.default_rng(seed)
    hub = int(rng.integers(0, n))
    empty = np.zeros((0, 2), np.int32)
    up = max(1, int(steps * hub_frac))
    hub_edges: list = []
    for step in range(steps):
        q = rng.integers(0, n, size=(queries, 2)).astype(np.int32)
        if step < up:
            spokes = rng.integers(0, n, size=(batch,)).astype(np.int32)
            ins = np.stack([np.full((batch,), hub, np.int32), spokes], 1)
            hub_edges.extend(map(tuple, ins.tolist()))
            yield ins, empty, q
        else:
            take = min(len(hub_edges), max(1, batch // 2))
            dels = np.asarray(hub_edges[:take], np.int32).reshape(-1, 2)
            del hub_edges[:take]
            # background inserts keep the insert path busy during teardown
            ins = rng.integers(0, n, size=(batch // 4, 2)).astype(np.int32)
            yield ins, dels, q


def partition_heal(n: int, *, steps: int = 16, batch: int = 256,
                   queries: int = 64, seed: int = 0):
    """Two halves joined by a thin bridge that is repeatedly cut and
    re-laid: odd steps delete every bridge edge (splitting one component
    into two), even steps re-insert bridges plus intra-half edges. Queries
    straddle the cut, so answers flip with the bridge state — the
    partition/heal pattern distributed-systems churn tests use."""
    rng = np.random.default_rng(seed)
    half = n // 2
    empty = np.zeros((0, 2), np.int32)
    bridges: list = []
    for step in range(steps):
        qa = rng.integers(0, half, size=(queries,)).astype(np.int32)
        qb = rng.integers(half, n, size=(queries,)).astype(np.int32)
        q = np.stack([qa, qb], 1)
        if step % 2 == 0:
            a = rng.integers(0, half, size=(batch // 2, 2)).astype(np.int32)
            b = rng.integers(half, n, size=(batch // 2, 2)).astype(np.int32)
            nb = np.stack([rng.integers(0, half, size=(4,)),
                           rng.integers(half, n, size=(4,))], 1).astype(np.int32)
            bridges = nb.tolist()
            yield np.concatenate([a, b, nb]), empty, q
        else:
            dels = np.asarray(bridges, np.int32).reshape(-1, 2)
            bridges = []
            yield empty, dels, q


# ---------------------------------------------------------------------------
# Streamed chunked sources (repro_torch.graphs.ingest): the full edge list
# never exists on the host. Each chunk is drawn from its own counter-based
# generator (``default_rng([seed, chunk_index])``), so a stream is
# reproducible, seekable and O(chunk) resident.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StreamedEdgeSource:
    """ChunkedEdgeSource over a per-chunk generator function."""

    n: int
    total_edges: int
    chunk: int
    make_chunk: Callable[[int, int], np.ndarray]  # (chunk_index, k) → (k, 2)

    @property
    def num_chunks(self) -> int:
        return max(-(-self.total_edges // self.chunk), 1)

    def chunks(self) -> Iterator[np.ndarray]:
        if self.total_edges == 0:
            yield np.zeros((0, 2), np.int32)
            return
        made = 0
        i = 0
        while made < self.total_edges:
            k = min(self.chunk, self.total_edges - made)
            yield self.make_chunk(i, k)
            made += k
            i += 1


def rmat_chunks(n: int, m: int, *, chunk: int = 1 << 20, a: float = 0.5,
                b: float = 0.1, c: float = 0.1,
                seed: int = 0) -> StreamedEdgeSource:
    """Streamed RMAT with the paper's (a, b, c) = (0.5, 0.1, 0.1): the
    quadrant recursion of ``rmat``, one chunk at a time, with threshold
    comparisons in place of ``rng.choice``."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    scale = int(np.ceil(np.log2(max(n, 2))))

    def make(i: int, k: int) -> np.ndarray:
        rng = np.random.default_rng([seed, i])
        src = np.zeros(k, np.int64)
        dst = np.zeros(k, np.int64)
        for level in range(scale):
            r = rng.random(k)
            bit = 1 << (scale - 1 - level)
            # quadrants (a | b / c | d): src bit on for c,d; dst for b,d
            src += np.where(r >= a + b, bit, 0)
            dst += np.where(((r >= a) & (r < a + b)) | (r >= a + b + c),
                            bit, 0)
        src %= n
        dst %= n
        return np.stack([src, dst], 1).astype(np.int32)

    return StreamedEdgeSource(n=n, total_edges=m, chunk=chunk, make_chunk=make)


def powerlaw_chunks(n: int, m: int, *, chunk: int = 1 << 20,
                    seed: int = 0) -> StreamedEdgeSource:
    """Streamed power-law endpoints: both ends log-uniform over ``[0, n)``
    (``floor(n**U)``, p(v) ∝ 1/(v+1)), the hub skew of social and web
    graphs."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")

    def make(i: int, k: int) -> np.ndarray:
        rng = np.random.default_rng([seed, i])
        e = np.floor(n ** rng.random((k, 2))).astype(np.int64) % n
        return e.astype(np.int32)

    return StreamedEdgeSource(n=n, total_edges=m, chunk=chunk, make_chunk=make)
