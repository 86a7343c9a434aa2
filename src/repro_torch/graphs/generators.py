"""Host-side synthetic graph generators (numpy) → Graph containers on a device.

The edges are drawn with numpy exactly as the JAX package's
``repro.graphs.generators`` draws them, so one seed gives one edge list in
both packages; only the container is built on ``device``.
"""

from __future__ import annotations

import numpy as np

from ..device import DEFAULT_DEVICE
from .containers import Graph, build_graph


def rmat_edges(n: int, m: int, *, a: float = 0.5, b: float = 0.1,
               c: float = 0.1, seed: int = 0) -> np.ndarray:
    """The ``(m, 2)`` int64 RMAT edge list before symmetrization/dedup."""
    rng = np.random.default_rng(seed)
    scale = int(np.ceil(np.log2(max(n, 2))))
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    d = 1.0 - a - b - c
    p = np.array([a, b, c, d])
    for level in range(scale):
        quad = rng.choice(4, size=m, p=p)
        bit = 1 << (scale - 1 - level)
        src += np.where((quad == 2) | (quad == 3), bit, 0)
        dst += np.where((quad == 1) | (quad == 3), bit, 0)
    src %= n
    dst %= n
    return np.stack([src, dst], 1)


def rmat(n: int, m: int, *, a: float = 0.5, b: float = 0.1, c: float = 0.1,
         seed: int = 0, device=DEFAULT_DEVICE) -> Graph:
    """RMAT generator with paper parameters (a,b,c) = (0.5, 0.1, 0.1)."""
    return build_graph(rmat_edges(n, m, a=a, b=b, c=c, seed=seed), n,
                       device=device)


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
