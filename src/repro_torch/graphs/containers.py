"""Dense graph container for PyTorch.

Conventions (the same as the JAX package's ``repro.graphs.containers``):
  * Vertices are ``0..n-1``. A *dump vertex* with id ``n`` absorbs padded
    edges: label arrays over vertices have ``n + 1`` rows, so scatters from
    padded edges are harmless.
  * Edge lists are COO ``(senders, receivers)`` int32 tensors padded to
    ``m_pad`` with the sentinel ``n`` at both endpoints.
  * Undirected graphs store each edge in both directions (the paper counts
    directed edges; symmetrization happens at build time).
  * CSR (``indptr``, ``indices``) is carried beside COO for per-vertex edge
    selection (k-out sampling).

Storage is int32 throughout; indices widen to int64 only at each torch
indexing call.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device

INT32_MAX = np.iinfo(np.int32).max


@dataclasses.dataclass(frozen=True)
class Graph:
    """COO + CSR static graph. All tensors live on one device."""

    senders: torch.Tensor    # (m_pad,) int32, sentinel = n for padding
    receivers: torch.Tensor  # (m_pad,) int32
    indptr: torch.Tensor     # (n + 2,) int32 CSR offsets (row n = dump, empty)
    indices: torch.Tensor    # (m_pad,) int32 CSR column ids, sentinel-padded
    n: int
    m: int                   # real directed edges

    @property
    def m_pad(self) -> int:
        return self.senders.shape[0]

    @property
    def device(self) -> torch.device:
        return self.senders.device

    @property
    def edge_mask(self) -> torch.Tensor:
        return torch.arange(self.m_pad, device=self.device) < self.m

    def degrees(self) -> torch.Tensor:
        return self.indptr[1:] - self.indptr[:-1]  # (n + 1,), dump row last


def round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def sort_dedup_edges(edges, n: int, *, symmetrize: bool = True,
                     dedup: bool = True,
                     device=DEFAULT_DEVICE) -> torch.Tensor:
    """Self-loop drop + symmetrize + one sort-based dedup pass → sorted
    ``(k, 2)`` int32 directed edges on ``device``.

    The sort runs on the device over the int64 key ``s * (n + 1) + r``,
    which orders edges by (sender, receiver) exactly as a lexsort does.
    Raises instead of silently wrapping when vertex ids or the directed
    edge count would overflow int32."""
    dev = resolve_device(device)
    if n >= INT32_MAX:
        raise ValueError(f"n={n} does not fit int32 vertex ids")
    edges = np.asarray(edges)
    if edges.dtype != np.int32:
        if edges.size and (edges.min() < np.iinfo(np.int32).min
                           or edges.max() > INT32_MAX):
            raise ValueError("edge endpoints overflow int32")
        edges = edges.astype(np.int32)
    e = torch.from_numpy(np.ascontiguousarray(edges.reshape(-1, 2))).to(dev)
    e = e[e[:, 0] != e[:, 1]]  # drop self loops
    k = int(e.shape[0])
    if (2 * k if symmetrize else k) > INT32_MAX:
        raise ValueError(
            f"{2 * k if symmetrize else k} directed edges overflow the int32 "
            f"edge indexing (m must stay < 2^31)")
    s, r = e[:, 0].long(), e[:, 1].long()
    del e
    if symmetrize:
        s, r = torch.cat([s, r]), torch.cat([r, s])
    key = torch.sort(s * (n + 1) + r).values
    del s, r
    if dedup:
        key = torch.unique_consecutive(key)
    return torch.stack([key // (n + 1), key % (n + 1)], 1).to(torch.int32)


def _padded(x: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    out = torch.full((size,), fill, dtype=torch.int32, device=x.device)
    out[: x.shape[0]] = x
    return out


def build_graph(edges, n: int, *, symmetrize: bool = True, dedup: bool = True,
                pad_multiple: int = 8, device=DEFAULT_DEVICE) -> Graph:
    """Build a Graph on ``device`` from a host-side (k, 2) int array of
    undirected edges."""
    edges = sort_dedup_edges(edges, n, symmetrize=symmetrize, dedup=dedup,
                             device=device)
    m = int(edges.shape[0])
    m_pad = max(round_up(m, pad_multiple), pad_multiple)
    senders = _padded(edges[:, 0], m_pad, n)
    receivers = _padded(edges[:, 1], m_pad, n)
    counts = torch.bincount(edges[:, 0].long(), minlength=n + 1)
    indptr = torch.zeros((n + 2,), dtype=torch.int32, device=senders.device)
    indptr[1:] = torch.cumsum(counts, 0)
    # sorted by sender, so the padded receivers are the CSR columns
    return Graph(senders=senders, receivers=receivers, indptr=indptr,
                 indices=receivers, n=n, m=m)


def graph_from_arrays(senders, receivers, indptr, indices, n: int, m: int, *,
                      device=DEFAULT_DEVICE) -> Graph:
    """A Graph from another container's arrays (e.g. a JAX ``Graph``'s,
    taken as numpy), verbatim: no re-sort, no re-padding."""
    dev = resolve_device(device)

    def t(x):
        return torch.from_numpy(np.asarray(x, dtype=np.int32).copy()).to(dev)

    return Graph(senders=t(senders), receivers=t(receivers), indptr=t(indptr),
                 indices=t(indices), n=int(n), m=int(m))


def to_numpy_edges(g: Graph) -> np.ndarray:
    s = g.senders[: g.m].cpu().numpy()
    r = g.receivers[: g.m].cpu().numpy()
    return np.stack([s, r], axis=1)


def components_oracle(g: Graph) -> np.ndarray:
    """Host-side oracle labels: component id = min vertex id in component,
    from scipy's ``connected_components``."""
    if g.m == 0:
        return np.arange(g.n, dtype=np.int64)
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components as scipy_cc
    s, r = to_numpy_edges(g).T
    mat = csr_matrix((np.ones(len(s), dtype=np.int8), (s, r)),
                     shape=(g.n, g.n))
    _, lab = scipy_cc(mat, directed=False)
    reps = np.full(int(lab.max()) + 1 if g.n else 1, g.n, dtype=np.int64)
    np.minimum.at(reps, lab, np.arange(g.n))
    return reps[lab]
