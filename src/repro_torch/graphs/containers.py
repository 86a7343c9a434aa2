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

Two containers exist beside the dense ``Graph`` for the out-of-core path
(``repro_torch.graphs.ingest``), as in the JAX package:

  * ``ChunkedEdgeSource`` — what chunked ingest consumes: an ``n`` and a
    ``chunks()`` iterator of ``(k, 2)`` edge arrays. ``ArrayEdgeSource``
    wraps an in-memory (or memory-mapped) edge array; the streamed
    generators and ``CompressedEdgeBlocks`` never hold the whole list.
  * ``CompressedEdgeBlocks`` — sorted edge blocks with byte-wide sender
    deltas and int16 receiver deltas, patched by exception lists, plus a
    block directory. The blocks are built with numpy on the host, byte for
    byte the JAX package's; each decodes on its device (``decode_block``).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Protocol, runtime_checkable

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
    ``(k, 2)`` int32 directed edges on ``device``. ``edges`` is a host
    ``(k, 2)`` int array or a tensor.

    The sort runs on the device over the int64 key ``s * (n + 1) + r``,
    which orders edges by (sender, receiver) exactly as a lexsort does.
    Raises instead of silently wrapping when vertex ids or the directed
    edge count would overflow int32."""
    dev = resolve_device(device)
    if n >= INT32_MAX:
        raise ValueError(f"n={n} does not fit int32 vertex ids")
    if not isinstance(edges, torch.Tensor):
        edges = np.asarray(edges)
        if edges.dtype.kind == "u":  # torch reduces no wide unsigned type:
            # widened, clipped just past int32 so the check below still fails
            edges = np.minimum(edges, INT32_MAX + 1).astype(np.int64)
        edges = torch.from_numpy(np.ascontiguousarray(edges))
    # a device chunk (a decoded compressed block) stays on its device
    e = edges.reshape(-1, 2)
    if e.dtype != torch.int32:
        if e.numel() and (int(e.min()) < np.iinfo(np.int32).min
                          or int(e.max()) > INT32_MAX):
            raise ValueError("edge endpoints overflow int32")
        e = e.to(torch.int32)
    e = e.to(dev)
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


# ---------------------------------------------------------------------------
# Out-of-core containers (repro_torch.graphs.ingest): the scale path.
# ---------------------------------------------------------------------------


@runtime_checkable
class ChunkedEdgeSource(Protocol):
    """Anything chunked ingest can consume: ``n`` vertices plus an iterator
    of ``(k, 2)`` edge arrays (numpy arrays or tensors, any int dtype;
    endpoints in ``[0, n)``). Chunks may be any size and need not be sorted
    or deduped; the full edge list never has to exist at once.
    ``total_edges`` is an optional count hint."""

    n: int

    def chunks(self) -> Iterator:
        ...


@dataclasses.dataclass(frozen=True)
class ArrayEdgeSource:
    """ChunkedEdgeSource over an in-memory (or memory-mapped) edge array:
    the bridge between the one-shot and chunked paths, and the reader of
    ``np.memmap``-backed edge files."""

    edges: np.ndarray  # (m, 2) int array (np.memmap works: slices stay lazy)
    n: int
    chunk: int = 1 << 20

    def __post_init__(self):
        if self.chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {self.chunk}")

    @property
    def total_edges(self) -> int:
        return int(self.edges.shape[0])

    @property
    def num_chunks(self) -> int:
        return max(-(-self.total_edges // self.chunk), 1)

    def chunks(self) -> Iterator[np.ndarray]:
        m = self.total_edges
        if m == 0:
            yield np.zeros((0, 2), np.int32)
            return
        for lo in range(0, m, self.chunk):
            yield np.asarray(self.edges[lo: lo + self.chunk])


def open_edge_file(path: str, n: int, *, chunk: int = 1 << 20
                   ) -> ArrayEdgeSource:
    """Memory-mapped ChunkedEdgeSource over a raw int32 ``(m, 2)`` edge
    file (see ``write_edge_file``): chunks are read from disk lazily."""
    mm = np.memmap(path, dtype=np.int32, mode="r")
    if mm.shape[0] % 2:
        raise ValueError(f"{path}: odd element count, not an (m, 2) edge file")
    return ArrayEdgeSource(mm.reshape(-1, 2), n, chunk=chunk)


def write_edge_file(path: str, source: "ChunkedEdgeSource") -> int:
    """Stream a ChunkedEdgeSource to a raw int32 ``(m, 2)`` edge file, one
    chunk at a time. Returns the number of edges written."""
    total = 0
    with open(path, "wb") as f:
        for c in source.chunks():
            if isinstance(c, torch.Tensor):
                c = c.cpu().numpy()
            arr = np.ascontiguousarray(np.asarray(c, dtype=np.int32))
            f.write(arr.tobytes())
            total += arr.shape[0]
    return total


_DS_ESCAPE = 255          # uint8 sender-delta escape -> exception list
_DR_ESCAPE = -(1 << 15)   # int16 receiver-delta escape -> exception list


@dataclasses.dataclass(frozen=True, eq=False)
class CompressedEdgeBlocks:
    """Sorted edge blocks with delta-encoded ids and a block directory.

    Edges are sorted by (sender, receiver) and split into fixed-size blocks.
    Within a block both columns are delta coded against the previous edge:
    senders as uint8, receivers as int16. A delta that overflows its narrow
    type holds an escape code, and the true delta sits in a per-block
    exception list (patched frame-of-reference). The directory carries
    each block's first edge and real length, so any block decodes alone:
    on ``device``, as two scatter-patched cumsums (``decode_block``).

    At ~3 bytes an edge against 8 for int32 COO, and the block iterator
    makes it a ``ChunkedEdgeSource`` whose chunks are tensors on
    ``device``."""

    n: int
    m: int                    # real encoded edges (directed as given)
    block_size: int           # edges per block (last block ragged)
    ds: np.ndarray            # (nb, B) uint8 sender deltas (escape 255)
    dr: np.ndarray            # (nb, B) int16 receiver deltas (escape -2^15)
    first_s: np.ndarray       # (nb,) int32 first sender per block
    first_r: np.ndarray       # (nb,) int32 first receiver per block
    block_len: np.ndarray     # (nb,) int32 real edges per block
    exc_s_pos: np.ndarray     # (Es,) int32 within-block sender-exception pos
    exc_s_val: np.ndarray     # (Es,) int32 true sender deltas at exceptions
    exc_s_start: np.ndarray   # (nb + 1,) int32 per-block offsets into exc_s_*
    exc_r_pos: np.ndarray     # (Er,) int32 within-block receiver-exception pos
    exc_r_val: np.ndarray     # (Er,) int32 true receiver deltas at exceptions
    exc_r_start: np.ndarray   # (nb + 1,) int32 per-block offsets into exc_r_*
    device: torch.device = DEFAULT_DEVICE  # where blocks decode

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    @property
    def num_blocks(self) -> int:
        return int(self.ds.shape[0])

    @property
    def nbytes(self) -> int:
        """Compressed footprint (all arrays)."""
        return sum(a.nbytes for a in (
            self.ds, self.dr, self.first_s, self.first_r, self.block_len,
            self.exc_s_pos, self.exc_s_val, self.exc_s_start,
            self.exc_r_pos, self.exc_r_val, self.exc_r_start))

    @property
    def ratio(self) -> float:
        """Compression ratio against int32 COO (8 bytes an edge)."""
        return (8.0 * self.m / self.nbytes) if self.nbytes else 0.0

    @property
    def total_edges(self) -> int:
        return self.m

    def _exc_slice(self, start, pos, val, i: int):
        lo, hi = int(start[i]), int(start[i + 1])
        cap = _exc_bucket(hi - lo, self.block_size)
        p = np.full((cap,), self.block_size, np.int32)  # pad -> patch no slot
        v = np.zeros((cap,), np.int32)
        p[: hi - lo] = pos[lo:hi]
        v[: hi - lo] = val[lo:hi]
        return (torch.from_numpy(p).to(self.device),
                torch.from_numpy(v).to(self.device))

    def decode_block(self, i: int):
        """Decode block ``i`` → (senders, receivers) int32 tensors on
        ``device`` of length ``block_size``, dump-padded (``n``) past the
        block's real length."""
        sp, sv = self._exc_slice(self.exc_s_start, self.exc_s_pos,
                                 self.exc_s_val, i)
        rp, rv = self._exc_slice(self.exc_r_start, self.exc_r_pos,
                                 self.exc_r_val, i)
        ds = torch.from_numpy(self.ds[i]).to(self.device)
        dr = torch.from_numpy(self.dr[i]).to(self.device)
        return decode_block(ds, dr, sp, sv, rp, rv, int(self.first_s[i]),
                            int(self.first_r[i]), int(self.block_len[i]),
                            self.n)

    def chunks(self) -> Iterator[torch.Tensor]:
        for i in range(self.num_blocks):
            s, r = self.decode_block(i)
            k = int(self.block_len[i])
            yield torch.stack([s[:k], r[:k]], 1)


def _exc_bucket(k: int, block_size: int) -> int:
    """Pow2 bucket for a block's exception count (at least 8, at most the
    block size), the padded length of its exception lists."""
    return min(max(8, 1 << (max(k, 1) - 1).bit_length()), block_size)


def decode_block(ds_u8: torch.Tensor, dr16: torch.Tensor, sp, sv, rp, rv,
                 first_s: int, first_r: int, blen: int, n: int):
    """One block's (senders, receivers), int32 on the deltas' device: widen
    the deltas, scatter the true deltas over the escape slots (exception
    positions padded with ``B`` land in a dropped tail slot), then two
    cumsums from the block's first edge; slots past ``blen`` hold ``n``."""
    B = ds_u8.shape[0]
    dev = ds_u8.device

    def patched(d, pos, val):
        out = torch.zeros((B + 1,), dtype=torch.int32, device=dev)
        out[:B] = d.to(torch.int32)
        out[pos.long()] = val
        return out[:B]

    senders = first_s + torch.cumsum(patched(ds_u8, sp, sv), 0,
                                     dtype=torch.int32)
    receivers = first_r + torch.cumsum(patched(dr16, rp, rv), 0,
                                       dtype=torch.int32)
    live = torch.arange(B, device=dev) < blen
    return (torch.where(live, senders, n).to(torch.int32),
            torch.where(live, receivers, n).to(torch.int32))


def _delta_exceptions(d: np.ndarray, exc: np.ndarray, escape: int, dtype):
    """Split per-block deltas into a narrow array (escape code at overflow
    positions) plus flat (pos, val, start) exception lists."""
    nb = d.shape[0]
    out = np.where(exc, escape, d).astype(dtype)
    bi, bj = np.nonzero(exc)
    start = np.zeros((nb + 1,), np.int32)
    start[1:] = np.cumsum(np.bincount(bi, minlength=nb))
    return out, bj.astype(np.int32), d[bi, bj].astype(np.int32), start


def compress_edges(edges, n: int, *, block_size: int = 1 << 16,
                   symmetrize: bool = False, dedup: bool = True,
                   device=DEFAULT_DEVICE) -> CompressedEdgeBlocks:
    """Sort + delta-encode a host edge array into ``CompressedEdgeBlocks``
    whose blocks decode on ``device``.

    The sort is ``sort_dedup_edges`` on the CPU (the key ``s * (n + 1) + r``
    orders edges as a (sender, receiver) lexsort does), the encoding numpy:
    every array equals the JAX package's. ``symmetrize=False`` (default)
    encodes each input pair once, as ingest sources want."""
    if block_size < 2:
        raise ValueError(f"block_size must be >= 2, got {block_size}")
    edges = sort_dedup_edges(edges, n, symmetrize=symmetrize, dedup=dedup,
                             device="cpu").numpy()
    m = int(edges.shape[0])
    B = int(block_size)
    nb = max(-(-m // B), 1)
    s = np.zeros((nb * B,), np.int32)
    r = np.zeros((nb * B,), np.int32)
    s[:m] = edges[:, 0]
    r[:m] = edges[:, 1]
    if m:  # pad tail repeats the last edge: deltas 0, sliced off by block_len
        s[m:] = s[m - 1]
        r[m:] = r[m - 1]
    s2 = s.reshape(nb, B)
    r2 = r.reshape(nb, B)
    ds = np.zeros((nb, B), np.int64)
    ds[:, 1:] = s2[:, 1:].astype(np.int64) - s2[:, :-1]
    dr = np.zeros((nb, B), np.int64)
    dr[:, 1:] = r2[:, 1:].astype(np.int64) - r2[:, :-1]
    ds_out, s_pos, s_val, s_start = _delta_exceptions(
        ds, ds >= _DS_ESCAPE, _DS_ESCAPE, np.uint8)
    dr_out, r_pos, r_val, r_start = _delta_exceptions(
        dr, (dr <= _DR_ESCAPE) | (dr > np.iinfo(np.int16).max),
        _DR_ESCAPE, np.int16)
    lens = np.full((nb,), B, np.int32)
    lens[-1] = m - (nb - 1) * B  # 0 for the empty-edge single block
    return CompressedEdgeBlocks(
        n=n, m=m, block_size=B,
        ds=ds_out, dr=dr_out,
        first_s=s2[:, 0].copy(), first_r=r2[:, 0].copy(),
        block_len=lens,
        exc_s_pos=s_pos, exc_s_val=s_val, exc_s_start=s_start,
        exc_r_pos=r_pos, exc_r_val=r_val, exc_r_start=r_start,
        device=device)


def compress_graph(g: Graph, *, block_size: int = 1 << 16
                   ) -> CompressedEdgeBlocks:
    """Compress a dense ``Graph``'s (sorted, symmetrized) edge list into
    blocks that decode on the graph's device."""
    return compress_edges(to_numpy_edges(g), g.n, block_size=block_size,
                          symmetrize=False, dedup=False, device=g.device)
