"""ConnectIt two-phase driver (paper Algorithm 1).

``run_connectivity(g, sampler_fn, finish_fn, generator)`` is the
orchestrator behind ``repro_torch.api.ConnectIt``:

  1. run the sampling phase → partial labeling P
  2. identify L_max (most frequent label) and pin it to the virtual minimum
     label -1 (Theorem 4's "smallest possible ID" relabeling)
  3. *compact* the finish-phase edge list: edges internal to L_max are
     dropped (the paper's m - X + Y edge saving), on the graph's device,
     keeping edge order
  4. run the finish phase on the compacted edges
  5. compress + restore -1 → canonical min-vertex-id labels

``run_connectivity_fused`` skips the compaction: L_max-internal edges stay
in the list as no-ops under write_min. Both paths fill the same
``ConnectivityStats``.

``run_spanning_forest`` is paper Algorithm 2: the same steps with a
root-based finish that records one forest edge per hooked root, seeded with
the sampler's partial forest.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from ..graphs.containers import Graph, round_up
from .finish import resolve_finish, uf_sync_forest
from .primitives import (
    full_compress,
    init_labels,
    min_vertex_labels,
    most_frequent,
    relabel_lmax,
    restore_lmax,
)
from .sampling import resolve_sampler


@dataclasses.dataclass
class ConnectivityStats:
    """Paper Figure 2 quantities; the fields of the JAX package's stats.

    ``edges_finish`` is the number of *real* directed edges handed to the
    finish phase (``edges_total`` when nothing was dropped), and
    ``edges_finish_padded`` the padded finish-phase dispatch size."""

    variant: str = ""          # canonical VariantSpec string
    exec: str = "single"       # canonical ExecutionSpec string
    placement: str = "single"  # single | replicated | sharded
    devices: int = 1           # devices the dispatch ran on
    edges_total: int = 0       # real directed edges in the input graph
    edges_finish: int = 0      # real directed edges processed by finish
    edges_finish_padded: int = 0  # padded finish-phase dispatch size
    edges_per_device: tuple = ()  # real finish edges per edge shard
    dispatch_sizes: tuple = ()    # padded dispatch size per edge shard
    batch_shapes: tuple = ()      # streams: distinct batch shapes
    lmax_count: int = 0        # vertices in L_max after sampling (0 = none)
    finish_rounds: int = 0     # (outer) rounds the finish phase ran
    fused: bool = False        # single: no host compaction
    app: str = ""              # canonical AppSpec string ("" for core paths)
    buckets: int = 0           # AMSF: weight buckets swept
    edges_per_bucket: tuple = ()  # AMSF: in-bucket candidate edges
    chunks: int = 0            # chunked ingest: edge chunks streamed
    spills: int = 0            # chunked ingest: survivor-buffer flushes
    survivor_ratio: float = 0.0  # chunked ingest: survivors / real edges


def _finish_phase(P, senders, receivers, finish_fn):
    P, rounds = finish_fn(P, senders, receivers)
    P = full_compress(P)
    return min_vertex_labels(restore_lmax(P)), rounds


def _prep_sampled(P, senders, receivers):
    n = P.shape[0] - 1
    P = full_compress(P)
    lmax, cnt = most_frequent(P)
    # drop L_max-internal edges AND the dump-slot padding (senders == n) so
    # the compacted list — and edges_finish — counts real edges only
    s, r = senders.long(), receivers.long()
    keep = ~((P[s] == lmax) & (P[r] == lmax)) & (senders < n)
    return relabel_lmax(P, lmax), keep, lmax, cnt


def bucket_size(k: int, *, pad: str = "pow2", pad_multiple: int = 8,
                shards: int = 1, floor: int = 8) -> int:
    """Static dispatch size for ``k`` real elements under a pad policy.

    ``pow2`` buckets to the next power of two (at least ``floor``);
    ``multiple`` rounds up to ``pad_multiple``. The result is always a
    positive multiple of ``shards``."""
    k = max(int(k), 1)
    if pad == "pow2":
        size = max(floor, 1 << (k - 1).bit_length())
    else:
        size = max(round_up(k, pad_multiple), pad_multiple)
    return round_up(size, shards)


def _per_chunk_counts(k: int, size: int, shards: int) -> tuple:
    """Real-element count per contiguous shard chunk of a padded dispatch
    whose first ``k`` slots are real (padding is always a suffix)."""
    per = size // shards
    return tuple(max(min((i + 1) * per, k) - i * per, 0)
                 for i in range(shards))


def _compact(senders, receivers, keep, n_dump: int, pad_multiple: int = 8,
             pad: str = "multiple"):
    """Kept edges in their order, padded with dump-slot edges."""
    s = senders[keep]
    r = receivers[keep]
    kept = int(s.shape[0])
    m_pad = bucket_size(kept, pad=pad, pad_multiple=pad_multiple)
    s_out = torch.full((m_pad,), n_dump, dtype=torch.int32, device=s.device)
    r_out = torch.full((m_pad,), n_dump, dtype=torch.int32, device=s.device)
    s_out[:kept] = s
    r_out[:kept] = r
    return s_out, r_out, kept


def _default_generator(g: Graph, generator):
    if generator is None:
        generator = torch.Generator(device=g.device)
        generator.manual_seed(0)
    return generator


def run_connectivity(
    g: Graph,
    sampler_fn: Optional[Callable],
    finish_fn: Callable,
    generator: Optional[torch.Generator] = None,
    *,
    variant: str = "",
    compact_pad: int = 8,
    pad: str = "multiple",
) -> tuple[torch.Tensor, ConnectivityStats]:
    """Two-phase connectivity on resolved callables → (labels, stats).

    ``compact_pad``/``pad`` set the padding of the compacted finish-phase
    edge list (see ``bucket_size``)."""
    stats = ConnectivityStats(variant=variant, edges_total=g.m)
    if sampler_fn is None:
        P = init_labels(g.n, device=g.device)
        senders, receivers = g.senders, g.receivers
        stats.edges_finish = g.m
        stats.edges_finish_padded = g.m_pad
    else:
        P = sampler_fn(g, _default_generator(g, generator))
        P, keep, _, cnt = _prep_sampled(P, g.senders, g.receivers)
        senders, receivers, kept = _compact(g.senders, g.receivers, keep, g.n,
                                            compact_pad, pad)
        stats.lmax_count = int(cnt)
        stats.edges_finish = kept
        stats.edges_finish_padded = int(senders.shape[0])
    P, rounds = _finish_phase(P, senders, receivers, finish_fn)
    stats.finish_rounds = int(rounds)
    stats.edges_per_device = (stats.edges_finish,)
    stats.dispatch_sizes = (stats.edges_finish_padded,)
    return P[: g.n], stats


def run_connectivity_fused(
    g: Graph,
    sampler_fn: Optional[Callable],
    finish_fn: Callable,
    generator: Optional[torch.Generator] = None,
    *,
    variant: str = "",
) -> tuple[torch.Tensor, ConnectivityStats]:
    """Connectivity with no compaction → (labels, stats)."""
    stats = ConnectivityStats(variant=variant, edges_total=g.m, fused=True,
                              edges_finish=g.m, edges_finish_padded=g.m_pad)
    if sampler_fn is None:
        P = init_labels(g.n, device=g.device)
    else:
        P = full_compress(sampler_fn(g, _default_generator(g, generator)))
        lmax, cnt = most_frequent(P)
        P = relabel_lmax(P, lmax)
        stats.lmax_count = int(cnt)
    P, rounds = _finish_phase(P, g.senders, g.receivers, finish_fn)
    stats.finish_rounds = int(rounds)
    stats.edges_per_device = (stats.edges_finish,)
    stats.dispatch_sizes = (stats.edges_finish_padded,)
    return P[: g.n], stats


def forest_edges(fu: torch.Tensor, fv: torch.Tensor) -> np.ndarray:
    """Compact forest slots to a host ``(k, 2)`` int32 edge array."""
    fu_np, fv_np = fu.cpu().numpy(), fv.cpu().numpy()
    sel = (fu_np >= 0) & (fv_np >= 0)
    return np.stack([fu_np[sel], fv_np[sel]], 1)


def run_spanning_forest(
    g: Graph,
    sampler_fn: Optional[Callable],
    generator: Optional[torch.Generator] = None,
    *,
    compress: str = "full",
    variant: str = "",
    compact_pad: int = 8,
    pad: str = "multiple",
) -> tuple[np.ndarray, ConnectivityStats]:
    """Spanning forest via a root-based finish (paper Algorithm 2) → (host
    ``(k, 2)`` forest edges, stats). With a sampler, its partial forest
    seeds the finish, which runs on the compacted edges; padding changes no
    real edge's id."""
    stats = ConnectivityStats(variant=variant, edges_total=g.m)
    if sampler_fn is None:
        P = init_labels(g.n, device=g.device)
        st, rounds = uf_sync_forest(P, g.senders, g.receivers,
                                    compress=compress)
        stats.edges_finish = g.m
        stats.edges_finish_padded = g.m_pad
    else:
        st0 = sampler_fn(g, _default_generator(g, generator),
                         want_forest=True)
        P, keep, _, cnt = _prep_sampled(st0.P, g.senders, g.receivers)
        senders, receivers, kept = _compact(g.senders, g.receivers, keep, g.n,
                                            compact_pad, pad)
        st, rounds = uf_sync_forest(P, senders, receivers, st0.fu, st0.fv,
                                    compress=compress)
        stats.lmax_count = int(cnt)
        stats.edges_finish = kept
        stats.edges_finish_padded = int(senders.shape[0])
    stats.finish_rounds = int(rounds)
    stats.edges_per_device = (stats.edges_finish,)
    stats.dispatch_sizes = (stats.edges_finish_padded,)
    return forest_edges(st.fu, st.fv), stats


# ---------------------------------------------------------------------------
# Legacy string-keyed entrypoints (deprecation shims over the impl above).
# ---------------------------------------------------------------------------

_DEPRECATION = ("%s with flat string keys is deprecated; build a "
                "repro_torch.api.VariantSpec and use repro_torch.api.ConnectIt "
                "instead")


def connectivity(
    g: Graph,
    *,
    sample: Optional[str] = None,
    finish: str = "uf_sync",
    generator: Optional[torch.Generator] = None,
    return_stats: bool = False,
):
    """Deprecated: use ``repro_torch.api.ConnectIt(spec).connectivity(g)``.
    ``generator`` stands in for the reference's ``key``."""
    warnings.warn(_DEPRECATION % "connectivity(g, sample=..., finish=...)",
                  DeprecationWarning, stacklevel=2)
    sampler_fn = None if sample is None else resolve_sampler(sample)
    labels, stats = run_connectivity(
        g, sampler_fn, resolve_finish(finish), generator,
        variant=f"{sample or 'none'}+{finish}")
    if return_stats:
        return labels, stats
    return labels


def connectivity_fused(P, senders, receivers, finish: str = "uf_sync",
                       use_sampling_relabel: bool = False):
    """Deprecated single-dispatch connectivity on a (pre-sampled) labeling
    → ``(P, rounds)``, ``P`` the ``(n + 1,)`` min-vertex-id canonical labels.
    ``run_connectivity_fused`` (or ``ConnectIt(spec).connectivity(g,
    fused=True)``) is the replacement."""
    warnings.warn(_DEPRECATION % "connectivity_fused(..., finish=...)",
                  DeprecationWarning, stacklevel=2)
    if use_sampling_relabel:
        P = full_compress(P)
        lmax, _ = most_frequent(P)
        P = relabel_lmax(P, lmax)
    return _finish_phase(P, senders, receivers, resolve_finish(finish))


def spanning_forest(
    g: Graph,
    *,
    sample: Optional[str] = None,
    generator: Optional[torch.Generator] = None,
) -> np.ndarray:
    """Deprecated: use ``repro_torch.api.ConnectIt(spec).spanning_forest(g)``
    → the host ``(k, 2)`` forest edges."""
    warnings.warn(_DEPRECATION % "spanning_forest(g, sample=...)",
                  DeprecationWarning, stacklevel=2)
    sampler_fn = None if sample is None else resolve_sampler(sample)
    return run_spanning_forest(g, sampler_fn, generator)[0]


def connected_components(g: Graph, **kw) -> np.ndarray:
    """Convenience: numpy canonical labels (delegates to the legacy shim)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return connectivity(g, **kw).cpu().numpy()
