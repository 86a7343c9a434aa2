"""The single-device app programs behind ``ConnectIt.amsf`` / ``.scan``.

The JAX package keeps these on its ``SingleBackend``
(``repro/core/execution.py``: ``SingleBackend.amsf`` and ``.scan``,
``_fill_amsf_stats``, ``_amsf_coo_host``); the port has one placement, so
they are plain functions here, with the same names and the same stats.
"""

from __future__ import annotations

from ..primitives import init_forest, init_labels
from . import amsf as amsf_impl
from . import scan as scan_impl


def _fill_amsf_stats(stats, nb, rounds, counts, *, size: int,
                     m_real: int) -> None:
    """The AMSF fields of ConnectivityStats after a masked sweep.

    ``edges_finish`` counts finite-weight real edges (each in exactly one
    bucket); every bucket scatters the full ``size`` list once, hence
    ``edges_finish_padded = buckets * size``."""
    nb = int(nb)
    counts = counts.cpu().numpy()
    stats.buckets = nb
    stats.finish_rounds = int(rounds)
    stats.edges_per_bucket = tuple(
        int(c) for c in counts[: min(nb, counts.shape[0])])
    stats.edges_finish = int(counts.sum())
    stats.edges_finish_padded = nb * size
    stats.edges_per_device = (min(m_real, size),)
    stats.dispatch_sizes = (size,)


def _amsf_coo_host(g, weights, app, forest_fn, stats):
    """AMSF-COO: the host's bucket compaction, one dispatch per bucket
    padded to the pow2 buckets of ``driver.bucket_size``."""
    _, fu, fv, nb, rounds, counts, sizes = amsf_impl.amsf_coo_run(
        g, weights, eps=app.eps, forest_fn=forest_fn)
    cap = amsf_impl.STATS_BUCKET_CAP
    if len(counts) > cap:  # fold the overflow as the device histogram does
        counts = counts[: cap - 1] + [sum(counts[cap - 1:])]
    stats.buckets = nb
    stats.finish_rounds = rounds
    stats.edges_per_bucket = tuple(counts)
    stats.edges_finish = sum(counts)
    stats.edges_finish_padded = sum(sizes)
    stats.edges_per_device = (sum(counts),)
    stats.dispatch_sizes = tuple(sizes)
    return fu, fv


def amsf(g, weights, app, forest_fn, *, stats):
    """AMSF of ``g`` under ``app`` (mask or coo mode) → forest slots
    ``(fu, fv)``; fills ``stats``."""
    if app.mode == "coo":
        return _amsf_coo_host(g, weights, app, forest_fn, stats)
    P0 = init_labels(g.n, device=g.device)
    fu0, fv0 = init_forest(g.n, device=g.device)
    _, fu, fv, nb, rounds, counts = amsf_impl.amsf_device(
        P0, fu0, fv0, g.senders, g.receivers, weights,
        eps=app.eps, skip=(app.skip == "lmax"), forest_fn=forest_fn)
    _fill_amsf_stats(stats, nb, rounds, counts, size=g.m_pad, m_real=g.m)
    return fu, fv


def scan(g, sims, app, finish_fn, stats):
    """GS*-Query of ``g`` at ``app``'s (eps, mu) → ``(labels, is_core)``;
    fills ``stats``."""
    labels, is_core, rounds, edges_core = scan_impl.gs_query_device(
        g.senders, g.receivers, g.edge_mask, sims, eps=app.eps,
        mu=app.mu, finish_fn=finish_fn, n=g.n)
    stats.finish_rounds = int(rounds)
    stats.edges_finish = int(edges_core)
    stats.edges_finish_padded = g.m_pad
    stats.edges_per_device = (int(edges_core),)
    stats.dispatch_sizes = (g.m_pad,)
    return labels, is_core


