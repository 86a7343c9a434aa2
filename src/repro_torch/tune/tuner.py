"""The tuner: sweep the (variant × block size) grid on the session's
device and persist the winners in the selection cache.

Three entry points, the reference's (``repro/tune/tuner.py``), each cheap
to call again (winners persist):

* ``tune_block_m`` — per primitive, the threads a block of its CUDA kernel
  over the tuner's ladder, whose one point is the size the kernels are
  built for (256); the winners feed ``kernels.ops.tuned_block_m``.
* ``tune_variant`` — times candidate variants end to end on one graph;
  the winner is recorded under the graph's family fingerprint and resolves
  ``ConnectIt("auto", ...)`` for every later graph of that family.
* ``tune_families`` — the CLI's driver: proxy graphs per synthetic family,
  the variant winner per family, and the device-global (``"*"``) winner by
  majority vote across families.

Resolution (``resolve_variant`` / ``resolve_block_m``) measures nothing and
never fails on the cache's content: a cold cache gives the paper's
recommended default (``kout_hybrid_k2+uf_sync_full``, §5 guidance) and 256
threads a block, and a corrupt winner is skipped.

On a mesh placement (``exec`` not ``single``) every rank times every
candidate, since a candidate's collectives need all ranks; the times are
reduced with ``pmax`` over the mesh before the argmin, so that every rank
elects the same winner, and only the mesh's origin rank (coordinate 0 on
every axis) writes the cache.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from .. import random as trandom
from ..device import DEFAULT_DEVICE
from ..kernels.ops import DEFAULT_BLOCK_M
from .cache import SelectionCache, default_cache, fingerprint_graph, make_key
from .harness import PRIMITIVES, primitive_drivers, time_fn
from .space import BLOCK_M_FULL, TuneSpec, TuneSpecLike, as_tune_spec

__all__ = [
    "PAPER_DEFAULT_VARIANT", "DEFAULT_BLOCK_M", "resolve_variant",
    "resolve_block_m", "tune_block_m", "tune_variant", "tune_families",
]

# §5 guidance: k-out sampling (hybrid, k=2) + union-find with full path
# compression is the paper's recommended default across inputs
PAPER_DEFAULT_VARIANT = "kout_hybrid_k2+uf_sync_full"


def _valid_variant(text) -> Optional[str]:
    from ..api import VariantSpec  # lazy: api imports this module
    if not isinstance(text, str) or text.strip().lower() == "auto":
        return None
    try:
        return str(VariantSpec.parse(text))
    except ValueError:
        return None


def resolve_variant(family: Optional[str] = None, *,
                    cache: Optional[SelectionCache] = None,
                    device=DEFAULT_DEVICE) -> str:
    """The ``auto`` variant for a graph family on ``device``: the family's
    winner > the device-global (``"*"``) winner > the paper default. A pure
    lookup: it never tunes."""
    cache = default_cache() if cache is None else cache
    for fam in ([family] if family and family != "*" else []) + ["*"]:
        winner = _valid_variant(
            cache.winner(make_key("variant", fam, device=device)))
        if winner is not None:
            return winner
    return PAPER_DEFAULT_VARIANT


def resolve_block_m(primitive: str, *, default: int = DEFAULT_BLOCK_M,
                    cache: Optional[SelectionCache] = None,
                    device=DEFAULT_DEVICE) -> int:
    """The tuned threads a block of one primitive's kernel on ``device``:
    the cached winner where it is on the ladder (``BLOCK_M_FULL``), else
    ``default``."""
    cache = default_cache() if cache is None else cache
    winner = cache.winner(make_key(f"block_m:{primitive}", device=device))
    try:
        v = int(winner)
    except (TypeError, ValueError):
        return default
    return v if v in BLOCK_M_FULL else default


# ---------------------------------------------------------------------------
# Tuning sweeps.
# ---------------------------------------------------------------------------

def tune_block_m(spec: TuneSpecLike = TuneSpec(), *,
                 cache: Optional[SelectionCache] = None,
                 n: int = 1 << 12, m: Optional[int] = None,
                 primitives: Optional[Sequence[str]] = None,
                 timer: Optional[Callable[[], float]] = None,
                 seed: int = 0, device=DEFAULT_DEVICE) -> list:
    """Sweep the block ladder per primitive on ``device`` and persist each
    winner under the device-global family.

    Returns rows ``{"primitive", "block_m", "time_s", "winner"}``, one per
    measured point; ``winner`` marks the argmin, ties to the smaller
    block. The plain versions ignore the block size, so on the CPU what
    wins is the clock's noise (or a test's scripted clock)."""
    spec = as_tune_spec(spec)
    cache = default_cache() if cache is None else cache
    m = 4 * n if m is None else m
    names = PRIMITIVES if primitives is None else tuple(primitives)
    drivers = primitive_drivers(n, m, seed=seed, device=device)
    rows = []
    for name in names:
        call = drivers[name]
        timed = []
        for block in spec.block_m_candidates():
            t = time_fn(call, block_m=block, trials=spec.trials,
                        warmup=spec.warmup, timer=timer, device=device)
            timed.append((t, block))
        best_t, best_b = min(timed)  # a tie goes to the smaller block
        cache.put(make_key(f"block_m:{name}", device=device), int(best_b),
                  time_s=best_t, n=n, m=m,
                  candidates={str(b): t for t, b in timed})
        for t, b in timed:
            rows.append(dict(primitive=name, block_m=b, time_s=t,
                             winner=(b == best_b)))
    return rows


def _tune_variant(g, spec: TuneSpec, cache: SelectionCache, exec: str,
                  family: str, names: tuple, timer, rng,
                  mesh=None) -> tuple:
    """(winner, its time, whether this rank wrote the cache)."""
    from ..api import ConnectIt  # lazy: api imports this module
    if not names:
        raise ValueError("no variant candidates to tune over")
    times, session = [], None
    draws = ({"generator": rng} if isinstance(rng, torch.Generator)
             else {"key": rng})
    for name in names:
        session = ConnectIt(name, exec=exec, mesh=mesh, device=g.device)
        times.append(time_fn(
            lambda: session.connectivity(g, **draws),
            trials=spec.trials, warmup=spec.warmup, timer=timer,
            device=g.device))
    mesh = session._backend.mesh
    leader = True  # this rank writes the cache: the origin of a mesh
    if mesh is not None:
        import torch.distributed as dist

        from ..core import collectives as coll
        times = coll.pmax(
            torch.tensor(times, dtype=torch.float64, device=g.device), mesh,
            session.exec.mesh_axes).tolist()
        leader = dist.get_rank() == coll.origin_rank(mesh)
    best = min(range(len(names)), key=lambda i: (times[i], i))
    if leader:
        cache.put(make_key("variant", family, device=g.device), names[best],
                  time_s=times[best], exec=exec, n=g.n, m=g.m,
                  candidates=dict(zip(names, times)))
    return names[best], times[best], leader


def tune_variant(g, spec: TuneSpecLike = TuneSpec(), *,
                 cache: Optional[SelectionCache] = None,
                 exec: str = "single",  # noqa: A002 - mirrors the API
                 family: Optional[str] = None,
                 candidates: Optional[Sequence[str]] = None,
                 timer: Optional[Callable[[], float]] = None,
                 key: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 mesh=None) -> str:
    """Time candidate variants end to end on ``g`` (on its device) and
    persist the winner under the graph's family fingerprint.

    One full ``connectivity`` per trial, every call drawing from ``key``
    (``PRNGKey(0)`` when None, as the reference's; or from ``generator``),
    so sampling variants are charged for their sampling phase on the same
    draws each trial. Ties go to candidate order (the fast grid lists
    the paper default first). ``mesh`` is the placement's ``DeviceMesh``
    (the whole group when None), as ``ConnectIt`` takes it. Returns the
    winning variant string."""
    spec = as_tune_spec(spec)
    cache = default_cache() if cache is None else cache
    family = fingerprint_graph(g) if family is None else family
    names = tuple(spec.variant_candidates() if candidates is None
                  else candidates)
    return _tune_variant(g, spec, cache, exec, family, names, timer,
                         trandom.choose(key, generator), mesh)[0]


def tune_families(families: dict, spec: TuneSpecLike = TuneSpec(), *,
                  cache: Optional[SelectionCache] = None,
                  exec: str = "single",  # noqa: A002 - mirrors the API
                  candidates: Optional[Sequence[str]] = None,
                  timer: Optional[Callable[[], float]] = None) -> list:
    """Tune the variant per graph family and elect the device-global
    (``"*"``) winner by majority vote across families (ties to the winner
    of the first family).

    ``families`` maps display names to built ``Graph``s, all on one device.
    Returns rows ``{"family", "fingerprint", "winner", "time_s"}``."""
    spec = as_tune_spec(spec)
    cache = default_cache() if cache is None else cache
    names = tuple(spec.variant_candidates() if candidates is None
                  else candidates)
    rows, votes, leader, device = [], [], True, None
    for name, g in families.items():
        fam = fingerprint_graph(g)
        winner, t, leader = _tune_variant(g, spec, cache, exec, fam, names,
                                          timer, None)
        rows.append(dict(family=name, fingerprint=fam, winner=winner,
                         time_s=t))
        votes.append(winner)
        device = g.device
    if votes and leader:
        tally = {v: votes.count(v) for v in votes}
        global_winner = max(votes, key=lambda v: (tally[v], -votes.index(v)))
        cache.put(make_key("variant", "*", device=device), global_winner,
                  families=len(votes))
    return rows
