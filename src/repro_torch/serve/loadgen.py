"""Load generators for the serving subsystem.

Two standard shapes from the serving-systems literature:

  * **closed loop** — ``clients`` concurrent workers issue back-to-back
    requests; throughput saturates at the service capacity, so the
    achieved QPS is the *saturation* estimate for the placement;
  * **open loop** — requests arrive on a fixed schedule at an *offered*
    QPS regardless of completions (the arrival process the paper's
    billions-of-edges-per-second ingest implies); latency percentiles at a
    given offered load are the serving SLO numbers, and queueing delay
    shows up honestly because arrivals never slow down.

Both mix insert traffic into the query stream (``insert_every`` /
``insert_edges``), drive the public coroutines only (admission,
coalescing, snapshot epochs all engaged), and return a ``LoadResult`` with
p50/p95/p99 latency, achieved throughput, and insert rates. ``run_sync``
wraps one measurement in its own event loop for sync callers.

``delete_frac`` mixes deletions into the churn against a *dynamic* server
(``ConnectIt(...).serve(n, dynamic=True)``): each insert request is
followed by a delete of ``delete_frac`` × ``insert_edges`` edges sampled
from that worker's own insert history, so deletions always target edges
that were really submitted (the adversarial-churn shape from the
batch-dynamic literature). At ``0.0`` the code path is identical to the
static generators.

The traffic is the JAX package's (``repro.serve.loadgen``): the same numpy
draws from the same seeds.
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
from typing import Optional

import numpy as np

from .server import Server

__all__ = ["LoadResult", "closed_loop", "open_loop", "percentiles",
           "run_sync"]


@dataclasses.dataclass
class LoadResult:
    """One load-generation measurement against a running server."""

    mode: str                 # "closed" | "open"
    offered_qps: Optional[float]  # open loop only (closed has no schedule)
    achieved_qps: float       # completed query requests / wall second
    queries: int              # query requests completed
    inserts: int              # insert submissions completed
    deletes: int              # delete submissions completed (dynamic only)
    edges_per_s: float        # committed edge throughput
    duration_s: float
    p50_ms: float
    p95_ms: float
    p99_ms: float
    mean_ms: float
    max_ms: float

    def row(self) -> dict:
        return dataclasses.asdict(self)


def percentiles(latencies_s) -> dict:
    """p50/p95/p99/mean/max in milliseconds from per-request seconds."""
    lat = np.asarray(sorted(latencies_s), float)
    if lat.size == 0:
        return dict(p50_ms=0.0, p95_ms=0.0, p99_ms=0.0, mean_ms=0.0,
                    max_ms=0.0)
    q = np.percentile(lat, [50, 95, 99]) * 1e3
    return dict(p50_ms=float(q[0]), p95_ms=float(q[1]), p99_ms=float(q[2]),
                mean_ms=float(lat.mean() * 1e3),
                max_ms=float(lat[-1] * 1e3))


def _traffic(rng: np.random.Generator, n: int, query_pairs: int,
             insert_edges: int):
    """One request's payloads over tenant-local ids."""
    q = rng.integers(0, n, size=(2, query_pairs)).astype(np.int32)
    e = rng.integers(0, n, size=(2, insert_edges)).astype(np.int32)
    return q[0], q[1], e[0], e[1]


def _sample_deletes(rng: np.random.Generator, history: list,
                    count: int):
    """Draw ``count`` previously inserted edges from a worker's history
    (with replacement; duplicates just re-tombstone)."""
    idx = rng.integers(0, len(history), size=(count,))
    pairs = np.asarray([history[i] for i in idx], np.int32)
    return pairs[:, 0], pairs[:, 1]


async def closed_loop(server: Server, *, clients: int = 8,
                      requests_per_client: int = 32, query_pairs: int = 64,
                      insert_every: int = 4, insert_edges: int = 256,
                      delete_frac: float = 0.0,
                      tenant: str = "default", seed: int = 0) -> LoadResult:
    """Back-to-back workers: the achieved QPS estimates saturation."""
    n = server.tenants.get(tenant).n
    lat: list[float] = []
    inserts = 0
    deletes = 0
    del_edges = int(insert_edges * delete_frac) if delete_frac else 0

    async def worker(wid: int):
        nonlocal inserts, deletes
        rng = np.random.default_rng(seed + 1000 * wid)
        history: list = []
        for i in range(requests_per_client):
            qa, qb, eu, ev = _traffic(rng, n, query_pairs, insert_edges)
            if insert_every and i % insert_every == 0:
                await server.submit_inserts(eu, ev, tenant)
                inserts += 1
                if del_edges:
                    history.extend(zip(eu.tolist(), ev.tolist()))
                    du, dv = _sample_deletes(rng, history,
                                             max(1, del_edges))
                    await server.submit_deletes(du, dv, tenant)
                    deletes += 1
            t0 = time.perf_counter()
            await server.query(qa, qb, tenant)
            lat.append(time.perf_counter() - t0)

    edges0 = server.epoch_edges[-1]
    t0 = time.perf_counter()
    await asyncio.gather(*(worker(w) for w in range(clients)))
    dt = max(time.perf_counter() - t0, 1e-9)
    return LoadResult(
        mode="closed", offered_qps=None, achieved_qps=len(lat) / dt,
        queries=len(lat), inserts=inserts, deletes=deletes,
        edges_per_s=(server.epoch_edges[-1] - edges0) / dt,
        duration_s=dt, **percentiles(lat))


async def open_loop(server: Server, *, qps: float, requests: int = 128,
                    query_pairs: int = 64, insert_every: int = 4,
                    insert_edges: int = 256, delete_frac: float = 0.0,
                    tenant: str = "default",
                    seed: int = 0) -> LoadResult:
    """Fixed-schedule arrivals at an offered QPS; latency includes any
    queueing delay the server accumulates at that load."""
    n = server.tenants.get(tenant).n
    rng = np.random.default_rng(seed)
    interval = 1.0 / max(qps, 1e-9)
    lat: list[float] = []
    tasks: list = []
    inserts = 0
    deletes = 0
    del_edges = int(insert_edges * delete_frac) if delete_frac else 0
    history: list = []

    async def fire_query(qa, qb):
        t0 = time.perf_counter()
        await server.query(qa, qb, tenant)
        lat.append(time.perf_counter() - t0)

    edges0 = server.epoch_edges[-1]
    loop = asyncio.get_running_loop()
    t0 = loop.time()
    for i in range(requests):
        # fixed schedule: sleep to the i-th slot, never to "now + interval"
        # (an open loop must not let service time throttle arrivals)
        delay = t0 + i * interval - loop.time()
        if delay > 0:
            await asyncio.sleep(delay)
        qa, qb, eu, ev = _traffic(rng, n, query_pairs, insert_edges)
        if insert_every and i % insert_every == 0:
            tasks.append(asyncio.create_task(
                server.submit_inserts(eu, ev, tenant)))
            inserts += 1
            if del_edges:
                history.extend(zip(eu.tolist(), ev.tolist()))
                du, dv = _sample_deletes(rng, history, max(1, del_edges))
                tasks.append(asyncio.create_task(
                    server.submit_deletes(du, dv, tenant)))
                deletes += 1
        tasks.append(asyncio.create_task(fire_query(qa, qb)))
    await asyncio.gather(*tasks)
    dt = max(loop.time() - t0, 1e-9)
    return LoadResult(
        mode="open", offered_qps=float(qps), achieved_qps=len(lat) / dt,
        queries=len(lat), inserts=inserts, deletes=deletes,
        edges_per_s=(server.epoch_edges[-1] - edges0) / dt,
        duration_s=dt, **percentiles(lat))


def run_sync(server: Server, coro_fn, /, **kw) -> LoadResult:
    """Run one load measurement in a private event loop: start the server,
    apply ``coro_fn(server, **kw)``, close it, return the result."""

    async def _main():
        async with server:
            return await coro_fn(server, **kw)

    return asyncio.run(_main())
