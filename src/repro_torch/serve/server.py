"""The async query-serving front-end over a snapshot-isolated label state.

``Server`` turns one ``SnapshotOps`` bundle (``core/streaming.py``, or the
dynamic one of ``dynamic/engine.py``) into a service, as the JAX package's
``repro.serve.server`` does:

  * **admission** — ``submit_inserts`` / ``query`` coroutines accept raw
    client traffic in tenant-local vertex ids, translate it onto the shared
    vertex space (tenancy.py), and enqueue it; insert admission applies
    queue-depth backpressure (``ServeConfig.max_pending_edges``);
  * **coalescing** — two background loops cut size-bucketed device batches
    from the queues: a batch dispatches when it reaches the admission cap
    or when its oldest request has waited ``flush_ms`` (the max-latency
    flush timer), and ragged batches land on pow2 dispatch shapes
    (``SnapshotOps.batch_size``), so concurrent clients share a handful of
    shapes instead of one per request size;
  * **snapshot isolation** — inserts commit through the double-buffered
    ``SnapshotStore``: queries always gather against the committed epoch's
    buffer, an in-flight commit becomes visible only at the buffer
    rotation, and every query response carries the exact epoch it read
    (snapshot.py has the begin/finish split).

A commit reads a host bool every finish and compress round, so the insert
loop runs ``begin_commit`` and the wait for its device work in a worker
thread (on the card, on the store's commit stream), then rotates on the
event loop's thread. "Epoch e committed" means the device state is real,
and insert latency measured by the load generator includes device time.
Queries overlap the in-flight commit and read the prior epoch; their
answers come to the host in a worker thread too.

On a placement over several ranks this server runs on rank 0, and every
other rank follows its commits (serve/mesh.py): queries read whole labels
and enter no collective, so only commits, one at a time, meet across
ranks.
"""

from __future__ import annotations

import asyncio
import dataclasses
from collections import deque
from typing import Optional

import numpy as np

from .config import ServeConfig
from .snapshot import SnapshotStore
from .tenancy import DEFAULT_TENANT, TenantRegistry

__all__ = ["Server", "ServerStats", "TenantStats"]


@dataclasses.dataclass
class TenantStats:
    """Per-tenant serving counters."""

    edges_submitted: int = 0
    edges_committed: int = 0
    deletes_submitted: int = 0
    deletes_committed: int = 0
    queries: int = 0
    positives: int = 0


@dataclasses.dataclass
class ServerStats:
    """A point-in-time snapshot of the server's counters."""

    exec: str
    variant: str
    devices: int
    epoch: int
    edges_committed: int
    edges_deleted: int
    commit_batches: int
    query_batches: int
    queries_answered: int
    finish_rounds: int
    peak_pending_edges: int
    commit_shapes: tuple
    query_shapes: tuple
    tenants: dict


def _to_host(t) -> np.ndarray:
    return t.cpu().numpy()


class _Pending:
    """One admitted request waiting for its batch."""

    __slots__ = ("u", "v", "k", "tenant", "future", "t", "kind")

    def __init__(self, u, v, k, tenant, future, t, kind="ins"):
        self.u, self.v, self.k = u, v, k
        self.tenant, self.future, self.t = tenant, future, t
        self.kind = kind  # "ins" | "del" — mixed in one commit queue


class Server:
    """Async connectivity-serving front-end (``ConnectIt(...).serve(n)``).

    Lifecycle: ``async with server:`` (or ``await server.start()`` /
    ``await server.close()``). The sync ``commit_now``, ``delete_now`` and
    ``query_now`` bypass admission and operate directly on the snapshot
    store — CLI and test conveniences for when no event loop is running.
    """

    def __init__(self, ops, tenants: TenantRegistry, *,
                 config: Optional[ServeConfig] = None,
                 variant: str = "", exec_str: str = "", devices: int = 1,
                 channel=None):
        self.config = config or ServeConfig()
        self.tenants = tenants
        self.variant = variant
        self.exec_str = exec_str
        self.devices = devices
        self.n = tenants.total
        # ``channel``: rank 0 of a placement over several ranks, whose
        # store broadcasts its commits to the followers (serve/mesh.py)
        self.store = SnapshotStore(ops, self.n, channel=channel)
        self._inserts: deque = deque()
        self._queries: deque = deque()
        self._pending_edges = 0      # queued, not yet cut into a batch
        self._peak_pending = 0
        self._accepting = False
        self._tasks: list = []
        self._open: set = set()      # unresolved request futures (flush)
        self._insert_arrival: Optional[asyncio.Event] = None
        self._insert_full: Optional[asyncio.Event] = None
        self._query_arrival: Optional[asyncio.Event] = None
        self._query_full: Optional[asyncio.Event] = None
        self._space: Optional[asyncio.Condition] = None
        self._tstats = {t.name: TenantStats() for t in tenants}
        self._commit_batches = 0
        self._query_batches = 0
        self._queries_answered = 0
        self._commit_shapes: set = set()
        self._query_shapes: set = set()

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> "Server":
        if self._accepting:
            return self
        self._insert_arrival = asyncio.Event()
        self._insert_full = asyncio.Event()
        self._query_arrival = asyncio.Event()
        self._query_full = asyncio.Event()
        self._space = asyncio.Condition()
        if self.config.warmup:
            await asyncio.to_thread(
                self.store.warm,
                self._warm_sizes(self.config.max_batch_edges),
                self._warm_sizes(self.config.max_batch_queries),
                self._warm_sizes(self.config.max_batch_edges)
                if self.store.dynamic else ())
        self._accepting = True
        self._tasks = [
            asyncio.create_task(self._insert_loop(), name="serve-inserts"),
            asyncio.create_task(self._query_loop(), name="serve-queries"),
        ]
        return self

    def _warm_sizes(self, cap: int) -> list:
        """Request sizes to precompile: the cap, plus — under
        ``warmup="all"`` — every pow2 bucket below it (the bucketing maps
        each to its dispatch shape; duplicate shapes hit the jit cache)."""
        if self.config.warmup != "all":
            return [cap]
        sizes, k = [], 1
        while k < cap:
            sizes.append(k)
            k *= 2
        return sizes + [cap]

    async def close(self) -> None:
        if not self._accepting:
            return
        self._accepting = False
        async with self._space:
            self._space.notify_all()  # release backpressure waiters
        await self.flush()
        for t in self._tasks:
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks = []

    def stop_followers(self) -> None:
        """End the followers' loops (serve/mesh.py); no commit can run
        after it. A no-op where rank 0 serves alone."""
        if self.store._channel is not None:
            self.store._channel.send_stop()

    async def __aenter__(self) -> "Server":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.close()

    async def flush(self) -> None:
        """Force partial batches out and wait for every admitted request."""
        self._insert_full.set()
        self._query_full.set()
        open_now = list(self._open)
        if open_now:
            await asyncio.gather(*open_now)

    # -- admission -----------------------------------------------------------

    def _check_pair(self, a, b, what: str):
        a = np.asarray(a, np.int32).ravel()
        b = np.asarray(b, np.int32).ravel()
        if a.shape != b.shape:
            raise ValueError(f"{what} endpoint arrays must match: "
                             f"{a.shape} vs {b.shape}")
        return a, b

    async def submit_inserts(self, u, v,
                             tenant: str = DEFAULT_TENANT) -> int:
        """Insert a batch of tenant-local undirected edges; resolves with
        the epoch whose snapshot includes them (after the commit is real on
        device). Awaits under backpressure when the admission queue holds
        ``max_pending_edges`` or more."""
        if not self._accepting:
            raise RuntimeError("server is not running (use 'async with')")
        t = self.tenants.get(tenant)
        u, v = self._check_pair(u, v, "insert")
        u, v = t.translate(u), t.translate(v)
        k = int(u.shape[0])
        self._tstats[tenant].edges_submitted += k
        if k == 0:
            return self.store.epoch
        async with self._space:
            await self._space.wait_for(
                lambda: self._pending_edges < self.config.max_pending_edges
                or not self._accepting)
        if not self._accepting:
            raise RuntimeError("server closed while awaiting admission")
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self._open.add(fut)
        fut.add_done_callback(self._open.discard)
        self._inserts.append(_Pending(u, v, k, tenant, fut, loop.time()))
        self._pending_edges += k
        self._peak_pending = max(self._peak_pending, self._pending_edges)
        self._insert_arrival.set()
        if self._pending_edges >= self.config.max_batch_edges:
            self._insert_full.set()
        return await fut

    async def submit_deletes(self, u, v,
                             tenant: str = DEFAULT_TENANT) -> int:
        """Delete a batch of tenant-local undirected edges (dynamic serving
        only); resolves with the epoch whose snapshot excludes them.

        Deletions coalesce into the same commit pipeline as inserts: a mixed
        batch commits deletes before inserts within one epoch (the engine's
        batch linearization), under the same backpressure and flush timer."""
        if not self._accepting:
            raise RuntimeError("server is not running (use 'async with')")
        if not self.store.dynamic:
            raise RuntimeError(
                "this server has no deletion support — serve with "
                "dynamic=True")
        t = self.tenants.get(tenant)
        u, v = self._check_pair(u, v, "delete")
        u, v = t.translate(u), t.translate(v)
        k = int(u.shape[0])
        self._tstats[tenant].deletes_submitted += k
        if k == 0:
            return self.store.epoch
        async with self._space:
            await self._space.wait_for(
                lambda: self._pending_edges < self.config.max_pending_edges
                or not self._accepting)
        if not self._accepting:
            raise RuntimeError("server closed while awaiting admission")
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self._open.add(fut)
        fut.add_done_callback(self._open.discard)
        self._inserts.append(_Pending(u, v, k, tenant, fut, loop.time(),
                                      kind="del"))
        self._pending_edges += k
        self._peak_pending = max(self._peak_pending, self._pending_edges)
        self._insert_arrival.set()
        if self._pending_edges >= self.config.max_batch_edges:
            self._insert_full.set()
        return await fut

    async def query(self, qa, qb, tenant: str = DEFAULT_TENANT):
        """IsConnected for tenant-local pairs -> (bool ndarray, epoch).

        The answers and the epoch tag refer to the same committed snapshot:
        queries admitted while an insert batch is mid-commit read exactly
        the prior epoch (snapshot isolation)."""
        if not self._accepting:
            raise RuntimeError("server is not running (use 'async with')")
        t = self.tenants.get(tenant)
        qa, qb = self._check_pair(qa, qb, "query")
        qa, qb = t.translate(qa), t.translate(qb)
        k = int(qa.shape[0])
        if k == 0:
            return np.zeros((0,), bool), self.store.epoch
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self._open.add(fut)
        fut.add_done_callback(self._open.discard)
        self._queries.append(_Pending(qa, qb, k, tenant, fut, loop.time()))
        self._query_arrival.set()
        if sum(p.k for p in self._queries) >= self.config.max_batch_queries:
            self._query_full.set()
        return await fut

    # -- coalescing ----------------------------------------------------------

    def _take(self, queue: deque, cap: int, arrival: asyncio.Event,
              full: asyncio.Event) -> list:
        """Cut one batch: whole requests until the cap (a single oversized
        request still dispatches whole)."""
        batch, total = [], 0
        while queue and (total == 0 or total + queue[0].k <= cap):
            p = queue.popleft()
            batch.append(p)
            total += p.k
        if not queue:
            arrival.clear()
        if sum(p.k for p in queue) < cap:
            full.clear()
        return batch

    async def _coalesce(self, queue: deque, cap: int, arrival: asyncio.Event,
                        full: asyncio.Event) -> list:
        """Wait for traffic, then up to the flush window for a full batch."""
        await arrival.wait()
        if not queue:          # raced a flush with an empty queue
            arrival.clear()
            return []
        flush_s = self.config.flush_s
        if flush_s > 0 and not full.is_set():
            # the oldest request bounds the extra wait: never more than
            # flush_ms past its admission, and none if the loop was busy
            loop = asyncio.get_running_loop()
            timeout = queue[0].t + flush_s - loop.time()
            if timeout > 0:
                try:
                    await asyncio.wait_for(full.wait(), timeout)
                except asyncio.TimeoutError:
                    pass
        return self._take(queue, cap, arrival, full)

    async def _insert_loop(self):
        cfg = self.config
        while True:
            batch = await self._coalesce(self._inserts, cfg.max_batch_edges,
                                         self._insert_arrival,
                                         self._insert_full)
            if not batch:
                continue
            total = sum(p.k for p in batch)
            self._pending_edges -= total
            ins = [p for p in batch if p.kind == "ins"]
            dels = [p for p in batch if p.kind == "del"]
            empty = np.empty((0,), np.int32)
            u = np.concatenate([p.u for p in ins]) if ins else empty
            v = np.concatenate([p.v for p in ins]) if ins else empty
            if dels:
                du = np.concatenate([p.u for p in dels])
                dv = np.concatenate([p.v for p in dels])
            else:
                du = dv = None
            try:
                pending = await asyncio.to_thread(self._commit_work, u, v,
                                                  du, dv)
                epoch = self.store.finish_commit(pending)
            except Exception as e:  # noqa: BLE001 - fanned out to callers
                for p in batch:
                    if not p.future.done():
                        p.future.set_exception(e)
                continue
            self._commit_batches += 1
            self._commit_shapes.add(int(self.store._ops.batch_size(
                sum(p.k for p in ins))))
            for p in batch:
                if p.kind == "del":
                    self._tstats[p.tenant].deletes_committed += p.k
                else:
                    self._tstats[p.tenant].edges_committed += p.k
                if not p.future.done():
                    p.future.set_result(epoch)
            async with self._space:
                self._space.notify_all()

    def _commit_work(self, u, v, du, dv):
        """The commit and the wait for its device work (worker thread)."""
        pending = self.store.begin_commit(u, v, du, dv)
        self.store.wait(pending)
        return pending

    async def _query_loop(self):
        cfg = self.config
        while True:
            batch = await self._coalesce(self._queries,
                                         cfg.max_batch_queries,
                                         self._query_arrival,
                                         self._query_full)
            if not batch:
                continue
            qa = np.concatenate([p.u for p in batch])
            qb = np.concatenate([p.v for p in batch])
            try:
                ans, epoch = self.store.query(qa, qb)
                ans = await asyncio.to_thread(_to_host, ans)
            except Exception as e:  # noqa: BLE001 - fanned out to callers
                for p in batch:
                    if not p.future.done():
                        p.future.set_exception(e)
                continue
            self._query_batches += 1
            self._query_shapes.add(int(self.store._ops.batch_size(
                int(qa.shape[0]))))
            off = 0
            for p in batch:
                part = ans[off: off + p.k]
                off += p.k
                st = self._tstats[p.tenant]
                st.queries += p.k
                st.positives += int(part.sum())
                self._queries_answered += p.k
                if not p.future.done():
                    p.future.set_result((part, epoch))

    # -- sync conveniences (no event loop required) --------------------------

    def commit_now(self, u, v, tenant: str = DEFAULT_TENANT) -> int:
        """Synchronous insert commit, bypassing admission (CLI/tests)."""
        t = self.tenants.get(tenant)
        u, v = self._check_pair(u, v, "insert")
        u, v = t.translate(u), t.translate(v)
        self._tstats[tenant].edges_submitted += int(u.shape[0])
        self._tstats[tenant].edges_committed += int(u.shape[0])
        self._commit_batches += 1
        return self.store.commit(u, v)

    def delete_now(self, u, v, tenant: str = DEFAULT_TENANT) -> int:
        """Synchronous delete commit, bypassing admission (dynamic serving
        only; CLI/tests)."""
        if not self.store.dynamic:
            raise RuntimeError(
                "this server has no deletion support — serve with "
                "dynamic=True")
        t = self.tenants.get(tenant)
        u, v = self._check_pair(u, v, "delete")
        u, v = t.translate(u), t.translate(v)
        self._tstats[tenant].deletes_submitted += int(u.shape[0])
        self._tstats[tenant].deletes_committed += int(u.shape[0])
        self._commit_batches += 1
        empty = np.empty((0,), np.int32)
        return self.store.commit(empty, empty, u, v)

    def query_now(self, qa, qb, tenant: str = DEFAULT_TENANT):
        """Synchronous query against the committed snapshot (CLI/tests)."""
        t = self.tenants.get(tenant)
        qa, qb = self._check_pair(qa, qb, "query")
        ans, epoch = self.store.query(t.translate(qa), t.translate(qb))
        ans = _to_host(ans)
        st = self._tstats[tenant]
        st.queries += int(ans.shape[0])
        st.positives += int(ans.sum())
        self._queries_answered += int(ans.shape[0])
        return ans, epoch

    # -- views ---------------------------------------------------------------

    @property
    def epoch(self) -> int:
        return self.store.epoch

    @property
    def epoch_edges(self) -> list:
        """Cumulative committed real edges per epoch (linearization log)."""
        return self.store.epoch_edges

    @property
    def epoch_deletes(self) -> list:
        """Cumulative committed real deletes per epoch (dynamic serving)."""
        return self.store.epoch_deletes

    def num_components(self, tenant: Optional[str] = None) -> int:
        """Component count over the shared space, or within one tenant's
        block (each untouched vertex is its own component)."""
        if tenant is None:
            return self.store.num_components()
        t = self.tenants.get(tenant)
        lab = _to_host(self.store.labels)[t.base: t.base + t.n]
        return int(np.unique(lab).shape[0])

    def stats(self) -> ServerStats:
        return ServerStats(
            exec=self.exec_str, variant=self.variant, devices=self.devices,
            epoch=self.store.epoch,
            edges_committed=self.store.epoch_edges[-1],
            edges_deleted=self.store.epoch_deletes[-1],
            commit_batches=self._commit_batches,
            query_batches=self._query_batches,
            queries_answered=self._queries_answered,
            finish_rounds=self.store.rounds_total,
            peak_pending_edges=self._peak_pending,
            commit_shapes=tuple(sorted(self._commit_shapes)),
            query_shapes=tuple(sorted(self._query_shapes)),
            tenants={k: dataclasses.replace(v)
                     for k, v in self._tstats.items()})
