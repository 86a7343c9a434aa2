"""SnapshotStore: double-buffered label epochs with commit/read isolation.

The store owns two epoch buffers made by ``snapshot_ops`` (a raw label
buffer, ``core/streaming.py``) or ``dynamic_snapshot_ops`` (a whole
``DynamicState``, ``dynamic/engine.py``):

  * the **committed** snapshot — the labels of epoch ``e``; every query
    between commits gathers against exactly this buffer, and no op of a
    commit writes it (they all write out of place), so a query never
    observes a half-applied batch;
  * the **shadow** buffer — epoch ``e-1``'s labels, unreachable by queries.
    With ``donate`` the store drops it before the commit allocates, so its
    block is free for the commit's buffers; without, it is held until the
    rotation.

A commit is split in two, so that the serving layer (and the race test)
can hold the epoch boundary open:

    pending = store.begin_commit(u, v)   # new = f(committed, batch)
    ...                                  # queries here still read epoch e
    store.finish_commit(pending)         # swap buffers, epoch -> e + 1

``_committed`` and ``epoch`` change only in ``finish_commit``. Unlike a jit
dispatch, ``begin_commit`` cannot only enqueue: each finish and compress
round reads a host bool (``core/primitives.py::iterate_to_fixpoint``). So
the async server runs it in a worker thread, and on the card it runs on
the store's own CUDA stream, beside the queries on the caller's stream.

Streams on the card. The kernels launch on PyTorch's current stream, so a
commit under ``torch.cuda.stream(commit_stream)`` overlaps the query
gathers. An event recorded after the commit is waited on before the
rotation, so a query never reads an epoch that is still being written. The
epoch buffers are allocated on the commit stream and read by queries on
another one; the caching allocator would hand a dropped buffer's block to
the next commit at once, while a query's gather on the other stream may
still be pending. Every read from another stream therefore calls
``record_stream`` on the buffer it reads (``_read_committed``): the allocator
then waits for that stream's work before reusing the block. On the CPU
there is no stream and none of this applies.
"""

from __future__ import annotations

import contextlib
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ..core.driver import _per_chunk_counts
from ..core.execution import served_labels

__all__ = ["PendingCommit", "SnapshotStore"]


class PendingCommit(NamedTuple):
    """An epoch in flight: computed (or computing, on the commit stream) but
    not yet visible to queries."""

    labels: Any         # the next epoch's state: a label buffer, or a
                        # DynamicState in dynamic mode
    rounds: int         # finish rounds of the commit
    edges: int          # real (non-padding) edges in the batch
    epoch: int          # the epoch this commit will become
    deletes: int = 0    # real delete entries in the batch (dynamic mode)
    done: Optional[torch.cuda.Event] = None  # recorded after the commit
                                             # (card only)


class SnapshotStore:
    """Double-buffered snapshot state for one served vertex space."""

    def __init__(self, ops, n: int, channel=None):
        self._ops = ops
        self.n = n
        # rank 0 of a served placement over several ranks: every operation
        # that enters a collective is broadcast first (serve/mesh.py)
        self._channel = channel
        self.device = ops.device
        self.epoch = 0
        # a DynamicSnapshotOps bundle (deletes in the commit pipeline)
        # announces itself by carrying a log capacity
        self.dynamic = hasattr(ops, "log_cap")
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._committed = ops.init()
        # the shadow starts as a second, independent buffer, as in the JAX
        # package, whose first donated commit rotates into it
        self._shadow = ops.init()
        self._pending: Optional[PendingCommit] = None
        # cumulative real edges committed as of each epoch (epoch 0 = empty
        # graph): the linearization log the serve tests audit against
        self.epoch_edges: list[int] = [0]
        self.epoch_deletes: list[int] = [0]
        self.rounds_total = 0
        if self.dynamic:
            # conservative per-shard log-occupancy bound; synced against the
            # true live counts only when a batch would overflow it
            self._cap_local = ops.log_cap // ops.edge_shards
            self._bound = np.zeros((ops.edge_shards,), np.int64)

    # -- streams ---------------------------------------------------------------

    def _on_commit_stream(self):
        """The commit stream as PyTorch's current stream (card only)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _read_committed(self):
        """The committed state, to be read on the caller's current stream:
        the caching allocator is told, so that a block dropped by a later
        rotation is not reused before this stream's reads of it are done.
        Reads go through its whole labels only (``served_labels``)."""
        state = self._committed
        P = served_labels(state)
        if P.is_cuda:
            P.record_stream(torch.cuda.current_stream(P.device))
        return state

    def _done_event(self) -> Optional[torch.cuda.Event]:
        if self._stream is None:
            return None
        done = torch.cuda.Event()
        done.record(self._stream)
        return done

    @staticmethod
    def wait(pending: PendingCommit) -> None:
        """Block the calling thread until ``pending``'s device work is done
        (the async server calls this in its worker thread)."""
        if pending.done is not None:
            pending.done.synchronize()

    # -- commit path -----------------------------------------------------------

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(x).to(self.device)

    def _pad_edges(self, u, v):
        u = np.asarray(u, np.int32)
        v = np.asarray(v, np.int32)
        k = int(u.shape[0])
        size = int(self._ops.batch_size(k))
        if size != k:
            pad = np.full((size - k,), self.n, np.int32)
            u = np.concatenate([u, pad])
            v = np.concatenate([v, pad])
        return self._to_device(u), self._to_device(v), size

    def _pad_deletes(self, du, dv):
        du = np.asarray(du, np.int32) if du is not None else \
            np.empty((0,), np.int32)
        dv = np.asarray(dv, np.int32) if dv is not None else \
            np.empty((0,), np.int32)
        k = int(du.shape[0])
        size = int(self._ops.delete_size(k))
        if size != k:
            pad = np.full((size - k,), self.n, np.int32)
            du = np.concatenate([du, pad])
            dv = np.concatenate([dv, pad])
        return self._to_device(du), self._to_device(dv), k

    def _ensure_capacity(self, k: int, size: int) -> None:
        incoming = np.asarray(_per_chunk_counts(k, size,
                                                self._ops.edge_shards))
        if (self._bound + incoming <= self._cap_local).all():
            self._bound += incoming
            return
        self._bound = self._ops.used(self._committed).cpu().numpy().astype(
            np.int64)
        if (self._bound + incoming > self._cap_local).any():
            raise ValueError(
                f"edge log full: shard occupancy {self._bound.tolist()} + "
                f"batch {incoming.tolist()} exceeds {self._cap_local} "
                f"slots/shard — serve with a larger log= (total capacity "
                f"{self._ops.log_cap})")
        self._bound += incoming

    def begin_commit(self, u, v, du=None, dv=None) -> PendingCommit:
        """Compute the next epoch's labels from the committed snapshot (on
        the commit stream on the card). At most one commit may be in flight
        (there are exactly two buffers). ``du``/``dv`` (dynamic mode only)
        apply before the inserts within the same epoch."""
        if self._pending is not None:
            raise RuntimeError("a commit is already in flight; "
                               "finish_commit it first")
        if (du is not None or dv is not None) and not self.dynamic:
            raise RuntimeError(
                "deletions need a dynamic snapshot store — serve with "
                "dynamic=True")
        if self._channel is not None:
            self._channel.send_commit(u, v, du, dv)
        with self._on_commit_stream():
            uj, vj, size = self._pad_edges(u, v)
            k = int(np.sum(np.asarray(u, np.int64) < self.n))
            if self.dynamic:
                duj, dvj, dk = self._pad_deletes(du, dv)
                self._ensure_capacity(k, size)
            else:
                dk = 0
            if self._ops.donate:
                # the shadow is dead state: dropping it here lets the
                # allocator hand its block to this commit's buffers
                self._shadow = None
            if self.dynamic:
                labels, rounds = self._ops.commit(
                    self._committed, self._shadow, duj, dvj, uj, vj)
            else:
                labels, rounds = self._ops.commit(self._committed,
                                                  self._shadow, uj, vj)
            done = self._done_event()
        self._pending = PendingCommit(labels, int(rounds), k, self.epoch + 1,
                                      dk, done)
        return self._pending

    def finish_commit(self, pending: PendingCommit) -> int:
        """Rotate buffers: the committed snapshot becomes the shadow, the
        pending labels become the committed epoch. Returns the new epoch.
        On the card the commit's work is complete before the rotation."""
        if pending is not self._pending:
            raise RuntimeError("finish_commit got a stale PendingCommit")
        self.wait(pending)
        self._shadow = self._committed
        self._committed = pending.labels
        self.epoch = pending.epoch
        self.epoch_edges.append(self.epoch_edges[-1] + pending.edges)
        self.epoch_deletes.append(self.epoch_deletes[-1] + pending.deletes)
        self.rounds_total += pending.rounds
        self._pending = None
        return self.epoch

    def commit(self, u, v, du=None, dv=None) -> int:
        """begin + finish (which waits), in one call: the sync path; the
        async server waits in a worker thread before it finishes."""
        return self.finish_commit(self.begin_commit(u, v, du, dv))

    # -- read path -------------------------------------------------------------

    def _pad_queries(self, qa, qb):
        qa = np.asarray(qa, np.int32)
        qb = np.asarray(qb, np.int32)
        k = int(qa.shape[0])
        size = int(self._ops.batch_size(k))
        if size != k:
            qa = np.pad(qa, (0, size - k))
            qb = np.pad(qb, (0, size - k))
        return self._to_device(qa), self._to_device(qb), k

    def query(self, qa, qb):
        """IsConnected against the committed snapshot -> (ans, epoch).

        ``ans`` is a device tensor (the caller decides when to sync); the
        epoch tag is exact: the gather reads precisely the buffer that
        carried ``epoch`` at call time."""
        qaj, qbj, k = self._pad_queries(qa, qb)
        state, epoch = self._read_committed(), self.epoch
        ans = self._ops.query(state, qaj, qbj)
        return ans[:k], epoch

    @property
    def labels(self) -> torch.Tensor:
        """Committed labels over real vertices (n,)."""
        return self._ops.labels(self._read_committed())

    def num_components(self) -> int:
        return int(self._ops.ncomp(self._read_committed()))

    # -- warmup ----------------------------------------------------------------

    def warm(self, edge_sizes=(), query_sizes=(), delete_sizes=()) -> None:
        """Exercise dispatch shapes on scratch buffers.

        Runs the commit on throwaway buffers (on the commit stream) and the
        query on the committed snapshot with padding-only inputs: nothing
        is committed, no epoch is consumed, the served labels are untouched.
        On the card this builds and loads the kernels at first use and
        warms the caching allocator on both streams, so that no request
        pays for either."""
        n = self.n
        if self._channel is not None:
            self._channel.send_warm(edge_sizes, query_sizes, delete_sizes)

        def pads(size):
            return torch.full((size,), n, dtype=torch.int32,
                              device=self.device)

        with self._on_commit_stream():
            for k in sorted(set(int(s) for s in edge_sizes)):
                scratch_a, scratch_b = self._ops.init(), self._ops.init()
                u = pads(int(self._ops.batch_size(k)))
                if self.dynamic:
                    d = pads(int(self._ops.delete_size(0)))
                    self._ops.commit(scratch_a, scratch_b, d, d, u, u)
                else:
                    self._ops.commit(scratch_a, scratch_b, u, u)
            if self.dynamic:
                u0 = pads(int(self._ops.batch_size(0)))
                for k in sorted(set(int(s) for s in delete_sizes)):
                    scratch_a, scratch_b = self._ops.init(), self._ops.init()
                    d = pads(int(self._ops.delete_size(k)))
                    self._ops.commit(scratch_a, scratch_b, d, d, u0, u0)
            done = self._done_event()
        if done is not None:
            done.synchronize()
        state = self._read_committed()
        for k in sorted(set(int(s) for s in query_sizes)):
            q = torch.zeros((int(self._ops.batch_size(k)),),
                            dtype=torch.int32, device=self.device)
            self._ops.query(state, q, q).cpu()
