"""Serving a placement over several ranks: rank 0 serves, the others follow.

The JAX package serves a placement from one controller: its commits are
``shard_map`` programs dispatched to every device at once. Under
``torch.distributed`` every rank runs its own process, and a commit is a
program every rank must enter, in the same order, for its collectives to
pair up. So serving is multi-controller:

  * rank 0 runs the asyncio ``Server``: admission, coalescing, queries;
  * every other rank runs a ``Follower``, which holds its own
    ``SnapshotStore`` of the same ops and replays rank 0's store
    operations that enter a collective, in rank 0's order;
  * rank 0's store broadcasts each such operation and its batch
    (``Channel``) before running it: a warmup, a commit (inserts, and on a
    dynamic server deletes), and the stop that ends the followers' loop.

Queries enter no collective on any placement: they read the committed
epoch's whole labels, which the sharded placement gathers once at the end
of the commit that made the epoch (``core/execution.py::ShardedEpoch``). So
only commits meet across ranks, and rank 0's insert loop runs one at a
time. The broadcasts go over a gloo group of their own, on CPU tensors, so
they never share a communicator with the commits' collectives (NCCL on the
card): a follower blocks in the gloo broadcast while rank 0's commit thread
is still free to issue its own collectives.

A follower replays an operation that raised on rank 0 and raises the same
way (a full edge log, say: every rank reads the same per-shard counts), so
it records the error and goes on, as rank 0's server does.

    server = ConnectIt(v, exec="sharded(x)").serve(n)   # every rank
    if isinstance(server, Follower):
        server.run()                 # until rank 0 stops it
    else:
        ...                          # serve; then
        server.stop_followers()
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .snapshot import SnapshotStore

__all__ = ["Channel", "Follower", "channel_for"]

_STOP, _COMMIT, _WARM = 0, 1, 2
_HEADER = 4

# the channel's gloo group per world: making one is a collective of every
# rank, so a world makes it once
_GROUPS: dict = {}


class Channel:
    """Rank 0's store operations, broadcast to the other ranks over a gloo
    group of their own (CPU tensors)."""

    def __init__(self, group):
        self.group = group
        self.leader = dist.get_rank() == 0
        self.stopped = False

    def _bcast(self, t: torch.Tensor) -> torch.Tensor:
        dist.broadcast(t, src=0, group=self.group)
        return t

    def _send(self, op: int, counts: tuple, payload: np.ndarray) -> None:
        if self.stopped:
            raise RuntimeError("the followers were stopped: no store "
                               "operation can run across ranks any more")
        head = np.zeros((_HEADER,), np.int64)
        head[0] = op
        head[1: 1 + len(counts)] = counts
        self._bcast(torch.from_numpy(head))
        if payload.size:
            self._bcast(torch.from_numpy(payload))

    def send_commit(self, u, v, du=None, dv=None) -> None:
        u = np.asarray(u, np.int32).ravel()
        v = np.asarray(v, np.int32).ravel()
        has_del = du is not None
        du = np.asarray(du if has_del else (), np.int32).ravel()
        dv = np.asarray(dv if has_del else (), np.int32).ravel()
        self._send(_COMMIT, (u.size, du.size, int(has_del)),
                   np.concatenate([u, v, du, dv]))

    def send_warm(self, edge_sizes, query_sizes, delete_sizes) -> None:
        sizes = [np.asarray(list(x), np.int64).ravel()
                 for x in (edge_sizes, query_sizes, delete_sizes)]
        self._send(_WARM, tuple(x.size for x in sizes),
                   np.concatenate(sizes))

    def send_stop(self) -> None:
        if not self.stopped:
            self._send(_STOP, (), np.zeros((0,), np.int32))
            self.stopped = True

    def _recv(self, size: int, dtype) -> np.ndarray:
        buf = torch.zeros((size,), dtype=dtype)
        return (self._bcast(buf) if size else buf).numpy()

    def recv(self) -> tuple:
        """The next operation on a follower: ``("stop",)``, ``("commit", u,
        v, du, dv)`` (``du``/``dv`` None on a static server) or ``("warm",
        edge_sizes, query_sizes, delete_sizes)``."""
        head = self._bcast(torch.zeros((_HEADER,), dtype=torch.int64))
        op, a, b, c = (int(x) for x in head)
        if op == _STOP:
            self.stopped = True
            return ("stop",)
        if op == _COMMIT:
            buf = self._recv(2 * (a + b), torch.int32)
            u, v = buf[:a], buf[a: 2 * a]
            du, dv = buf[2 * a: 2 * a + b], buf[2 * a + b:]
            return ("commit", u, v, *((du, dv) if c else (None, None)))
        buf = self._recv(a + b + c, torch.int64).tolist()
        return ("warm", buf[:a], buf[a: a + b], buf[a + b:])


def channel_for(backend) -> Optional[Channel]:
    """The serving channel of a backend's world, or None where one rank
    serves alone (the single placement, or a one-rank group). Every rank
    calls it: the first call in a world makes the gloo group."""
    if backend.mesh is None or dist.get_world_size() == 1:
        return None
    world = dist.group.WORLD
    if _GROUPS.get("world") is not world:  # a new group: forget the old
        _GROUPS.clear()
        _GROUPS["world"] = world
        _GROUPS["group"] = dist.new_group(backend="gloo")
    return Channel(_GROUPS["group"])


class Follower:
    """A rank other than 0 of a served placement: its own snapshot store
    of the same ops, driven by rank 0's broadcasts (``run``)."""

    def __init__(self, ops, n: int, channel: Channel):
        self.store = SnapshotStore(ops, n)
        self.channel = channel
        self.replayed = 0
        self.errors: list = []

    def run(self) -> int:
        """Replay rank 0's store operations until its stop → the number
        replayed."""
        while True:
            op, *args = self.channel.recv()
            if op == "stop":
                return self.replayed
            try:
                if op == "warm":
                    self.store.warm(*args)
                else:
                    self.store.commit(*args)
            except Exception as e:  # noqa: BLE001 - raised on rank 0 alike
                self.errors.append(e)
            self.replayed += 1

    @property
    def epoch(self) -> int:
        return self.store.epoch

    @property
    def epoch_edges(self) -> list:
        return self.store.epoch_edges

    @property
    def labels(self) -> torch.Tensor:
        return self.store.labels

    def num_components(self) -> int:
        return self.store.num_components()
