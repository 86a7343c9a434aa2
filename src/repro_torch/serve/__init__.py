"""repro_torch.serve: the async query-serving subsystem.

Turns a ``ConnectIt(variant)`` session into a service over a live graph:
async admission with batch coalescing (server.py), double-buffered
snapshot epochs so queries never see a half-committed insert batch
(snapshot.py), multi-tenant vertex namespaces over one shared device state
(tenancy.py), closed/open-loop load generators (loadgen.py), and on a
placement over several ranks a server on rank 0 whose commits the other
ranks follow (mesh.py). The semantics are the JAX package's
``repro.serve``; commits run in a worker thread, on their own CUDA stream
on the card.

Entry point::

    server = ConnectIt("none+uf_sync_full").serve(1 << 16)   # on the card
    async with server:
        epoch = await server.submit_inserts(u, v)
        ans, at_epoch = await server.query(qa, qb)
"""

from .config import ServeConfig
from .loadgen import LoadResult, closed_loop, open_loop, percentiles, run_sync
from .mesh import Follower
from .server import Server, ServerStats, TenantStats
from .snapshot import PendingCommit, SnapshotStore
from .tenancy import DEFAULT_TENANT, Tenant, TenantRegistry

__all__ = [
    "ServeConfig", "Server", "ServerStats", "TenantStats",
    "SnapshotStore", "PendingCommit", "Follower",
    "Tenant", "TenantRegistry", "DEFAULT_TENANT",
    "LoadResult", "closed_loop", "open_loop", "percentiles", "run_sync",
]
