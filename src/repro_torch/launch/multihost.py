"""Multi-process entry path for the distributed placements.

A ``replicated(...)`` or ``sharded(...)`` ExecutionSpec describes a logical
mesh; this module maps it onto ``torch.distributed``. Every rank calls
:func:`initialize` (idempotent) and builds the global mesh with
:func:`global_mesh`: the spec's axes are factored over all ranks, so the
same ``ConnectIt(spec, exec=..., mesh=...)`` call runs on one process or on
many. Every rank then makes the same session calls.

The rendezvous comes from the arguments or from the environment
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
as ``torchrun`` sets them). With nothing configured, :func:`initialize`
makes a one-rank group on an in-process ``HashStore``, so that a
placement runs in a plain process (on one card: it warns where there are
more). Unlike the JAX package's ``initialize``,
a configured rendezvous that fails raises: degrading to one process would
hide the placement.

The default backend, ``"cpu:gloo,cuda:nccl"``, serves CPU and CUDA tensors
from one group (``"gloo"`` where PyTorch has no NCCL). NCCL takes one rank
per card; ranks that share a card pass ``backend="gloo"``. A rank's card is
``cuda:{local_rank % torch.cuda.device_count()}``.

CLI (the ExecutionSpec grammar of every other entry point)::

    python -m repro_torch.launch.multihost --exec "sharded(x)" --n 4096
    MASTER_ADDR=localhost MASTER_PORT=29511 WORLD_SIZE=2 RANK=$R \\
        python -m repro_torch.launch.multihost --device cpu --exec "sharded(x)"
    python -m repro_torch.launch.multihost --device cpu --num-processes 2 \\
        --process-id $R --init-method file:///tmp/rdv --exec "replicated(x)"
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import os
import warnings
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["HostTopology", "initialize", "global_mesh", "shutdown", "main"]


@dataclasses.dataclass(frozen=True)
class HostTopology:
    """What the process knows about the job after :func:`initialize`."""

    num_processes: int
    process_id: int
    coordinator: Optional[str]
    distributed: bool
    local_rank: int = 0
    backend: str = ""

    @property
    def is_leader(self) -> bool:
        return self.process_id == 0


_TOPOLOGY: Optional[HostTopology] = None


def _env(name: str, default=None):
    v = os.environ.get(name)
    return v if v not in (None, "") else default


def _default_backend() -> str:
    return "cpu:gloo,cuda:nccl" if dist.is_nccl_available() else "gloo"


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               backend: Optional[str] = None,
               init_method: Optional[str] = None,
               local_rank: Optional[int] = None,
               timeout: Optional[float] = None) -> HostTopology:
    """Join (or make) the process group → the topology (idempotent).

    ``coordinator`` is ``host:port`` (default ``$MASTER_ADDR:$MASTER_PORT``),
    ``init_method`` any ``torch.distributed`` URL (``tcp://``,
    ``file://``, ``env://``) in its place; ``timeout`` is in seconds."""
    global _TOPOLOGY
    if _TOPOLOGY is not None and dist.is_initialized():
        return _TOPOLOGY
    if coordinator is None and _env("MASTER_ADDR"):
        coordinator = f"{_env('MASTER_ADDR')}:{_env('MASTER_PORT', 29500)}"
    if num_processes is None:
        num_processes = int(_env("WORLD_SIZE", 1))
    if process_id is None:
        process_id = int(_env("RANK", 0))
    if local_rank is None:
        local_rank = int(_env("LOCAL_RANK", process_id))
    backend = backend or _default_backend()
    if torch.cuda.is_available():
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    if init_method is None and (coordinator is None or num_processes <= 1):
        ndev = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if ndev > 1:
            # the JAX package shards over every local device here; a rank
            # here is one process on one card
            warnings.warn(
                f"no rendezvous configured: a one-rank group on cuda:"
                f"{local_rank % ndev} of the {ndev} cards; start one process "
                f"per card (WORLD_SIZE, RANK, MASTER_ADDR) to use them all",
                stacklevel=2)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **kw)
        _TOPOLOGY = HostTopology(1, 0, None, distributed=False,
                                 local_rank=local_rank, backend=backend)
        return _TOPOLOGY
    init_method = init_method or f"tcp://{coordinator}"
    # no fallback: a rendezvous that fails raises here
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id, **kw)
    _TOPOLOGY = HostTopology(dist.get_world_size(), dist.get_rank(),
                             coordinator or init_method, distributed=True,
                             local_rank=local_rank, backend=backend)
    return _TOPOLOGY


def global_mesh(exec="sharded(x)", topology: Optional[HostTopology] = None,
                *, device="cuda"):
    """``(spec, mesh)`` for a spec over every rank: the spec's
    ``mesh_axes`` factored over the world with the balanced factorization
    of single-process planning. ``mesh`` is ``None`` for ``single``."""
    from ..core.execution import as_execution_spec, plan_mesh

    if topology is None:
        initialize()
    spec = as_execution_spec(exec)
    return spec, plan_mesh(spec, device_type=torch.device(device).type)


def shutdown() -> None:
    """Destroy the group (the meshes planned in it go with it)."""
    global _TOPOLOGY
    if dist.is_initialized():
        dist.destroy_process_group()
    _TOPOLOGY = None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Multi-process distributed connectivity entry point")
    parser.add_argument("--exec", default="sharded(x)",
                        help="ExecutionSpec string (see core/execution.py)")
    parser.add_argument("--variant", default="none+uf_sync_full")
    parser.add_argument("--n", type=int, default=1 << 12)
    parser.add_argument("--m", type=int, default=None,
                        help="edge count (default 8*n)")
    parser.add_argument("--coordinator", default=None,
                        help="host:port (default $MASTER_ADDR:$MASTER_PORT)")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument("--init-method", default=None,
                        help="a torch.distributed URL in place of "
                             "--coordinator (tcp://, file://, env://)")
    parser.add_argument("--backend", default=None,
                        help="process-group backend (default "
                             "cpu:gloo,cuda:nccl)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from ..api import ConnectIt
    from ..graphs.generators import rmat

    topo = initialize(args.coordinator, args.num_processes, args.process_id,
                      backend=args.backend, init_method=args.init_method)
    try:
        spec, mesh = global_mesh(args.exec, topo, device=args.device)
        g = rmat(args.n, args.m or 8 * args.n, seed=7, device=args.device)
        ci = ConnectIt(args.variant, exec=spec, mesh=mesh,
                       device=args.device)
        labels, stats = ci.connectivity(g, return_stats=True)
        comps = int(torch.unique(labels).numel())
        if topo.is_leader:
            shape = (dict(zip(mesh.mesh_dim_names, mesh.shape))
                     if mesh is not None else {})
            print(f"processes={topo.num_processes} "
                  f"distributed={topo.distributed} mesh={shape} exec={spec} "
                  f"n={args.n} components={comps} "
                  f"rounds={stats.finish_rounds}")
    finally:
        shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
