"""Connectivity serving CLI — a thin driver over ``repro_torch.serve``.

Builds a session on ``--device`` (the card by default) under ``--exec``,
starts a server, drives a closed-loop load and prints the rates. As in the
JAX package's ``repro.launch.serve``, ``--seed`` makes runs reproducible
and warmup runs on scratch buffers (``ServeConfig.warmup``), so the
measured workload and ``num_components()`` are exactly the requested
traffic. The port has no kernel policy, so there is no ``--kernels``.

A placement runs over the ranks of the ``torch.distributed`` group
(``repro_torch.launch.multihost``; one rank when none is configured):
every rank runs this CLI, rank 0 serves and prints, the others follow its
commits until it is done (``repro_torch.serve.mesh``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --n 65536 --clients 16
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --exec "sharded(x)" --variant none+uf_sync_full --batch 4096 \\
      --queries 1024 --seed 7
"""

from __future__ import annotations

import argparse
import sys


def serve(n: int = 1 << 16, *, batches: int = 32, batch_edges: int = 4096,
          queries: int = 1024, clients: int = 8,
          variant: str = "none+uf_sync_full",
          exec: str = "single",  # noqa: A002 - mirrors the session API
          device: str = "cuda", seed: int = 0, flush_ms: float = 1.0,
          verbose: bool = True):
    """Closed-loop serving run; returns (queries_per_s, server).

    ``batches`` is the total request budget (spread over ``clients``
    concurrent workers). The returned server is closed; use its sync
    ``query_now`` / ``commit_now`` for post-run inspection (on rank 0 of
    several, before ``stop_followers``). A follower rank returns ``(0.0,
    follower)`` once rank 0 is done.
    """
    from ..api import ConnectIt
    from ..serve import Follower, closed_loop, run_sync

    ci = ConnectIt(variant, exec=exec, device=device)
    server = ci.serve(n, max_batch_edges=batch_edges,
                      max_batch_queries=max(queries, 1), flush_ms=flush_ms)
    if isinstance(server, Follower):
        server.run()
        return 0.0, server
    per_client = max(batches // max(clients, 1), 1)
    try:
        res = run_sync(server, closed_loop, clients=clients,
                       requests_per_client=per_client, query_pairs=queries,
                       insert_every=1, insert_edges=batch_edges, seed=seed)
    finally:
        server.stop_followers()
    if verbose:
        st = server.stats()
        print(f"[serve] {variant} exec={st.exec} on {ci.device}: "
              f"{res.inserts} insert "
              f"batches x {batch_edges} edges + {res.queries} query "
              f"requests x {queries} pairs "
              f"({res.achieved_qps * queries:,.0f} queries/s, "
              f"{res.edges_per_s:,.0f} edge inserts/s, "
              f"p50={res.p50_ms:.2f}ms p99={res.p99_ms:.2f}ms, "
              f"{st.devices} device(s))")
        print(f"[serve] epoch {st.epoch}, components now: "
              f"{server.num_components()} (commit shapes: "
              f"{list(st.commit_shapes)}, query shapes: "
              f"{list(st.query_shapes)})")
    return res.achieved_qps * queries, server


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 16)
    ap.add_argument("--batches", type=int, default=32,
                    help="total request budget across clients")
    ap.add_argument("--batch", type=int, default=4096, dest="batch_edges")
    ap.add_argument("--queries", type=int, default=1024,
                    help="connectivity pairs per query request")
    ap.add_argument("--clients", type=int, default=8,
                    help="concurrent closed-loop clients")
    ap.add_argument("--variant", default="none+uf_sync_full")
    ap.add_argument("--exec", default="single", dest="exec_spec",
                    help="ExecutionSpec string (see core/execution.py)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="traffic RNG seed (reproducible runs)")
    ap.add_argument("--flush-ms", type=float, default=1.0,
                    help="max-latency coalescing flush timer")
    args = ap.parse_args(argv)
    serve(args.n, batches=args.batches, batch_edges=args.batch_edges,
          queries=args.queries, clients=args.clients, variant=args.variant,
          exec=args.exec_spec, device=args.device, seed=args.seed,
          flush_ms=args.flush_ms)
    return 0


if __name__ == "__main__":
    sys.exit(main())
