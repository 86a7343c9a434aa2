"""Streaming-connectivity ingest driver (mirrors ``repro.launch.ingest``).

Builds a graph stream, feeds insert batches and connectivity queries
through ``repro_torch.core.streaming`` at a given batch size, reports the
throughput (directed edges a second) and checkpoints the labels for a
restart (``--ckpt-dir``: every 8 batches; a rerun resumes from the latest).

``--chunked`` switches to the out-of-core path (``repro_torch.graphs.ingest``
through ``ConnectIt(variant).from_chunks``): the edge stream is generated a
chunk at a time, never materialized, and reported with its survivor and
spill counts.

Queries are drawn from a ``torch.Generator`` seeded with the batch's step
(``step`` and ``step + 1`` for the two ends), where the reference draws
``jax.random.PRNGKey(step)``: the pairs differ, the labels do not.

Two flags beyond the reference's: ``--max-steps K`` stops after K batches
of this run, as a preemption would (a rerun with the same ``--ckpt-dir``
resumes), and ``--out PATH`` saves the final ``(n,)`` labels with
``numpy.save``.

Usage:
  python -m repro_torch.launch.ingest --n 100000 --edges 1000000 \\
      --batch 65536 --finish uf_sync_full
  python -m repro_torch.launch.ingest --chunked --n $((1<<22)) \\
      --edges $((1<<24)) --batch $((1<<20))
  python -m repro_torch.launch.ingest --device cpu --n 4096 --edges 16384 \\
      --batch 4096
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import numpy as np
import torch

from ..core import streaming
from ..core.finish import resolve_finish
from ..device import DEFAULT_DEVICE, resolve_device
from ..graphs import generators as gen
from ..legacy import checkpoint as ckpt
from ..legacy.data import EdgeStream

CKPT_EVERY = 8


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _queries(step: int, nq: int, n: int, dev: torch.device) -> tuple:
    g = torch.Generator(device=dev)
    ends = []
    for seed in (step, step + 1):
        g.manual_seed(seed)
        ends.append(torch.randint(0, n, (nq,), generator=g, device=dev,
                                  dtype=torch.int32))
    return tuple(ends)


def run_ingest(n: int, edges: int, batch: int, finish: str = "uf_sync_full",
               graph: str = "rmat", seed: int = 0, query_frac: float = 0.0,
               ckpt_dir: Optional[str] = None, verbose: bool = True, *,
               device=DEFAULT_DEVICE, max_steps: Optional[int] = None):
    """Insert-and-query batches of a generated graph's directed edges in a
    seeded order → ``(directed edges/s, StreamState)``."""
    dev = resolve_device(device)
    g = {"rmat": lambda: gen.rmat(n, edges, seed=seed, device=dev),
         "ba": lambda: gen.barabasi_albert(n, max(edges // n, 1), seed=seed,
                                           device=dev),
         }[graph]()
    s = g.senders[: g.m].cpu().numpy()
    r = g.receivers[: g.m].cpu().numpy()
    perm = np.random.default_rng(seed).permutation(g.m)
    stream = EdgeStream(s[perm], r[perm], batch, g.n, seed=seed, device=dev)
    nq = max(int(batch * query_frac), 1)
    state = streaming.init_stream(g.n, device=dev)
    start = 0
    manager = None
    if ckpt_dir:
        manager = ckpt.CheckpointManager(ckpt_dir, every=CKPT_EVERY)
        (state,), start = manager.resume_or((state,))
    finish_fn = resolve_finish(finish)
    # one warmup batch (the first launch of each kernel loads its library)
    b0 = stream.batch_at(start)
    zq = torch.zeros((nq,), dtype=torch.int32, device=dev)
    streaming.process_batch_fn(state, b0["u"], b0["v"], zq, zq, finish_fn)
    _sync(dev)
    stop = stream.num_batches()
    if max_steps is not None:
        stop = min(stop, start + max_steps)
    t0 = time.time()
    total_edges = 0
    for step in range(start, stop):
        b = stream.batch_at(step)
        qa, qb = _queries(step, nq, g.n, dev)
        state, _ = streaming.process_batch_fn(state, b["u"], b["v"], qa, qb,
                                              finish_fn)
        total_edges += batch
        if manager:
            manager.maybe_save((state,), step + 1)
    _sync(dev)
    dt = time.time() - t0
    tput = total_edges / max(dt, 1e-9)
    if verbose:
        print(f"[ingest] n={n} edges={total_edges} batch={batch} "
              f"finish={finish} steps={start}..{stop} of "
              f"{stream.num_batches()}: {tput:.3e} directed edges/s "
              f"({dt:.2f}s)")
    return tput, state


def run_chunked(n: int, edges: int, chunk: int,
                variant: str = "kout_afforest_k2+uf_sync_full",
                graph: str = "rmat", seed: int = 0,
                survivor_cap: Optional[int] = None, verbose: bool = True, *,
                device=DEFAULT_DEVICE):
    """Out-of-core ingest: generate → relabel → survivor buffer, bounded
    memory end to end → ``(edges/s, labels)``."""
    from ..api import ConnectIt
    dev = resolve_device(device)
    make = {"rmat": gen.rmat_chunks, "powerlaw": gen.powerlaw_chunks}[graph]
    src = make(n, edges, chunk=chunk, seed=seed)
    ci = ConnectIt(variant, device=dev)
    t0 = time.time()
    labels, stats = ci.from_chunks(src, survivor_cap=survivor_cap,
                                   return_stats=True)
    labels = labels.cpu()
    dt = time.time() - t0
    tput = edges / max(dt, 1e-9)
    if verbose:
        print(f"[ingest --chunked] n={n} edges={edges} chunk={chunk} "
              f"variant={variant}: {tput:.3e} edges/s ({dt:.2f}s), "
              f"survivor_ratio={stats.survivor_ratio:.4f} "
              f"spills={stats.spills} chunks={stats.chunks}")
    return tput, labels


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 17)
    ap.add_argument("--edges", type=int, default=1 << 20)
    ap.add_argument("--batch", type=int, default=1 << 16,
                    help="insert batch size; chunk size under --chunked")
    ap.add_argument("--finish", default="uf_sync_full")
    ap.add_argument("--graph", default="rmat",
                    choices=["rmat", "ba", "powerlaw"])
    ap.add_argument("--query-frac", type=float, default=0.0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunked", action="store_true",
                    help="out-of-core chunked ingest (repro_torch.graphs."
                         "ingest): the edge list is never materialized")
    ap.add_argument("--variant", default="kout_afforest_k2+uf_sync_full",
                    help="VariantSpec for --chunked")
    ap.add_argument("--survivor-cap", type=int, default=None)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    ap.add_argument("--max-steps", type=int, default=None,
                    help="stop after this many batches of this run")
    ap.add_argument("--out", default=None,
                    help="save the final (n,) labels here (numpy.save)")
    args = ap.parse_args(argv)
    if args.chunked:
        if args.graph == "ba":
            ap.error("--chunked supports rmat | powerlaw")
        _, labels = run_chunked(args.n, args.edges, args.batch, args.variant,
                                args.graph, args.seed, args.survivor_cap,
                                device=args.device)
    else:
        if args.graph == "powerlaw":
            ap.error("powerlaw is a --chunked source")
        _, state = run_ingest(args.n, args.edges, args.batch, args.finish,
                              args.graph, args.seed, args.query_frac,
                              args.ckpt_dir, device=args.device,
                              max_steps=args.max_steps)
        labels = state.P[: args.n].cpu()
    if args.out:
        np.save(args.out, labels.numpy())
    return 0


if __name__ == "__main__":
    sys.exit(main())
