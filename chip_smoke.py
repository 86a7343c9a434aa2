#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA card and check them.

    python3 chip_smoke.py                         # RMAT n=2^22, 2^25 edges;
                                                  # DLRM-RM2 at full width
    python3 chip_smoke.py --log-n 14 --log-m 17   # a short compile check
                                                  # (DLRM vocab, batches and
                                                  # candidates cut to 2^14)
    python3 chip_smoke.py --ranks 4               # only the placements and
                                                  # the sharded cells, on 4
                                                  # cards, a rank each

Phases, in order; any failure exits non-zero:

  1. device   the card's name and power limit (nvidia-smi);
  2. build    nvcc builds every CUDA kernel from src/repro_torch/kernels/csrc
              (one process per source, all at once) into build/kernels/,
              with each kernel's registers, shared memory and spills;
  3. graph    an RMAT graph, paper parameters (a,b,c) = (0.5, 0.1, 0.1),
              generated on the host from the seed and built on the card;
  4. kernels  each kernel at the main paths' shapes against its plain
              PyTorch version on the same inputs (the int32 kernels exactly,
              embedding_bag within BAG_TOL), with its time, the plain
              version's, one PyTorch call's where one computes the same
              function (scatter_reduce for scatter_min; for pointer_jump at
              k = 1 and edge_rewrite, gathers through the labels with a -1
              slot appended), and the bound. The connectivity kernels also
              run on what the paths really hand them: the hook of
              hook_compress on the graph edges with (a) the phase's labels,
              (b) all labels -1 (the pass's floor), (c) identity labels, and
              (d) the first round of the sampler, of the compacted finish
              and of the fused finish, at k = 0 and 3; scatter_min on
              uniform targets, on a synthetic hub taking ~98% of them, on
              min_vertex_labels' call after the main path; edge_relabel and
              edge_rewrite on the graph edges with the phase's labels and
              with ~10% -1 endpoints; pointer_jump on the phase's labels at
              k = 1 and 3. Then every call, recorded from real runs
              (RECORDED) and timed as one run's calls back to back:
              scatter_min's finish calls of kout_hybrid_k2+liu_tarjan_CRFA
              and kout_hybrid_k2+label_prop, compacted and fused, and both
              passes of every round of a none+uf_sync_full spanning forest;
              edge_relabel's of kout_hybrid_k2+liu_tarjan_PUFA, compacted
              and fused (3 each), and of none+stergiou (4, on the rewritten
              endpoints), with their count of live proposals;
              pointer_jump's of the main path, compacted and fused (12
              each); edge_rewrite's of kout_hybrid_k2+liu_tarjan_PUFA (3)
              and _CRFA (4), compacted and fused, of none+stergiou (4, on
              the graph edges) and of the main variant's first 8 stream
              batches of 2^20 edges, with their count of non-negative ends;
              the ingest phase's calls: edge_rewrite's and hook_compress's
              of the main variant on the graph's edges in 8 chunks, and
              every kernel's of kout_afforest_k2+uf_sync_full on the
              power-law stream of 2^25 edges over 2^24 vertices; an
              evenly spaced sample (4 to 7 calls) of scatter_min's and
              pointer_jump's in the main variant's amsf; and the same sample
              of the serve phase's closed loops: edge_rewrite's,
              hook_compress's and pointer_jump's of the static server
              (commits of at most 32,768 directed entries against the
              preloaded 2^22 + 1 labels), scatter_min's and pointer_jump's
              of the dynamic server; and every call but the
              canonicalization's of the placements phase's one-rank runs:
              the main variant's under sharded(x) (scatter_min's into the
              label window plus one appended dump slot, hook_compress's,
              pointer_jump's) and under sharded(x):overlap (scatter_min's,
              hook_compress's on the two half-blocks), and
              kout_hybrid_k2+liu_tarjan_PUFA's edge_relabel and
              edge_rewrite calls under sharded(x); and, one run at a time
              (LATE_RUNS), the connectit cells' calls at their published
              sizes: the first and last hook_compress round of
              static_1b_edges (2^30 edges on 2^26 + 1 labels) with the
              pointer_jump call of its exactness check's compression (run
              kind "cell"), of ingest_256m_batch (its batch mirrored to
              2^29 entries) with its stream's pointer_jump ("cell
              ingest"), and of static_8b_edges_sharded at one rank (2^31
              edges on 2^28 + 1 labels) with its 7 scatter_min frontier
              applies into the window plus a dump slot ("cell sharded").
              The plain hook proposes 2^26 edges a pass, so it fits beside
              2^31 edges.
              Bounds count the bytes this run's data needs (edge_rewrite:
              the label slots its non-negative ends read). embedding_bag
              on a 1,000,448 x 64 table at RM2's serve_bulk shape (B=262144, L=1, zipfian ids) and a multi-hot
              one (B=65536, L=8, ~10% on the dump row, and with wrapped and
              clamped ids), sum / mean / max, float32 / bfloat16;
  5. small    every variant of enumerate_variants() (148) on a small graph,
              compacted and fused, on the card, against the CPU path and
              scipy; the spanning forest of its 28 forest-capable variants,
              valid on the card and the CPU path, and equal row for row on
              the deterministic samplings;
  6. oracle   scipy's labels of the big graph and its sorted edge keys
              (each scipy oracle's CSR input is sorted, counted and, for
              components, deduplicated on the card);
  7. paths    on the big graph, each against the scipy oracle, with wall
              time, stats, peak memory and each kernel's launch count; each
              path names its launches per kernel and finish rounds on the
              default graph, asserted there (LDD's follow the random stream
              and are printed):
                kout_hybrid_k2+uf_sync_full      compacted, fused (the main path)
                kout_hybrid_k2+liu_tarjan_PUFA   compacted, fused
                kout_hybrid_k2+liu_tarjan_CRFA   compacted, fused
                none+stergiou
                ldd_b0.2+uf_sync_full
  8. forest   ConnectIt(v).spanning_forest(g) for the FOREST_PATHS variants
              on the big graph, each forest checked on the host: n -
              #components edges, the graph's components, every edge in the
              graph; wall time, peak memory, launches and finish rounds
              (asserted on the default graph but for BFS and LDD);
  9. stream   the graph's undirected edges permuted by --seed through
              ConnectIt(MAIN_VARIANT).stream(n) in batches of 2^20 and, for
              the first 2^22, of 2^16, with 2^16 query pairs a batch: labels
              against scipy's, the queries of batch 8 and of the last batch
              against scipy on the prefix; inserted edges/s, per-batch p50
              and p99; launches and rounds asserted on the default graph;
 10. dynamic  (a) the same 2^20 batches through stream(n, dynamic=True,
              log=2^26): labels and forest against the graph's; (b) 8 steps
              of sliding_window(n, batch=2^20, window=4, queries=2^16) on a
              fresh stream(n, dynamic=True, log=2^23): each step's answers
              against scipy on the live multiset, the final forest within
              the survivors; updates/s, rounds, fallback rebuilds;
 11. serve    ConnectIt(MAIN_VARIANT).serve(n) at benchmarks/serve_bench.py's
              full-scale settings (max_batch_edges 16384, max_batch_queries
              8192, flush_ms 0.5, warmup "all"): the static server preloaded
              with the stream phase's edges in commits of 2^20, an untimed
              closed-loop pass, a closed loop of 16 clients x 48 requests
              (1024 query pairs each, 4096 insert edges every 4th) and open
              loops at 0.25, 0.5 and 0.75 of its QPS (256 requests), each
              LoadResult row and the server's stats; epochs in commit order,
              every submitted edge committed, the final partition and the
              answers of 4 evenly spaced epochs against scipy on their prefix
              of the commit log, edge_rewrite once a commit; then the dynamic
              server (log 2^23) preloaded with 4 commits of 2^20 and a closed
              loop of 16 x 16 with delete_frac 0.25: its labels against scipy
              on the live multiset replayed from the commit log;
 12. ingest   ConnectIt(v).from_chunks on the graph's undirected edges in
              the stream phase's order, a host ArrayEdgeSource of 8 chunks
              (2^22 each), for kout_hybrid_k2+, kout_afforest_k2+ and
              none+uf_sync_full: labels against scipy and .connectivity,
              chunks, edges streamed, survivors, spills, rounds, edges/s,
              peak memory beside the one-shot path's; the same edges as
              CompressedEdgeBlocks (2^16 a block) decoded on the card;
              powerlaw_chunks(4n, m, seed=7) at m = 2^25 and 2^27 (labels
              against scipy at 2^27), whose peaks must agree within 5% and
              print beside the analytic resident bytes; edge_rewrite once a
              chunk;
 13. apps     with_weights(g, seed=0): amsf, amsf(skip=lmax), amsf(mode=coo)
              and msf with the main variant, each a spanning forest (checked
              as in the forest phase) whose weight is within 1.25x of scipy's
              minimum spanning tree (msf: equal to float32 rounding);
              scan(eps=0.6,mu=3) and scan(eps=0.3,mu=3) on seeded symmetric
              similarities against a numpy/scipy restatement of the
              sequential query, and scan(eps=0.1,mu=3), scan(eps=0.3,mu=3)
              on rmat(2^13, 12*2^13, seed=4) with build_index's
              similarities against gs_query_sequential;
 14. placements the replicated and sharded placements on the graph, each
              against scipy's labels: (a) one rank over NCCL in this
              process: the main variant under replicated(x), sharded(x),
              sharded(x):frontier=0, sharded(x):fused, sharded(x):overlap
              and sharded(x,y), none+uf_sync_full under replicated(x) and
              sharded(x), and kout_hybrid_k2+liu_tarjan_PUFA under
              sharded(x), each also against the single path's labels, with
              its median wall of 5, rounds, launches (asserted on the
              default graph), host waits an outer round from one traced
              run (the sharded(x) main run's trace printed whole) and peak
              memory; (b) the stream phase's 2^20-edge batches under
              sharded(x): labels, the last batch's answers, edges/s, p50;
              (c) scan(eps=0.6,mu=3) under sharded(x) against the single
              path on the apps phase's similarities; (e) the dynamic
              phase's 8 sliding_window steps under replicated(x) and
              sharded(x): each step's answers, the final labels and rounds
              against the single path's, the forest n - #components edges
              of the live graph, with updates/s, per-step p50/p99,
              fallbacks and a traced ninth step; (f) amsf and
              amsf(skip=lmax) under both on the apps phase's weights: a
              spanning forest within 1.25x of scipy's MST weight, buckets
              and edges per bucket the single path's, and one traced
              sharded(x) run; (g) the serve phase's static and dynamic
              servers under sharded(x), same caps and traffic without the
              open loops, answers at 2 epochs and the final labels against
              scipy, a traced closed-loop window; (d) two processes
              sharing the card over gloo (this script with --mesh-rank),
              reading the graph and scipy's labels this process writes once
              to a temporary directory: replicated(x), sharded(x),
              sharded(x):frontier=0, each against scipy's labels (which
              (a)'s equal), with wall and rounds;
 15. tune     the tuning loop on the card, each part in a cache file of its
              own: (a) the five connectivity kernels at every block size
              of the ladder (256 threads, the one they are built for)
              against the plain versions bit for bit on tune_block_m's
              problem (n = 2^22 parents, 2^24 uniform edges), and refusing
              any other; each point's time_fn median beside a CUDA-event
              mean of 20 launches, then tune_block_m; (b) tune_variant over
              the seven fast variants on the graph, each variant's median
              and the winner; (c) ConnectIt("auto") on that cache runs the
              winner: labels equal scipy's, finish rounds the winner's
              explicit run's; (d) ConnectIt("auto", exec="single:tune") on
              a fresh cache measures once for two calls; (e) python -m
              repro_torch.launch.tune --smoke exits 0, then the full CLI
              on its proxies, whose device-global winner is printed beside
              (b)'s; (f) the cold cache resolves 256 threads again;
 16. cells    the connectit cells (launch.steps.build_cell, CONNECTIT_SHAPES)
              at their published sizes on a one-rank (data, model) mesh
              over NCCL, each on a planted graph generated on the card
              (2^20 blocks: a random tree in each, the rest of the edges
              uniform inside a block; exact iff every edge's ends share a
              root and the roots number the blocks): static_1b_edges
              (2^26 vertices, 2^30 edges; wall of the counted run and
              median of CELL_TIMING_REPEATS after it), ingest_256m_batch
              (one 2^28-edge batch, 2^20 uniform query pairs against block
              identity; batch edges/s), static_8b_edges_sharded and
              static_8b_sharded_fused (2^28 vertices, 2^31 edges), each
              with its peak above the inputs, outer rounds and launches
              (CELL_COUNTS, asserted on the default graph); the legacy
              shims on the graph (connectivity(g, sample="kout",
              finish="uf_sync"), get_finish("liu_tarjan_CRFA") through
              run_connectivity, make_replicated_connectivity at one rank)
              against scipy; every wall so far timed with nothing else
              running; then python -m repro_torch.launch.dryrun --all
              --mesh both beside python -m repro_torch.launch.ingest on the
              graph's rmat (n = 2^22, 2^25 edges, batches of 2^20): plain,
              stopped after CLI_STOP_STEPS batches with --ckpt-dir and
              resumed, each against scipy, and --chunked (chunks of 2^22)
              against scipy on its stream;
 17. dlrm     DLRM-RM2 built on the card from the seed (26 x 1,000,448 x 64
              float32 tables, 6.66 GB); serve_p99 (B=512), serve_bulk
              (B=262144) and retrieval_cand (10^6 candidates), each through
              the embedding_bag kernel and held against the same model
              through the plain version, with step times, peak memory and
              launches per step;
 18. profile  where the compacted main path's time goes: wall time per
              driver step, device time per kernel and the device's busy
              share (torch.profiler); then the same trace of none+stergiou,
              of kout_hybrid_k2+liu_tarjan_PUFA fused (its per-round state
              compares run over the whole edge list), of one stream batch
              and one dynamic step, of one ingest of the ingest phase's
              8-chunk source, one amsf(skip=lmax) with the main variant and
              one msf, one closed-loop window of the serve phase's static
              server (with the host's waits a commit), and of one DLRM-RM2
              serve_bulk and one serve_p99 step.

With --ranks N (N > 1) it runs device, build, graph and oracle, then
only the placements across N cards: the runs of (a) and the stream of (b)
on N processes of this script, one rank a card over NCCL, each rank's
labels against scipy's, the ranks' rounds and stats equal, with each run's
wall, rounds, edges per rank and launches; then (e) and amsf(skip=lmax)
under sharded(x), against the single path's runs in this process, and one
served closed loop under sharded(x), rank 0 serving and the other ranks
following its commits, every rank's final labels equal to rank 0's and to
scipy's on rank 0's commit log; last ConnectIt("auto",
exec="sharded(x):tune"), each rank on a cache file of its own: every rank
elects rank 0's winner, only rank 0's file is written, and every rank's
labels equal scipy's. Then the two sharded cells at their published sizes
on a (data, model) mesh of N processes, one rank a card: each rank
generates only its edge block and label window, and the gathered labels
pass the planted check on every rank.

The whole script reads a tuning cache of its own, an empty file under a
temporary directory (REPRO_TORCH_TUNE_CACHE, printed first), so every
kernel launches 256 threads a block outside the tune phase whatever a
cache in the home directory holds. Each phase prints its seconds.
The line before the last holds the per-kernel JSON; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA card, or outside a
checkout of the repository, it prints no result and exits 1.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MAIN_VARIANT = "kout_hybrid_k2+uf_sync_full"
UF_KERNELS = ("hook_compress", "pointer_jump", "scatter_min")
PATH_KERNELS = UF_KERNELS + ("edge_relabel", "edge_rewrite")
# (variant, fused modes, launches of PATH_KERNELS per run and finish rounds
# on the default graph, which no change inside a kernel may alter); the
# first is the main path, whose launches the per-kernel JSON
# reports for its three kernels. A run must launch each kernel with a count
# above 0, at any size.
PATHS = (
    (MAIN_VARIANT, (False, True), (7, 12, 1, 0, 0), 3),
    ("kout_hybrid_k2+liu_tarjan_PUFA", (False, True), (4, 15, 1, 3, 3), 3),
    ("kout_hybrid_k2+liu_tarjan_CRFA", (False, True), (4, 16, 9, 0, 4), 4),
    ("none+stergiou", (False,), (0, 5, 1, 4, 4), 4),
    ("ldd_b0.2+uf_sync_full", (False,), (2, 4, 82, 0, 0), 2),
)
# paths whose counts follow the random stream (LDD's shifts, BFS's
# sources): printed, not asserted
RANDOM_STREAM_PATHS = ("ldd_b0.2+uf_sync_full", "bfs_c3+uf_sync_full")
DEFAULT_GRAPH = (22, 25, 0)  # log n, log m, seed
# the path whose compacted run reports the two edge kernels' launches
EDGE_PATH = "kout_hybrid_k2+liu_tarjan_PUFA"
# spanning forests on the big graph: (variant, (launches of PATH_KERNELS,
# finish rounds) on the default graph), asserted there but for
# RANDOM_STREAM_PATHS
FOREST_PATHS = (
    (MAIN_VARIANT, ((0, 19, 14, 0, 0), 3)),
    ("none+uf_sync_full", ((0, 11, 8, 0, 0), 4)),
    ("kout_afforest_k2+uf_sync_full", ((0, 16, 12, 0, 0), 2)),
    ("bfs_c3+uf_sync_full", ((0, 9, 20, 0, 0), 4)),
    ("ldd_b0.2+uf_sync_full", ((0, 4, 166, 0, 0), 2)),
    ("kout_hybrid_k2+shiloach_vishkin", ((0, 19, 14, 0, 0), 3)),
)
# the stream phase's launches of PATH_KERNELS and finish rounds per batch
# size, and the dynamic phase's for (a) and (b), on the default graph
STREAM_COUNTS = {1 << 20: ((103, 145, 0, 0, 32), 103),
                 1 << 16: ((209, 290, 0, 0, 64), 209)}
DYNAMIC_COUNTS = {"a": ((0, 251, 206, 0, 0), 103),
                  "b": ((0, 200, 122, 0, 0), 61)}
# the placements phase's one-rank runs over NCCL: (variant, exec), and
# their launches of PATH_KERNELS and finish rounds on the default graph
PLACEMENT_RUNS = (
    (MAIN_VARIANT, "replicated(x)"), (MAIN_VARIANT, "sharded(x)"),
    (MAIN_VARIANT, "sharded(x):frontier=0"), (MAIN_VARIANT, "sharded(x):fused"),
    (MAIN_VARIANT, "sharded(x):overlap"), (MAIN_VARIANT, "sharded(x,y)"),
    ("none+uf_sync_full", "replicated(x)"), ("none+uf_sync_full", "sharded(x)"),
    (EDGE_PATH, "sharded(x)"),
)
PLACEMENT_COUNTS = {
    (MAIN_VARIANT, "replicated(x)"): ((8, 13, 1, 0, 0), 2),
    (MAIN_VARIANT, "sharded(x)"): ((8, 13, 3, 0, 0), 2),
    (MAIN_VARIANT, "sharded(x):frontier=0"): ((8, 13, 1, 0, 0), 2),
    (MAIN_VARIANT, "sharded(x):fused"): ((8, 13, 3, 0, 0), 2),
    (MAIN_VARIANT, "sharded(x):overlap"): ((12, 17, 3, 0, 0), 5),
    (MAIN_VARIANT, "sharded(x,y)"): ((8, 13, 3, 0, 0), 2),
    ("none+uf_sync_full", "replicated(x)"): ((5, 8, 1, 0, 0), 2),
    ("none+uf_sync_full", "sharded(x)"): ((5, 8, 2, 0, 0), 2),
    (EDGE_PATH, "sharded(x)"): ((4, 17, 3, 5, 5), 2),
}
# the placements phase's stream under sharded(x), 2^20-edge batches
PLACEMENT_STREAM_COUNTS = ((135, 177, 63, 0, 0), 64)
# the placements phase's (e) dynamic streams (the dynamic phase's
# sliding_window) and (f) AMSF under each placement, one rank over NCCL;
# their launches of PATH_KERNELS and rounds on the default graph
PLACEMENT_DYN_EXECS = ("replicated(x)", "sharded(x)")
AMSF_SPECS = ("amsf", "amsf(skip=lmax)")
PLACEMENT_DYNAMIC_COUNTS = {"replicated(x)": ((0, 188, 159, 0, 0), 61),
                            "sharded(x)": ((0, 188, 159, 0, 0), 61)}
PLACEMENT_AMSF_COUNTS = {
    (e, spec): ((0, 332 if spec == "amsf" else 423, 535, 0, 0), 239)
    for e in PLACEMENT_DYN_EXECS for spec in AMSF_SPECS}
# (g): the serve phase's servers under this placement
SERVE_EXEC = "sharded(x)"
# the placements the two gloo ranks sharing the card run (MAIN_VARIANT)
GLOO_EXECS = ("replicated(x)", "sharded(x)", "sharded(x):frontier=0")
# the cells phase: the connectit cells (CONNECTIT_SHAPES) on planted graphs
# of CELL_BLOCKS components, generated CELL_CHUNK edge slots at a time;
# static_1b_edges timed CELL_TIMING_REPEATS times after its counted run; the
# ingest CLI stopped after CLI_STOP_STEPS batches and resumed; the legacy
# replicated factory's fixed rounds on the graph phase's graph
CELL_BLOCKS = 1 << 20
CELL_CHUNK = 1 << 26
CELL_TIMING_REPEATS = 3
CLI_STOP_STEPS = 20
SHIM_MESH_ROUNDS = 64
# each cell's launches of PATH_KERNELS in one run and its outer rounds, at
# the published sizes (the sharded cells at one rank)
CELL_COUNTS = {
    "static_1b_edges": ((12, 0, 0, 0, 0), 8),
    "ingest_256m_batch": ((8, 1, 0, 0, 0), 4),
    "static_8b_edges_sharded": ((13, 0, 7, 0, 0), 8),
    "static_8b_sharded_fused": ((13, 0, 7, 0, 0), 8),
}
# the connectit cells' finish (ConnectItConfig.finish, no sampling). Their
# recorded run kinds, at the published sizes: "cell" (static_1b_edges, then
# the exactness check's compression: 2^30 edges, 2^26 + 1 labels), "cell
# ingest" (ingest_256m_batch: its batch mirrored to 2^29 entries) and "cell
# sharded" (static_8b_edges_sharded at one rank: 2^31 edges, 2^28 + 1
# labels, frontier applies into the window plus a dump slot). Each keeps
# the first and the last call of CELL_FIRST_LAST's kernels and every call
# of the others.
CELL_VARIANT = "none+uf_sync_naive"
CELL_FIRST_LAST = ("hook_compress", "pointer_jump")
# recorded runs whose calls the kernels phase compares last, one run at a
# time with every other input freed: a cell's calls and their plain
# versions would not fit beside the other runs' calls
LATE_RUNS = ("cell", "cell ingest", "cell sharded")
# the tune phase: launches each block size is timed over with CUDA events
TUNE_EVENT_ITERS = 20
# samplings whose stats take no random draw, so the card's equal the CPU's
DETERMINISTIC_SAMPLINGS = ("none", "kout_afforest_k2")
# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12  # 32-bit, outside the tensor cores
INT32_MAX = 2**31 - 1
# DLRM-RM2 (src/repro_torch/configs/legacy/dlrm_rm2.py) at full width
RM2_VOCAB = 1_000_000
BAG_MODES = ("sum", "mean", "max")
# embedding_bag against its plain version: a one-row float32 bag is a copy
# (exact); longer bags sum in another order (the reference test's
# tolerances, rtol = atol)
BAG_TOL = {"float32": 1e-6, "bfloat16": 3e-2}


class SmokeFailure(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def bound_ms(nbytes: int, nops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, iters: int, warmup: int = 2,
            budget_ms: float = 200.0) -> float:
    """Mean ms of one call over ``iters`` back-to-back calls (CUDA events).
    A call whose last warm-up took longer than ``budget_ms / iters`` (the
    plain versions and library calls on whole edge lists, 0.1-0.5 s each)
    is timed over fewer calls, at least 3."""
    for _ in range(warmup - 1):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    last = (time.perf_counter() - t0) * 1e3
    iters = max(3, min(iters, int(budget_ms / max(last, 1e-3))))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device(torch) -> dict:
    print(_card_line())
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"[device] torch.cuda.get_device_name(0)={kind!r} count={count} "
          f"torch={torch.__version__} cuda={torch.version.cuda}")
    return {"platform": "gpu", "kind": kind, "count": count}


def _card_line() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    records = _build.build_all()
    print(f"[build] {len(records)} libraries in "
          f"{time.perf_counter() - t0:.2f} s (wall, parallel nvcc)")
    for rec in records.values():
        print(f"[build] {rec.name}: {rec.seconds:.2f} s -> {rec.path.name}")
        for entry in _ptxas_summary(rec.ptxas):
            print(f"[build]   {entry}")
    for name in _build.SIGNATURES:
        _build.load(name)


def _ptxas_summary(lines) -> list:
    """One line per compiled kernel of ``nvcc -Xptxas -v``'s output:
    registers, shared memory and spills."""
    import re
    out, kernel, spills = [], None, "spills not reported"
    for line in lines:
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            name = re.search(r"\d([a-z_]+_kernel)", m.group(1))
            vec = re.search(r"ILi(\d+)E", m.group(1))
            kernel = ((name.group(1) if name else m.group(1))
                      + (f"<{vec.group(1)}>" if vec else ""))
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", line):
            spills = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
        elif kernel and (m := re.search(r"Used (\d+) registers", line)):
            smem = re.search(r"(\d+) bytes smem", line)
            out.append(f"{kernel}: {m.group(1)} registers, "
                       f"{smem.group(1) if smem else 0} bytes shared memory, "
                       f"{spills}")
            kernel, spills = None, "spills not reported"
    return out


def phase_graph(torch, log_n: int, log_m: int, seed: int):
    from repro_torch.graphs.containers import build_graph
    from repro_torch.graphs.generators import rmat_edges
    n, m = 1 << log_n, 1 << log_m
    t0 = time.perf_counter()
    edges = rmat_edges(n, m, seed=seed)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    g = build_graph(edges, n, device="cuda")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    del edges
    print(f"[graph] rmat n=2^{log_n} edges=2^{log_m} seed={seed}: "
          f"m={g.m} directed (m_pad={g.m_pad}); host generation "
          f"{t_gen:.2f} s, build_graph on the card {t_build:.3f} s")
    return g


def _labels_with_virtual_min(torch, L: int, gen):
    """Chains, roots, and ~10% sprinkled -1 virtual minimums."""
    lab = torch.randint(0, L, (L,), generator=gen, device="cuda")
    lab = torch.minimum(lab, torch.arange(L, device="cuda"))
    lab[torch.rand(L, generator=gen, device="cuda") < 0.1] = -1
    return lab.to(torch.int32)


def _max_abs_err(torch, got, want) -> int:
    """Largest |got - want| over the (tuple of) outputs; -1 if any output's
    shape or dtype differs from the plain version's."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0
    for a, b in zip(got, want, strict=True):
        if a.shape != b.shape or a.dtype != b.dtype:
            return -1
        if a.numel():
            err = max(err, int((a.long() - b.long()).abs().max()))
    return err


def _main_path_inputs(torch, g) -> dict:
    """What the main path really hands its two accumulating kernels:
    hook_compress's first round in the sampler (identity labels, the ~2n
    k-out edges), in the compacted finish (the kept edges on relabel_lmax's
    output) and in the fused finish (all edges on the pinned labels); and
    scatter_min's call in min_vertex_labels (every vertex's id to its
    component's slot)."""
    from repro_torch import ConnectIt
    from repro_torch.core import driver
    from repro_torch.core.primitives import init_labels
    from repro_torch.core.sampling import _select_kout_edges

    session = ConnectIt(MAIN_VARIANT, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    s_k, r_k = _select_kout_edges(g, gen, 2, "hybrid")
    gen.manual_seed(0)
    P_sampled = session._sampler(g, gen)
    P_pinned, keep, _, _ = driver._prep_sampled(P_sampled, g.senders,
                                                g.receivers)
    s_c, r_c, _ = driver._compact(g.senders, g.receivers, keep, g.n,
                                  pad="pow2")
    labels = session.connectivity(g)
    n = labels.shape[0]
    ext = torch.cat([labels, labels.new_tensor([n])])
    ids = torch.arange(n + 1, dtype=torch.int32, device="cuda")
    canon = (torch.full_like(ext, n), torch.where(ids < n, ext, n),
             torch.where(ids < n, ids, INT32_MAX))
    top = int(torch.bincount(labels.long()).max())
    print(f"[kernels] main-path inputs: sampled {s_k.shape[0]} k-out edges; "
          f"compacted {s_c.shape[0]} edges ({int(keep.sum())} kept); fused "
          f"{g.m_pad} edges, {int((P_pinned < 0).sum())} of {n + 1} labels "
          f"pinned to -1; canonicalization {top} of {n} vertices in one "
          f"component")
    return {"sampled": (init_labels(g.n, device="cuda"), s_k, r_k),
            "compacted": (P_pinned, s_c, r_c),
            "fused": (P_pinned, g.senders, g.receivers),
            "canonicalization": canon}


# runs whose calls of a kernel are recorded, and the kernel is timed on
# them: scatter_min on the heaviest finish traffic, Liu-Tarjan connect's
# write_min over the edge list (8 of CRFA's 9 launches) and label
# propagation's, and both passes of the spanning forest's hook_and_record
# (the labels, then edge ids into an INT_MAX buffer) in each round of a
# none+uf_sync_full forest run; edge_relabel on Liu-Tarjan PUFA's connect
# rounds (fused: the whole edge list, mostly -1 endpoints) and Stergiou's
# rounds (the rewritten endpoints prev[s], prev[r]); pointer_jump on the
# main path's calls; edge_rewrite on every path that calls it: the alter
# steps of Liu-Tarjan PUFA and CRFA (compacted: the kept edges; fused: the
# whole edge list, whose ends turn -1 round by round), Stergiou's endpoint
# rewrites (the original graph edges, every end live), and the main
# variant's first RECORDED_STREAM_BATCHES stream batches of STREAM_BATCH
# edges. The ingest phase's sources: the graph's edges in 8 chunks
# ("ingest": a rewrite a chunk, the head's k-out hooks and the finalize's
# hooks over the 2 x (2^24 + 1)-entry survivor buffer) and the power-law
# stream at 2^(log_m) edges over 4n vertices ("ingest powerlaw": every
# kernel on labels larger than the card's L2). The apps phase's amsf
# ("amsf": both forest passes a round and the compressions, each on the
# whole edge list; an evenly spaced sample of its calls, see
# RECORDED_SAMPLED_CALLS). The serve phase's servers ("serve": the static
# server's commits of at most SERVE_CAPS' 16,384 edges, 32,768 directed
# entries, against the preloaded 2^22 + 1 labels; "serve dynamic": the
# dynamic server's forest rounds, deletes included): an evenly spaced
# sample of the closed loop's calls, none of the preload's. The placements
# phase's one-rank runs ("placement sharded": sharded(x), whose frontier
# merge scatters into the label window plus one appended dump slot, and
# the PUFA run's calls on the edge block; "placement overlap":
# sharded(x):overlap, its finishes on the two half-blocks): every call but
# the canonicalization's. (kernel, variant, runs: "compacted" and "fused"
# connectivity, "forest", "stream", "ingest", "ingest powerlaw", "amsf",
# "serve", "serve dynamic", "placement sharded", "placement overlap",
# "placement dynamic", "placement amsf"). The placements phase's (e) and
# (f) under sharded(x) ("placement dynamic": RECORDED_DYNAMIC_STEPS steps of
# the sliding window; "placement amsf": amsf): an evenly spaced sample of
# their calls, the merged forest round's third scatter_min pass (into the
# stacked endpoint buffer of 2 (n + 1) + 1 slots) sampled apart.
RECORDED = (
    ("scatter_min", "kout_hybrid_k2+liu_tarjan_CRFA", ("compacted", "fused")),
    ("scatter_min", "kout_hybrid_k2+label_prop", ("compacted", "fused")),
    ("scatter_min", "none+uf_sync_full", ("forest",)),
    ("scatter_min", "kout_afforest_k2+uf_sync_full", ("ingest powerlaw",)),
    ("scatter_min", MAIN_VARIANT, ("amsf", "serve dynamic",
                                   "placement sharded", "placement overlap",
                                   "placement dynamic", "placement amsf")),
    ("edge_relabel", "kout_hybrid_k2+liu_tarjan_PUFA", ("compacted", "fused",
                                                        "placement sharded")),
    ("edge_relabel", "none+stergiou", ("compacted",)),
    ("pointer_jump", MAIN_VARIANT, ("compacted", "fused", "amsf", "serve",
                                    "serve dynamic", "placement sharded",
                                    "placement dynamic", "placement amsf")),
    ("pointer_jump", "kout_afforest_k2+uf_sync_full", ("ingest powerlaw",)),
    ("edge_rewrite", "kout_hybrid_k2+liu_tarjan_PUFA", ("compacted", "fused",
                                                        "placement sharded")),
    ("edge_rewrite", "kout_hybrid_k2+liu_tarjan_CRFA", ("compacted", "fused")),
    ("edge_rewrite", "none+stergiou", ("compacted",)),
    ("edge_rewrite", MAIN_VARIANT, ("stream", "ingest", "serve")),
    ("edge_rewrite", "kout_afforest_k2+uf_sync_full", ("ingest powerlaw",)),
    ("hook_compress", MAIN_VARIANT, ("ingest", "serve", "placement sharded",
                                     "placement overlap")),
    ("hook_compress", "kout_afforest_k2+uf_sync_full", ("ingest powerlaw",)),
    ("hook_compress", CELL_VARIANT, LATE_RUNS),
    ("pointer_jump", CELL_VARIANT, ("cell", "cell ingest")),
    ("scatter_min", CELL_VARIANT, ("cell sharded",)),
)
# the placement a recorded run's session takes
RECORDED_EXEC = {"placement sharded": "sharded(x)",
                 "placement overlap": "sharded(x):overlap",
                 "placement dynamic": "sharded(x)",
                 "placement amsf": "sharded(x)"}
# the recorded runs that are one connectivity call (whose last scatter_min
# call, the canonicalization's, is left out)
CONNECTIVITY_RUNS = ("compacted", "fused", "placement sharded",
                     "placement overlap")
RECORDED_DYNAMIC_STEPS = 5
STREAM_BATCH = 1 << 20
RECORDED_STREAM_BATCHES = 8
# an amsf run makes ~480 scatter_min calls, each with two arrays of the
# whole edge list, and a served closed loop a few hundred small ones: in
# these runs a kernel keeps from RECORDED_SAMPLED_CALLS to twice that many
# of its calls, evenly spaced over the run (every 2^j-th call)
RECORDED_SAMPLED_CALLS = 4
SAMPLED_RUNS = ("amsf", "serve", "serve dynamic", "placement dynamic",
                "placement amsf")
# the serve phase: benchmarks/serve_bench.py's server settings and traffic
# at its full scale (_scale), over the §4 graph's vertices
SERVE_CAPS = dict(max_batch_edges=16384, max_batch_queries=8192,
                  flush_ms=0.5)
SERVE_TRAFFIC = dict(query_pairs=1024, insert_every=4, insert_edges=4096)
SERVE_CLIENTS, SERVE_REQUESTS, SERVE_OPEN_REQUESTS = 16, 48, 256
SERVE_LOADS = (0.25, 0.5, 0.75)
SERVE_PRELOAD = 1 << 20          # edges a preload commit
SERVE_DYNAMIC_PRELOAD = 4        # preload commits of the dynamic server
SERVE_DYNAMIC_LOG = 1 << 23
SERVE_DYNAMIC_REQUESTS = 16
SERVE_DELETE_FRAC = 0.25


def stream_edges(torch, g, seed: int) -> tuple:
    """The graph's undirected edges (s < r) on the card, permuted by
    ``seed``: what the stream and dynamic phases insert."""
    s, r = g.senders[: g.m], g.receivers[: g.m]
    keep = s < r
    s, r = s[keep], r[keep]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    perm = torch.randperm(s.shape[0], generator=gen, device="cuda")
    return s[perm], r[perm]


def sliding_batch_log(n: int) -> tuple:
    """The dynamic phase's sliding_window batch (2^20 at n = 2^22) and the
    edge-log capacity it runs with (2^23)."""
    batch = min(1 << 20, n // 4)
    return batch, 1 << (8 * batch - 1).bit_length()


def sliding_steps(torch, n: int, seed: int, steps: int = 8):
    """sliding_window(n, steps, batch, window=4, queries=2^16, seed): each
    step's (inserts, deletes, queries) host arrays and the process()
    arguments on the card."""
    import numpy as np

    from repro_torch.graphs.generators import sliding_window
    batch, _ = sliding_batch_log(n)
    for ins, dels, q in sliding_window(n, steps=steps, batch=batch,
                                       window=4, queries=1 << 16, seed=seed):
        args = [torch.from_numpy(np.ascontiguousarray(x)).cuda()
                for x in (dels[:, 0], dels[:, 1], ins[:, 0], ins[:, 1],
                          q[:, 0], q[:, 1])]
        yield ins, dels, q, args


def ingest_chunk(log_m: int) -> int:
    """The ingest phase's chunk: 2^22 edges at the default 2^25."""
    return 1 << (log_m - 3)


def ingest_source(torch, g, seed: int, log_m: int):
    """The ingest phase's first source: the stream phase's edges as a host
    ArrayEdgeSource in chunks of ingest_chunk(log_m)."""
    from repro_torch.graphs import ArrayEdgeSource
    u, v = stream_edges(torch, g, seed)
    E = torch.stack([u, v], 1).cpu().numpy()
    return ArrayEdgeSource(E, g.n, chunk=ingest_chunk(log_m))


def powerlaw_source(g, lm: int, log_m: int):
    """powerlaw_chunks over 4n vertices, 2^lm edges, the ingest chunk."""
    from repro_torch.graphs.generators import powerlaw_chunks
    return powerlaw_chunks(4 * g.n, 1 << lm, chunk=ingest_chunk(log_m), seed=7)


def _recorded_calls(torch, g, names: tuple, variant: str, run: str,
                    log_m: int, seed: int = 0) -> dict:
    """{kernel: (calls, made, stride)} for each kernel of ``names`` in one
    ``run``
    of ``variant``: the arguments of its calls as ops hands them to the
    kernel's wrapper, (labels, senders, receivers, k) for hook_compress,
    (labels, idx, vals) for scatter_min, (labels, senders, receivers) for
    edge_relabel and edge_rewrite, (labels, k) for pointer_jump; ``made``
    the calls the run made. A SAMPLED_RUNS run keeps every
    ``stride``-th call (RECORDED_SAMPLED_CALLS); every other run keeps every
    call. A "serve" run records its closed loop only. A "placement" run
    runs on its RECORDED_EXEC placement, in a one-rank group made for it:
    one connectivity call, or the placements phase's dynamic steps or amsf,
    whose scatter_min calls into the stacked endpoint buffer are kept apart
    as "scatter_min stacked". The last scatter_min call of a connectivity
    run, the canonicalization's, is left out (it has its own input)."""
    from collections import defaultdict
    from contextlib import ExitStack
    from types import SimpleNamespace
    from unittest import mock

    from repro_torch import ConnectIt
    from repro_torch.graphs.generators import with_weights
    from repro_torch.kernels import ops
    from repro_torch.launch import multihost

    calls = defaultdict(list)
    made = defaultdict(int)
    stride = defaultdict(lambda: 1)
    # a serve run records from its closed loop on, not its preload
    live = [not run.startswith("serve")]
    forest_rounds = run in ("placement dynamic", "placement amsf")

    def recorder(name):
        launch = ops.KERNELS[name]

        def record(*args, **kw):
            if not live[0]:
                return launch(*args, **kw)
            key = name
            if (forest_rounds and name == "scatter_min"
                    and args[0].shape[0] > 2 * (g.n + 1)):
                key = "scatter_min stacked"
            if (run in LATE_RUNS and name in CELL_FIRST_LAST
                    and len(calls[key]) == 2):
                calls[key][1] = (*args, *kw.values())  # the newest
            elif made[key] % stride[key] == 0:
                calls[key].append((*args, *kw.values()))
                if (run in SAMPLED_RUNS
                        and len(calls[key]) == 2 * RECORDED_SAMPLED_CALLS):
                    del calls[key][1::2]
                    stride[key] *= 2
            made[key] += 1
            return launch(*args, **kw)
        return record

    placement = run in RECORDED_EXEC
    session = ConnectIt(variant, exec=RECORDED_EXEC.get(run, "single"),
                        device="cuda")
    # ops reaches each wrapper through its module at call time: ops's name
    # for that module is patched, so the wrapper itself, and its launch
    # count, stay as they are
    with ExitStack() as stack:
        if placement or run in LATE_RUNS:
            stack.callback(multihost.shutdown)
        for module in {sys.modules[ops.KERNELS[x].__module__] for x in names}:
            attr = next(k for k, v in vars(ops).items() if v is module)
            patched = {x: recorder(x) for x in names
                       if ops.KERNELS[x].__module__ == module.__name__}
            stack.enter_context(mock.patch.object(
                ops, attr, SimpleNamespace(**{**vars(module), **patched})))
        if run == "forest":
            session.spanning_forest(g)
        elif run == "stream":
            u, v = stream_edges(torch, g, seed)
            st = session.stream(g.n)
            for i in range(RECORDED_STREAM_BATCHES):
                lo = i * STREAM_BATCH
                st.insert(u[lo: lo + STREAM_BATCH], v[lo: lo + STREAM_BATCH])
        elif run == "ingest":
            session.from_chunks(ingest_source(torch, g, seed, log_m))
        elif run == "ingest powerlaw":
            session.from_chunks(powerlaw_source(g, log_m, log_m))
        elif run in LATE_RUNS:
            _record_cell(torch, run, g.n.bit_length() - 1, seed)
        elif run in ("amsf", "placement amsf"):
            session.amsf(g, with_weights(g, seed=0), "amsf")
        elif run == "placement dynamic":
            st = session.stream(g.n, dynamic=True,
                                log=sliding_batch_log(g.n)[1])
            for *_, args in sliding_steps(torch, g.n, seed,
                                          RECORDED_DYNAMIC_STEPS):
                st.process(*args)
        elif run.startswith("serve"):
            dynamic = run == "serve dynamic"
            server = serve_server(session, g, dynamic, warmup=False)
            serve_preload(torch, server, g, seed, dynamic)
            live[0] = True
            serve_closed_loop(server, dynamic, seed)
        else:
            session.connectivity(g, fused=run == "fused")
    if "scatter_min" in names and run in CONNECTIVITY_RUNS:
        calls["scatter_min"] = calls["scatter_min"][:-1]
        made["scatter_min"] -= 1
    kept = [x for x in (*names, "scatter_min stacked") if x in calls]
    return {x: (tuple(calls[x]), made[x], stride[x]) for x in kept}


def _record_cell(torch, run: str, log_n: int, seed: int) -> None:
    """A recorded cell run (LATE_RUNS) on its planted graph at one rank:
    "cell" runs static_1b_edges, then the exactness check's compression;
    "cell ingest" ingest_256m_batch's batch and queries; "cell sharded"
    static_8b_edges_sharded on the whole label window."""
    from repro_torch.core.primitives import full_compress
    from repro_torch.launch import multihost
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.steps import build_cell

    arch = cell_arch(log_n)
    multihost.initialize()
    shape = {"cell": "static_1b_edges", "cell ingest": "ingest_256m_batch",
             "cell sharded": "static_8b_edges_sharded"}[run]
    n = arch.shapes[shape]["n"]
    cell = build_cell(arch, shape, make_smoke_mesh("cuda"), device="cuda")
    perm, starts = planted_structure(torch, n, cell_blocks(n), seed)
    ingest = run == "cell ingest"
    s, r = planted_edges(torch, perm, starts, cell.args[1].shape[0],
                         seed + ingest, symmetric=not ingest)
    del perm, starts
    P0 = torch.arange(cell.args[0].shape[0], dtype=torch.int32,
                      device="cuda")
    if ingest:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        q = [torch.randint(0, n, (cell.args[3].shape[0],), generator=gen,
                           device="cuda", dtype=torch.int32)
             for _ in range(2)]
        cell.fn(P0, s, r, *q)
        return
    P, _ = cell.fn(P0, s, r)
    if run == "cell":
        full_compress(P)


def run_calls(name: str, fn, calls) -> tuple:
    """``fn``, a kernel's wrapper or its plain version, on each of
    ``calls`` in turn (pointer_jump's and hook_compress's hop count is a
    call's last item; edge_rewrite's two outputs a call are flattened)."""
    if name in ("pointer_jump", "hook_compress"):
        return tuple(fn(*c[:-1], k=c[-1]) for c in calls)
    if name == "edge_rewrite":
        return tuple(x for c in calls for x in fn(*c))
    return tuple(fn(*c) for c in calls)


def _recorded_sets(torch, g, log_m: int, seed: int,
                   late: str | None = None) -> list:
    """``[(kernel, key, calls)]`` of the RECORDED runs not in LATE_RUNS, or
    of the one LATE_RUNS run ``late``, each run once, recording every kernel
    RECORDED asks of it; a line each on what the calls hold."""
    from repro_torch.kernels.edge_relabel.ref import edge_rewrite_ref

    out = []
    wanted = {}
    for name, variant, runs in RECORDED:
        for run in runs:
            if (run == late) if late else run not in LATE_RUNS:
                wanted.setdefault((variant, run), []).append(name)
    recorded = {key: _recorded_calls(torch, g, tuple(names), *key, log_m,
                                     seed)
                for key, names in wanted.items()}
    for name, variant, runs in RECORDED:
        finish = variant.split("+")[1]
        for run, part in ((run, part) for run in runs
                          if (variant, run) in recorded
                          for part in (name, f"{name} stacked")
                          if part in recorded[variant, run]):
            calls, made, stride = recorded[variant, run][part]
            key = f"{finish} {run}" + (" stacked" if part != name else "")
            if name == "hook_compress":
                what = (f"on labels ({calls[0][0].shape[0]},), edges per "
                        f"call {[c[1].shape[0] for c in calls]}, k = "
                        f"{sorted({c[3] for c in calls})}")
            elif name == "scatter_min":
                live = sum(int((v != INT32_MAX).sum()) for _, _, v in calls)
                what = (f"into ({calls[0][0].shape[0]},) of "
                        f"{calls[0][1].shape[0]} entries each, {live} "
                        f"entries not dumped in all")
            elif name == "edge_relabel":
                # live proposals: edges whose ends' labels disagree
                ends = [edge_rewrite_ref(*c) for c in calls]
                live = [int((a != b).sum()) for a, b in ends]
                neg = [int(((a < 0) & (b < 0)).sum()) for _, a, b in calls]
                what = (f"of {calls[0][1].shape[0]} edges each; live "
                        f"proposals {sum(live)} in all, per call {live}; "
                        f"edges with both ends -1 per call {neg}")
            elif name == "edge_rewrite":
                # the ends that gather a label (a -1 end is kept as it is)
                live = [int((a >= 0).sum()) + int((b >= 0).sum())
                        for _, a, b in calls]
                what = (f"of {calls[0][1].shape[0]} entries each, "
                        f"non-negative ends (of {2 * calls[0][1].shape[0]}) "
                        f"per call {live}")
                if run in ("stream", "serve"):
                    real = [int((a < g.n).sum()) for _, a, _ in calls]
                    what += (f"; the symmetrized pow2 batch, real entries "
                             f"per call {real}")
            else:
                what = (f"on labels ({calls[0][0].shape[0]},), k = "
                        f"{sorted({k for _, k in calls})}")
            kept = (f"{len(calls)}" if stride == 1 else
                     f"{len(calls)} of {made} (1 in {stride})")
            print(f"[kernels] {key} ({variant}): {kept} {name} calls {what}")
            out.append((name, key, calls))
    return out


def kernel_inputs(torch, g, gen, log_m: int, seed: int = 0) -> tuple:
    """(P, sets): the phase's labels P (chains, roots, ~10% -1) and, per
    kernel, the named tuples of calls it is timed on. hook_compress at k =
    0 and 3 (and 1 on the graph) on one (labels, senders, receivers) each:
    (a) "graph", P on the graph edges; (b) "floor", all labels -1 (a
    streamed read and one gather, no hook); (c) "identity", each edge
    proposing to its own sender with no slot contended; (d) the main
    path's first rounds. scatter_min on (n+1,) sanitized targets, ~10% carrying the
    dump sentinel as masked entries do: "uniform"; a synthetic "hub" taking
    ~98% of them with random values, which no path produces (the worst case
    for one slot); the canonicalization's own call. edge_relabel on the
    graph edges with P ("graph") and with ~10% of the endpoints -1 ("neg",
    as the alter step leaves them), and edge_rewrite on both. pointer_jump
    on P at k = 1 and 3. Then the calls of the RECORDED runs but
    LATE_RUNS' (``seed`` permutes the stream's and the ingest's edges;
    ``log_m`` sizes the ingest's chunks and power-law stream). Also used by
    compare_kernels.py."""
    L = g.n + 1
    m = g.m_pad
    P = _labels_with_virtual_min(torch, L, gen)
    idx = torch.randint(0, L, (L,), generator=gen, device="cuda",
                        dtype=torch.int32)
    vals = torch.randint(-1, L, (L,), generator=gen, device="cuda",
                         dtype=torch.int32)
    dumped = torch.rand(L, generator=gen, device="cuda") < 0.1
    idx[dumped] = L - 1
    vals[dumped] = INT32_MAX
    hub = torch.where(torch.rand(L, generator=gen, device="cuda") < 0.98,
                      L // 3, idx).to(torch.int32)
    hub[dumped] = L - 1
    s, r = g.senders, g.receivers
    s_neg = torch.where(torch.rand(m, generator=gen, device="cuda") < 0.1,
                        -1, s).to(torch.int32)
    r_neg = torch.where(torch.rand(m, generator=gen, device="cuda") < 0.1,
                        -1, r).to(torch.int32)
    main = _main_path_inputs(torch, g)
    hook = {"graph": (P, s, r), "floor": (torch.full_like(P, -1), s, r),
            "identity": (torch.arange(L, dtype=torch.int32, device="cuda"),
                         s, r),
            **{x: main[x] for x in ("sampled", "compacted", "fused")}}
    sets = {
        "hook_compress": {f"{x} k={k}": ((*args, k),)
                          for x, args in hook.items()
                          for k in ((0, 1, 3) if x == "graph" else (0, 3))},
        "scatter_min": {"uniform": ((P, idx, vals),), "hub": ((P, hub, vals),),
                        "canonicalization": (main["canonicalization"],)},
        "edge_relabel": {"graph": ((P, s, r),), "neg": ((P, s_neg, r_neg),)},
        "edge_rewrite": {"graph": ((P, s, r),), "neg": ((P, s_neg, r_neg),)},
        "pointer_jump": {"k=1": ((P, 1),), "k=3": ((P, 3),)},
    }
    for name, key, calls in _recorded_sets(torch, g, log_m, seed):
        sets[name][key] = calls
    return P, sets


def phase_kernels(torch, g, cap: int, log_m: int, seed: int = 0) -> dict:
    """Each kernel against its plain version at the main paths' shapes,
    and on the calls the paths really make (kernel_inputs)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.edge_relabel.ref import (
        edge_relabel_ref,
        edge_rewrite_ref,
    )
    from repro_torch.kernels.hook_compress.ref import hook_compress_ref
    from repro_torch.kernels.pointer_jump.ref import pointer_jump_ref
    from repro_torch.kernels.scatter_min.ref import scatter_min_ref

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    P, sets = kernel_inputs(torch, g, gen, log_m, seed)
    hook_sets, scatter_sets = sets["hook_compress"], sets["scatter_min"]
    relabel_sets, jump_sets = sets["edge_relabel"], sets["pointer_jump"]
    rewrite_sets = sets["edge_rewrite"]

    def hook_bytes(x):
        # per call: labels read and the result written once, every sender
        # read, and a receiver only where its sender's label is a slot that
        # can take a hook (a -1 label never hooks)
        total = 0
        for lab, e, _, _ in hook_sets[x]:
            hooks = 0
            for lo in range(0, e.shape[0], CELL_CHUNK):
                pu = lab[e[lo: lo + CELL_CHUNK].long()]
                hooks += int(((pu >= 0) & (pu < lab.shape[0])).sum())
            total += 4 * (2 * lab.shape[0] + e.shape[0] + hooks)
        return total

    def scatter_live(x):
        return sum(int((v != INT32_MAX).sum()) for _, _, v in scatter_sets[x])

    def scatter_bytes(x):
        # per call: labels read and written once, every value read, and an
        # index only where its value is not the dump sentinel
        return sum(4 * (2 * lab.shape[0] + v.shape[0])
                   for lab, _, v in scatter_sets[x]) + 4 * scatter_live(x)

    def gathered_slots(lab, a, b):
        # the distinct label slots that the call's non-negative ends read
        # (an end at or past L reads the last slot)
        ends = torch.cat([a[a >= 0], b[b >= 0]]).clamp_max(lab.shape[0] - 1)
        return int(torch.unique(ends).numel())

    def extended(lab):
        # labels with a -1 slot appended: a -1 index wraps onto it, so one
        # gather keeps -1 fixed (built outside the timed window)
        return torch.cat([lab, lab.new_tensor([-1])])

    def jump_library(x):
        # at k = 1 a call is one gather P <- Pe[P]
        if any(k != 1 for _, k in jump_sets[x]):
            return None
        ext = [(extended(lab), lab) for lab, _ in jump_sets[x]]
        return lambda: tuple(e[lab] for e, lab in ext)

    def rewrite_library(x):
        # two gathers a call, Pe[s] and Pe[r]
        calls = [(extended(lab), a, b) for lab, a, b in rewrite_sets[x]]
        return lambda: tuple(y for e, a, b in calls for y in (e[a], e[b]))

    def scatter_library(x):
        calls = [(base, i.long(), v) for base, i, v in scatter_sets[x]]
        return lambda: tuple(base.scatter_reduce(0, i, v, "amin",
                                                 include_self=True)
                             for base, i, v in calls)

    # per kernel: the settings swept (input sets and hop counts; "main" is
    # the one the JSON's top-level numbers report, as earlier runs did), the
    # CUDA wrapper and the plain version, bytes and operations for the
    # bound, and the one PyTorch call that computes the same function,
    # where there is one
    cases = {
        "hook_compress": {
            "sweep": tuple(hook_sets), "main": "graph k=3",
            "kernel": lambda x: run_calls("hook_compress",
                                          ops.KERNELS["hook_compress"],
                                          hook_sets[x]),
            "plain": lambda x: run_calls("hook_compress", hook_compress_ref,
                                         hook_sets[x]),
            "bytes": hook_bytes,
            "ops": lambda x: sum(4 * e.shape[0] + k * lab.shape[0]
                                 for lab, e, _, k in hook_sets[x]),
            "library": None,
            "source": "src/repro_torch/kernels/csrc/hook_compress.cu",
            "replaces": "src/repro/kernels/hook_compress/kernel.py:68",
            "shapes": lambda x: (f"{len(hook_sets[x])} x labels "
                                 f"({hook_sets[x][0][0].shape[0]},) edges "
                                 f"({hook_sets[x][0][1].shape[0]},)"),
        },
        "pointer_jump": {
            "sweep": tuple(jump_sets), "main": "k=1",
            "kernel": lambda x: run_calls("pointer_jump",
                                          ops.KERNELS["pointer_jump"],
                                          jump_sets[x]),
            "plain": lambda x: run_calls("pointer_jump", pointer_jump_ref,
                                         jump_sets[x]),
            # each call reads its labels and writes its result once
            "bytes": lambda x: sum(8 * lab.shape[0] for lab, _ in jump_sets[x]),
            "ops": lambda x: sum(k * lab.shape[0] for lab, k in jump_sets[x]),
            "library": jump_library,
            "source": "src/repro_torch/kernels/csrc/pointer_jump.cu",
            "replaces": "src/repro/kernels/pointer_jump/kernel.py:38",
            "shapes": lambda x: (f"{len(jump_sets[x])} x labels "
                                 f"({jump_sets[x][0][0].shape[0]},)"),
        },
        "scatter_min": {
            "sweep": tuple(scatter_sets), "main": "uniform",
            "kernel": lambda x: run_calls("scatter_min",
                                          ops.KERNELS["scatter_min"],
                                          scatter_sets[x]),
            "plain": lambda x: run_calls("scatter_min", scatter_min_ref,
                                         scatter_sets[x]),
            "bytes": scatter_bytes,
            "ops": scatter_live,
            "library": scatter_library,
            "source": "src/repro_torch/kernels/csrc/scatter_min.cu",
            "replaces": "src/repro/kernels/scatter_min/kernel.py:45",
            "shapes": lambda x: (f"{len(scatter_sets[x])} x labels "
                                 f"({scatter_sets[x][0][0].shape[0]},) "
                                 f"idx/vals ({scatter_sets[x][0][1].shape[0]},)"),
        },
        "edge_relabel": {
            "sweep": tuple(relabel_sets), "main": "graph",
            "kernel": lambda x: run_calls("edge_relabel",
                                          ops.KERNELS["edge_relabel"],
                                          relabel_sets[x]),
            "plain": lambda x: run_calls("edge_relabel", edge_relabel_ref,
                                         relabel_sets[x]),
            # per call: the label copy (read and written once) and both
            # endpoint arrays read once
            "bytes": lambda x: sum(4 * (2 * lab.shape[0] + 2 * a.shape[0])
                                   for lab, a, _ in relabel_sets[x]),
            "ops": lambda x: sum(4 * a.shape[0] for _, a, _ in relabel_sets[x]),
            "library": None,
            "source": "src/repro_torch/kernels/csrc/edge_relabel.cu",
            "replaces": "src/repro/kernels/edge_relabel/kernel.py:63",
            "shapes": lambda x: (f"{len(relabel_sets[x])} x labels "
                                 f"({relabel_sets[x][0][0].shape[0]},) edges "
                                 f"({relabel_sets[x][0][1].shape[0]},)"),
        },
        "edge_rewrite": {
            "sweep": tuple(rewrite_sets), "main": "graph",
            "kernel": lambda x: run_calls("edge_rewrite",
                                          ops.KERNELS["edge_rewrite"],
                                          rewrite_sets[x]),
            "plain": lambda x: run_calls("edge_rewrite", edge_rewrite_ref,
                                         rewrite_sets[x]),
            # per call: two endpoint arrays read and two written, and each
            # label slot a non-negative end reads, once
            "bytes": lambda x: sum(4 * (gathered_slots(*c) + 4 * c[1].shape[0])
                                   for c in rewrite_sets[x]),
            "ops": lambda x: sum(2 * a.shape[0] for _, a, _ in rewrite_sets[x]),
            "library": rewrite_library,
            "source": "src/repro_torch/kernels/csrc/edge_relabel.cu",
            "replaces": "src/repro/kernels/edge_relabel/kernel.py:96",
            "shapes": lambda x: (f"{len(rewrite_sets[x])} x labels "
                                 f"({rewrite_sets[x][0][0].shape[0]},) edges "
                                 f"({rewrite_sets[x][0][1].shape[0]},), two "
                                 f"outputs"),
        },
    }
    results = {}

    def measure(name, x) -> None:
        c = cases[name]
        got = c["kernel"](x)
        want = c["plain"](x)
        torch.cuda.synchronize()
        err = _max_abs_err(torch, got, want)
        require(err == 0, f"{name} {x}: kernel disagrees with its plain "
                f"version (max_abs_err={err}; -1 is a shape or dtype "
                f"mismatch)")
        ms = time_ms(torch, lambda: c["kernel"](x), iters=20)
        plain_ms = time_ms(torch, lambda: c["plain"](x), iters=5)
        lib_ms = None
        lib = c["library"](x) if c["library"] is not None else None
        if lib is not None:
            require(_max_abs_err(torch, lib(), want) == 0,
                    f"{name} {x}: the library call differs from the "
                    f"plain version")
            lib_ms = time_ms(torch, lib, iters=20)
        del got, want
        nbytes = c["bytes"](x)
        b_ms, b_by = bound_ms(nbytes, c["ops"](x))
        print(f"[kernels] {name} {x} {c['shapes'](x)}: exact match; "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={'null' if lib_ms is None else f'{lib_ms:.4f}'} "
              f"bound_ms={b_ms:.4f} ({b_by}, {nbytes} bytes at "
              f"3.35 TB/s) kernel/bound={ms / b_ms:.2f}")
        results.setdefault(name, {"inputs": {}})["inputs"][x] = {
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err}
        if x == c["main"]:
            results[name].update({
                "name": name, "route": "cuda", "source": c["source"],
                "replaces": c["replaces"], "launches": 0,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                "main": x})

    for name, c in cases.items():
        for x in c["sweep"]:
            measure(name, x)
    # the recorded calls of LATE_RUNS last, one run at a time, with every
    # other input freed: one cell's calls hold up to 2^31 edges (16 GiB)
    for d in sets.values():
        d.clear()
    del P
    for late in LATE_RUNS:
        torch.cuda.empty_cache()
        recorded = _recorded_sets(torch, g, log_m, seed, late)
        while recorded:
            name, key, calls = recorded.pop(0)
            sets[name][key] = calls
            del calls
            measure(name, key)
            sets[name].clear()
    torch.cuda.empty_cache()
    hook = results["hook_compress"]["inputs"]
    a, b, c0 = (hook[f"{x} k=0"]["ms"] for x in ("graph", "floor", "identity"))
    print(f"[kernels] hook pass (k=0: copy + hook) on the graph edges: "
          f"(a) phase labels {a:.4f} ms, (b) all -1 {b:.4f} ms, (c) identity "
          f"{c0:.4f} ms; (c) - (b) = {c0 - b:.4f} ms of label gathers and "
          f"uncontended proposals, (a) - (c) = {a - c0:.4f} ms of what the "
          f"phase labels add")
    results["embedding_bag"] = _embedding_bag_cases(torch, cap)
    return results


def _embedding_bag_cases(torch, cap: int) -> dict:
    """embedding_bag against its plain version on one RM2-width table."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.legacy import embedding_bag
    from repro_torch.kernels.legacy.embedding_bag.ref import (
        embedding_bag_ref,
        wrap_and_clamp,
    )
    from repro_torch.legacy.data import RecsysStream
    from repro_torch.legacy.models.dlrm import table_rows

    vocab = min(RM2_VOCAB, cap)
    rows, D = table_rows(vocab), 64
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    table = torch.randn(rows, D, generator=gen, device="cuda") / 8.0
    table[vocab:] = 0.0  # RM2's zero pad rows; the last is the dump row

    def zipf_ids(batch: int, bag: int):
        s = RecsysStream(batch=batch, n_dense=13, n_sparse=1, vocab=vocab,
                         multi_hot=bag, seed=2).batch_at(0, device="cuda")
        return s["sparse"][:, 0].contiguous()

    bulk = zipf_ids(min(262144, cap), 1)
    multi = zipf_ids(min(65536, cap), 8)
    multi[torch.rand(multi.shape, generator=gen, device="cuda") < 0.1] = (
        rows - 1)
    wrapped = multi.clone()
    u = torch.rand(wrapped.shape, generator=gen, device="cuda")
    wrapped[u < 0.01] = -1
    wrapped[(u >= 0.01) & (u < 0.02)] = -rows - 2
    wrapped[(u >= 0.02) & (u < 0.03)] = rows + 3
    id_sets = {"serve_bulk": bulk, "multi_hot": multi, "wrapped": wrapped}
    tables = {"float32": table, "bfloat16": table.to(torch.bfloat16)}
    main = None
    for ids_name, ids in id_sets.items():
        B, L = ids.shape
        ids_long = ids.long()
        # the bound reads each distinct row the bags need once; zipfian ids
        # repeat, so that is fewer rows than the B*L gathered
        distinct = int(torch.unique(wrap_and_clamp(ids, rows)).numel())
        for dtype, tab in tables.items():
            size = tab.element_size()
            nbytes = distinct * D * size + B * L * 4 + B * D * size
            gathered_ms = (B * L * D * size + B * L * 4 + B * D * size
                           ) / HBM_BYTES_PER_S * 1e3
            for mode in BAG_MODES:
                got = ops.KERNELS["embedding_bag"](tab, ids, mode=mode)
                want = embedding_bag_ref(tab, ids, mode=mode)
                torch.cuda.synchronize()
                require(got.shape == want.shape and got.dtype == want.dtype,
                        f"embedding_bag {ids_name} {dtype} {mode}: shape or "
                        f"dtype differs from the plain version")
                err = float((got.float() - want.float()).abs().max())
                tol = BAG_TOL[dtype]
                if dtype == "float32" and L == 1:
                    require(torch.equal(got, want),
                            f"embedding_bag {ids_name} {dtype} {mode}: a "
                            f"one-row bag is not a copy (max_abs_err={err})")
                else:
                    require(torch.allclose(got.float(), want.float(),
                                           rtol=tol, atol=tol),
                            f"embedding_bag {ids_name} {dtype} {mode}: kernel "
                            f"disagrees with its plain version "
                            f"(max_abs_err={err}, rtol=atol={tol})")
                ms = time_ms(torch, lambda: embedding_bag(tab, ids, mode=mode),
                             iters=20)
                plain_ms = time_ms(
                    torch, lambda: embedding_bag_ref(tab, ids, mode=mode),
                    iters=5)
                # F.embedding_bag skips padding_idx rows, so it computes this
                # function for in-range ids in sum and mean (max differs on
                # all-dump bags)
                lib_ms = None
                if mode != "max" and ids_name != "wrapped":
                    def lib():
                        return F.embedding_bag(ids_long, tab, mode=mode,
                                               padding_idx=rows - 1)
                    require(torch.allclose(lib().float(), want.float(),
                                           rtol=tol, atol=tol),
                            f"F.embedding_bag {ids_name} {dtype} {mode} "
                            f"differs from the plain version")
                    lib_ms = time_ms(torch, lib, iters=20)
                b_ms, b_by = bound_ms(nbytes, B * L * D)
                print(f"[kernels] embedding_bag {ids_name} {dtype} {mode} "
                      f"table ({rows}, {D}) ids ({B}, {L}): max_abs_err={err} "
                      f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                      f"library_ms={'null' if lib_ms is None else f'{lib_ms:.4f}'} "
                      f"bound_ms={b_ms:.4f} ({b_by}, {nbytes} bytes at "
                      f"3.35 TB/s: {distinct} distinct rows) "
                      f"gathered_rows_bound_ms={gathered_ms:.4f}")
                if (ids_name, dtype, mode) == ("serve_bulk", "float32", "sum"):
                    main = {
                        "name": "embedding_bag", "route": "cuda",
                        "source": "src/repro_torch/kernels/csrc/embedding_bag.cu",
                        "replaces":
                            "src/repro/kernels/legacy/embedding_bag/kernel.py:47",
                        "launches": 0, "max_abs_err": err, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": lib_ms}
    return main


def phase_small(torch) -> None:
    """The whole variant grid on a small graph: card vs CPU vs scipy."""
    import numpy as np

    from repro_torch import ConnectIt, enumerate_variants
    from repro_torch.graphs import components_oracle, generators as gen
    g_cpu = gen.rmat(1 << 12, 1 << 15, seed=1, device="cpu")
    g_gpu = gen.rmat(1 << 12, 1 << 15, seed=1, device="cuda")
    expect = components_oracle(g_cpu)
    variants = [str(v) for v in enumerate_variants()]
    t0 = time.perf_counter()
    for variant in variants:
        deterministic = variant.split("+")[0] in DETERMINISTIC_SAMPLINGS
        for fused in (False, True):
            a, sa = ConnectIt(variant, device="cpu").connectivity(
                g_cpu, fused=fused, return_stats=True)
            b, sb = ConnectIt(variant, device="cuda").connectivity(
                g_gpu, fused=fused, return_stats=True)
            require(np.array_equal(a.numpy(), expect),
                    f"small {variant} fused={fused}: CPU path != scipy")
            require(np.array_equal(b.cpu().numpy(), expect),
                    f"small {variant} fused={fused}: card != scipy")
            # the random draws (k-out columns, BFS sources, LDD shifts) of
            # the CPU and CUDA generators differ, and so may those stats
            require(not deterministic or sa == sb,
                    f"small {variant} fused={fused}: stats differ: cpu {sa} "
                    f"card {sb}")
    print(f"[small] all {len(variants)} variants of enumerate_variants() x "
          f"compacted/fused on rmat n=2^12: card == CPU path == scipy, stats "
          f"equal on the deterministic ones ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    keys = (g_cpu.senders[: g_cpu.m].numpy().astype(np.int64) * (g_cpu.n + 1)
            + g_cpu.receivers[: g_cpu.m].numpy())
    forest = [v for v in enumerate_variants() if v.forest_capable]
    for spec in forest:
        variant = str(spec)
        a = ConnectIt(variant, device="cpu").spanning_forest(g_cpu)
        b = ConnectIt(variant, device="cuda").spanning_forest(g_gpu)
        for edges, where in ((a, "CPU path"), (b, "card")):
            check_forest(edges, g_cpu.n, expect, keys,
                         f"small forest {variant} ({where})")
        require(variant.split("+")[0] not in DETERMINISTIC_SAMPLINGS
                or np.array_equal(a, b),
                f"small forest {variant}: the card's edges differ from the "
                f"CPU path's")
    print(f"[small] spanning_forest of all {len(forest)} forest-capable "
          f"variants on rmat n=2^12: valid forests on the card and the CPU "
          f"path, equal row for row on the deterministic samplings "
          f"({time.perf_counter() - t0:.1f} s)")


def phase_oracle(g) -> tuple:
    """scipy's labels of the big graph (min vertex ids) and its sorted edge
    keys s * (n + 1) + r, both on the host."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    _, lab = _scipy_labels(g.n, torch.stack([g.senders[: g.m],
                                             g.receivers[: g.m]], 1))
    expect = canonical(lab)
    # build_graph orders the edges by this key, so the keys are sorted
    keys = (g.senders[: g.m].cpu().numpy().astype(np.int64) * (g.n + 1)
            + g.receivers[: g.m].cpu().numpy())
    print(f"[oracle] scipy oracle on the host: {time.perf_counter() - t0:.2f} "
          f"s, {len(np.unique(expect))} components")
    return expect, keys


def phase_paths(torch, g, expect, results: dict, exact: bool) -> None:
    """Each path of PATHS on the big graph against the scipy oracle, with
    the kernels it must launch; on the default graph (``exact``) also its
    launch counts and finish rounds."""
    import numpy as np

    from repro_torch import ConnectIt
    from repro_torch.kernels import ops

    for variant, modes, want_counts, want_rounds in PATHS:
        session = ConnectIt(variant, device="cuda")
        for fused in modes:
            path = "fused" if fused else "compacted"
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            labels, stats = session.connectivity(g, fused=fused,
                                                 return_stats=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = ops.launch_counts()
            peak = torch.cuda.max_memory_allocated()
            require(labels.shape == (g.n,) and labels.dtype == torch.int32,
                    f"{variant} {path}: labels shape {tuple(labels.shape)}")
            require(np.array_equal(labels.cpu().numpy(), expect),
                    f"{variant} {path}: labels differ from the scipy oracle")
            got_counts = tuple(counts[k] for k in PATH_KERNELS)
            for name, want in zip(PATH_KERNELS, want_counts):
                require(want == 0 or counts[name] > 0,
                        f"{variant} {path}: kernel {name} never launched")
            same = (got_counts == want_counts
                    and stats.finish_rounds == want_rounds)
            if exact and variant not in RANDOM_STREAM_PATHS:
                require(same, f"{variant} {path}: launches {got_counts} and "
                        f"finish_rounds {stats.finish_rounds}, want "
                        f"{want_counts} and {want_rounds}")
            elif not same:
                print(f"[paths] {variant} {path}: launches {got_counts} and "
                      f"finish_rounds {stats.finish_rounds} differ from the "
                      f"default graph's {want_counts} and {want_rounds} "
                      f"(not asserted: "
                      f"{'random stream' if exact else 'another graph'})")
            print(f"[paths] {variant} {path}: labels == scipy oracle; "
                  f"wall {wall:.4f} s; finish_rounds {stats.finish_rounds}; "
                  f"peak device memory {peak} bytes; launches "
                  f"{json.dumps(counts)}")
            print(f"[paths]   stats {stats}")
            if not fused and variant == MAIN_VARIANT:
                for name in UF_KERNELS:
                    results[name]["launches"] = counts[name]
            if not fused and variant == EDGE_PATH:
                for name in ("edge_relabel", "edge_rewrite"):
                    results[name]["launches"] = counts[name]


def canonical(labels):
    """Min-vertex-id labels of the partition that ``labels`` (n,) gives:
    the first vertex of a label is its component's smallest."""
    import numpy as np
    _, first, inv = np.unique(labels, return_index=True, return_inverse=True)
    return first[inv]


def check_forest(edges, n: int, expect, keys, what: str) -> None:
    """A spanning forest of the graph whose scipy labels are ``expect`` and
    sorted edge keys ``keys``, on the host without a Python loop: n -
    #components edges, whose components are the graph's (so, with that
    size, acyclic), each an edge of the graph."""
    import numpy as np

    ncomp = int((expect == np.arange(n)).sum())
    require(edges.ndim == 2 and edges.shape == (n - ncomp, 2),
            f"{what}: forest of shape {edges.shape}, want ({n - ncomp}, 2)")
    u, v = edges[:, 0].astype(np.int64), edges[:, 1].astype(np.int64)
    require(bool(((u >= 0) & (u < n) & (v >= 0) & (v < n)).all()),
            f"{what}: a forest endpoint is not a vertex")
    _, lab = _scipy_labels(n, edges)
    require(np.array_equal(canonical(lab), expect),
            f"{what}: the forest's components differ from the graph's")
    key = np.sort(u * (n + 1) + v)  # sorted: the search walks keys in order
    at = np.searchsorted(keys, key).clip(0, len(keys) - 1)
    require(bool((keys[at] == key).all()),
            f"{what}: a forest edge is not an edge of the graph")


def _check_counts(what: str, counts: dict, rounds: int, want, exact: bool,
                  kernels=PATH_KERNELS) -> None:
    """Assert launches per kernel and rounds on the default graph, where
    ``want`` = (launches, rounds) is known; print them otherwise."""
    got = tuple(counts[k] for k in kernels)
    if exact and want is not None:
        require((got, rounds) == want,
                f"{what}: launches {got} and rounds {rounds}, want "
                f"{want[0]} and {want[1]} ({kernels})")
    elif want is not None and (got, rounds) != want:
        print(f"[check] {what}: launches {got} and rounds {rounds} differ "
              f"from the default graph's {want} (not asserted here)")


def phase_forest(torch, g, expect, keys, exact: bool) -> None:
    """Each spanning forest of FOREST_PATHS on the big graph, checked on the
    host against the graph and its scipy labels."""
    from repro_torch import ConnectIt
    from repro_torch.kernels import ops

    for variant, want in FOREST_PATHS:
        session = ConnectIt(variant, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        edges = session.spanning_forest(g)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        check_forest(edges, g.n, expect, keys, f"forest {variant}")
        t_check = time.perf_counter() - t0
        stats = session.stats
        for name in ("pointer_jump", "scatter_min"):
            require(counts[name] > 0, f"forest {variant}: kernel {name} "
                    f"never launched")
        _check_counts(f"forest {variant}", counts, stats.finish_rounds, want,
                      exact and variant not in RANDOM_STREAM_PATHS)
        print(f"[forest] {variant}: {len(edges)} edges, a spanning forest "
              f"(size, components, edges checked on the host in "
              f"{t_check:.2f} s); wall {wall:.4f} s (to the host array); "
              f"finish_rounds {stats.finish_rounds}; lmax_count "
              f"{stats.lmax_count}; edges_finish {stats.edges_finish}; peak "
              f"device memory {peak} bytes; launches {json.dumps(counts)}")


def _prefix_answers(n: int, u, v, hi: int, q):
    """scipy's IsConnected for the query pairs ``q`` (2, k) after the first
    ``hi`` stream edges."""
    import numpy as np
    edges = np.stack([u[:hi].cpu().numpy(), v[:hi].cpu().numpy()], 1)
    _, lab = _scipy_labels(n, edges)
    return lab[q[0]] == lab[q[1]]


def _pct(xs: list, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def phase_stream(torch, g, expect, seed: int, exact: bool, card: str) -> None:
    """The graph's undirected edges, permuted by ``seed``, inserted through
    ConnectIt(MAIN_VARIANT).stream(n) in batches of STREAM_BATCH (all of
    them, the last batch ragged) and of 2^16 (the first 2^22), each batch
    with 2^16 uniform query pairs; the labels at the end against scipy's,
    the queries of batch 8 and of the last batch against scipy on the edges
    inserted by then."""
    import numpy as np

    from repro_torch import ConnectIt
    from repro_torch.kernels import ops

    u, v = stream_edges(torch, g, seed)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    for batch, total in ((STREAM_BATCH, u.shape[0]),
                         (1 << 16, min(1 << 22, u.shape[0]))):
        nb = -(-total // batch)
        queries = torch.randint(0, g.n, (nb, 2, 1 << 16), generator=gen,
                                device="cuda", dtype=torch.int32)
        st = ConnectIt(MAIN_VARIANT, device="cuda").stream(g.n)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        walls, kept = [], {}
        for i in range(nb):
            lo, hi = i * batch, min((i + 1) * batch, total)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ans = st.process(u[lo:hi], v[lo:hi], queries[i, 0], queries[i, 1])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if i in (7, nb - 1):
                kept[i] = (hi, ans.cpu().numpy(), queries[i].cpu().numpy())
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        stats = st.stats
        what = f"stream batch={batch}"
        require(stats.edges_total == total and counts["edge_rewrite"] == nb,
                f"{what}: {stats.edges_total} edges in "
                f"{counts['edge_rewrite']} rewrites, want {total} in {nb}")
        for name in ("hook_compress", "pointer_jump"):
            require(counts[name] > 0, f"{what}: kernel {name} never launched")
        _check_counts(what, counts, stats.finish_rounds,
                      STREAM_COUNTS.get(batch), exact)
        for i, (hi, ans, q) in kept.items():
            require(np.array_equal(ans, _prefix_answers(g.n, u, v, hi, q)),
                    f"{what}: the queries of batch {i + 1} differ from "
                    f"scipy's on the first {hi} edges")
        if total == u.shape[0]:
            labels = st.labels.cpu().numpy()
            require(np.array_equal(canonical(labels), expect),
                    f"{what}: the stream's components differ from the "
                    f"static path's")
            same = np.array_equal(labels, expect)
            end = (f"labels' partition == scipy's (labels themselves "
                   f"{'==' if same else '!='} the static path's)")
        else:
            end = "prefix run"
        ms = [w * 1e3 for w in walls]
        print(f"[stream] {what}: {nb} batches, {total} edges, 2^16 queries "
              f"a batch; queries of batches {sorted(k + 1 for k in kept)} == "
              f"scipy on the prefix; {end}; {total / sum(walls):.1f} inserted "
              f"edges/s; per batch p50 {_pct(ms, 0.5):.4f} ms, p99 "
              f"{_pct(ms, 0.99):.4f} ms, max {max(ms):.4f} ms; finish_rounds "
              f"{stats.finish_rounds}; batch_shapes {stats.batch_shapes}; peak "
              f"device memory {peak} bytes; launches {json.dumps(counts)}; "
              f"card {card}")


def _live_keys(live, n: int):
    import numpy as np
    lo = np.minimum(live[:, 0], live[:, 1]).astype(np.int64)
    return lo * n + np.maximum(live[:, 0], live[:, 1])


def phase_dynamic(torch, g, expect, keys, seed: int, exact: bool,
                  card: str) -> None:
    """(a) The stream phase's batches of STREAM_BATCH through a dynamic
    stream (log 2^26): labels and forest against the graph's. (b) 8 steps
    of sliding_window on a fresh dynamic stream (log 2^23 at n = 2^22):
    each step's answers against scipy on the live multiset, the final
    forest a subset of the survivors. Fallback rebuilds are counted.
    Returns (b)'s answers a step, its final labels, the live graph's
    component count and the live edge keys, for the placements phase."""
    from unittest import mock

    import numpy as np

    from repro_torch import ConnectIt
    from repro_torch.dynamic import engine
    from repro_torch.kernels import ops

    fallbacks = []
    rebuild = engine.uf_sync_forest

    def counted(*a, **kw):
        fallbacks.append(1)
        return rebuild(*a, **kw)

    n = g.n
    u, v = stream_edges(torch, g, seed)
    nb = -(-u.shape[0] // STREAM_BATCH)
    with mock.patch.object(engine, "uf_sync_forest", counted):
        d = ConnectIt(MAIN_VARIANT, device="cuda").stream(
            n, dynamic=True, log=1 << 26)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        walls = []
        for i in range(nb):
            lo = i * STREAM_BATCH
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            d.insert(u[lo: lo + STREAM_BATCH], v[lo: lo + STREAM_BATCH])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        stats = d.stats
        what = "dynamic (a) inserts"
        require(np.array_equal(canonical(d.labels.cpu().numpy()), expect),
                f"{what}: components differ from the static path's")
        check_forest(d.forest_edges(), n, expect, keys, what)
        require(d.log_used() == u.shape[0],
                f"{what}: {d.log_used()} live log entries, want {u.shape[0]}")
        _check_counts(what, counts, stats.finish_rounds, DYNAMIC_COUNTS["a"],
                      exact)
        ms = [w * 1e3 for w in walls]
        print(f"[dynamic] {what}: {nb} batches of {STREAM_BATCH}, "
              f"{u.shape[0]} edges; components == scipy's, forest checked; "
              f"{u.shape[0] / sum(walls):.1f} updates/s; per batch p50 "
              f"{_pct(ms, 0.5):.4f} ms, p99 {_pct(ms, 0.99):.4f} ms; "
              f"finish_rounds {stats.finish_rounds}; fallbacks "
              f"{len(fallbacks)}; peak device memory {peak} bytes; launches "
              f"{json.dumps(counts)}; card {card}")
        del d

        batch, log = sliding_batch_log(n)
        d = ConnectIt(MAIN_VARIANT, device="cuda").stream(
            n, dynamic=True, log=log)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        live = np.zeros((0, 2), np.int32)
        steps, answers = [], []
        for step, (ins, dels, q, args) in enumerate(
                sliding_steps(torch, n, seed)):
            before, k0 = d._rounds, len(fallbacks)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ans = d.process(*args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            # the live multiset: a delete removes every copy of its pair,
            # then the batch's non-loop inserts join
            if len(dels):
                live = live[~np.isin(_live_keys(live, n),
                                     _live_keys(dels, n))]
            live = np.concatenate([live, ins[ins[:, 0] != ins[:, 1]]])
            ncomp, lab = _scipy_labels(n, live)
            answers.append(ans.cpu().numpy())
            require(np.array_equal(answers[-1],
                                   lab[q[:, 0]] == lab[q[:, 1]]),
                    f"dynamic (b) step {step}: answers differ from scipy's "
                    f"on the live multiset")
            steps.append((wall, len(ins) + len(dels), d._rounds - before,
                          len(fallbacks) - k0))
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        forest = d.forest_edges()
        require(bool(np.isin(_live_keys(forest, n), _live_keys(live, n)).all()),
                "dynamic (b): a forest edge is not a surviving edge")
        require(d.log_used() == len(live),
                f"dynamic (b): {d.log_used()} live log entries, want "
                f"{len(live)}")
        rounds = d.stats.finish_rounds
        _check_counts("dynamic (b) sliding_window", counts, rounds,
                      DYNAMIC_COUNTS["b"], exact)
    total = sum(x[1] for x in steps)
    print(f"[dynamic] (b) sliding_window(n={n}, steps=8, batch={batch}, "
          f"window=4, queries=2^16, seed={seed}), log {log}: answers == scipy "
          f"on the live multiset at every step, final forest ({len(forest)} "
          f"edges) within the {len(live)} survivors; "
          f"{total / sum(x[0] for x in steps):.1f} updates/s; finish_rounds "
          f"{rounds}; steps that fell back "
          f"{sum(1 for x in steps if x[3])} of 8; peak device memory {peak} "
          f"bytes; launches {json.dumps(counts)}; card {card}")
    for i, (wall, ups, r, fb) in enumerate(steps):
        print(f"[dynamic]   step {i}: {ups} updates, wall {wall * 1e3:.4f} "
              f"ms, rounds {r}, fallback rebuilds {fb}")
    return {"answers": answers, "labels": canonical(d.labels.cpu().numpy()),
            "ncomp": int(ncomp), "live": _live_keys(live, n),
            "used": len(live), "rounds": [x[2] for x in steps]}


def serve_server(session, g, dynamic: bool, warmup="all"):
    """The serve phase's server over the graph's vertices: the static one,
    or the dynamic one with a log of SERVE_DYNAMIC_LOG."""
    kw = dict(dynamic=True, log=SERVE_DYNAMIC_LOG) if dynamic else {}
    return session.serve(g.n, warmup=warmup, **SERVE_CAPS, **kw)


def serve_preload(torch, server, g, seed: int, dynamic: bool) -> list:
    """commit_now the stream phase's edges in commits of SERVE_PRELOAD: all
    of them (static), or the first SERVE_DYNAMIC_PRELOAD commits' (dynamic).
    Returns each commit's wall seconds."""
    u, v = stream_edges(torch, g, seed)
    total = u.shape[0]
    if dynamic:
        total = min(total, SERVE_DYNAMIC_PRELOAD * SERVE_PRELOAD)
    u, v = u[:total].cpu().numpy(), v[:total].cpu().numpy()
    walls = []
    for lo in range(0, total, SERVE_PRELOAD):
        t0 = time.perf_counter()
        server.commit_now(u[lo: lo + SERVE_PRELOAD], v[lo: lo + SERVE_PRELOAD])
        walls.append(time.perf_counter() - t0)
    return walls


def serve_closed_loop(server, dynamic: bool, seed: int, requests=None):
    """serve_bench's full-scale closed loop (16 clients); the dynamic
    server's has SERVE_DYNAMIC_REQUESTS requests a client and deletes."""
    from repro_torch.serve import closed_loop, run_sync
    if requests is None:
        requests = SERVE_DYNAMIC_REQUESTS if dynamic else SERVE_REQUESTS
    kw = dict(delete_frac=SERVE_DELETE_FRAC) if dynamic else {}
    return run_sync(server, closed_loop, clients=SERVE_CLIENTS,
                    requests_per_client=requests, seed=seed,
                    **SERVE_TRAFFIC, **kw)


class _ServeLog:
    """What the serve phase records of one server: each commit's edges (and
    deletes) in commit order, its epoch and wall time (begin + wait, in the
    insert loop's worker thread), every commit-program call (warmup's
    included), and every query dispatch's ids, answers and epoch."""

    def __init__(self, server):
        import numpy as np
        self.commits, self.walls, self.answers = [], [], []
        self.calls = 0
        store = server.store
        begin, query, work = store.begin_commit, store.query, \
            server._commit_work
        commit = store._ops.commit

        def logged(u, v, du=None, dv=None):
            pending = begin(u, v, du, dv)
            self.commits.append((pending.epoch, np.asarray(u, np.int32),
                                 np.asarray(v, np.int32),
                                 np.asarray(du if du is not None else [],
                                            np.int32),
                                 np.asarray(dv if dv is not None else [],
                                            np.int32)))
            return pending

        def counted(*args):
            self.calls += 1
            return commit(*args)

        def timed(*args):
            t0 = time.perf_counter()
            out = work(*args)
            self.walls.append(time.perf_counter() - t0)
            return out

        def kept(qa, qb):
            ans, epoch = query(qa, qb)
            self.answers.append((epoch, np.asarray(qa), np.asarray(qb), ans))
            return ans, epoch

        store.begin_commit, store.query = logged, kept
        store._ops = store._ops._replace(commit=counted)
        server._commit_work = timed


def _serve_row(pre: str, tag: str, res) -> str:
    return f"{pre} {tag} LoadResult {json.dumps(res.row())}"


def phase_serve(torch, g, seed: int, card: str):
    """ConnectIt(MAIN_VARIANT).serve over the graph's vertices at
    serve_bench's full-scale settings: the static server preloaded with the
    stream phase's edges in commits of 2^20, an untimed closed-loop pass,
    the closed loop (saturation) and open loops at SERVE_LOADS of it;
    scipy on the final labels and on 4 evenly spaced epochs' answers. Then
    the dynamic server: SERVE_DYNAMIC_PRELOAD commits, a closed loop with
    deletes, scipy on the live multiset. Returns the static server."""
    from repro_torch import ConnectIt

    session = ConnectIt(MAIN_VARIANT, device="cuda")
    server = serve_static(torch, g, session, seed, card, "[serve]",
                          open_loops=True, epochs=4)
    serve_dynamic(torch, g, session, seed, card, "[serve]")
    return server


def serve_static(torch, g, session, seed: int, card: str, pre: str, *,
                 open_loops: bool, epochs: int):
    """The static server of ``session`` (the serve phase's, or (g)'s under
    a placement): preload, warm pass, the closed loop, with ``open_loops``
    the open loops at SERVE_LOADS; the commit log's linearization, the
    final labels and the answers of ``epochs`` evenly spaced epochs against
    scipy. ``pre`` heads each printed line. Returns the server."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.serve import open_loop, run_sync

    n = g.n
    ops.reset_launch_counts()
    server = serve_server(session, g, dynamic=False)
    log = _ServeLog(server)
    pre_walls = serve_preload(torch, server, g, seed, dynamic=False)
    preloaded = server.epoch_edges[-1]
    print(f"{pre} static server n={n} exec={server.exec_str}, {SERVE_CAPS}, "
          f"warmup='all': preloaded {preloaded} edges in {len(pre_walls)} "
          f"commits of {SERVE_PRELOAD}, {sum(pre_walls):.3f} s "
          f"({preloaded / sum(pre_walls):.1f} edges/s, commit p50 "
          f"{_pct(pre_walls, 0.5) * 1e3:.3f} ms)")
    warm = serve_closed_loop(server, False, seed + 1,
                             requests=SERVE_REQUESTS // 4)
    print(_serve_row(pre, "warm pass (untimed)", warm))
    walls0 = len(log.walls)
    sat = serve_closed_loop(server, False, seed)
    loop_walls = log.walls[walls0:]
    results = [("closed", sat)]
    print(_serve_row(pre, f"closed {SERVE_CLIENTS}x{SERVE_REQUESTS}", sat))
    for frac in SERVE_LOADS if open_loops else ():
        qps = max(sat.achieved_qps * frac, 1.0)
        res = run_sync(server, open_loop, qps=qps,
                       requests=SERVE_OPEN_REQUESTS, seed=seed,
                       **SERVE_TRAFFIC)
        results.append((f"open {frac}", res))
        print(_serve_row(pre, f"open {frac} of saturation", res))
    counts = ops.launch_counts()
    st = server.stats()
    print(f"{pre} stats {st}")
    ms = [w * 1e3 for w in loop_walls]
    print(f"{pre} closed loop: {len(ms)} commits, commit wall (begin + "
          f"wait, worker thread) p50 {_pct(ms, 0.5):.4f} ms, p99 "
          f"{_pct(ms, 0.99):.4f} ms, mean {sum(ms) / len(ms):.4f} ms; "
          f"saturation {sat.achieved_qps:.1f} query requests/s, p99 "
          f"{sat.p99_ms:.4f} ms; committed {sat.edges_per_s:.1f} edges/s; "
          f"launches {json.dumps(counts)}; card {card}")

    # linearization: epochs 1, 2, ... in commit order; every edge submitted
    # was committed; the final labels and the answers of evenly spaced
    # epochs against scipy on their epoch's prefix of the commit log
    epoch_order = [c[0] for c in log.commits]
    require(epoch_order == list(range(1, len(epoch_order) + 1)),
            f"{pre} commits did not become epochs 1, 2, ... in order")
    sizes = np.cumsum([0] + [c[1].shape[0] for c in log.commits])
    require(server.epoch_edges == sizes.tolist(),
            f"{pre} epoch_edges is not the commit log's running total")
    submitted = st.tenants["default"].edges_submitted
    loops = [warm] + [r for _, r in results]
    want = preloaded + sum(r.inserts for r in loops) * \
        SERVE_TRAFFIC["insert_edges"]
    require(server.epoch_edges[-1] == submitted == want,
            f"{pre} {server.epoch_edges[-1]} edges committed, {submitted} "
            f"submitted, want {want}")
    # a single-path commit rewrites its batch once; a placement's does not
    # (its finish takes the raw ends, as the reference's does)
    rewrites = log.calls if session.exec.placement == "single" else 0
    require(counts["edge_rewrite"] == rewrites
            and counts["hook_compress"] > 0 and counts["pointer_jump"] > 0,
            f"{pre} launches {counts}, want edge_rewrite == {rewrites} "
            f"({log.calls} commits, warmup's included) and hook_compress, "
            f"pointer_jump above 0")
    edges = np.stack([np.concatenate([c[1] for c in log.commits]),
                      np.concatenate([c[2] for c in log.commits])], 1)
    t0 = time.perf_counter()
    oracle = {}  # scipy's labels by prefix size: the last epoch's is final

    def prefix_labels(size):
        if size not in oracle:
            oracle[size] = _scipy_labels(n, edges[:size])[1]
        return oracle[size]

    require(np.array_equal(canonical(server.store.labels.cpu().numpy()),
                           canonical(prefix_labels(len(edges)))),
            f"{pre} the final labels' partition differs from scipy's on "
            f"every committed edge")
    seen = sorted({a[0] for a in log.answers if a[0] > len(pre_walls)})
    picks = sorted({seen[round(i * (len(seen) - 1) / (epochs - 1))]
                    for i in range(epochs)})
    checked = 0
    for e in picks:
        lab = prefix_labels(int(sizes[e]))
        for epoch, qa, qb, ans in log.answers:
            if epoch == e:
                require(np.array_equal(ans.cpu().numpy(),
                                       lab[qa] == lab[qb]),
                        f"{pre} answers at epoch {e} differ from scipy's "
                        f"on its {sizes[e]}-edge prefix")
                checked += qa.shape[0]
    require(len(picks) >= epochs or len(seen) < epochs,
            f"{pre} only epochs {picks} answered")
    print(f"{pre} checks: epochs 1..{len(epoch_order)} in commit order; "
          f"{submitted} edges submitted == committed; final partition == "
          f"scipy's; {checked} answers at epochs {picks} == scipy on their "
          f"prefixes ({len(oracle)} scipy runs, "
          f"{time.perf_counter() - t0:.2f} s)")
    return server


def serve_dynamic(torch, g, session, seed: int, card: str, pre: str):
    """The dynamic server of ``session``: SERVE_DYNAMIC_PRELOAD commits, a
    closed loop with deletes, scipy on the live multiset replayed from the
    commit log."""
    import numpy as np

    from repro_torch.kernels import ops

    n = g.n
    ops.reset_launch_counts()
    dserver = serve_server(session, g, dynamic=True)
    dlog = _ServeLog(dserver)
    dpre = serve_preload(torch, dserver, g, seed, dynamic=True)
    dres = serve_closed_loop(dserver, True, seed)
    dcounts = ops.launch_counts()
    dst = dserver.stats()
    print(_serve_row(pre, f"dynamic closed {SERVE_CLIENTS}x"
                     f"{SERVE_DYNAMIC_REQUESTS} delete_frac="
                     f"{SERVE_DELETE_FRAC}", dres))
    print(f"{pre} dynamic stats {dst}")
    # the live multiset, replayed from the commit log: a delete removes
    # every copy of its pair, and within a commit deletes apply before
    # inserts, so an insert of commit i lives iff no commit after i deletes
    # its pair
    ins_key, ins_at, del_key, del_at = [], [], [], []
    for i, (_, u, v, du, dv) in enumerate(dlog.commits):
        keep = u != v
        ins_key.append(_live_keys(np.stack([u[keep], v[keep]], 1), n))
        ins_at.append(np.full(int(keep.sum()), i))
        del_key.append(_live_keys(np.stack([du, dv], 1), n))
        del_at.append(np.full(du.shape[0], i))
    ins_key, ins_at = np.concatenate(ins_key), np.concatenate(ins_at)
    del_key, del_at = np.concatenate(del_key), np.concatenate(del_at)
    last = {}
    for k, at in zip(del_key.tolist(), del_at.tolist()):
        last[k] = max(at, last.get(k, -1))
    dkeys = np.asarray(sorted(last), np.int64)
    dlast = np.asarray([last[k] for k in dkeys.tolist()], np.int64)
    pos = np.searchsorted(dkeys, ins_key).clip(0, max(len(dkeys) - 1, 0))
    hit = (dkeys[pos] == ins_key) if len(dkeys) else np.zeros_like(ins_key,
                                                                   bool)
    live = ins_key[~hit | (dlast[pos] <= ins_at)]
    _, lab = _scipy_labels(n, np.stack([live // n, live % n], 1))
    used = int(dserver.store._ops.used(dserver.store._committed).sum())
    require(np.array_equal(canonical(dserver.store.labels.cpu().numpy()),
                           canonical(lab)),
            f"{pre} dynamic: the final labels differ from scipy's on the "
            "live multiset")
    require(used == len(live),
            f"{pre} dynamic: {used} live log entries, want {len(live)}")
    require(dcounts["scatter_min"] > 0 and dcounts["pointer_jump"] > 0,
            f"{pre} dynamic: launches {dcounts}")
    dms = [w * 1e3 for w in dlog.walls]
    print(f"{pre} dynamic server n={n} exec={dserver.exec_str}, log "
          f"{SERVE_DYNAMIC_LOG}: preload "
          f"{len(dpre)} commits of {SERVE_PRELOAD} in {sum(dpre):.3f} s; "
          f"closed loop {len(dms)} commits, commit wall p50 "
          f"{_pct(dms, 0.5):.4f} ms, p99 {_pct(dms, 0.99):.4f} ms; "
          f"{dst.edges_deleted} deletes committed; final labels == scipy on "
          f"the {len(live)} live edges == the log's live count; launches "
          f"{json.dumps(dcounts)}; card {card}")
    return dserver


# the analytic resident bytes of chunked ingest, as the JAX package's scale
# benchmark states them (benchmarks/scale_bench.py::_analytic_bytes): int32
# labels over n + 1 rows, one dump-padded (u, v) chunk at its pow2 bucket,
# the survivor buffer pair, and the sampling head's graph (4 int32 arrays at
# the head chunk's padded size, freed after sampling)
def _analytic_bytes(n: int, chunk: int, cap: int) -> int:
    from repro_torch.core.driver import bucket_size
    b = bucket_size(chunk, pad="pow2")
    return 4 * (n + 1) + 2 * 4 * b + 2 * 4 * (cap + 1) + 4 * 4 * b + 4 * (n + 2)


INGEST_VARIANTS = (MAIN_VARIANT, "kout_afforest_k2+uf_sync_full",
                   "none+uf_sync_full")
INGEST_PATH = "kout_afforest_k2+uf_sync_full"  # the power-law streams'


class _Timed:
    """A ChunkedEdgeSource wrapper that counts the host seconds its chunks
    take to make and keeps each chunk (for the oracle) if asked."""

    def __init__(self, source, keep: bool = False):
        self.n = source.n
        self._source, self._keep = source, keep
        self.seconds, self.kept = 0.0, []

    def chunks(self):
        it = iter(self._source.chunks())
        while True:
            t0 = time.perf_counter()
            chunk = next(it, None)
            self.seconds += time.perf_counter() - t0
            if chunk is None:
                return
            if self._keep:
                self.kept.append(chunk)
            yield chunk


def _run_ingest(torch, session, source, what: str):
    """One from_chunks run → (labels, stats, wall s, launches, peak bytes
    above what was allocated before it)."""
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    labels, stats = session.from_chunks(source, return_stats=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    require(labels.shape == (source.n,) and labels.dtype == torch.int32,
            f"{what}: labels shape {tuple(labels.shape)}")
    require(counts["edge_rewrite"] == stats.chunks,
            f"{what}: {counts['edge_rewrite']} edge_rewrite launches for "
            f"{stats.chunks} chunks")
    for name in ("hook_compress", "pointer_jump", "scatter_min"):
        require(counts[name] > 0, f"{what}: kernel {name} never launched")
    return labels, stats, wall, counts, peak


def phase_ingest(torch, g, expect, seed: int, log_m: int, exact: bool,
                 card: str):
    """Out-of-core ingest (ConnectIt.from_chunks): the graph's undirected
    edges in the stream phase's order as a host ArrayEdgeSource of 8 chunks,
    for INGEST_VARIANTS, against scipy and the one-shot path; the same
    edges as compressed blocks decoded on the card; power-law streams of
    2^(log_m) and 2^(log_m + 2) edges over 4n vertices, whose resident
    peaks must agree. Returns the host edge array (for the profile)."""
    import numpy as np

    from repro_torch import ConnectIt
    from repro_torch.graphs import compress_edges

    n = g.n
    src = ingest_source(torch, g, seed, log_m)
    E = src.edges
    m = E.shape[0]
    chunk = ingest_chunk(log_m)
    for variant in INGEST_VARIANTS:
        session = ConnectIt(variant, device="cuda")
        what = f"ingest {variant}"
        labels, stats, wall, counts, peak = _run_ingest(torch, session, src,
                                                        what)
        require(np.array_equal(labels.cpu().numpy(), expect),
                f"{what}: labels differ from the scipy oracle")
        require(stats.chunks == src.num_chunks and stats.edges_total == m,
                f"{what}: {stats.chunks} chunks, {stats.edges_total} edges "
                f"streamed; want {src.num_chunks} and {m}")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        one = session.connectivity(g)
        torch.cuda.synchronize()
        one_peak = torch.cuda.max_memory_allocated() - base
        require(torch.equal(one, labels),
                f"{what}: labels differ from .connectivity(g)'s")
        print(f"[ingest] {what}: {stats.chunks} chunks of {chunk}, {m} edges "
              f"streamed; labels == scipy == .connectivity; survivors "
              f"{stats.edges_finish} (ratio {stats.survivor_ratio:.6f}); "
              f"spills {stats.spills}; finish_rounds {stats.finish_rounds}; "
              f"lmax_count {stats.lmax_count}; wall {wall:.4f} s, "
              f"{m / wall:.1f} edges/s; peak device memory above the "
              f"resident graph {peak} bytes (one-shot .connectivity "
              f"{one_peak}); launches {json.dumps(counts)}; card {card}")

    t0 = time.perf_counter()
    blocks = compress_edges(E, n, block_size=1 << 16, device="cuda")
    t_comp = time.perf_counter() - t0
    what = f"ingest {MAIN_VARIANT} compressed"
    labels, stats, wall, counts, peak = _run_ingest(
        torch, ConnectIt(MAIN_VARIANT, device="cuda"), blocks, what)
    require(np.array_equal(labels.cpu().numpy(), expect),
            f"{what}: labels differ from the scipy oracle")
    require(stats.edges_total == m, f"{what}: {stats.edges_total} edges")
    print(f"[ingest] {what}: compress_edges on the host {t_comp:.2f} s, "
          f"{blocks.num_blocks} blocks of 2^16, {blocks.nbytes} bytes "
          f"(ratio {blocks.ratio:.3f} against int32 COO); decoded on the "
          f"card: labels == scipy; spills {stats.spills}; wall {wall:.4f} s, "
          f"{m / wall:.1f} edges/s; peak above the graph {peak} bytes; "
          f"launches {json.dumps(counts)}")
    del blocks

    session = ConnectIt(INGEST_PATH, device="cuda")
    pn = 4 * n
    peaks = []
    for lm in (log_m, log_m + 2):
        stream = _Timed(powerlaw_source(g, lm, log_m), keep=lm > log_m)
        what = f"ingest {INGEST_PATH} powerlaw_chunks(n={pn}, m=2^{lm})"
        labels, stats, wall, counts, peak = _run_ingest(torch, session,
                                                        stream, what)
        peaks.append(peak)
        check = "labels not checked"
        if stream.kept:
            t0 = time.perf_counter()
            _, lab = _scipy_labels(pn, np.concatenate(stream.kept))
            stream.kept.clear()
            require(np.array_equal(labels.cpu().numpy(), canonical(lab)),
                    f"{what}: labels differ from scipy's")
            check = f"labels == scipy ({time.perf_counter() - t0:.1f} s)"
        cap = stats.edges_finish_padded // 2 - 1  # the buffer's capacity
        print(f"[ingest] {what}: {stats.chunks} chunks; {check}; survivors "
              f"{stats.edges_finish}; spills {stats.spills}; finish_rounds "
              f"{stats.finish_rounds}; lmax_count {stats.lmax_count}; wall "
              f"{wall:.4f} s ({stream.seconds:.4f} s of it making chunks on "
              f"the host), {(1 << lm) / wall:.1f} edges/s; peak device "
              f"memory above the resident graph {peak} bytes, analytic "
              f"resident bytes {_analytic_bytes(pn, chunk, cap)}; launches "
              f"{json.dumps(counts)}; card {card}")
    spread = max(peaks) / min(peaks) - 1
    print(f"[ingest] power-law peaks {peaks}: spread {100 * spread:.2f}%")
    if exact:
        require(spread <= 0.05, f"ingest: the power-law peaks {peaks} differ "
                f"by more than 5%")
    return E


def _sym_uniform(torch, g, seed: int):
    """One uniform float32 draw per undirected edge (numpy, ``seed``), given
    to both directions; inf on the padding, as ``with_weights`` pads."""
    import numpy as np
    s, r = g.senders[: g.m].long(), g.receivers[: g.m].long()
    key = torch.minimum(s, r) * (g.n + 1) + torch.maximum(s, r)
    uniq, inv = torch.unique(key, return_inverse=True)
    draw = np.random.default_rng(seed).random(uniq.shape[0]).astype(np.float32)
    out = torch.full((g.m_pad,), float("inf"), device=g.device)
    out[: g.m] = torch.from_numpy(draw).cuda()[inv]
    return out


def _scan_oracle(n: int, s, r, sims, eps: float, mu: int):
    """gs_query_sequential restated with numpy and scipy: cores have at
    least mu similar edges; the core-core similar subgraph's components
    take their min vertex; a non-core vertex takes the min of its own id
    and its similar core neighbours' labels."""
    import numpy as np
    similar = sims >= np.float32(eps)
    core = np.bincount(s[similar], minlength=n) >= mu
    # the similar core-core edges, one direction each (sims are symmetric)
    cc = similar & core[s] & core[r] & (s < r)
    _, lab = _scipy_labels(n, np.stack([s[cc], r[cc]], 1))
    labels = canonical(lab).astype(np.int64)
    att = similar & core[r] & ~core[s]
    np.minimum.at(labels, s[att], labels[r[att]])
    return labels, core


def _mst_weight(g, w) -> tuple:
    """scipy's minimum spanning tree weight (float64) of the graph under
    weights ``w``, the host weights of the graph's edges, and the tree's
    edge count."""
    import numpy as np
    from scipy.sparse.csgraph import minimum_spanning_tree

    s = g.senders[: g.m].cpu().numpy()
    r = g.receivers[: g.m].cpu().numpy()
    wh = w[: g.m].cpu().numpy()
    up = s < r
    mst = minimum_spanning_tree(_csr(g.n, s[up], r[up],
                                     wh[up].astype(np.float64)))
    return float(mst.sum()), wh, mst.nnz


def _forest_weight64(edges, n: int, keys, wh) -> float:
    """A forest's weight in float64: each edge's weight found by its key
    among the graph's sorted edge keys."""
    import numpy as np
    at = np.searchsorted(keys, edges[:, 0].astype(np.int64) * (n + 1)
                         + edges[:, 1])
    return float(wh[at].astype(np.float64).sum())


def phase_apps(torch, g, expect, keys, exact: bool, card: str):
    """AMSF (mask, skip=lmax, coo) and exact MSF on the graph with
    with_weights(g, seed=0), against scipy's minimum spanning tree; SCAN at
    full size on seeded symmetric similarities against a numpy/scipy
    restatement of the sequential query, and on a graph small enough for
    build_index against gs_query_sequential. Returns the weights, scipy's
    MST weight and, per AMSF spec, the single path's forest, buckets and
    edges per bucket."""
    import numpy as np

    from repro_torch import ConnectIt
    from repro_torch.core.apps import amsf as amsf_impl
    from repro_torch.core.apps import scan as scan_impl
    from repro_torch.graphs.generators import rmat, with_weights
    from repro_torch.kernels import ops

    n = g.n
    t0 = time.perf_counter()
    w = with_weights(g, seed=0)
    torch.cuda.synchronize()
    t_w = time.perf_counter() - t0
    s = g.senders[: g.m].cpu().numpy()
    r = g.receivers[: g.m].cpu().numpy()
    t0 = time.perf_counter()
    exact_w, wh, nnz = _mst_weight(g, w)
    t_mst = time.perf_counter() - t0
    print(f"[apps] with_weights on the card {t_w:.2f} s; scipy "
          f"minimum_spanning_tree (float64) {t_mst:.2f} s: weight "
          f"{exact_w!r}, {nnz} edges")
    session = ConnectIt(MAIN_VARIANT, device="cuda")
    single = {}
    for spec in ("amsf", "amsf(skip=lmax)", "amsf(mode=coo)", "msf"):
        what = f"apps {MAIN_VARIANT} {spec}"
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        edges, stats = session.amsf(g, w, spec, return_stats=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() - base
        single[spec] = (edges, stats.buckets, stats.edges_per_bucket)
        for name in ("pointer_jump", "scatter_min"):
            require(counts[name] > 0, f"{what}: kernel {name} never launched")
        check_forest(edges, n, expect, keys, what)
        weight = amsf_impl.forest_weight(edges, g, w)
        w64 = _forest_weight64(edges, n, keys, wh)
        if spec == "msf":
            require(abs(w64 - exact_w) <= 1e-9 * exact_w
                    and abs(weight - exact_w) <= 1e-5 * exact_w,
                    f"{what}: weight {w64!r} (float32 sum {weight!r}), "
                    f"scipy's {exact_w!r}")
        else:
            require(exact_w * (1 - 1e-9) <= w64 <= 1.25 * exact_w,
                    f"{what}: weight {w64!r} outside [{exact_w!r}, 1.25 x]")
        print(f"[apps] {what}: {len(edges)} edges, a spanning forest; weight "
              f"{w64!r} ({w64 / exact_w:.6f} x scipy's MST; float32 sum "
              f"{weight!r}); buckets {stats.buckets}; finish_rounds "
              f"{stats.finish_rounds}; wall {wall:.4f} s; peak device "
              f"memory above the graph {peak} bytes; launches "
              f"{json.dumps(counts)}; card {card}")

    sims = _sym_uniform(torch, g, 0)
    sh = sims[: g.m].cpu().numpy()
    for eps, mu in ((0.6, 3), (0.3, 3)):
        what = f"apps {MAIN_VARIANT} scan(eps={eps},mu={mu})"
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        labels, is_core, stats = session.scan(
            g, sims, f"scan(eps={eps},mu={mu})", return_stats=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        t0 = time.perf_counter()
        want, core = _scan_oracle(n, s, r, sh, eps, mu)
        t_ref = time.perf_counter() - t0
        require(np.array_equal(is_core.cpu().numpy(), core),
                f"{what}: is_core differs from the restatement's")
        require(np.array_equal(labels.cpu().numpy(), want),
                f"{what}: labels differ from the restatement's")
        for name in ("hook_compress", "pointer_jump", "scatter_min"):
            require(counts[name] > 0, f"{what}: kernel {name} never launched")
        print(f"[apps] {what}: labels, is_core == the numpy/scipy "
              f"restatement ({t_ref:.2f} s on the host); {int(core.sum())} "
              f"cores, {len(np.unique(want))} clusters; core-core edges "
              f"{stats.edges_finish}; finish_rounds {stats.finish_rounds}; "
              f"wall {wall:.4f} s; launches {json.dumps(counts)}")

    small = rmat(1 << 13, 12 << 13, seed=4, device="cuda")
    t0 = time.perf_counter()
    index = scan_impl.build_index(small)
    t_index = time.perf_counter() - t0
    for eps, mu in ((0.1, 3), (0.3, 3)):  # benchmarks/scan_bench.py's
        labels, is_core = session.scan(small, torch.from_numpy(index).cuda(),
                                       f"scan(eps={eps},mu={mu})")
        want, core = scan_impl.gs_query_sequential(small, index, eps, mu=mu)
        require(np.array_equal(labels.cpu().numpy(), want)
                and np.array_equal(is_core.cpu().numpy(), core),
                f"apps scan(eps={eps},mu={mu}) on rmat(2^13): differs from "
                f"gs_query_sequential")
        print(f"[apps] scan(eps={eps},mu={mu}) on rmat(2^13, 12*2^13, seed=4) "
              f"(m={small.m}; build_index on the host {t_index:.2f} s): "
              f"labels, is_core == gs_query_sequential; {int(core.sum())} "
              f"cores")
    return {"weights": w, "exact": exact_w, "wh": wh, "single": single}


def _required_kernels(variant: str) -> tuple:
    """The kernels a run of ``variant`` must launch: those its single-device
    path launches (PATHS), the uf_sync kernels otherwise."""
    for v, _, counts, _ in PATHS:
        if v == variant:
            return tuple(k for k, c in zip(PATH_KERNELS, counts) if c)
    return UF_KERNELS


def phase_placements(torch, g, expect, keys, seed: int, exact: bool,
                     card: str, dyn: dict, apps: dict):
    """The replicated and sharded placements (repro_torch.core.execution)
    at the full size: (a) PLACEMENT_RUNS at one rank over NCCL in this
    process, each against scipy's labels and the single path's, with its
    median wall of 5, rounds, launches, host waits an outer round (one
    traced run) and peak memory; (b) the stream phase's 2^20-edge batches
    under sharded(x); (c) scan(eps=0.6,mu=3) under sharded(x) against the
    single path on the apps phase's similarities; (e) the dynamic phase's
    sliding window, (f) amsf and amsf(skip=lmax), and (g) the serve phase's
    servers, under the placements, each against the single path (``dyn``,
    ``apps``) or scipy; (d) GLOO_EXECS on two processes sharing the card
    over gloo, each against (a)'s labels."""
    import statistics

    import numpy as np

    from repro_torch import ConnectIt
    from repro_torch.kernels import ops
    from repro_torch.launch import multihost

    topo = multihost.initialize()  # nothing configured: one rank
    require(topo.num_processes == 1 and "nccl" in topo.backend,
            f"placements: one-rank group expected, got {topo}")
    t_a = time.perf_counter()
    try:
        single = {}
        for variant, exec_str in PLACEMENT_RUNS:
            what = f"placements {variant} {exec_str}"
            if variant not in single:
                single[variant] = ConnectIt(variant, device="cuda") \
                    .connectivity(g).cpu().numpy()
            ci = ConnectIt(variant, exec=exec_str, device="cuda")
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            labels, stats = ci.connectivity(g, return_stats=True)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            peak = torch.cuda.max_memory_allocated() - base
            got = labels.cpu().numpy()
            require(np.array_equal(got, expect),
                    f"{what}: labels differ from the scipy oracle")
            require(np.array_equal(got, single[variant]),
                    f"{what}: labels differ from the single path's")
            require(stats.exec == exec_str and stats.devices == 1
                    and sum(stats.edges_per_device) == stats.edges_finish
                    and sum(stats.dispatch_sizes)
                    == stats.edges_finish_padded,
                    f"{what}: stats {stats}")
            for name in _required_kernels(variant):
                require(counts[name] > 0,
                        f"{what}: kernel {name} never launched")
            _check_counts(what, counts, stats.finish_rounds,
                          PLACEMENT_COUNTS.get((variant, exec_str)), exact)
            walls = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ci.connectivity(g)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            main = (variant, exec_str) == (MAIN_VARIANT, "sharded(x)")
            calls = _trace(torch, what, lambda: ci.connectivity(g),
                           top=15 if main else 0)
            waits = sum(calls.get(k, 0) for k in SYNC_CALLS)
            print(f"[placements] {what}: labels == scipy == single; median "
                  f"wall of 5 {statistics.median(walls) * 1e3:.4f} ms; "
                  f"finish_rounds {stats.finish_rounds}; host waits "
                  f"{waits} ({waits / stats.finish_rounds:.1f} an outer "
                  f"round); edges_finish {stats.edges_finish} of "
                  f"{stats.edges_finish_padded}; peak device memory above "
                  f"the graph {peak} bytes; launches {json.dumps(counts)}; "
                  f"card {card}")
        print(f"[time] placements (a): {time.perf_counter() - t_a:.1f} s")
        for part, fn, args in (
                ("(b)", _placement_stream, (expect, seed, exact, card)),
                ("(c)", _placement_scan, ()),
                ("(e)", _placement_dynamic, (dyn, seed, exact, card)),
                ("(f)", _placement_amsf, (expect, keys, apps, exact, card)),
                ("(g)", _placement_serve, (seed, card))):
            t0 = time.perf_counter()
            fn(torch, g, *args)
            print(f"[time] placements {part}: {time.perf_counter() - t0:.1f} "
                  f"s")
    finally:
        multihost.shutdown()
    t0 = time.perf_counter()
    _placement_gloo(torch, g, expect, card)
    print(f"[time] placements (d): {time.perf_counter() - t0:.1f} s")


def _placement_stream(torch, g, expect, seed: int, exact: bool, card: str,
                      tag: str = "", want=PLACEMENT_STREAM_COUNTS) -> None:
    """(b): the stream phase's 2^20-edge batches, each with 2^16 query
    pairs, through ConnectIt(MAIN_VARIANT, exec="sharded(x)").stream(n).
    The last batch's prefix is every edge, so its oracle is ``expect``.
    ``want`` holds its launches and rounds at one rank (None elsewhere)."""
    import numpy as np

    from repro_torch import ConnectIt
    from repro_torch.kernels import ops

    u, v = stream_edges(torch, g, seed)
    total, batch = u.shape[0], STREAM_BATCH
    nb = -(-total // batch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    queries = torch.randint(0, g.n, (nb, 2, 1 << 16), generator=gen,
                            device="cuda", dtype=torch.int32)
    st = ConnectIt(MAIN_VARIANT, exec="sharded(x)",
                   device="cuda").stream(g.n)
    ops.reset_launch_counts()
    walls = []
    for i in range(nb):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ans = st.process(u[i * batch: (i + 1) * batch],
                         v[i * batch: (i + 1) * batch],
                         queries[i, 0], queries[i, 1])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    counts = ops.launch_counts()
    stats = st.stats
    what = f"placements {tag}stream sharded(x) batch={batch}"
    require(stats.edges_total == total, f"{what}: {stats.edges_total} edges")
    require(np.array_equal(canonical(st.labels.cpu().numpy()), expect),
            f"{what}: the stream's components differ from scipy's")
    q = queries[-1].cpu().numpy()
    require(np.array_equal(ans.cpu().numpy(), expect[q[0]] == expect[q[1]]),
            f"{what}: the last batch's answers differ from scipy's")
    for name in UF_KERNELS:
        require(counts[name] > 0, f"{what}: kernel {name} never launched")
    _check_counts(what, counts, stats.finish_rounds, want, exact)
    ms = [w * 1e3 for w in walls]
    print(f"[placements] {what}: {nb} batches, {total} edges; labels' "
          f"partition == scipy's; the last batch's answers == scipy's; "
          f"{total / sum(walls):.1f} inserted edges/s; per batch p50 "
          f"{_pct(ms, 0.5):.4f} ms, p99 {_pct(ms, 0.99):.4f} ms; "
          f"finish_rounds {stats.finish_rounds}; batch_shapes "
          f"{stats.batch_shapes}; launches {json.dumps(counts)}; card {card}")


def _placement_scan(torch, g) -> None:
    """(c): scan(eps=0.6,mu=3) under sharded(x) against the single path,
    on the apps phase's similarities."""
    from repro_torch import ConnectIt

    sims = _sym_uniform(torch, g, 0)
    spec = "scan(eps=0.6,mu=3)"
    want = ConnectIt(MAIN_VARIANT, device="cuda").scan(g, sims, spec)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    labels, cores, stats = ConnectIt(
        MAIN_VARIANT, exec="sharded(x)", device="cuda").scan(
        g, sims, spec, return_stats=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    require(torch.equal(labels, want[0]) and torch.equal(cores, want[1]),
            f"placements {spec} sharded(x): differs from the single path")
    print(f"[placements] {MAIN_VARIANT} {spec} sharded(x): labels, is_core "
          f"== the single path's; core-core edges {stats.edges_finish}; "
          f"finish_rounds {stats.finish_rounds}; wall {wall:.4f} s")


def _placement_dynamic(torch, g, single: dict, seed: int, exact: bool,
                       card: str, execs=PLACEMENT_DYN_EXECS, tag: str = "",
                       trace: bool = True) -> list:
    """(e): the dynamic phase's sliding window (8 steps, log 2^23) through
    ConnectIt(MAIN_VARIANT, exec=...).stream(n, dynamic=True) for each of
    ``execs``: each step's answers against the single path's (``single``,
    which scipy checked), the final labels' partition equal to its, the
    forest n - #components edges of the live graph; updates/s, the
    per-step wall, rounds, fallback rebuilds, and with ``trace`` the host
    waits of a traced ninth step. Returns each run's rounds and stats."""
    from unittest import mock

    import numpy as np

    from repro_torch import ConnectIt
    from repro_torch.core import distributed
    from repro_torch.dynamic.engine import DEFAULT_SEARCH_ROUNDS
    from repro_torch.kernels import ops

    n = g.n
    _, log = sliding_batch_log(n)
    fixpoint = distributed.iterate_to_fixpoint
    out = []
    for exec_str in execs:
        what = f"placements {tag}(e) dynamic {exec_str}"
        bounds = []

        def recording(step, state, max_rounds, **kw):
            # an update's insert phase and its search fallback run to the
            # outer cap, its bounded search to DEFAULT_SEARCH_ROUNDS
            bounds.append(max_rounds)
            return fixpoint(step, state, max_rounds, **kw)

        d = ConnectIt(MAIN_VARIANT, exec=exec_str, device="cuda").stream(
            n, dynamic=True, log=log)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        steps = []
        calls = {}
        with mock.patch.object(distributed, "iterate_to_fixpoint",
                               recording):
            gen = sliding_steps(torch, n, seed, 9)
            for step, (ins, dels, q, args) in zip(range(8), gen):
                before, b0 = d._rounds, len(bounds)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ans = d.process(*args)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                require(np.array_equal(ans.cpu().numpy(),
                                       single["answers"][step]),
                        f"{what} step {step}: answers differ from the "
                        f"single path's")
                capped = sum(1 for b in bounds[b0:]
                             if b > DEFAULT_SEARCH_ROUNDS)
                steps.append((wall, len(ins) + len(dels), d._rounds - before,
                              capped - 1))
            counts = ops.launch_counts()
            stats = d.stats
            require(np.array_equal(canonical(d.labels.cpu().numpy()),
                                   single["labels"]),
                    f"{what}: the labels' partition differs from the single "
                    f"path's")
            forest = d.forest_edges()
            require(forest.shape == (n - single["ncomp"], 2)
                    and bool(np.isin(_live_keys(forest, n),
                                     single["live"]).all()),
                    f"{what}: the forest ({forest.shape[0]} edges) is not "
                    f"n - {single['ncomp']} edges of the live graph")
            require(d.log_used() == single["used"],
                    f"{what}: {d.log_used()} live log entries, want "
                    f"{single['used']}")
            require([x[2] for x in steps] == single["rounds"],
                    f"{what}: rounds a step {[x[2] for x in steps]}, the "
                    f"single path's {single['rounds']}")
            for name in ("scatter_min", "pointer_jump"):
                require(counts[name] > 0,
                        f"{what}: kernel {name} never launched")
            _check_counts(what, counts, stats.finish_rounds,
                          PLACEMENT_DYNAMIC_COUNTS.get(exec_str) if not tag
                          else None, exact)
            if trace:
                ins, dels, q, args = next(gen)
                calls = _trace(torch, f"{what} step 9 ({len(dels)} deletes, "
                               f"{len(ins)} inserts)",
                               lambda: d.process(*args),
                               top=12 if exec_str == "sharded(x)" else 0)
        ms = [x[0] * 1e3 for x in steps]
        total = sum(x[1] for x in steps)
        waits = sum(calls.get(k, 0) for k in SYNC_CALLS)
        print(f"[placements] {what}: answers == the single path's at every "
              f"step, labels' partition == its, forest {len(forest)} edges "
              f"of the live graph; {total / sum(x[0] for x in steps):.1f} "
              f"updates/s; per-step wall p50 {_pct(ms, 0.5):.4f} ms, p99 "
              f"{_pct(ms, 0.99):.4f} ms; finish_rounds {stats.finish_rounds} "
              f"(a step {[x[2] for x in steps]}); fallback rebuilds a step "
              f"{[x[3] for x in steps]}; host waits of the traced step "
              f"{waits if trace else 'not traced'}; launches "
              f"{json.dumps(counts)}; card {card}")
        out.append({"variant": MAIN_VARIANT, "exec": f"{exec_str} dynamic",
                    "rounds": stats.finish_rounds,
                    "edges_per_device": list(stats.edges_per_device),
                    "dispatch_sizes": list(stats.dispatch_sizes)})
    return out


def _placement_amsf(torch, g, expect, keys, apps: dict, exact: bool,
                    card: str, execs=PLACEMENT_DYN_EXECS, specs=AMSF_SPECS,
                    tag: str = "", trace: bool = True) -> list:
    """(f): ``specs`` under each of ``execs`` on the apps phase's weights:
    a spanning forest within 1.25x of scipy's MST weight, its buckets and
    edges per bucket equal to the single path's (``apps``); wall, rounds,
    launches, and with ``trace`` one traced sharded(x) amsf(skip=lmax)
    (busy share, collectives, host waits a round). Returns each run's
    rounds and stats."""
    import numpy as np

    from repro_torch import ConnectIt
    from repro_torch.kernels import ops

    n, w, exact_w = g.n, apps["weights"], apps["exact"]
    out = []
    for exec_str in execs:
        session = ConnectIt(MAIN_VARIANT, exec=exec_str, device="cuda")
        for spec in specs:
            what = f"placements {tag}(f) {spec} {exec_str}"
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            edges, stats = session.amsf(g, w, spec, return_stats=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = ops.launch_counts()
            s_edges, buckets, per_bucket = apps["single"][spec]
            same = np.array_equal(edges, s_edges)
            if not same:  # the single path's forest was checked already
                check_forest(edges, n, expect, keys, what)
            w64 = _forest_weight64(edges, n, keys, apps["wh"])
            require(exact_w * (1 - 1e-9) <= w64 <= 1.25 * exact_w,
                    f"{what}: weight {w64!r} outside [{exact_w!r}, 1.25 x]")
            require(stats.buckets == buckets
                    and stats.edges_per_bucket == per_bucket,
                    f"{what}: buckets {stats.buckets} "
                    f"{stats.edges_per_bucket}, the single path's {buckets} "
                    f"{per_bucket}")
            for name in ("scatter_min", "pointer_jump"):
                require(counts[name] > 0,
                        f"{what}: kernel {name} never launched")
            _check_counts(what, counts, stats.finish_rounds,
                          PLACEMENT_AMSF_COUNTS.get((exec_str, spec))
                          if not tag else None, exact)
            print(f"[placements] {what}: {len(edges)} edges, a spanning "
                  f"forest; weight {w64!r} ({w64 / exact_w:.6f} x scipy's "
                  f"MST); buckets, edges per bucket == the single path's "
                  f"({stats.buckets}); forest {'==' if same else '!='} the "
                  f"single path's{'' if same else ' (checked on the host)'}; "
                  f"finish_rounds {stats.finish_rounds}; wall "
                  f"{wall:.4f} s; launches {json.dumps(counts)}; card {card}")
            out.append({"variant": MAIN_VARIANT, "exec": f"{exec_str} {spec}",
                        "rounds": stats.finish_rounds,
                        "edges_per_device": list(stats.edges_per_device),
                        "dispatch_sizes": list(stats.dispatch_sizes),
                        "edges": len(edges)})
    if trace:
        session = ConnectIt(MAIN_VARIANT, exec="sharded(x)", device="cuda")
        calls = _trace(torch, "placements (f) amsf(skip=lmax) sharded(x)",
                       lambda: session.amsf(g, w, "amsf(skip=lmax)"))
        waits = sum(calls.get(k, 0) for k in SYNC_CALLS)
        rounds = session.stats.finish_rounds
        print(f"[profile]   host waits {waits} ({waits / rounds:.2f} a "
              f"forest round of {rounds})")
    return out


def _placement_serve(torch, g, seed: int, card: str) -> None:
    """(g): the serve phase's static and dynamic servers under SERVE_EXEC
    at one rank, same caps and traffic (no open loops): answers against
    scipy at 2 epochs, the final labels against scipy, and a traced
    closed-loop window for the host waits a commit."""
    from repro_torch import ConnectIt

    session = ConnectIt(MAIN_VARIANT, exec=SERVE_EXEC, device="cuda")
    pre = f"[placements] (g) serve {SERVE_EXEC}"
    server = serve_static(torch, g, session, seed, card, pre,
                          open_loops=False, epochs=2)
    _trace_serve_window(torch, server, seed)
    del server
    serve_dynamic(torch, g, session, seed, card, pre)


def _placement_gloo(torch, g, expect, card: str) -> None:
    """(d): GLOO_EXECS on two processes that share the card over gloo
    (NCCL takes one rank a card)."""
    _run_ranks(torch, g, expect, 0, 2, "gloo",
               [(MAIN_VARIANT, e) for e in GLOO_EXECS], False, card)


def _single_dynamic(torch, n: int, seed: int) -> dict:
    """The single path's run of the dynamic phase's sliding window: each
    step's answers and rounds, the final labels' partition, and scipy's
    component count of the final live graph with its edge keys."""
    import numpy as np

    from repro_torch import ConnectIt

    d = ConnectIt(MAIN_VARIANT, device="cuda").stream(
        n, dynamic=True, log=sliding_batch_log(n)[1])
    live = np.zeros((0, 2), np.int32)
    answers, rounds = [], []
    for ins, dels, q, args in sliding_steps(torch, n, seed):
        before = d._rounds
        answers.append(d.process(*args).cpu().numpy())
        rounds.append(d._rounds - before)
        if len(dels):
            live = live[~np.isin(_live_keys(live, n), _live_keys(dels, n))]
        live = np.concatenate([live, ins[ins[:, 0] != ins[:, 1]]])
    ncomp, lab = _scipy_labels(n, live)
    labels = canonical(d.labels.cpu().numpy())
    require(np.array_equal(labels, canonical(lab)),
            "ranks: the single path's dynamic labels differ from scipy's")
    return {"answers": answers, "labels": labels, "ncomp": int(ncomp),
            "live": _live_keys(live, n), "used": len(live),
            "rounds": rounds}


def phase_ranks(torch, g, expect, seed: int, world: int, card: str) -> None:
    """``--ranks N``: PLACEMENT_RUNS and (b)'s stream on N processes, one
    rank a card over NCCL, each rank's labels against scipy's; then (e)
    under sharded(x), (f)'s amsf(skip=lmax) under sharded(x), each against
    the single path's run here, and one served closed loop under SERVE_EXEC
    with rank 0 serving and the other ranks following."""
    from repro_torch import ConnectIt
    from repro_torch.graphs.generators import with_weights

    require(torch.cuda.device_count() >= world,
            f"ranks: {world} ranks over NCCL need {world} cards, have "
            f"{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    dyn = _single_dynamic(torch, g.n, seed)
    w = with_weights(g, seed=0)
    exact_w, _, _ = _mst_weight(g, w)
    spec = "amsf(skip=lmax)"
    edges, st = ConnectIt(MAIN_VARIANT, device="cuda").amsf(
        g, w, spec, return_stats=True)
    print(f"[placements] ranks: the single path's dynamic run and {spec}, "
          f"scipy's MST weight {exact_w!r}: {time.perf_counter() - t0:.1f} s")
    extra = {"dyn": dyn, "weights": w.cpu().numpy(),
             "apps": {"exact": exact_w,
                      "single": {spec: (edges, st.buckets,
                                        st.edges_per_bucket)}}}
    _run_ranks(torch, g, expect, seed, world, "cpu:gloo,cuda:nccl",
               list(PLACEMENT_RUNS), True, card, extra)


def _run_ranks(torch, g, expect, seed: int, world: int, backend: str,
               runs: list, stream: bool, card: str,
               extra: dict = None) -> None:
    """Start ``world`` processes of this script (--mesh-rank), one rank
    each of a group over ``backend``. They read the graph and scipy's
    labels, which this process writes once to a temporary directory (not
    generating the graph again), run ``runs`` (and, with ``stream``, (b)'s
    stream; with ``extra``, phase_ranks' single-path results, (e), (f) and
    the served loop) and write what they measured there. Every rank must
    exit 0, the ranks must agree on each run's rounds and stats, and the
    served loop's ranks must end in rank 0's labels, which scipy's on its
    commit log must give."""
    import pickle
    import shutil
    import tempfile

    import numpy as np

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ranks_"))
    try:
        t0 = time.perf_counter()
        for name in ("senders", "receivers", "indptr", "indices"):
            getattr(g, name).cpu().numpy().tofile(tmp / f"{name}.i32")
        expect.astype("int32").tofile(tmp / "expect.i32")
        (tmp / "job.json").write_text(json.dumps(
            {"n": g.n, "m": g.m, "world": world, "backend": backend,
             "runs": runs, "stream": stream, "seed": seed, "card": card,
             "extra": extra is not None, "tune": extra is not None}))
        if extra is not None:
            extra["weights"].tofile(tmp / "weights.f32")
            (tmp / "extra.pkl").write_bytes(pickle.dumps(
                {k: v for k, v in extra.items() if k != "weights"}))
        t_write = time.perf_counter() - t0
        logs = _run_rank_procs(tmp, world, f"placements {backend}")
        for r, log in enumerate(logs):
            for line in log.splitlines():
                if line.startswith(("[placements]", "[check]")):
                    head, rest = line.split("]", 1)
                    print(f"{head}] {backend} rank {r} of {world}:{rest}")
        res = [json.loads((tmp / f"rank{r}.json").read_text())
               for r in range(world)]
        for i, run in enumerate(res[0]):
            keys = ("variant", "rounds", "edges_per_device", "dispatch_sizes")
            require(all({k: x[i][k] for k in keys} ==
                        {k: run[k] for k in keys} for x in res),
                    f"placements {backend} {run['variant']} {run['exec']}: "
                    f"the ranks disagree: {[x[i] for x in res]}")
        if extra is not None:
            written = [r for r in range(world)
                       if (tmp / f"tune{r}.json").exists()]
            require(written == [0], f"placements {backend} auto "
                    f"sharded(x):tune: cache files written by ranks "
                    f"{written}, only rank 0's may be")
            print(f"[placements] {backend} {world} ranks auto "
                  f"sharded(x):tune: every rank elected "
                  f"{res[0][-1]['variant']}; only rank 0's cache file "
                  f"written")
            served = [np.fromfile(tmp / f"served{r}.i32", dtype=np.int32)
                      for r in range(world)]
            for r in range(1, world):
                require(np.array_equal(served[r], served[0]),
                        f"placements {backend} serve: rank {r}'s final "
                        f"labels differ from rank 0's")
            log = np.fromfile(tmp / "commits.i32", dtype=np.int32)
            _, lab = _scipy_labels(g.n, log.reshape(-1, 2))
            require(np.array_equal(canonical(served[0]), canonical(lab)),
                    f"placements {backend} serve: rank 0's final labels "
                    f"differ from scipy's on its {log.size // 2} committed "
                    f"edges")
            print(f"[placements] {backend} {world} ranks serve {SERVE_EXEC}: "
                  f"every follower's final labels == rank 0's == scipy on "
                  f"the {log.size // 2} committed edges")
        print(f"[placements] {backend} {world} ranks: the graph written once "
              f"in {t_write:.2f} s; every rank's labels == scipy's; the "
              f"ranks agree on rounds and stats")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run_rank_procs(tmp: Path, world: int, what: str) -> list:
    """Run ``world`` processes of this script (--mesh-rank R --mesh-dir
    tmp) to their end; every one must exit 0 → their logs."""
    logs = [tmp / f"rank{r}.log" for r in range(world)]
    procs = []
    try:
        for r in range(world):
            with open(logs[r], "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, str(ROOT / "chip_smoke.py"),
                     "--mesh-rank", str(r), "--mesh-dir", str(tmp)],
                    stdout=f, stderr=subprocess.STDOUT))
        # a rank that fails leaves the others waiting in a collective
        deadline = time.monotonic() + 900
        while (any(p.poll() is None for p in procs)
               and not any(p.poll() for p in procs)
               and time.monotonic() < deadline):
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = []
    for r, p in enumerate(procs):
        log = logs[r].read_text()
        require(p.returncode == 0, f"{what} rank {r} of {world} exited "
                f"{p.returncode}:\n{log[-4000:]}")
        out.append(log)
    return out


def mesh_rank(rank: int, tmp: str) -> int:
    """One rank of _run_ranks: the job in ``tmp``'s job.json."""
    import statistics

    import numpy as np
    import torch

    from repro_torch import ConnectIt
    from repro_torch.graphs import graph_from_arrays
    from repro_torch.kernels import ops
    from repro_torch.launch import multihost

    d = Path(tmp)
    job = json.loads((d / "job.json").read_text())
    if job.get("cells"):
        return _rank_cells(rank, d, job)
    world, tag = job["world"], f"{job['backend']} {job['world']} ranks "
    arrays = [np.fromfile(d / f"{k}.i32", dtype=np.int32)
              for k in ("senders", "receivers", "indptr", "indices")]
    expect = np.fromfile(d / "expect.i32", dtype=np.int32)
    topo = multihost.initialize(init_method=f"file://{d}/rendezvous",
                                num_processes=world, process_id=rank,
                                backend=job["backend"], timeout=300)
    out = []
    try:
        g = graph_from_arrays(*arrays, job["n"], job["m"], device="cuda")
        for variant, exec_str in job["runs"]:
            what = f"{variant} {exec_str}"
            ci = ConnectIt(variant, exec=exec_str, device="cuda")
            ops.reset_launch_counts()
            labels, stats = ci.connectivity(g, return_stats=True)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            require(np.array_equal(labels.cpu().numpy(), expect),
                    f"rank {rank}: {what}: labels differ from scipy's")
            require(stats.devices == world
                    and sum(stats.edges_per_device) == stats.edges_finish
                    and sum(stats.dispatch_sizes)
                    == stats.edges_finish_padded,
                    f"rank {rank}: {what}: stats {stats}")
            for name in _required_kernels(variant):
                require(counts[name] > 0,
                        f"rank {rank}: {what}: kernel {name} never launched")
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ci.connectivity(g)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            wall = statistics.median(walls) * 1e3
            out.append({"variant": variant, "exec": exec_str,
                        "rounds": stats.finish_rounds,
                        "edges_per_device": list(stats.edges_per_device),
                        "dispatch_sizes": list(stats.dispatch_sizes),
                        "wall_ms": wall})
            print(f"[placements] {what}: labels == scipy; median wall of 3 "
                  f"{wall:.4f} ms; finish_rounds {stats.finish_rounds}; "
                  f"edges_per_device {stats.edges_per_device}; launches "
                  f"{json.dumps(counts)}; cuda:{torch.cuda.current_device()} "
                  f"of {topo.num_processes} ranks; card {job['card']}",
                  flush=True)
        if job["stream"]:
            _placement_stream(torch, g, expect, job["seed"], False,
                              job["card"], tag, want=None)
        if job["extra"]:
            out += _rank_extra(torch, g, d, job, expect, rank, tag)
        if job.get("tune"):
            out.append(_rank_tune(torch, g, d, expect, rank, tag))
    finally:
        multihost.shutdown()
    (d / f"rank{rank}.json").write_text(json.dumps(out))
    return 0


def _rank_extra(torch, g, d: Path, job: dict, expect, rank: int,
                tag: str) -> list:
    """One rank's part of phase_ranks' extra runs: (e) under sharded(x) and
    amsf(skip=lmax) under sharded(x) against the single path's results in
    ``d``, then the served closed loop under SERVE_EXEC (rank 0 serves and
    writes its commit log; every rank writes its final labels)."""
    import pickle

    import numpy as np

    from repro_torch import ConnectIt
    from repro_torch.serve import Follower

    extra = pickle.loads((d / "extra.pkl").read_bytes())
    out = _placement_dynamic(torch, g, extra["dyn"], job["seed"], False,
                             job["card"], execs=("sharded(x)",), tag=tag,
                             trace=False)
    w = np.fromfile(d / "weights.f32", dtype=np.float32)
    apps = dict(extra["apps"], weights=torch.from_numpy(w).cuda(),
                wh=w[: g.m])
    # the graph's sorted edge keys, as phase_oracle's
    keys = (g.senders[: g.m].cpu().numpy().astype(np.int64) * (g.n + 1)
            + g.receivers[: g.m].cpu().numpy())
    out += _placement_amsf(torch, g, expect, keys, apps, False,
                           job["card"], execs=("sharded(x)",),
                           specs=("amsf(skip=lmax)",), tag=tag, trace=False)
    session = ConnectIt(MAIN_VARIANT, exec=SERVE_EXEC, device="cuda")
    server = serve_server(session, g, dynamic=False)
    t0 = time.perf_counter()
    if isinstance(server, Follower):
        replayed = server.run()
        require(not server.errors, f"rank {rank}: the follower's replays "
                f"raised {server.errors}")
        print(f"[placements] {tag}serve {SERVE_EXEC}: rank {rank} followed "
              f"{replayed} operations (warmup and commits) to epoch "
              f"{server.epoch} in {time.perf_counter() - t0:.1f} s",
              flush=True)
        store = server.store
    else:
        log = _ServeLog(server)
        try:
            serve_preload(torch, server, g, job["seed"], dynamic=False)
            res = serve_closed_loop(server, False, job["seed"])
        finally:
            server.stop_followers()
        ms = [w * 1e3 for w in log.walls]
        print(_serve_row(f"[placements] {tag}serve {SERVE_EXEC} rank 0",
                         f"closed {SERVE_CLIENTS}x{SERVE_REQUESTS}", res))
        print(f"[placements] {tag}serve {SERVE_EXEC}: rank 0 served to "
              f"epoch {server.epoch}; closed loop {len(ms)} commits, commit "
              f"wall p50 {_pct(ms, 0.5):.4f} ms; saturation "
              f"{res.achieved_qps:.1f} query requests/s, p99 "
              f"{res.p99_ms:.4f} ms, committed {res.edges_per_s:.1f} "
              f"edges/s; card {job['card']}", flush=True)
        np.concatenate([np.stack([c[1], c[2]], 1).ravel()
                        for c in log.commits]).astype(np.int32).tofile(
            d / "commits.i32")
        store = server.store
    store.labels.cpu().numpy().tofile(d / f"served{rank}.i32")
    out.append({"variant": MAIN_VARIANT, "exec": f"{SERVE_EXEC} serve",
                "rounds": store.rounds_total, "edges_per_device": [],
                "dispatch_sizes": [store.epoch]})
    return out


def phase_tune(torch, g, expect, card: str) -> None:
    """The tuning loop on the card, each part on a cache file of its own
    under a temporary directory: (a) the five connectivity kernels at the
    ladder's block size against their plain versions, timed, then
    tune_block_m; (b) tune_variant on the graph; (c) ConnectIt("auto") on
    that cache; (d) the tune opt on a fresh cache; (e) launch.tune --smoke,
    then on its full proxies; (f) the script's cold cache resolves 256
    threads again."""
    import contextlib
    import functools
    import io
    import os
    import shutil
    import tempfile

    import numpy as np

    from repro_torch import ConnectIt, tune
    from repro_torch.kernels import ops
    from repro_torch.kernels.edge_relabel.ref import (
        edge_relabel_ref,
        edge_rewrite_ref,
    )
    from repro_torch.kernels.hook_compress.ref import hook_compress_ref
    from repro_torch.kernels.pointer_jump.ref import pointer_jump_ref
    from repro_torch.kernels.scatter_min.ref import scatter_min_ref
    from repro_torch.launch import tune as tlaunch
    from repro_torch.tune.space import BLOCK_M_FULL

    # the drivers' calls of each primitive (harness.primitive_drivers)
    plain = {"scatter_min": lambda P, s, r, v: scatter_min_ref(P, s, v),
             "pointer_jump": lambda P, s, r, v: pointer_jump_ref(P, k=3),
             "hook_compress": lambda P, s, r, v: hook_compress_ref(P, s, r,
                                                                   k=1),
             "edge_relabel": lambda P, s, r, v: edge_relabel_ref(P, s, r),
             "edge_rewrite": lambda P, s, r, v: edge_rewrite_ref(P, s, r)}

    def same(got, want) -> bool:
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        return all(torch.equal(a, b) for a, b in zip(got, want, strict=True))

    cold = os.environ[tune.ENV_VAR]
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_tune_"))
    try:
        # (a) every block size of the ladder, bit for bit, before any timing
        t0 = time.perf_counter()
        n, m = g.n, 4 * g.n
        problem = tune.primitive_problem(n, m, seed=0, device="cuda")
        drivers = tune.primitive_drivers(n, m, seed=0, device="cuda")
        for name in tune.PRIMITIVES:
            want = plain[name](*problem)
            for b in BLOCK_M_FULL:
                require(same(drivers[name](block_m=b), want),
                        f"tune: {name} at {b} threads differs from its plain "
                        f"version on tune_block_m's problem")
            try:
                drivers[name](block_m=2 * ops.DEFAULT_BLOCK_M)
                refused = False
            except ValueError:
                refused = True
            require(refused, f"tune: {name} launched at a block size off "
                    f"the ladder")
        torch.cuda.synchronize()
        print(f"[tune] (a) the five kernels at {list(BLOCK_M_FULL)} threads "
              f"a block == their plain versions on tune_block_m's problem "
              f"(n = {n}, m = {m}), and refuse "
              f"{2 * ops.DEFAULT_BLOCK_M}: {time.perf_counter() - t0:.1f} s")
        print(f"[tune] (a) ms a call at n = {n}, m = {m}: the time_fn "
              f"median (3 after 1, host clock, synchronized) and the "
              f"CUDA-event mean of {TUNE_EVENT_ITERS}; card {card}")
        for name in tune.PRIMITIVES:
            row = []
            for b in BLOCK_M_FULL:
                med = tune.time_fn(drivers[name], block_m=b, trials=3,
                                   warmup=1, device="cuda") * 1e3
                ev = time_ms(torch, functools.partial(drivers[name],
                                                      block_m=b),
                             iters=TUNE_EVENT_ITERS)
                row.append(f"{b}: median {med:.4f} event {ev:.4f}")
            print(f"[tune]   {name:14s} " + "; ".join(row))
        cache = tune.SelectionCache(str(tmp / "tune.json"))
        rows = tune.tune_block_m(tune.TuneSpec(), cache=cache, n=n, m=m,
                                 device="cuda")
        winners = {r["primitive"]: r["block_m"] for r in rows if r["winner"]}
        print(f"[tune] (a) tune_block_m(TuneSpec()) over "
              f"{list(tune.TuneSpec().block_m_candidates())}: " + "; ".join(
                  f"{r['primitive']} {r['block_m']} "
                  f"{r['time_s'] * 1e3:.4f} ms" + (" *" if r["winner"] else "")
                  for r in rows))
        require(sorted(winners) == sorted(tune.PRIMITIVES),
                f"tune: block winners {winners}")

        # (b) the variant on the graph
        t0 = time.perf_counter()
        fam = tune.fingerprint_graph(g)
        winner = tune.tune_variant(g, tune.TuneSpec(), cache=cache)
        entry = cache.get(tune.make_key("variant", fam, device=g.device))
        print(f"[tune] (b) tune_variant on the graph (family {fam}), median "
              f"ms of 3 after 1: " + "; ".join(
                  f"{v} {t * 1e3:.4f}" for v, t in entry["candidates"].items())
              + f"; winner {winner} ({time.perf_counter() - t0:.1f} s; card "
              f"{card})")
        require(entry["winner"] == winner
                and winner in tune.TuneSpec().variant_candidates(),
                f"tune: variant entry {entry}")

        # (c) the whole loop: persist, reload, resolve, run the winner
        os.environ[tune.ENV_VAR] = cache.path
        tune.reset_default_cache()
        ops.clear_tuned_blocks()
        blocks = {p: ops.tuned_block_m(p, g.device) for p in tune.PRIMITIVES}
        require(blocks == winners, f"tune: resolved blocks {blocks}, tuned "
                f"{winners}")
        ci = ConnectIt("auto", device="cuda")
        labels, st = ci.connectivity(g, return_stats=True)
        _, want = ConnectIt(winner, device="cuda").connectivity(
            g, return_stats=True)
        torch.cuda.synchronize()
        require(st.variant == winner, f"tune: auto ran {st.variant}, the "
                f"cache names {winner}")
        require(np.array_equal(labels.cpu().numpy(), expect),
                "tune: auto's labels differ from scipy's")
        require(st.finish_rounds == want.finish_rounds,
                f"tune: auto's finish rounds {st.finish_rounds}, the "
                f"winner's {want.finish_rounds}")
        print(f"[tune] (c) ConnectIt('auto') on that cache: {st.variant} at "
              f"blocks {blocks}; labels == scipy; finish_rounds "
              f"{st.finish_rounds} == the explicit run's")

        # (d) the tune opt on a fresh cache: one measurement, two calls
        os.environ[tune.ENV_VAR] = str(tmp / "fresh.json")
        tune.reset_default_cache()
        ops.clear_tuned_blocks()
        ci = ConnectIt("auto", exec="single:tune", device="cuda")
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            labels = ci.connectivity(g)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            require(np.array_equal(labels.cpu().numpy(), expect),
                    "tune: the tune opt's labels differ from scipy's")
        fresh = tune.SelectionCache(str(tmp / "fresh.json"))
        require(ci._tuned_families == {fam}
                and fresh.keys() == [tune.make_key("variant", fam,
                                                   device=g.device)],
                f"tune: the tune opt measured {ci._tuned_families}, cache "
                f"{fresh.keys()}")
        print(f"[tune] (d) ConnectIt('auto', exec='single:tune') on a fresh "
              f"cache: one family measured, winner "
              f"{fresh.winner(fresh.keys()[0])}, ran {ci.stats.variant}; "
              f"two calls {walls[0]:.2f} s (measuring) and "
              f"{walls[1] * 1e3:.2f} ms; labels == scipy")

        # (e) the CLI's smoke on the card
        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.tune", "--smoke",
             "--cache", str(tmp / "cli.json")],
            cwd=ROOT, capture_output=True, text=True, timeout=600,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
        require(cli.returncode == 0,
                f"tune: launch.tune --smoke exited {cli.returncode}:\n"
                f"{(cli.stdout + cli.stderr)[-4000:]}")
        print(f"[tune] (e) python -m repro_torch.launch.tune --smoke: exit 0 "
              f"in {time.perf_counter() - t0:.1f} s; "
              f"{cli.stdout.strip().splitlines()[-1]}")
        # the CLI on its full proxies, in this process: is the
        # device-global winner of small graphs the §4 graph's?
        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = tlaunch.main(["--cache", str(tmp / "full.json")])
        full = tune.SelectionCache(str(tmp / "full.json"))
        star = full.winner(tune.make_key("variant", "*", device=g.device))
        require(rc == 0 and star in tune.TuneSpec().variant_candidates(),
                f"tune: launch.tune exited {rc}, '*' winner {star}")
        for line in out.getvalue().splitlines():
            if line.strip():
                print(f"[tune]   {line}")
        print(f"[tune] (e) python -m repro_torch.launch.tune (full proxies, "
              f"2^11-2^13 vertices): '*' winner {star}, (b)'s on the graph "
              f"{winner}: {'the same' if star == winner else 'they differ'}"
              f"; {time.perf_counter() - t0:.1f} s; card {card}")
    finally:
        os.environ[tune.ENV_VAR] = cold
        tune.reset_default_cache()
        ops.clear_tuned_blocks()
        shutil.rmtree(tmp, ignore_errors=True)
    # (f) the script's cold cache again
    blocks = {p: ops.tuned_block_m(p, g.device) for p in tune.PRIMITIVES}
    require(set(blocks.values()) == {ops.DEFAULT_BLOCK_M},
            f"tune: the cold cache resolves {blocks}")
    print(f"[tune] (f) cold cache {cold}: every kernel at "
          f"{ops.DEFAULT_BLOCK_M} threads a block")


def _rank_tune(torch, g, d: Path, expect, rank: int, tag: str) -> dict:
    """phase_ranks' last run: ConnectIt("auto", exec="sharded(x):tune") with
    this rank's own cache file in ``d`` (only rank 0's is written)."""
    import os

    import numpy as np

    from repro_torch import ConnectIt, tune

    cold = os.environ.get(tune.ENV_VAR)
    os.environ[tune.ENV_VAR] = str(d / f"tune{rank}.json")
    tune.reset_default_cache()
    try:
        t0 = time.perf_counter()
        ci = ConnectIt("auto", exec="sharded(x):tune", device="cuda")
        labels, st = ci.connectivity(g, return_stats=True)
        torch.cuda.synchronize()
    finally:
        if cold is None:
            del os.environ[tune.ENV_VAR]
        else:
            os.environ[tune.ENV_VAR] = cold
        tune.reset_default_cache()
    require(np.array_equal(labels.cpu().numpy(), expect),
            f"rank {rank}: auto sharded(x):tune: labels differ from scipy's")
    print(f"[placements] {tag}auto sharded(x):tune: rank {rank} measured "
          f"and ran {st.variant} in {time.perf_counter() - t0:.1f} s; labels "
          f"== scipy", flush=True)
    return {"variant": st.variant, "exec": "sharded(x):tune",
            "rounds": st.finish_rounds,
            "edges_per_device": list(st.edges_per_device),
            "dispatch_sizes": list(st.dispatch_sizes)}


def _csr(n: int, rows, cols, data=None):
    """scipy's (n, n) CSR matrix of the entries (rows, cols, data; data 1.0
    if None; host arrays or card tensors), its rows sorted (stably) and
    counted on the card: scipy's COO conversion would sort and sum them on
    the host, much of an oracle's time. Entries are kept as they are (the
    MST's input has no duplicates)."""
    import numpy as np
    import torch
    from scipy.sparse import csr_matrix
    row, order = torch.sort(torch.as_tensor(rows, device="cuda"), stable=True)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device="cuda")
    indptr[1:] = torch.cumsum(torch.bincount(row, minlength=n), 0)
    del row
    cols = torch.as_tensor(cols, device="cuda")[order]
    data = (np.ones(order.shape[0]) if data is None else
            torch.as_tensor(data, device="cuda")[order].cpu().numpy())
    return csr_matrix((data, cols.to(torch.int32).cpu().numpy(),
                       indptr.to(torch.int32).cpu().numpy()), shape=(n, n))


def _scipy_labels(n: int, edges):
    """scipy's connected components of the host (k, 2) edge list, each
    vertex pair given once (deduplicated on the card)."""
    import torch
    from scipy.sparse.csgraph import connected_components
    e = torch.as_tensor(edges, device="cuda").long()
    key = torch.unique(torch.minimum(e[:, 0], e[:, 1]) * n
                       + torch.maximum(e[:, 0], e[:, 1]))
    del e
    return connected_components(_csr(n, key // n, key % n), directed=False)


# ---------------------------------------------------------------------------
# The connectit production cells (phase "cells") on a planted graph.
# ---------------------------------------------------------------------------

def cell_shapes(log_n: int) -> dict:
    """CONNECTIT_SHAPES at their published sizes on the default graph; a
    short check (--log-n below 22) cuts every count by the same power of
    two."""
    from repro_torch.configs.base import CONNECTIT_SHAPES
    cut = max(0, DEFAULT_GRAPH[0] - log_n)
    return {k: {f: (v >> cut if f in ("n", "m", "batch", "queries") else v)
                for f, v in spec.items()}
            for k, spec in CONNECTIT_SHAPES.items()}


def cell_arch(log_n: int):
    import dataclasses

    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch("connectit"),
                               shapes=cell_shapes(log_n))


def cell_blocks(n: int) -> int:
    """The planted components: 2^20 at every published size."""
    return min(CELL_BLOCKS, n // 64)


def planted_structure(torch, n: int, k: int, seed: int) -> tuple:
    """The planted partition of [0, n) into ``k`` blocks, the same on every
    rank for one seed: ``perm`` (n,) int32, a random order of the vertices,
    and ``starts`` (k + 1,) int32, the sorted random cut points (0 first, n
    last). Block b is the vertices perm[starts[b]:starts[b + 1]]."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    perm = torch.randperm(n, generator=gen, device="cuda", dtype=torch.int32)
    cuts = torch.randperm(n - 1, generator=gen, device="cuda")[: k - 1] + 1
    starts = torch.cat([torch.zeros(1, dtype=torch.int64, device="cuda"),
                        cuts.sort().values,
                        torch.full((1,), n, dtype=torch.int64,
                                   device="cuda")]).to(torch.int32)
    return perm, starts


def planted_edges(torch, perm, starts, m: int, seed: int, *, shard: int = 0,
                  shards: int = 1, symmetric: bool = True) -> tuple:
    """Block ``shard`` of ``shards`` of an m-slot planted edge list, int32 on
    the card, generated CELL_CHUNK slots at a time from (seed, shard, chunk)
    so that ranks with one data index make the same block. The n - k tree
    edges (every non-first vertex of a block to a uniform earlier vertex of
    its block) are split among the shards by position range and among a
    shard's chunks evenly; the rest are edges with both ends uniform in one
    block (the block drawn by size). ``symmetric`` stores each edge both
    ways (a static cell's list); otherwise once (a stream batch). Each chunk
    is shuffled."""
    n, k = perm.shape[0], starts.shape[0] - 1
    per_edge = 2 if symmetric else 1
    size = m // shards
    require(size * shards == m and size % per_edge == 0,
            f"planted edges: {m} slots over {shards} shards")
    trees = n - k
    t_lo, t_hi = shard * trees // shards, (shard + 1) * trees // shards
    chunk = min(CELL_CHUNK, size)
    nch = -(-size // chunk)
    before = starts[:-1] - torch.arange(k, dtype=torch.int32, device="cuda")
    s_out = torch.empty(size, dtype=torch.int32, device="cuda")
    r_out = torch.empty(size, dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda")
    for c in range(nch):
        lo, hi = c * chunk, min((c + 1) * chunk, size)
        und = (hi - lo) // per_edge
        a = t_lo + c * (t_hi - t_lo) // nch
        b = t_lo + (c + 1) * (t_hi - t_lo) // nch
        require(b - a <= und, "planted edges: the tree does not fit")
        gen.manual_seed((seed << 32) + (shard << 16) + c + 1)
        # tree edge t: the (t - before[blk])-th non-first vertex of its block
        t = torch.arange(a, b, dtype=torch.int32, device="cuda")
        blk = torch.searchsorted(before, t, right=True, out_int32=True) - 1
        p = starts[blk] + 1 + (t - before[blk])
        off = (torch.rand(b - a, generator=gen, device="cuda")
               * (p - starts[blk])).to(torch.int32)
        q = starts[blk] + torch.minimum(off, p - starts[blk] - 1)
        # the rest: both ends uniform in the block of a uniform position
        x = torch.randint(0, n, (und - (b - a),), generator=gen,
                          device="cuda", dtype=torch.int32)
        blk = torch.searchsorted(starts, x, right=True, out_int32=True) - 1
        width = starts[blk + 1] - starts[blk]
        off = (torch.rand(x.shape[0], generator=gen, device="cuda")
               * width).to(torch.int32)
        y = starts[blk] + torch.minimum(off, width - 1)
        u = perm[torch.cat([p, x])]
        v = perm[torch.cat([q, y])]
        if symmetric:
            u, v = torch.cat([u, v]), torch.cat([v, u])
        order = torch.randperm(u.shape[0], generator=gen, device="cuda")
        s_out[lo:hi] = u[order]
        r_out[lo:hi] = v[order]
    return s_out, r_out


def block_of(torch, perm, starts):
    """(n,) int32: each vertex's planted block."""
    n = perm.shape[0]
    pos = torch.arange(n, dtype=torch.int32, device="cuda")
    out = torch.empty(n, dtype=torch.int32, device="cuda")
    out[perm.long()] = torch.searchsorted(starts, pos, right=True,
                                          out_int32=True) - 1
    return out


def planted_misses(torch, labels, s, r, n: int) -> tuple:
    """(edges whose ends' roots differ, distinct roots in [0, n)) of
    ``labels`` (n + 1 slots at least) compressed to roots. Labels are exact
    iff both are (0, k): every block lies in one class, and there are as
    many classes as blocks."""
    from repro_torch.core.primitives import full_compress
    P = full_compress(labels[: n + 1].contiguous())
    require(torch.equal(P[P.long()], P), "cells: labels not compressed")
    miss = 0
    for lo in range(0, s.shape[0], CELL_CHUNK):
        a, b = s[lo: lo + CELL_CHUNK], r[lo: lo + CELL_CHUNK]
        miss += int((P[a] != P[b]).sum())
    roots = int((P[:n] == torch.arange(n, dtype=P.dtype,
                                        device=P.device)).sum())
    return miss, roots


def _cell_run(torch, fn, args, repeats: int = 0) -> tuple:
    """(output, launches, peak bytes above the inputs, wall s of the
    counted run, walls of ``repeats`` more runs)."""
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    walls = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return out, counts, peak, wall, walls


def _check_cell_counts(shape: str, counts: dict, rounds: int,
                       exact: bool) -> None:
    got = tuple(counts[x] for x in PATH_KERNELS)
    want = CELL_COUNTS.get(shape)
    require(counts["hook_compress"] > 0,
            f"cells {shape}: hook_compress never launched")
    if exact:
        require(want == (got, rounds), f"cells {shape}: launches {got} and "
                f"rounds {rounds}, want {want}")
    print(f"[cells] {shape}: launches of {'/'.join(PATH_KERNELS)} {got} "
          f"(CELL_COUNTS {want}{'' if exact else ', not asserted'}), "
          f"rounds {rounds}")


def phase_cells(torch, g, expect, seed: int, log_n: int, log_m: int,
                exact: bool, card: str) -> None:
    """The connectit cells through launch.steps.build_cell on a one-rank
    (data, model) mesh over NCCL, at their published sizes on planted
    graphs; then the legacy shims, the dry run and the ingest CLIs."""
    import statistics

    from repro_torch.launch import multihost
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.steps import build_cell, local_block

    arch = cell_arch(log_n)
    multihost.initialize()
    clis = None
    try:
        mesh = make_smoke_mesh("cuda")
        # static_1b_edges: replicated labels
        shape = "static_1b_edges"
        spec = arch.shapes[shape]
        t0 = time.perf_counter()
        n, k = spec["n"], cell_blocks(spec["n"])
        perm, starts = planted_structure(torch, n, k, seed)
        cell = build_cell(arch, shape, mesh, device="cuda")
        s, r = planted_edges(torch, perm, starts, cell.args[1].shape[0], seed)
        torch.cuda.synchronize()
        print(f"[cells] {shape}: planted n={n} k={k} m={s.shape[0]} "
              f"generated on the card in {time.perf_counter() - t0:.2f} s")
        P0 = torch.arange(n + 1, dtype=torch.int32, device="cuda")
        args = [local_block(x, sh, mesh)
                for x, sh in zip((P0, s, r), cell.in_shardings)]
        (P, rounds), counts, peak, wall, walls = _cell_run(
            torch, cell.fn, args, repeats=CELL_TIMING_REPEATS)
        miss, roots = planted_misses(torch, P, s, r, n)
        require((miss, roots) == (0, k), f"cells {shape}: {miss} edges "
                f"across classes, {roots} classes for {k} blocks")
        _check_cell_counts(shape, counts, int(rounds), exact)
        inputs = sum(x.numel() * 4 for x in args)
        print(f"[cells] {shape}: exact (every edge inside a class, {roots} "
              f"classes = {k} blocks); wall {wall:.4f} s first, median of "
              f"{len(walls)} after it {statistics.median(walls):.4f} s "
              f"({[round(w, 4) for w in walls]}); peak "
              f"{peak} bytes above the {inputs} bytes of inputs; outer "
              f"rounds {int(rounds)}; card {card}")
        del s, r, P, args, cell
        # ingest_256m_batch: one planted batch and uniform queries
        shape = "ingest_256m_batch"
        spec = arch.shapes[shape]
        cell = build_cell(arch, shape, mesh, device="cuda")
        u, v = planted_edges(torch, perm, starts, cell.args[1].shape[0],
                             seed + 1, symmetric=False)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        qa, qb = (torch.randint(0, n, (cell.args[3].shape[0],),
                                generator=gen, device="cuda",
                                dtype=torch.int32) for _ in range(2))
        args = [local_block(x, sh, mesh)
                for x, sh in zip((P0, u, v, qa, qb), cell.in_shardings)]
        (P, ans, rounds), counts, peak, wall, walls = _cell_run(
            torch, cell.fn, args, repeats=1)
        miss, roots = planted_misses(torch, P, u, v, n)
        require((miss, roots) == (0, k), f"cells {shape}: {miss} edges "
                f"across classes, {roots} classes for {k} blocks")
        bid = block_of(torch, perm, starts)
        want = bid[qa.long()] == bid[qb.long()]
        require(torch.equal(ans, want), f"cells {shape}: answers differ "
                f"from block identity")
        _check_cell_counts(shape, counts, int(rounds), exact)
        print(f"[cells] {shape}: exact; {int(ans.sum())} of {ans.shape[0]} "
              f"query pairs connected, every answer == block identity; "
              f"{u.shape[0] / walls[0]:.4e} batch edges/s (wall "
              f"{walls[0]:.4f} s; first run {wall:.4f} s); peak {peak} "
              f"bytes above the inputs; rounds {int(rounds)}; card {card}")
        del u, v, P, ans, args, cell, bid, want, perm, starts
        # the sharded cells at one rank, on one planted 2^31-slot list
        sharded_cells(torch, arch, mesh, seed, exact, card)
        multihost.shutdown()
        torch.cuda.empty_cache()
        _shims_on_card(torch, g, expect)
        # every wall above is timed alone; the ingest CLIs generate their
        # graphs on the host from here on, beside the dry run (no card)
        clis = _start_ingest_clis(log_n, log_m, seed)
        _dryrun_cli()
        _finish_ingest_clis(g, expect, clis, log_n, log_m, seed)
    finally:
        multihost.shutdown()
        for p in (clis or {}).get("procs", {}).values():
            if p.poll() is None:
                p.kill()
                p.wait()


def sharded_cells(torch, arch, mesh, seed: int, exact: bool,
                  card: str) -> None:
    """static_8b_edges_sharded and static_8b_sharded_fused on ``mesh``:
    each rank generates only its own edge block and label window, and
    checks the gathered labels (its own block's edges, the count reduced
    over the mesh)."""
    from repro_torch.core import collectives as coll
    from repro_torch.launch.steps import build_cell

    shapes = ("static_8b_edges_sharded", "static_8b_sharded_fused")
    spec = arch.shapes[shapes[0]]
    n, k = spec["n"], cell_blocks(spec["n"])
    t0 = time.perf_counter()
    perm, starts = planted_structure(torch, n, k, seed)
    cell = build_cell(arch, shapes[0], mesh, device="cuda")
    eaxes = cell.in_shardings[1]
    s, r = planted_edges(torch, perm, starts, cell.args[1].shape[0], seed,
                         shard=coll.shard_index(mesh, eaxes),
                         shards=coll.mesh_size(mesh, eaxes))
    del perm, starts
    torch.cuda.synchronize()
    rank = f"rank {coll.shard_index(mesh, mesh.mesh_dim_names)} of " \
           f"{mesh.size()}"
    print(f"[cells] {shapes[0][:-8]}: {rank} planted n={n} k={k}, its block "
          f"of {s.shape[0]} of {cell.args[1].shape[0]} edge slots generated "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)
    n1 = cell.args[0].shape[0]
    per = n1 // coll.axis_size(mesh, "model")
    lo = coll.axis_index(mesh, "model") * per
    window = torch.arange(lo, lo + per, dtype=torch.int32, device="cuda")
    for shape in shapes:
        cell = build_cell(arch, shape, mesh, device="cuda")
        (P, rounds), counts, peak, wall, _ = _cell_run(
            torch, cell.fn, (window, s, r))
        full = coll.all_gather(P, mesh, ("model",))
        del P
        miss, roots = planted_misses(torch, full, s, r, n)
        miss = int(coll.pmax(torch.tensor([miss], device="cuda"), mesh,
                             mesh.mesh_dim_names))
        require((miss, roots) == (0, k), f"cells {shape} {rank}: {miss} "
                f"edges across classes, {roots} classes for {k} blocks")
        if mesh.size() == 1:
            _check_cell_counts(shape, counts, int(rounds), exact)
        print(f"[cells] {shape}: {rank} exact (every edge inside a class, "
              f"{roots} classes = {k} blocks); wall {wall:.4f} s; peak "
              f"{peak} bytes above the {(window.numel() + 2 * s.numel()) * 4} "
              f"bytes of inputs; rounds {int(rounds)}; launches "
              f"{json.dumps(counts)}; card {card}", flush=True)
        del full


def _dryrun_cli() -> None:
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--mesh", "both"], cwd=ROOT, env=_src_env(), capture_output=True,
        text=True, timeout=300)
    require(proc.returncode == 0, f"dryrun exited {proc.returncode}:\n"
            f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    summary = [x for x in proc.stdout.splitlines()
               if x.startswith("DRY-RUN SUMMARY")]
    print(f"[cells] python -m repro_torch.launch.dryrun --all --mesh both: "
          f"exit 0 in {time.perf_counter() - t0:.1f} s; {summary[0]}")


def _src_env() -> dict:
    import os
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"))


def _ingest_args(log_n: int, log_m: int, seed: int) -> list:
    return ["--n", str(1 << log_n), "--edges", str(1 << log_m),
            "--seed", str(seed)]


def _start_ingest_clis(log_n: int, log_m: int, seed: int) -> dict:
    """Start the plain, the stopped (--ckpt-dir, --max-steps) and the
    chunked ingest CLI, together: each generates its graph on the host."""
    import tempfile
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ingest_"))
    base = [sys.executable, "-m", "repro_torch.launch.ingest"] + \
        _ingest_args(log_n, log_m, seed)
    batch = ["--batch", str(1 << (log_m - 5))]
    runs = {
        "plain": base + batch + ["--out", str(tmp / "plain.npy")],
        "stopped": base + batch + ["--ckpt-dir", str(tmp / "ckpt"),
                                   "--max-steps", str(CLI_STOP_STEPS)],
        "chunked": base + ["--chunked", "--batch", str(1 << (log_m - 3)),
                           "--out", str(tmp / "chunked.npy")],
    }
    procs = {k: subprocess.Popen(cmd, cwd=ROOT, env=_src_env(),
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for k, cmd in runs.items()}
    return {"tmp": tmp, "procs": procs, "cmds": runs, "t0": time.perf_counter()}


def _wait_cli(clis: dict, key: str) -> str:
    proc = clis["procs"][key]
    out, _ = proc.communicate(timeout=600)
    require(proc.returncode == 0, f"ingest CLI {key} exited "
            f"{proc.returncode}:\n{out[-3000:]}")
    return out.strip().splitlines()[-1]


def _finish_ingest_clis(g, expect, clis: dict, log_n: int, log_m: int,
                        seed: int) -> None:
    """Every ingest CLI's labels against scipy: the plain and the resumed
    run's on the graph of the graph phase (the same rmat), the chunked
    run's on its own stream's edges."""
    import shutil

    import numpy as np

    from repro_torch.graphs.generators import rmat_chunks
    from repro_torch.legacy import checkpoint as ckpt

    tmp = clis["tmp"]
    try:
        # the resumed run starts as soon as the stopped one has ended: the
        # two host generations in a row are the phase's longest chain
        print(f"[cells] ingest CLI stopped: {_wait_cli(clis, 'stopped')}")
        stopped = ckpt.latest_step(str(tmp / "ckpt"))
        require(stopped is not None and stopped > 0,
                "ingest CLI stopped: no checkpoint written")
        resume = clis["cmds"]["stopped"][:-2] + ["--out",
                                                 str(tmp / "resumed.npy")]
        clis["procs"]["resumed"] = subprocess.Popen(
            resume, cwd=ROOT, env=_src_env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        # the chunked stream's scipy labels, while the CLIs run
        src = rmat_chunks(1 << log_n, 1 << log_m, chunk=1 << (log_m - 3),
                          seed=seed)
        edges = np.concatenate(list(src.chunks()))
        _, lab = _scipy_labels(1 << log_n, edges)
        chunk_expect = canonical(lab)
        del edges, lab
        for key in ("plain", "chunked"):
            print(f"[cells] ingest CLI {key}: {_wait_cli(clis, key)}")
        print(f"[cells] ingest CLI resumed from step {stopped}: "
              f"{_wait_cli(clis, 'resumed')}")
        plain = np.load(tmp / "plain.npy")
        resumed = np.load(tmp / "resumed.npy")
        require(np.array_equal(resumed, plain),
                "ingest CLI: the resumed run's labels differ from the "
                "uninterrupted run's")
        # the CLI's rmat is the graph phase's (one n, m and seed)
        require(np.array_equal(canonical(plain), expect),
                "ingest CLI: labels differ from scipy's")
        require(np.array_equal(canonical(np.load(tmp / "chunked.npy")),
                               chunk_expect),
                "ingest CLI --chunked: labels differ from scipy's")
        print(f"[cells] ingest CLIs (n=2^{log_n}, 2^{log_m} edges): plain == "
              f"resumed == scipy's labels; --chunked == scipy's on its "
              f"stream; {time.perf_counter() - clis['t0']:.1f} s in all")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _shims_on_card(torch, g, expect) -> None:
    """The legacy shims on the graph phase's graph, each against scipy,
    with the launches each made."""
    import warnings

    import numpy as np

    from repro_torch.core import distributed as tdist
    from repro_torch.core import driver
    from repro_torch.core.finish import get_finish
    from repro_torch.kernels import ops
    from repro_torch.launch import multihost
    from repro_torch.launch.mesh import make_smoke_mesh

    def run(what, fn):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            labels = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        labels = labels.cpu().numpy()[: g.n]
        require(np.array_equal(canonical(labels), expect),
                f"shim {what}: labels differ from scipy's")
        print(f"[cells] shim {what}: labels == scipy's; wall {wall:.4f} s; "
              f"launches {json.dumps(counts)}")
        return counts

    run('connectivity(g, sample="kout", finish="uf_sync")',
        lambda: driver.connectivity(g, sample="kout", finish="uf_sync"))
    run('get_finish("liu_tarjan_CRFA") through run_connectivity',
        lambda: driver.run_connectivity(g, None,
                                        get_finish("liu_tarjan_CRFA"))[0])
    multihost.initialize()
    try:
        mesh = make_smoke_mesh("cuda")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            prog = tdist.make_replicated_connectivity(
                mesh, ("data", "model"), rounds=SHIM_MESH_ROUNDS)
            step = tdist.make_replicated_step(mesh, ("data", "model"))
        P0 = torch.arange(g.n + 1, dtype=torch.int32, device="cuda")
        out = {}

        def legacy():
            out["P"] = prog(P0, g.senders, g.receivers)
            return out["P"]

        counts = run(f"make_replicated_connectivity(rounds="
                     f"{SHIM_MESH_ROUNDS}) at one rank", legacy)
        require(torch.equal(step(out["P"], g.senders, g.receivers),
                            out["P"]),
                "shim make_replicated_connectivity: not at its fixpoint")
        require(counts["scatter_min"] > 0 and counts["pointer_jump"] > 0,
                "shim make_replicated_connectivity: scatter_min or "
                "pointer_jump never launched")
    finally:
        multihost.shutdown()


def phase_cells_ranks(torch, seed: int, world: int, card: str) -> None:
    """``--ranks N``: the two sharded cells at their published sizes on a
    (data, model) mesh over N processes of this script, one rank a card over
    NCCL; every rank generates its own edge block and checks the gathered
    labels."""
    import shutil
    import tempfile
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_cells_"))
    try:
        (tmp / "job.json").write_text(json.dumps(
            {"cells": True, "world": world, "backend": "cpu:gloo,cuda:nccl",
             "seed": seed, "card": card, "log_n": DEFAULT_GRAPH[0]}))
        for r, log in enumerate(_run_rank_procs(tmp, world, "cells")):
            for line in log.splitlines():
                if line.startswith("[cells]"):
                    print(f"[cells] {world} ranks, rank {r}:{line[7:]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _rank_cells(rank: int, d: Path, job: dict) -> int:
    """One rank of phase_cells_ranks."""
    import torch

    from repro_torch.launch import multihost
    from repro_torch.launch.mesh import make_smoke_mesh

    multihost.initialize(init_method=f"file://{d}/rendezvous",
                         num_processes=job["world"], process_id=rank,
                         backend=job["backend"], timeout=300)
    try:
        mesh = make_smoke_mesh("cuda")
        print(f"[cells] mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} "
              f"on cuda:{torch.cuda.current_device()}", flush=True)
        sharded_cells(torch, cell_arch(job["log_n"]), mesh, job["seed"],
                      False, job["card"])
    finally:
        multihost.shutdown()
    return 0


def phase_dlrm(torch, cap: int, seed: int, results: dict):
    """DLRM-RM2 serving on the card: each cell through the embedding_bag
    kernel against the same model through the plain version. Returns the
    model and each cell's inputs, for the profile phase."""
    import dataclasses
    from unittest import mock

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.kernels.legacy.embedding_bag.ref import embedding_bag_ref
    from repro_torch.launch.steps import build_cell
    from repro_torch.legacy.data import RecsysStream
    from repro_torch.legacy.models import dlrm as dlrm_mod

    arch = get_arch("dlrm-rm2")
    cfg = arch.model
    vocab = min(RM2_VOCAB, cap)
    if vocab < RM2_VOCAB:
        cfg = dataclasses.replace(cfg, vocab_sizes=(vocab,) * cfg.n_sparse)
    precision = torch.get_float32_matmul_precision()
    require(precision == "highest" and not torch.backends.cuda.matmul.allow_tf32,
            f"float32 matmuls must run in full float32, got {precision!r}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = dlrm_mod.init_dlrm(cfg, generator=gen, device="cuda")
    torch.cuda.synchronize()
    table_bytes = sum(t.numel() * t.element_size() for t in model.tables)
    print(f"[dlrm] {cfg.name}: {cfg.n_sparse} tables of "
          f"{tuple(model.tables[0].shape)} float32 = {table_bytes} bytes, "
          f"built on the card from seed {seed} in "
          f"{time.perf_counter() - t0:.2f} s; float32 matmul precision "
          f"{precision!r}, TF32 off")

    def plain(fn, *args):
        with mock.patch.object(dlrm_mod, "embedding_bag", embedding_bag_ref):
            return fn(model, *args)

    def wall_ms(fn, steps: int) -> list:
        fn()  # warm
        out = []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return sorted(out)

    def pct(xs: list, q: float) -> float:
        return xs[min(len(xs) - 1, int(q * len(xs)))]

    serve_inputs = {}
    for shape, steps in (("serve_p99", 50), ("serve_bulk", 10),
                         ("retrieval_cand", 20)):
        cell = build_cell(arch, shape)
        B = min(cell.args[0].shape[0], cap)
        batch = RecsysStream(batch=B, n_dense=cfg.n_dense,
                             n_sparse=cfg.n_sparse, vocab=vocab,
                             multi_hot=cfg.multi_hot,
                             seed=seed).batch_at(0, device="cuda")
        inputs = [batch["dense"], batch["sparse"]]
        if shape == "retrieval_cand":
            n_cand = min(cell.args[2].shape[0], cap)
            inputs.append(torch.randn(n_cand, cfg.embed_dim, generator=gen,
                                      device="cuda"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        got = cell.fn(model, *inputs)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        require(counts["embedding_bag"] == cfg.n_sparse and
                sum(counts.values()) == cfg.n_sparse,
                f"dlrm {shape}: launches {counts}, want {cfg.n_sparse} of "
                f"embedding_bag and nothing else")
        want = plain(cell.fn, *inputs)
        if shape == "retrieval_cand":
            (vals, idx), (want_vals, want_idx) = got, want
            require(vals.shape == (100,) and bool(torch.isfinite(vals).all()),
                    f"dlrm {shape}: top-k values {tuple(vals.shape)}")
            require(torch.equal(idx, want_idx),
                    f"dlrm {shape}: top-100 indices differ from the plain "
                    f"path's")
            err = float((vals - want_vals).abs().max())
            require(err <= 1e-6, f"dlrm {shape}: top-100 values differ by "
                    f"{err}")
            check = f"top-100 indices equal, values within {err}"
        else:
            require(got.shape == (B,) and bool(torch.isfinite(got).all())
                    and bool(((got >= 0) & (got <= 1)).all()),
                    f"dlrm {shape}: probabilities {tuple(got.shape)}")
            with torch.inference_mode():
                logits = model(*inputs)
                want_logits = plain(lambda m, *a: m(*a), *inputs)
            require(torch.equal(logits, want_logits) and torch.equal(got, want),
                    f"dlrm {shape}: logits differ from the plain path's at L=1")
            check = "logits and probabilities equal to the plain path's"
        ms = wall_ms(lambda: cell.fn(model, *inputs), steps)
        plain_ms = wall_ms(lambda: plain(cell.fn, *inputs), 3)
        rate = ""
        if shape == "serve_bulk":
            rate = f"; {B / (sum(ms) / len(ms) / 1e3):.1f} samples/s"
            results["embedding_bag"]["launches"] = counts["embedding_bag"]
        serve_inputs[shape] = inputs
        print(f"[dlrm] {shape} B={B}"
              + (f" candidates={inputs[2].shape[0]}" if len(inputs) > 2
                 else "")
              + f": {check}; wall per step over {steps} warm steps p50 "
              f"{pct(ms, 0.5):.4f} ms, p99 {pct(ms, 0.99):.4f} ms, mean "
              f"{sum(ms) / len(ms):.4f} ms{rate}; plain path p50 "
              f"{pct(plain_ms, 0.5):.4f} ms; peak device memory {peak} "
              f"bytes; embedding_bag launches per step "
              f"{counts['embedding_bag']}; cell meta {cell.meta}")
    return model, serve_inputs


def _trace(torch, tag: str, fn, top: int = 15) -> dict:
    """One run of ``fn`` under torch.profiler: wall time, the device's busy
    share, the collectives' device time (NCCL's kernels) and the ``top``
    device operations by time. Returns the host-side (CUDA runtime) calls
    by name with their counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only (kernels, copies, fills): the CPU ops that
    # launched them report the same time again
    rows = sorted(((ev.device_time_total, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA), reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    print(f"[profile] {tag}: traced wall {wall:.4f} s; device busy "
          f"{busy:.4f} s ({100 * busy / wall:.1f}%), idle "
          f"{100 * (1 - busy / wall):.1f}%")
    nccl = [r for r in rows if "nccl" in r[1].lower()]
    if nccl:
        print(f"[profile]   collectives: {sum(r[0] for r in nccl) / 1e3:.3f} "
              f"ms of device time in {sum(r[2] for r in nccl)} NCCL kernels")
    for dev_us, key, count in rows[:top]:
        print(f"[profile]   {dev_us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")
    return {ev.key: ev.count for ev in prof.key_averages()
            if ev.device_type != DeviceType.CUDA}


def phase_profile(torch, g, model, serve_inputs, seed: int, edges, weights,
                  log_m: int, server) -> None:
    """Where the compacted main path's time goes: wall time per driver step
    (host clock around synchronized work), then one traced run of it, one of
    none+stergiou, one of the fused PUFA path, one stream batch (the ninth
    of STREAM_BATCH), one dynamic step (sliding_window's fifth, the first
    that deletes), one ingest of the graph's edges (the ingest phase's
    source), one amsf(skip=lmax), one msf, one closed-loop window of the
    serve phase's static server (with its host syncs a commit), and one
    DLRM-RM2 serve_bulk and one serve_p99 step."""
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import serve_step
    from repro_torch import ConnectIt
    from repro_torch.core import driver

    session = ConnectIt(MAIN_VARIANT, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    steps = {}

    def step(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        steps[name] = time.perf_counter() - t0
        return out

    P = step("sample (kout + uf_sync_full)", lambda: session._sampler(g, gen))
    P, keep, _, _ = step("prep (compress, L_max, keep mask)",
                         lambda: driver._prep_sampled(P, g.senders,
                                                      g.receivers))
    s, r, kept = step("compact", lambda: driver._compact(
        g.senders, g.receivers, keep, g.n, pad="pow2"))
    step("finish + canonicalize",
         lambda: driver._finish_phase(P, s, r, session._finish))
    total = sum(steps.values())
    for name, sec in steps.items():
        print(f"[profile] {name}: {sec:.4f} s ({100 * sec / total:.1f}%)")
    print(f"[profile] kept {kept} of {g.m} edges for the finish phase")
    _trace(torch, MAIN_VARIANT, lambda: session.connectivity(g))
    stergiou = ConnectIt("none+stergiou", device="cuda")
    _trace(torch, "none+stergiou", lambda: stergiou.connectivity(g))
    pufa = ConnectIt(EDGE_PATH, device="cuda")
    _trace(torch, f"{EDGE_PATH} fused",
           lambda: pufa.connectivity(g, fused=True))
    _trace_stream_steps(torch, g, seed)
    from repro_torch.graphs import ArrayEdgeSource
    src = ArrayEdgeSource(edges, g.n, chunk=1 << (log_m - 3))
    for tag, fn in ((f"ingest {MAIN_VARIANT}, {src.num_chunks} chunks",
                     lambda: session.from_chunks(src)),
                    (f"amsf(skip=lmax) {MAIN_VARIANT}",
                     lambda: session.amsf(g, weights, "amsf(skip=lmax)")),
                    ("msf", lambda: session.msf(g, weights))):
        ops.reset_launch_counts()
        _trace(torch, tag, fn)
        print(f"[profile]   launches {json.dumps(ops.launch_counts())}")
    _trace_serve_window(torch, server, seed)
    for shape in ("serve_bulk", "serve_p99"):
        inputs = serve_inputs[shape]
        ops.reset_launch_counts()
        _trace(torch, f"dlrm-rm2 {shape} B={inputs[0].shape[0]}",
               lambda: serve_step(model, *inputs))
        print(f"[profile]   launches {json.dumps(ops.launch_counts())}")


# the CUDA runtime calls at which the host waits for the device
SYNC_CALLS = ("cudaStreamSynchronize", "cudaEventSynchronize",
              "cudaDeviceSynchronize")


def _trace_serve_window(torch, server, seed: int) -> None:
    """One traced closed-loop window (16 clients x 8 requests) of the serve
    phase's static server, its restart's warmup left out: busy share, the
    largest device operations, and the host's waits on the device a commit
    (a query dispatch waits once, for its answers)."""
    import dataclasses

    from repro_torch.kernels import ops
    server.config = dataclasses.replace(server.config, warmup=False)
    before = server.stats()
    ops.reset_launch_counts()
    calls = _trace(torch, f"serve closed loop {SERVE_CLIENTS}x8 "
                   f"({SERVE_TRAFFIC})",
                   lambda: serve_closed_loop(server, False, seed + 2,
                                             requests=8))
    st = server.stats()
    commits = st.commit_batches - before.commit_batches
    queries = st.query_batches - before.query_batches
    syncs = {k: calls.get(k, 0) for k in SYNC_CALLS}
    rounds = st.finish_rounds - before.finish_rounds
    waits = sum(syncs.values())
    print(f"[profile]   {commits} commits ({rounds} finish rounds), "
          f"{queries} query dispatches; host waits {json.dumps(syncs)}: "
          f"{(waits - queries) / max(commits, 1):.1f} a commit besides one a "
          f"query dispatch; cudaMemcpyAsync "
          f"{calls.get('cudaMemcpyAsync', 0)}; launches "
          f"{json.dumps(ops.launch_counts())}")


def _trace_stream_steps(torch, g, seed: int) -> None:
    """One traced stream batch and one traced dynamic step, each after the
    steps before it, with their launches."""
    from repro_torch import ConnectIt
    from repro_torch.kernels import ops

    B = STREAM_BATCH
    u, v = stream_edges(torch, g, seed)
    st = ConnectIt(MAIN_VARIANT, device="cuda").stream(g.n)
    for i in range(8):
        st.insert(u[i * B: (i + 1) * B], v[i * B: (i + 1) * B])
    ops.reset_launch_counts()
    _trace(torch, f"stream batch 9 of {B} edges",
           lambda: st.insert(u[8 * B: 9 * B], v[8 * B: 9 * B]))
    print(f"[profile]   launches {json.dumps(ops.launch_counts())}")
    d = ConnectIt(MAIN_VARIANT, device="cuda").stream(
        g.n, dynamic=True, log=sliding_batch_log(g.n)[1])
    for step, (ins, dels, q, args) in enumerate(
            sliding_steps(torch, g.n, seed, 5)):
        if step < 4:
            d.process(*args)
    ops.reset_launch_counts()
    _trace(torch, f"dynamic step 5 of sliding_window ({len(dels)} deletes, "
           f"{len(ins)} inserts)", lambda: d.process(*args))
    print(f"[profile]   launches {json.dumps(ops.launch_counts())}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-n", type=int, default=22)
    ap.add_argument("--log-m", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ranks", type=int, default=1,
                    help="N > 1: only the placements over N processes, one "
                         "rank a card over NCCL (needs N cards)")
    # one rank of a multi-process placements run, started by this script
    ap.add_argument("--mesh-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--mesh-dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs a CUDA card", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              f"from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    if args.mesh_rank is not None:  # the parent's isolated cache, inherited
        try:
            return mesh_rank(args.mesh_rank, args.mesh_dir)
        except SmokeFailure as e:
            print(f"chip_smoke: FAILED: {e}", flush=True)
            return 1

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        print(f"[time] phase {name}: {time.perf_counter() - t0:.1f} s")
        return out

    import os
    import tempfile

    from repro_torch import tune
    from repro_torch.kernels import ops

    # a tuning cache of the script's own, empty: a cache in the home
    # directory must not change the launch shapes between two runs
    cache_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_cache_")
    os.environ[tune.ENV_VAR] = os.path.join(cache_dir.name, "tune.json")
    open(os.environ[tune.ENV_VAR], "w").close()
    tune.reset_default_cache()
    ops.clear_tuned_blocks()
    print(f"[cache] tuning cache {os.environ[tune.ENV_VAR]} (empty: every "
          f"kernel launches {ops.DEFAULT_BLOCK_M} threads a block outside "
          f"the tune phase)")
    try:
        device = timed("device", phase_device, torch)
        card = _card_line()
        timed("build", phase_build)
        g = timed("graph", phase_graph, torch, args.log_n, args.log_m,
                  args.seed)
        exact = (args.log_n, args.log_m, args.seed) == DEFAULT_GRAPH
        if args.ranks > 1:
            expect, _ = timed("oracle", phase_oracle, g)
            timed("ranks", phase_ranks, torch, g, expect, args.seed,
                  args.ranks, card)
            timed("cells ranks", phase_cells_ranks, torch, args.seed,
                  args.ranks, card)
            print(json.dumps({"ok": True, "device": device}))
            return 0
        # the DLRM phases' size cap: at the default 2^22 it cuts nothing, so
        # RM2 runs at its published widths; a short check cuts vocab,
        # batches and candidates to 2^log_n
        cap = 1 << args.log_n
        results = timed("kernels", phase_kernels, torch, g, cap, args.log_m,
                        args.seed)
        timed("small", phase_small, torch)
        expect, keys = timed("oracle", phase_oracle, g)
        timed("paths", phase_paths, torch, g, expect, results, exact)
        timed("forest", phase_forest, torch, g, expect, keys, exact)
        timed("stream", phase_stream, torch, g, expect, args.seed, exact,
              card)
        dyn = timed("dynamic", phase_dynamic, torch, g, expect, keys,
                    args.seed, exact, card)
        server = timed("serve", phase_serve, torch, g, args.seed, card)
        edges = timed("ingest", phase_ingest, torch, g, expect, args.seed,
                      args.log_m, exact, card)
        apps = timed("apps", phase_apps, torch, g, expect, keys, exact,
                     card)
        timed("placements", phase_placements, torch, g, expect, keys,
              args.seed, exact, card, dyn, apps)
        timed("tune", phase_tune, torch, g, expect,
              card)
        timed("cells", phase_cells, torch, g, expect, args.seed, args.log_n,
              args.log_m, exact, card)
        model, serve_inputs = timed("dlrm", phase_dlrm, torch, cap, args.seed,
                                    results)
        timed("profile", phase_profile, torch, g, model, serve_inputs,
              args.seed, edges, apps["weights"], args.log_m, server)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        cache_dir.cleanup()
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
