#!/usr/bin/env python3
"""Time the connectivity kernels, and the paths that run them, built from
several kernel source trees in turns.

    python3 compare_kernels.py [NAME=]CSRC [[NAME=]CSRC ...]
                               [--log-n 22 --log-m 25] [--paths] [--reps 3]
                               [--only KERNEL ...]
    python3 compare_kernels.py [NAME=]CSRC [[NAME=]CSRC ...] --bags

Each CSRC is a ``kernels/csrc`` directory (for a parent commit: ``git
archive`` it into a git-ignored directory of this checkout). Each tree's
``scatter_min.cu``, ``hook_compress.cu``, ``edge_relabel.cu`` and
``pointer_jump.cu`` are built by ``_build`` into a directory of their own,
and the port's own wrappers call them, one tree's libraries swapped in at a
time. The inputs are ``chip_smoke.py``'s kernel phase's
(``chip_smoke.kernel_inputs``): the hook pass (k = 0 and 3) on the graph
edges with the phase's labels, all labels -1 and identity labels, and on
the main path's first sampled, compacted and fused rounds; scatter_min on
uniform targets, a synthetic hub, the canonicalization's call and the
recorded calls of CRFA, label propagation and a spanning forest;
edge_relabel on the graph edges (with and without -1 endpoints) and the
recorded calls of Liu-Tarjan PUFA and Stergiou; edge_rewrite on the same
graph edges and the recorded calls of Liu-Tarjan PUFA and CRFA (compacted
and fused), of Stergiou and of 8 stream batches; pointer_jump at k = 1 and
3 and the main path's recorded calls; and every kernel's recorded calls
of chunked ingest, of amsf and of the served closed loops
(``chip_smoke.RECORDED``). ``--only`` keeps the cases of the kernels
named. Every output is held against the plain version; each case
is timed with the trees in order, then in reverse (CUDA-event means over 20
launches), and a tree's time is the mean of its two.
``--paths`` also runs every path of ``chip_smoke.PATHS`` ``--reps`` times
per tree in the same turns (host wall time of a synchronized
``connectivity`` call, median), checking that every tree gives the same
labels, launches and finish rounds. ``--bags`` times only each tree's
``embedding_bag.cu`` forward (one launch for T tables), in the same
turns, on the grouped calls of ``chip_smoke._record_dlrm`` (a full-width
DLRM-RM2's serve_p99, serve_bulk, retrieval_cand and train_batch bags,
float32; serve_bulk's also on bfloat16 copies of the tables) and on 26
tables of zipfian multi-hot ids (L = 8), each tree's output the same bits
as the first's. Needs one CUDA card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNELS = ("scatter_min", "hook_compress", "edge_relabel", "pointer_jump")
BAGS = ("embedding_bag",)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", help="[NAME=]path to a csrc directory")
    ap.add_argument("--log-n", type=int, default=22)
    ap.add_argument("--log-m", type=int, default=25)
    ap.add_argument("--paths", action="store_true")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--only", nargs="+", metavar="KERNEL",
                    help="time only these kernels' cases")
    ap.add_argument("--bags", action="store_true",
                    help="time only the grouped embedding_bag forward")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("compare_kernels: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.edge_relabel.ref import (
        edge_relabel_ref,
        edge_rewrite_ref,
    )
    from repro_torch.kernels.hook_compress.ref import hook_compress_ref
    from repro_torch.kernels.pointer_jump.ref import pointer_jump_ref
    from repro_torch.kernels.scatter_min.ref import scatter_min_ref

    cs.phase_device(torch)
    trees = {}
    for i, arg in enumerate(args.trees):
        name, _, path = arg.rpartition("=")
        name = name or f"tree{i}"
        out = ROOT / "build" / "compare" / name
        t0 = time.perf_counter()
        recs = _build.build_all(Path(path).resolve(), out,
                                names=BAGS if args.bags else KERNELS)
        print(f"[build] {name} ({path}): {time.perf_counter() - t0:.1f} s")
        trees[name] = {k: _build.open_library(rec) for k, rec in recs.items()}
    names = list(trees)
    turns = names + names[::-1]

    def use(tree: str) -> None:
        _build._LIBS.update(trees[tree])

    if args.bags:
        return _bags(torch, cs, names, turns, use)
    g = cs.phase_graph(torch, args.log_n, args.log_m, 0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    _, sets = cs.kernel_inputs(torch, g, gen, args.log_m)
    refs = {"hook_compress": hook_compress_ref, "scatter_min": scatter_min_ref,
            "edge_relabel": edge_relabel_ref, "edge_rewrite": edge_rewrite_ref,
            "pointer_jump": pointer_jump_ref}
    cases = []
    for name, ref in refs.items():
        for x, calls in sets[name].items():
            cases.append((f"{name} {x}",
                          lambda name=name, calls=calls: cs.run_calls(
                              name, ops.KERNELS[name], calls),
                          lambda name=name, ref=ref, calls=calls: cs.run_calls(
                              name, ref, calls)))

    if args.only:
        cases = [c for c in cases if c[0].split()[0] in args.only]
    print(f"[kernels] ms per case, each tree the mean of its two turns; "
          f"ratio to {names[0]}")
    print(f"{'case':40s} " + " ".join(f"{n:>10s}" for n in names))
    for label, kernel, plain in cases:
        want = plain()
        times = {n: [] for n in names}
        for tree in turns:
            use(tree)
            got = kernel()
            torch.cuda.synchronize()
            cs.require(all(torch.equal(a, b) for a, b in zip(got, want)),
                       f"{label}: tree {tree} disagrees with the plain "
                       f"version")
            times[tree].append(cs.time_ms(torch, kernel, iters=20))
        mean = {n: sum(t) / len(t) for n, t in times.items()}
        print(f"{label:40s} " + " ".join(f"{mean[n]:10.4f}" for n in names)
              + "   " + " ".join(f"{mean[n] / mean[names[0]]:.3f}"
                                 for n in names[1:]))

    if args.paths:
        from repro_torch import ConnectIt
        print(f"[paths] host wall ms of a synchronized connectivity call, "
              f"median of {2 * args.reps} runs per tree")
        for variant, modes, _, _ in cs.PATHS:
            session = ConnectIt(variant, device="cuda")
            for fused in modes:
                walls = {n: [] for n in names}
                first = None
                for _ in range(args.reps):
                    for tree in turns:
                        use(tree)
                        ops.reset_launch_counts()
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        labels, stats = session.connectivity(
                            g, fused=fused, return_stats=True)
                        torch.cuda.synchronize()
                        walls[tree].append((time.perf_counter() - t0) * 1e3)
                        seen = (labels, ops.launch_counts(),
                                stats.finish_rounds)
                        if first is None:
                            first = seen
                        cs.require(torch.equal(seen[0], first[0])
                                   and seen[1:] == first[1:],
                                   f"{variant} fused={fused}: tree {tree} "
                                   f"differs in labels, launches or rounds")
                med = {n: statistics.median(w) for n, w in walls.items()}
                print(f"[paths] {variant} "
                      f"{'fused' if fused else 'compacted':9s} "
                      + " ".join(f"{n}={med[n]:.3f}" for n in names)
                      + f"  (all runs: "
                      + "; ".join(f"{n} " + ",".join(f"{w:.2f}" for w in
                                                     sorted(walls[n]))
                                  for n in names) + ")")
    return 0


def _bags(torch, cs, names, turns, use) -> int:
    """The grouped embedding_bag forward of each tree on the recorded
    DLRM-RM2 calls and on 26-table multi-hot ids."""
    from repro_torch.kernels.legacy.embedding_bag import kernel as bag_kernel
    from repro_torch.legacy.data import RecsysStream

    recorded, _ = cs._record_dlrm(torch, 1 << 22, 0)
    tables, idx, _ = recorded["serve_bulk"]
    halves = [t.to(torch.bfloat16) for t in tables]
    multi = RecsysStream(batch=65536, n_dense=13, n_sparse=len(tables),
                         vocab=cs.RM2_VOCAB, multi_hot=8, seed=2).batch_at(
                             0, device="cuda")["sparse"]
    multi = multi.transpose(0, 1).contiguous()
    cases = {**{f"recorded {k} float32": c for k, c in recorded.items()},
             "recorded serve_bulk bfloat16": (halves, idx, "sum"),
             **{f"multi_hot {d} {m}": (t, multi, m)
                for d, t in (("float32", tables), ("bfloat16", halves))
                for m in ("sum", "max")}}
    print(f"[bags] ms per case, each tree the mean of its two turns; ratio "
          f"to {names[0]}")
    print(f"{'case':40s} " + " ".join(f"{n:>10s}" for n in names))
    with torch.inference_mode():
        for label, (tabs, ids, mode) in cases.items():
            times = {n: [] for n in names}
            first = None
            for tree in turns:
                use(tree)

                def call():
                    return bag_kernel.embedding_bags(tabs, ids, mode=mode)
                got = call()
                if first is None:
                    first = got
                cs.require(torch.equal(got, first),
                           f"{label}: tree {tree} gives other bits")
                times[tree].append(cs.time_ms(torch, call, iters=30))
            mean = {n: sum(t) / len(t) for n, t in times.items()}
            print(f"{label:40s} "
                  + " ".join(f"{mean[n]:10.4f}" for n in names) + "   "
                  + " ".join(f"{mean[n] / mean[names[0]]:.3f}"
                             for n in names[1:]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
