#!/usr/bin/env python3
"""Time connectivity paths of several copies of the port, in turns.

    python3 compare_paths.py [NAME=]PKG [[NAME=]PKG ...]
                             [--variant V ...] [--reps 5]
                             [--log-n 22 --log-m 25] [--seed 0]

Each PKG is a ``repro_torch`` package directory (for a parent commit:
``git archive`` it into a git-ignored directory of this checkout). Each
copy is imported under a name of its own, so that Python code, and not
only the kernels, may differ between them; each builds its kernels from
its own ``kernels/csrc``. The graph is ``chip_smoke.py``'s RMAT graph,
built once. Every variant (default: LDD, whose sampler loop is the
slowest path) runs ``--reps`` times per copy with the copies in order,
then in reverse (host wall time of a synchronized ``connectivity`` call on
a generator seeded ``--seed``, median), and every copy must give the same
labels and finish rounds. Needs one CUDA card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("packages", nargs="+",
                    help="[NAME=]path to a repro_torch directory")
    ap.add_argument("--variant", action="append")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--log-n", type=int, default=22)
    ap.add_argument("--log-m", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("compare_paths: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    cs.phase_device(torch)
    pkgs = {}
    for i, arg in enumerate(args.packages):
        name, _, path = arg.rpartition("=")
        name = name or f"pkg{i}"
        pkg = cs.load_package(f"repro_torch_{name}", Path(path).resolve())
        t0 = time.perf_counter()
        pkg.kernels._build.build_all()
        print(f"[build] {name} ({path}): {time.perf_counter() - t0:.1f} s")
        pkgs[name] = pkg
    names = list(pkgs)
    turns = names + names[::-1]
    g = cs.phase_graph(torch, args.log_n, args.log_m, 0)
    print(f"[paths] host wall ms of a synchronized connectivity call, median "
          f"of {2 * args.reps} runs per copy")
    for variant in args.variant or ["ldd_b0.2+uf_sync_full"]:
        sessions = {n: p.ConnectIt(variant, device="cuda")
                    for n, p in pkgs.items()}
        walls = {n: [] for n in names}
        first = None
        for _ in range(args.reps):
            for name in turns:
                gen = torch.Generator(device="cuda")
                gen.manual_seed(args.seed)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                labels, stats = sessions[name].connectivity(
                    g, generator=gen, return_stats=True)
                torch.cuda.synchronize()
                walls[name].append((time.perf_counter() - t0) * 1e3)
                seen = (labels, stats.finish_rounds)
                first = first or seen
                cs.require(torch.equal(seen[0], first[0])
                           and seen[1] == first[1],
                           f"{variant}: copy {name} differs in labels or "
                           f"finish rounds")
        med = {n: statistics.median(w) for n, w in walls.items()}
        print(f"[paths] {variant} "
              + " ".join(f"{n}={med[n]:.3f}" for n in names)
              + "  (all runs: "
              + "; ".join(f"{n} " + ",".join(f"{w:.2f}" for w in
                                             sorted(walls[n]))
                          for n in names) + ")")
    return 0


if __name__ == "__main__":
    sys.exit(main())
