"""Offline autotuning driver: fill the selection cache for one device.

Sweeps each connectivity kernel's threads a block and the variant shortlist
over synthetic family proxies (stand-ins for the paper's Table 2 inputs,
the reference's ``repro.launch.tune`` proxies), and persists every winner
in the selection cache (``repro_torch.tune.cache``; location: ``--cache`` >
``REPRO_TORCH_TUNE_CACHE`` > ``~/.cache/repro_torch/tune.json``). After one
run, ``ConnectIt("auto", device=...)`` and the kernels' block sizes are
cache lookups on that device. The proxies have 2^8-2^13 vertices: their
device-global (``"*"``) winner is a measurement at that size, not evidence
for graphs orders of magnitude larger, which ``ConnectIt("auto",
exec="...:tune")`` measures on the graph itself.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.tune                # the card
  PYTHONPATH=src python -m repro_torch.launch.tune --grid full --trials 5
  PYTHONPATH=src python -m repro_torch.launch.tune --smoke --device cpu \\
      --cache /tmp/tune.json
      # tiny proxies, then re-read the cache from disk and check that every
      # winner resolves (write, reload, resolve end to end)
"""

from __future__ import annotations

import argparse
import sys

from ..tune.cache import SelectionCache, cache_path, make_key
from ..tune.harness import PRIMITIVES
from ..tune.space import BLOCK_M_FULL, TuneSpec
from ..tune.tuner import (
    resolve_block_m,
    resolve_variant,
    tune_block_m,
    tune_families,
)


def family_proxies(scale: int = 1, *, smoke: bool = False,
                   device="cuda") -> dict:
    """Synthetic stand-ins for the paper's input families, one per
    fingerprint regime (the reference's, on ``device``)."""
    from ..graphs import generators as gen
    if smoke:
        return {
            "grid(road)": gen.grid2d(16, 16, device=device),
            "rmat_small(LJ)": gen.rmat(1 << 8, 1 << 10, seed=1,
                                       device=device),
        }
    s = max(1, scale)
    return {
        "grid(road)": gen.grid2d(64 * s, 64 * s, device=device),
        "rmat_small(LJ)": gen.rmat(1 << 12, (1 << 14) * s, seed=1,
                                   device=device),
        "rmat_dense(CO)": gen.rmat(1 << 11, (1 << 15) * s, seed=2,
                                   device=device),
        "ba(FR)": gen.barabasi_albert((1 << 12) * s, 8, seed=3,
                                      device=device),
        "rmat_web(CW)": gen.rmat(1 << 13, (1 << 15) * s, seed=4, a=0.57,
                                 b=0.19, c=0.19, device=device),
    }


def run(spec: TuneSpec, *, cache: SelectionCache, scale: int = 1,
        smoke: bool = False, device="cuda") -> dict:
    """One tuning pass on ``device``: block sizes, then variants per
    family."""
    block_rows = tune_block_m(spec, cache=cache,
                              n=1 << 8 if smoke else 1 << 12, device=device)
    print(f"{'primitive':16} {'block_m':>8} {'time_s':>12}")
    for r in block_rows:
        mark = " *" if r["winner"] else ""
        print(f"{r['primitive']:16} {r['block_m']:>8} "
              f"{r['time_s']:>12.3e}{mark}")

    families = family_proxies(scale, smoke=smoke, device=device)
    fam_rows = tune_families(families, spec, cache=cache)
    print(f"\n{'family':20} {'fingerprint':16} {'winner':32} {'time_s':>12}")
    for r in fam_rows:
        print(f"{r['family']:20} {r['fingerprint']:16} {r['winner']:32} "
              f"{r['time_s']:>12.3e}")
    print(f"\nglobal winner: {resolve_variant(cache=cache, device=device)}")
    print(f"cache: {cache.path} ({len(cache)} entries)")
    return {"blocks": block_rows, "families": fam_rows}


def verify_roundtrip(path: str, device="cuda") -> None:
    """Re-read the cache from disk in a fresh instance and check that every
    tuned selection of ``device`` resolves: the ``--smoke`` gate."""
    fresh = SelectionCache(path)
    if not len(fresh):
        raise SystemExit(f"tune --smoke: cache {path} is empty after tuning")
    for prim in PRIMITIVES:
        key = make_key(f"block_m:{prim}", device=device)
        if fresh.winner(key) is None:
            raise SystemExit(f"tune --smoke: no block_m winner for {prim}")
        block = resolve_block_m(prim, cache=fresh, device=device)
        if block != fresh.winner(key) or block not in BLOCK_M_FULL:
            raise SystemExit(f"tune --smoke: bad block_m for {prim}: "
                             f"{fresh.winner(key)!r}")
    if fresh.winner(make_key("variant", "*", device=device)) is None:
        raise SystemExit("tune --smoke: no device-global variant winner")
    variant = resolve_variant(cache=fresh, device=device)
    print(f"smoke: cache re-read ok — {len(fresh)} entries, "
          f"global variant {variant}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", default="fast", choices=["fast", "full"])
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--scale", type=int, default=1,
                    help="proxy-graph size multiplier")
    ap.add_argument("--cache", default=None,
                    help="cache file (default: REPRO_TORCH_TUNE_CACHE or "
                         "~/.cache/repro_torch/tune.json)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the device to tune (default: the card)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny proxies, then check that the cache "
                         "round-trips through a fresh read")
    args = ap.parse_args(argv)
    spec = TuneSpec(grid=args.grid, trials=args.trials, warmup=args.warmup)
    path = cache_path(args.cache)
    run(spec, cache=SelectionCache(path), scale=args.scale, smoke=args.smoke,
        device=args.device)
    if args.smoke:
        verify_roundtrip(path, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
