#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py                         # RMAT n=2^22, 2^25 edges
    python3 chip_smoke.py --log-n 14 --log-m 17   # a short compile check

Phases, in order; any failure exits non-zero:

  1. device   the card's name and power limit (nvidia-smi);
  2. build    nvcc builds every CUDA kernel from src/repro_torch/kernels/csrc
              (one process per source, all at once) into build/kernels/;
  3. graph    an RMAT graph, paper parameters (a,b,c) = (0.5, 0.1, 0.1),
              generated on the host from the seed and built on the card;
  4. kernels  each kernel at the main path's shapes against its plain
              PyTorch version on the same inputs (exact: all int32), with
              its time, the plain version's, one PyTorch call's where one
              computes the same function, and the bound;
  5. small    every variant of the slice on a small graph, on the card,
              against the CPU path and scipy;
  6. main     ConnectIt("kout_hybrid_k2+uf_sync_full").connectivity(g),
              compacted and fused, each against scipy, with each kernel's
              launch count (must be > 0), wall time and peak memory;
  7. profile  where the compacted main path's time goes: wall time per
              driver step, device time per kernel and the device's busy
              share (torch.profiler).

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
SLICE_VARIANTS = ("none+uf_sync_naive", "none+uf_sync_halve",
                  "none+uf_sync_full", "kout_afforest_k2+uf_sync_full",
                  MAIN_VARIANT)
# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12  # 32-bit, outside the tensor cores
INT32_MAX = 2**31 - 1


class SmokeFailure(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def bound_ms(nbytes: int, nops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean ms of one call over ``iters`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"[device] torch.cuda.get_device_name(0)={kind!r} count={count} "
          f"torch={torch.__version__} cuda={torch.version.cuda}")
    return {"platform": "gpu", "kind": kind, "count": count}


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    records = _build.build_all()
    print(f"[build] {len(records)} libraries in "
          f"{time.perf_counter() - t0:.2f} s (wall, parallel nvcc)")
    for rec in records.values():
        print(f"[build] {rec.name}: {rec.seconds:.2f} s -> {rec.path.name}")
        for line in rec.ptxas:
            print(f"[build]   {line}")
    for name in _build.SIGNATURES:
        _build.load(name)


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


def phase_kernels(torch, g) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.hook_compress.ref import hook_compress_ref
    from repro_torch.kernels.pointer_jump.ref import pointer_jump_ref
    from repro_torch.kernels.scatter_min.ref import scatter_min_ref

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    L = g.n + 1
    m = g.m_pad
    P = _labels_with_virtual_min(torch, L, gen)
    s, r = g.senders, g.receivers
    # scatter_min on the main path (min_vertex_labels) takes (n+1,) sanitized
    # targets; ~10% carry the dump sentinel, as masked entries do
    idx = torch.randint(0, L, (L,), generator=gen, device="cuda",
                        dtype=torch.int32)
    vals = torch.randint(-1, L, (L,), generator=gen, device="cuda",
                         dtype=torch.int32)
    dumped = torch.rand(L, generator=gen, device="cuda") < 0.1
    idx[dumped] = L - 1
    vals[dumped] = INT32_MAX

    # per kernel: the hop counts swept (main_k is the main path's), the CUDA
    # wrapper and the plain version, bytes and operations for the bound, and
    # the one PyTorch call that computes the same function, where there is one
    cases = {
        "hook_compress": {
            "k": (1, 3), "main_k": 3,
            "kernel": lambda k: ops.KERNELS["hook_compress"](P, s, r, k=k),
            "plain": lambda k: hook_compress_ref(P, s, r, k=k),
            "bytes": 4 * (2 * L + 2 * m),
            "ops": lambda k: 4 * m + k * L,
            "library": None,
            "source": "src/repro_torch/kernels/csrc/hook_compress.cu",
            "replaces": "src/repro/kernels/hook_compress/kernel.py:68",
            "shapes": f"labels ({L},) edges ({m},)",
        },
        "pointer_jump": {
            "k": (1, 3), "main_k": 1,
            "kernel": lambda k: ops.KERNELS["pointer_jump"](P, k=k),
            "plain": lambda k: pointer_jump_ref(P, k=k),
            "bytes": 4 * 2 * L,
            "ops": lambda k: k * L,
            "library": None,
            "source": "src/repro_torch/kernels/csrc/pointer_jump.cu",
            "replaces": "src/repro/kernels/pointer_jump/kernel.py:38",
            "shapes": f"labels ({L},)",
        },
        "scatter_min": {
            "k": (None,), "main_k": None,
            "kernel": lambda k: ops.KERNELS["scatter_min"](P, idx, vals),
            "plain": lambda k: scatter_min_ref(P, idx, vals),
            "bytes": 4 * (2 * L + 2 * L),
            "ops": lambda k: L,
            "library": lambda idx_long=idx.long(): P.scatter_reduce(
                0, idx_long, vals, "amin", include_self=True),
            "source": "src/repro_torch/kernels/csrc/scatter_min.cu",
            "replaces": "src/repro/kernels/scatter_min/kernel.py:45",
            "shapes": f"labels ({L},) idx/vals ({L},)",
        },
    }
    results = {}
    for name, c in cases.items():
        for k in c["k"]:
            got = c["kernel"](k)
            want = c["plain"](k)
            torch.cuda.synchronize()
            require(got.shape == want.shape and got.dtype == want.dtype,
                    f"{name} k={k}: shape/dtype differ from the plain version")
            err = int((got.long() - want.long()).abs().max())
            require(err == 0 and torch.equal(got, want),
                    f"{name} k={k}: kernel disagrees with its plain version "
                    f"(max_abs_err={err})")
            ms = time_ms(torch, lambda: c["kernel"](k), iters=20)
            plain_ms = time_ms(torch, lambda: c["plain"](k), iters=5)
            lib_ms = (time_ms(torch, c["library"], iters=20)
                      if c["library"] is not None else None)
            b_ms, b_by = bound_ms(c["bytes"], c["ops"](k))
            ktxt = "" if k is None else f" k={k}"
            print(f"[kernels] {name}{ktxt} {c['shapes']}: exact match; "
                  f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"library_ms={'null' if lib_ms is None else f'{lib_ms:.4f}'} "
                  f"bound_ms={b_ms:.4f} ({b_by}, {c['bytes']} bytes at "
                  f"3.35 TB/s)")
            if k == c["main_k"]:
                results[name] = {
                    "name": name, "route": "cuda", "source": c["source"],
                    "replaces": c["replaces"], "launches": 0,
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
    return results


def phase_small(torch) -> None:
    """The slice's variants on a small graph: card vs CPU vs scipy."""
    import numpy as np

    from repro_torch import ConnectIt
    from repro_torch.graphs import components_oracle, generators as gen
    g_cpu = gen.rmat(1 << 12, 1 << 15, seed=1, device="cpu")
    g_gpu = gen.rmat(1 << 12, 1 << 15, seed=1, device="cuda")
    expect = components_oracle(g_cpu)
    for variant in SLICE_VARIANTS:
        for fused in (False, True):
            a, sa = ConnectIt(variant, device="cpu").connectivity(
                g_cpu, fused=fused, return_stats=True)
            b, sb = ConnectIt(variant, device="cuda").connectivity(
                g_gpu, fused=fused, return_stats=True)
            require(np.array_equal(a.numpy(), expect),
                    f"small {variant} fused={fused}: CPU path != scipy")
            require(np.array_equal(b.cpu().numpy(), expect),
                    f"small {variant} fused={fused}: card != scipy")
            if not variant.startswith("kout_hybrid"):  # random columns differ
                require(sa == sb, f"small {variant} fused={fused}: stats "
                        f"differ: cpu {sa} card {sb}")
    print(f"[small] {len(SLICE_VARIANTS)} variants x compacted/fused on rmat "
          f"n=2^12: card == CPU path == scipy")


def phase_main(torch, g, results: dict) -> None:
    import numpy as np

    from repro_torch import ConnectIt
    from repro_torch.graphs import components_oracle
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    expect = components_oracle(g)
    print(f"[main] scipy oracle on the host: {time.perf_counter() - t0:.2f} s, "
          f"{len(np.unique(expect))} components")
    session = ConnectIt(MAIN_VARIANT, device="cuda")
    for fused in (False, True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        labels, stats = session.connectivity(g, fused=fused, return_stats=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        path = "fused" if fused else "compacted"
        require(labels.shape == (g.n,) and labels.dtype == torch.int32,
                f"main {path}: labels shape {tuple(labels.shape)}")
        require(np.array_equal(labels.cpu().numpy(), expect),
                f"main {path}: labels differ from the scipy oracle")
        for name, cnt in counts.items():
            require(cnt > 0, f"main {path}: kernel {name} never launched")
        print(f"[main] {MAIN_VARIANT} {path}: labels == scipy oracle; "
              f"wall {wall:.4f} s; peak device memory {peak} bytes; "
              f"launches {json.dumps(counts)}")
        print(f"[main]   stats {stats}")
        if not fused:
            for name, cnt in counts.items():
                results[name]["launches"] = cnt

    # the canonicalization's own scatter_min call (min_vertex_labels): one
    # component holds most vertices, so most proposals hit one slot
    n = g.n
    ext = torch.cat([labels, labels.new_tensor([n])])
    ids = torch.arange(n + 1, dtype=torch.int32, device="cuda")
    idx = torch.where(ids < n, ext, n)
    vals = torch.where(ids < n, ids, INT32_MAX)
    base = torch.full_like(ext, n)
    idx_long = idx.long()
    got = ops.KERNELS["scatter_min"](base, idx, vals)
    want = base.scatter_reduce(0, idx_long, vals, "amin", include_self=True)
    require(torch.equal(got, want), "scatter_min on the canonicalization's "
            "inputs disagrees with scatter_reduce")
    ms = time_ms(torch, lambda: ops.KERNELS["scatter_min"](base, idx, vals),
                 iters=20)
    lib_ms = time_ms(torch, lambda: base.scatter_reduce(
        0, idx_long, vals, "amin", include_self=True), iters=20)
    top = int(torch.bincount(labels.long()).max())
    print(f"[main] scatter_min on the canonicalization's inputs ({top} of {n} "
          f"vertices in one component): kernel_ms={ms:.4f} "
          f"library_ms={lib_ms:.4f}")


def phase_profile(torch, g) -> None:
    """Where the compacted main path's time goes: wall time per driver step
    (host clock around synchronized work), then one run under
    torch.profiler for device time by kernel and the device's busy share."""
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

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        session.connectivity(g)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only (kernels, copies, fills): the CPU ops that
    # launched them report the same time again
    rows = sorted(((ev.device_time_total, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA), reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    print(f"[profile] traced wall {wall:.4f} s; device busy {busy:.4f} s "
          f"({100 * busy / wall:.1f}%), idle {100 * (1 - busy / wall):.1f}%")
    for dev_us, key, count in rows[:15]:
        print(f"[profile]   {dev_us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-n", type=int, default=22)
    ap.add_argument("--log-m", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
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

    try:
        device = phase_device(torch)
        phase_build()
        g = phase_graph(torch, args.log_n, args.log_m, args.seed)
        results = phase_kernels(torch, g)
        phase_small(torch)
        phase_main(torch, g, results)
        phase_profile(torch, g)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
