#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA card and check them.

    python3 chip_smoke.py                         # RMAT n=2^22, 2^25 edges;
                                                  # DLRM-RM2 at full width
    python3 chip_smoke.py --log-n 14 --log-m 17   # a short compile check
                                                  # (DLRM vocab, batches and
                                                  # candidates cut to 2^14)

Phases, in order; any failure exits non-zero:

  1. device   the card's name and power limit (nvidia-smi);
  2. build    nvcc builds every CUDA kernel from src/repro_torch/kernels/csrc
              (one process per source, all at once) into build/kernels/;
  3. graph    an RMAT graph, paper parameters (a,b,c) = (0.5, 0.1, 0.1),
              generated on the host from the seed and built on the card;
  4. kernels  each kernel at the main paths' shapes against its plain
              PyTorch version on the same inputs (the int32 kernels exactly,
              embedding_bag within BAG_TOL), with its time, the plain
              version's, one PyTorch call's where one computes the same
              function, and the bound; embedding_bag on a
              1,000,448 x 64 table at RM2's serve_bulk shape (B=262144,
              L=1, zipfian ids) and a multi-hot one (B=65536, L=8, ~10% on
              the dump row, and with wrapped and clamped ids), sum / mean /
              max, float32 / bfloat16;
  5. small    every variant of enumerate_variants() (148) on a small graph,
              compacted and fused, on the card, against the CPU path and
              scipy;
  6. paths    on the big graph, each against the scipy oracle (computed
              once), with wall time, stats, peak memory and each kernel's
              launch count; each path names the kernels it must launch:
                kout_hybrid_k2+uf_sync_full      compacted, fused (the main path)
                kout_hybrid_k2+liu_tarjan_PUFA   compacted, fused
                kout_hybrid_k2+liu_tarjan_CRFA   compacted, fused
                none+stergiou
                ldd_b0.2+uf_sync_full
  7. dlrm     DLRM-RM2 built on the card from the seed (26 x 1,000,448 x 64
              float32 tables, 6.66 GB); serve_p99 (B=512), serve_bulk
              (B=262144) and retrieval_cand (10^6 candidates), each through
              the embedding_bag kernel and held against the same model
              through the plain version, with step times, peak memory and
              launches per step;
  8. profile  where the compacted main path's time goes: wall time per
              driver step, device time per kernel and the device's busy
              share (torch.profiler); then the same trace of none+stergiou,
              of kout_hybrid_k2+liu_tarjan_PUFA fused (its per-round state
              compares run over the whole edge list) and of one DLRM-RM2
              serve_bulk and one serve_p99 step.

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
# (variant, fused modes, kernels the run must launch); the first is the main
# path, whose launches the per-kernel JSON reports for its three kernels
PATHS = (
    (MAIN_VARIANT, (False, True), UF_KERNELS),
    ("kout_hybrid_k2+liu_tarjan_PUFA", (False, True),
     UF_KERNELS + ("edge_relabel", "edge_rewrite")),
    ("kout_hybrid_k2+liu_tarjan_CRFA", (False, True),
     UF_KERNELS + ("edge_rewrite",)),
    ("none+stergiou", (False,),
     ("edge_relabel", "edge_rewrite", "pointer_jump", "scatter_min")),
    ("ldd_b0.2+uf_sync_full", (False,), UF_KERNELS),
)
# the path whose compacted run reports the two edge kernels' launches
EDGE_PATH = "kout_hybrid_k2+liu_tarjan_PUFA"
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


def phase_kernels(torch, g, cap: int) -> dict:
    """Each kernel against its plain version at the main paths' shapes."""
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
    # the graph's edges with ~10% of the endpoints -1, as Liu-Tarjan's alter
    # step leaves them once L_max is pinned
    s_neg = torch.where(torch.rand(m, generator=gen, device="cuda") < 0.1,
                        -1, s).to(torch.int32)
    r_neg = torch.where(torch.rand(m, generator=gen, device="cuda") < 0.1,
                        -1, r).to(torch.int32)
    edge_sets = {"graph": (s, r), "neg": (s_neg, r_neg)}

    # per kernel: the settings swept (hop counts, or edge input sets; "main"
    # is the one the JSON reports), the CUDA wrapper and the plain version,
    # bytes and operations for the bound, and the one PyTorch call that
    # computes the same function, where there is one
    cases = {
        "hook_compress": {
            "sweep": (1, 3), "main": 3,
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
            "sweep": (1, 3), "main": 1,
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
            "sweep": (None,), "main": None,
            "kernel": lambda _: ops.KERNELS["scatter_min"](P, idx, vals),
            "plain": lambda _: scatter_min_ref(P, idx, vals),
            "bytes": 4 * (2 * L + 2 * L),
            "ops": lambda _: L,
            "library": lambda idx_long=idx.long(): P.scatter_reduce(
                0, idx_long, vals, "amin", include_self=True),
            "source": "src/repro_torch/kernels/csrc/scatter_min.cu",
            "replaces": "src/repro/kernels/scatter_min/kernel.py:45",
            "shapes": f"labels ({L},) idx/vals ({L},)",
        },
        "edge_relabel": {
            "sweep": tuple(edge_sets), "main": "graph",
            "kernel": lambda e: ops.KERNELS["edge_relabel"](P, *edge_sets[e]),
            "plain": lambda e: edge_relabel_ref(P, *edge_sets[e]),
            "bytes": 4 * (2 * L + 2 * m),
            "ops": lambda _: 4 * m,
            "library": None,
            "source": "src/repro_torch/kernels/csrc/edge_relabel.cu",
            "replaces": "src/repro/kernels/edge_relabel/kernel.py:63",
            "shapes": f"labels ({L},) edges ({m},)",
        },
        "edge_rewrite": {
            "sweep": tuple(edge_sets), "main": "graph",
            "kernel": lambda e: ops.KERNELS["edge_rewrite"](P, *edge_sets[e]),
            "plain": lambda e: edge_rewrite_ref(P, *edge_sets[e]),
            "bytes": 4 * (L + 4 * m),
            "ops": lambda _: 2 * m,
            "library": None,
            "source": "src/repro_torch/kernels/csrc/edge_relabel.cu",
            "replaces": "src/repro/kernels/edge_relabel/kernel.py:96",
            "shapes": f"labels ({L},) edges ({m},), two outputs",
        },
    }
    results = {}
    for name, c in cases.items():
        for x in c["sweep"]:
            got = c["kernel"](x)
            want = c["plain"](x)
            torch.cuda.synchronize()
            err = _max_abs_err(torch, got, want)
            require(err == 0, f"{name} {x}: kernel disagrees with its plain "
                    f"version (max_abs_err={err}; -1 is a shape or dtype "
                    f"mismatch)")
            ms = time_ms(torch, lambda: c["kernel"](x), iters=20)
            plain_ms = time_ms(torch, lambda: c["plain"](x), iters=5)
            lib_ms = (time_ms(torch, c["library"], iters=20)
                      if c["library"] is not None else None)
            b_ms, b_by = bound_ms(c["bytes"], c["ops"](x))
            label = {None: "", "graph": " graph edges",
                     "neg": " ~10% -1 endpoints"}.get(x, f" k={x}")
            print(f"[kernels] {name}{label} {c['shapes']}: exact match; "
                  f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"library_ms={'null' if lib_ms is None else f'{lib_ms:.4f}'} "
                  f"bound_ms={b_ms:.4f} ({b_by}, {c['bytes']} bytes at "
                  f"3.35 TB/s)")
            if x == c["main"]:
                results[name] = {
                    "name": name, "route": "cuda", "source": c["source"],
                    "replaces": c["replaces"], "launches": 0,
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
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


def phase_paths(torch, g, results: dict) -> None:
    """Each path of PATHS on the big graph against the scipy oracle, with
    the kernels it must launch."""
    import numpy as np

    from repro_torch import ConnectIt
    from repro_torch.graphs import components_oracle
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    expect = components_oracle(g)
    print(f"[paths] scipy oracle on the host: {time.perf_counter() - t0:.2f} "
          f"s, {len(np.unique(expect))} components")
    for variant, modes, required in PATHS:
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
            for name in required:
                require(counts[name] > 0,
                        f"{variant} {path}: kernel {name} never launched")
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
        if variant == MAIN_VARIANT:
            _canonicalization_scatter_min(torch, labels)


def _canonicalization_scatter_min(torch, labels) -> None:
    """The canonicalization's own scatter_min call (min_vertex_labels): one
    component holds most vertices, so most proposals hit one slot."""
    from repro_torch.kernels import ops

    n = labels.shape[0]
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
    print(f"[paths] scatter_min on the canonicalization's inputs ({top} of "
          f"{n} vertices in one component): kernel_ms={ms:.4f} "
          f"library_ms={lib_ms:.4f}")


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


def _trace(torch, tag: str, fn) -> None:
    """One run of ``fn`` under torch.profiler: wall time, the device's busy
    share and device time by kernel."""
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
    for dev_us, key, count in rows[:15]:
        print(f"[profile]   {dev_us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")


def phase_profile(torch, g, model, serve_inputs) -> None:
    """Where the compacted main path's time goes: wall time per driver step
    (host clock around synchronized work), then one traced run of it, one of
    none+stergiou, one of the fused PUFA path, and one DLRM-RM2 serve_bulk
    and one serve_p99 step."""
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
    for shape in ("serve_bulk", "serve_p99"):
        inputs = serve_inputs[shape]
        ops.reset_launch_counts()
        _trace(torch, f"dlrm-rm2 {shape} B={inputs[0].shape[0]}",
               lambda: serve_step(model, *inputs))
        print(f"[profile]   launches {json.dumps(ops.launch_counts())}")


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
        # the DLRM phases' size cap: at the default 2^22 it cuts nothing, so
        # RM2 runs at its published widths; a short check cuts vocab,
        # batches and candidates to 2^log_n
        cap = 1 << args.log_n
        results = phase_kernels(torch, g, cap)
        phase_small(torch)
        phase_paths(torch, g, results)
        model, serve_inputs = phase_dlrm(torch, cap, args.seed, results)
        phase_profile(torch, g, model, serve_inputs)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
