"""Dry run: plan every (architecture × input shape × mesh) cell on the
production meshes without running it (mirrors ``repro.launch.dryrun``).

Each registered, supported cell is built on the ``meta`` device over a
shape-only mesh (``launch.mesh.make_production_mesh``: 16 x 16 ``single``,
2 x 16 x 16 ``multi``), so nothing is allocated and no process group is
needed for 256 or 512 ranks. Per cell it reports:

  * ``arg_bytes``: one rank's blocks of every input, cut by the cell's
    ``in_shardings`` (``launch.steps.local_bytes``), against the card's
    memory (``fits``);
  * the roofline terms: memory ``bytes_per_dev / HBM_BW`` from the cell's
    ``meta["bytes_touched"]`` over the ranks (the inputs' bytes where a cell
    does not count them), compute ``model_flops / PEAK_FLOPS_BF16``, and
    the larger of the two as ``dominant``.

The reference's ``memory_analysis``, ``cost_analysis`` and HLO collective
columns come from XLA's compiled program and have no counterpart here; they
are left out. An LM, GNN or DLRM cell is planned per rank on the mesh: its
``arg_bytes`` add the rank's blocks of the model's float32 parameters
under the reference's specs (a GNN's whole on every rank, a DLRM's tables
by rows over ``model`` and its MLPs whole), and for a train cell of
AdamW's two moments under the same specs and its step (the cell's
``state``), to its blocks of the inputs (a GNN's node features over the
data axes, its edges over every axis; a DLRM's batch over the data axes,
retrieval's candidates over ``model``) and of a decode cell's KV cache. A
cell the port has not built yet would be reported as not ported, not as a
failure.

Usage:
  python -m repro_torch.launch.dryrun --arch connectit --shape static_1b_edges
  python -m repro_torch.launch.dryrun --all --mesh both --csv dryrun.csv
"""

from __future__ import annotations

import argparse
import sys
import time
import traceback

from ..configs import all_archs, get_arch
from .mesh import (
    HBM_BW,
    HBM_BYTES,
    PEAK_FLOPS_BF16,
    make_production_mesh,
)
from .steps import build_cell, local_bytes, state_bytes


def run_cell(arch_name: str, shape_name: str, mesh_kind: str,
             verbose: bool = True) -> dict:
    arch = get_arch(arch_name)
    plan = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    t0 = time.time()
    try:
        cell = build_cell(arch, shape_name, plan, device="meta")
    except NotImplementedError as e:
        if verbose:
            print(f"== {arch_name} × {shape_name} × {mesh_kind}: not ported "
                  f"({e}) ==")
        return dict(arch=arch_name, shape=shape_name, mesh=mesh_kind,
                    status=f"not ported ({e})")
    build_s = time.time() - t0
    # the inputs; an LM, GNN or DLRM cell's model and AdamW state too, per
    # rank
    arg_bytes = local_bytes(cell, plan) + state_bytes(cell, plan)
    n_dev = plan.size()
    model_flops = cell.meta.get("model_flops", 0) / n_dev
    touched = cell.meta.get("bytes_touched", local_bytes(cell, plan) * n_dev)
    bytes_dev = touched / n_dev
    compute_t = model_flops / PEAK_FLOPS_BF16
    memory_t = bytes_dev / HBM_BW
    dom = "compute" if compute_t > memory_t else "memory"
    rec = dict(
        arch=arch_name, shape=shape_name, mesh=mesh_kind, devices=n_dev,
        status="ok", build_s=round(build_s, 4),
        flops_per_dev=model_flops, bytes_per_dev=bytes_dev,
        compute_term_s=compute_t, memory_term_s=memory_t, dominant=dom,
        model_flops_per_dev=model_flops, arg_bytes=arg_bytes,
        fits=arg_bytes <= HBM_BYTES,
        loop_trips=int(cell.meta.get("loop_trips", 1)),
    )
    if verbose:
        print(f"== {arch_name} × {shape_name} × {mesh_kind} "
              f"({n_dev} devices) ==")
        print(f"  arg_bytes per rank: {arg_bytes} of {HBM_BYTES} "
              f"({'fits' if rec['fits'] else 'DOES NOT FIT'})")
        print(f"  roofline: compute={compute_t:.4e}s memory={memory_t:.4e}s "
              f"→ dominant={dom}")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--csv", default=None)
    ap.add_argument("--fail-fast", action="store_true")
    args = ap.parse_args(argv)

    if args.all:
        cells = []
        for a in all_archs():
            arch = get_arch(a)
            cells += [(a, s) for s in arch.shape_names() if arch.supports(s)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    records, skipped, failures = [], [], []
    for a, s in cells:
        for mk in meshes:
            try:
                rec = run_cell(a, s, mk)
            except Exception as e:  # noqa: BLE001 - reported, counted
                failures.append((a, s, mk, repr(e)))
                traceback.print_exc()
                if args.fail_fast:
                    raise
                continue
            (records if rec["status"] == "ok" else skipped).append(rec)
    if args.csv and records:
        import csv
        with open(args.csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(records[0]))
            w.writeheader()
            w.writerows(records)
        print(f"wrote {len(records)} rows to {args.csv}")
    print(f"\nDRY-RUN SUMMARY: {len(records)} ok, {len(skipped)} not ported, "
          f"{len(failures)} failed")
    for rec in skipped:
        print(f"  NOT PORTED: {rec['arch']} {rec['shape']} {rec['mesh']}")
    for f in failures:
        print("  FAIL:", f)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
