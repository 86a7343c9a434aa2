"""One rank of a spawned world running the port's ``connectit`` cells on a
``(data, model)`` mesh (a helper of tests/test_torch_cells.py; it imports
neither jax nor repro).

    python tests/torch_cells_worker.py CASE.json OUT.json RANK

``CASE.json`` holds the world size, the rendezvous file, the cut-down
shape dicts and the global inputs of each cell. Every rank builds each
cell on the mesh over the world, takes its block of every input by the
cell's ``in_shardings``, runs the step, gathers the labels along the label
axis and writes them with the rounds (and the ingest cell's answers, with
the offset of its query block) to ``OUT.json``.

``CASE.json``'s ``legacy`` part names the legacy mesh factories of
``repro_torch.core.distributed`` with their settings and global inputs.
Every rank builds each on the mesh, runs it on its edge block and its
labels (whole, or its window of the label axis) and writes the gathered
labels (and ``make_streaming_ingest``'s answers to its query block).
"""

import dataclasses
import json
import sys
import warnings

import numpy as np
import torch


def main(case_path: str, out_path: str, rank: int) -> int:
    from repro_torch.configs import get_arch
    from repro_torch.core import collectives as coll
    from repro_torch.launch import multihost
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.shardings import spec_axes
    from repro_torch.launch.steps import build_cell, local_block

    with open(case_path) as f:
        case = json.load(f)
    multihost.initialize(init_method=f"file://{case['store']}",
                         num_processes=case["world"], process_id=rank,
                         backend="gloo", timeout=120)
    out = {}
    try:
        mesh = make_smoke_mesh("cpu")
        arch = dataclasses.replace(get_arch("connectit"),
                                   shapes=case["shapes"])
        for shape, inputs in case["inputs"].items():
            cell = build_cell(arch, shape, mesh, device="cpu")
            args = [torch.tensor(np.asarray(x, dtype=np.int32))
                    for x in inputs]
            blocks = [local_block(a, sh, mesh)
                      for a, sh in zip(args, cell.in_shardings)]
            res = cell.fn(*blocks)
            labels = res[0]
            if cell.in_shardings[0]:
                labels = coll.all_gather(labels, mesh, cell.in_shardings[0])
            out[shape] = {"labels": labels.tolist(), "rounds": int(res[-1]),
                          "mesh": list(mesh.shape)}
            if len(res) == 3:  # the ingest cell's answers to its block
                sh = spec_axes(cell.in_shardings[3][0])
                out[shape]["answers"] = res[1].tolist()
                out[shape]["query_lo"] = (coll.shard_index(mesh, sh)
                                          * blocks[3].shape[0])
        out["legacy"] = _legacy(case["legacy"], mesh)
    finally:
        multihost.shutdown()
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


def _legacy(legacy: dict, mesh) -> dict:
    """Each legacy mesh factory on this rank's blocks: its labels gathered
    along the label axis, and the streaming ingest's answers."""
    from repro_torch.core import collectives as coll
    from repro_torch.core import distributed as tdist
    from repro_torch.launch.steps import local_block

    lab, s, r, qa, qb = (torch.tensor(np.asarray(legacy[k], dtype=np.int32))
                         for k in ("labels", "s", "r", "qa", "qb"))
    out = {}
    for key, spec in legacy["runs"].items():
        name, args, kw = spec["name"], spec["args"], spec["kw"]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            fn = getattr(tdist, name)(mesh, *args, **kw)
        eaxes = tuple(args[0])
        es, er = (local_block(x, (eaxes,), mesh) for x in (s, r))
        if name.startswith("make_sharded"):
            lax = (args[1],)
            pad = torch.arange(-(-lab.shape[0] // coll.mesh_size(mesh, lax))
                               * coll.mesh_size(mesh, lax), dtype=torch.int32)
            pad[: lab.shape[0]] = lab
            got = coll.all_gather(fn(local_block(pad, lax, mesh), es, er),
                                  mesh, lax)
            out[key] = {"labels": got[: lab.shape[0]].tolist()}
        elif name == "make_streaming_ingest":
            qa_b, qb_b = (local_block(x, (eaxes,), mesh) for x in (qa, qb))
            got, ans = fn(lab, es, er, qa_b, qb_b)
            out[key] = {"labels": got.tolist(), "answers": ans.tolist(),
                        "query_lo": (coll.shard_index(mesh, eaxes)
                                     * qa_b.shape[0])}
        else:
            out[key] = {"labels": fn(lab, es, er).tolist()}
    return out


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2], int(sys.argv[3])))
