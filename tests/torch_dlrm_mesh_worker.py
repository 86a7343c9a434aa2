"""One rank of a spawned world running the port's DLRM cells on a mesh (a
helper of tests/test_torch_dlrm_mesh.py; it imports neither jax nor repro).

    python tests/torch_dlrm_mesh_worker.py CASE.json OUT_DIR RANK

``CASE.json`` names the world size, the rendezvous file, the meshes (shape
and axis names) and the inputs' ``.npz`` (the global parameters of the
reference's ``init_dlrm(PRNGKey(0))`` at ``CONFIG``, a batch, a query and
the candidates). For each mesh every rank builds the ``SHAPES`` cells on
the mesh, the model with each table's rows over ``model``
(``dlrm_from_jax(..., mesh=, specs=)``), takes its blocks of the inputs and
runs the serve cell, the retrieval cell and one step of the train cell;
rank 0 writes the gathered results to ``OUT_DIR/<mesh>.npz``, with the
tables of ``init_dlrm(PRNGKey(3), mesh=, specs=)`` gathered.
"""

import dataclasses
import json
import sys

import numpy as np
import torch

# 26 tables of 1,000 ids (1,024 rows) at D = 16, two ids a bag; the smoke
# MLPs with the bottom one ending at D
CONFIG = dict(vocab_sizes=(1000,) * 26, embed_dim=16, bot_mlp=(32, 16, 16),
              top_mlp=(32, 16, 1), multi_hot=2)
SHAPES = {"serve": dict(kind="serve", batch=64),
          "train": dict(kind="train", batch=64),
          "retrieval": dict(kind="retrieval", batch=1, n_candidates=4096)}


def arch_of(get_arch):
    """DLRM-RM2 from ``get_arch`` (either package's) at ``CONFIG`` with
    the ``SHAPES`` cells."""
    arch = get_arch("dlrm-rm2")
    return dataclasses.replace(arch, model=dataclasses.replace(
        arch.model, **CONFIG), shapes=SHAPES)


def to_global(x: torch.Tensor, spec: tuple, mesh) -> np.ndarray:
    """The global array of this rank's block ``x`` laid out by ``spec``."""
    from repro_torch.legacy.models import spmd
    x = x.detach()
    for i, e in enumerate(spec):
        if e is not None:
            x = spmd.gather(x, mesh, i, spmd.spec_axes(e), summed=False)
    return x.numpy()


def run_mesh(data, mesh) -> dict:
    from repro_torch import random as trandom
    from repro_torch.configs import get_arch
    from repro_torch.launch.shardings import local_block
    from repro_torch.launch.steps import build_cell
    from repro_torch.legacy import optim
    from repro_torch.legacy.models import dlrm
    from repro_torch.legacy.models.spmd import (
        spec_leaves,
        tree_paths,
        tree_rebuild,
    )
    from repro_torch.legacy.tree import leaves

    arch = arch_of(get_arch)
    cfg = arch.model
    shapes = dlrm.param_shapes(cfg)
    gparams = tree_rebuild(shapes, [data[f"param{i}"] for i in
                                    range(len(tree_paths(shapes)))])

    def model_for(cell):
        return dlrm.dlrm_from_jax(gparams, cfg, device="cpu", mesh=mesh,
                                  specs=cell.state_shardings[0])

    def specs_of(cell):
        return cell.state_shardings[0]["tables"]

    def blocks(cell, names):
        return [local_block(torch.from_numpy(data[k]), sp, mesh)
                for k, sp in zip(names, cell.in_shardings)]

    out = {}
    cell = build_cell(arch, "serve", mesh, device="cpu")
    model = model_for(cell)
    p = cell.fn(model, *blocks(cell, ("dense", "sparse")))
    out["serve_p"] = to_global(p, cell.in_shardings[0][:1], mesh)

    cell = build_cell(arch, "retrieval", mesh, device="cpu")
    vals, idx = cell.fn(model, *blocks(cell, ("q_dense", "q_sparse",
                                              "cand")))
    out["ret_vals"], out["ret_idx"] = vals.numpy(), idx.numpy()

    cell = build_cell(arch, "train", mesh, device="cpu")
    model = model_for(cell)
    state = optim.init_adam(model.params())
    _, state, info = cell.fn(model, state, *blocks(
        cell, ("dense", "sparse", "labels")))
    for t, x in enumerate(dlrm.init_dlrm(
            cfg, key=trandom.PRNGKey(3, device="cpu"), mesh=mesh,
            specs=cell.state_shardings[0]).tables):
        out[f"init{t}"] = to_global(x, specs_of(cell)[t], mesh)
    out["loss"] = info["loss"].numpy()
    out["gnorm"] = info["grad_norm"].numpy()
    specs = spec_leaves(cell.state_shardings[0])
    for part, tree in (("param", model.params()), ("mu", state.mu)):
        for i, (x, sp) in enumerate(zip(leaves(tree), specs, strict=True)):
            out[f"{part}{i}"] = to_global(x, sp, mesh)
    return out


def main(case_path: str, out_dir: str, rank: int) -> int:
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import multihost

    with open(case_path) as f:
        case = json.load(f)
    multihost.initialize(init_method=f"file://{case['store']}",
                         num_processes=case["world"], process_id=rank,
                         backend="gloo", timeout=240)
    try:
        data = np.load(case["inputs"])
        for shape, names in case["meshes"]:
            mesh = init_device_mesh("cpu", tuple(shape),
                                    mesh_dim_names=tuple(names))
            out = run_mesh(data, mesh)
            if rank == 0:
                np.savez(f"{out_dir}/{'x'.join(map(str, shape))}.npz", **out)
    finally:
        multihost.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2], int(sys.argv[3])))
