"""One rank of a spawned world running the port's GNN cells on a mesh (a
helper of tests/test_torch_gnn_mesh.py; it imports neither jax nor repro).

    python tests/torch_gnn_mesh_worker.py CASE.json OUT_DIR RANK

``CASE.json`` names the world size, the rendezvous file, the meshes (shape
and axis names), the cells (arch, shape) and the inputs' ``.npz`` (each
arch's global smoke parameters from the reference's ``init_gnn`` /
``init_nequip(PRNGKey(0))``, each cell's whole inputs). For each mesh and
cell every rank builds the smoke cell on the mesh, takes its blocks of the
inputs and runs one train step; rank 0 writes the loss, the global norm,
the parameters and the first moments (whole on every rank) to
``OUT_DIR/<mesh>_<arch>_<shape>.npz``. Then it checks ``scatter_max``'s
gradient with a tie on two ranks (``<mesh>_ties.npz``).
"""

import dataclasses
import json
import sys

import numpy as np
import torch


def inputs_of(data, arch: str, shape: str, cell) -> tuple:
    """The cell's whole inputs, as the test wrote them."""
    pre = f"{arch}/{shape}/"
    out = []
    for i, a in enumerate(cell.args):
        if isinstance(a, dict):
            out.append({k: torch.from_numpy(data[f"{pre}{i}/{k}"])
                        for k in a})
        else:
            out.append(torch.from_numpy(data[f"{pre}{i}"]))
    return out


def run_cell(arch_name: str, shape: str, spec: dict, data, mesh) -> dict:
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import build_cell, gnn_cell_config
    from repro_torch.launch.shardings import local_block
    from repro_torch.legacy import optim
    from repro_torch.legacy.models import gnn, nequip
    from repro_torch.legacy.models.spmd import tree_rebuild
    from repro_torch.legacy.tree import leaves

    arch = get_arch(arch_name)
    arch = dataclasses.replace(arch, model=dataclasses.replace(
        arch.model, **arch.smoke), shapes={shape: spec})
    cell = build_cell(arch, shape, mesh, device="cpu")
    cfg = gnn_cell_config(arch, shape)
    mod = nequip if arch_name == "nequip" else gnn
    shapes = mod.param_shapes(cfg)
    n = sum(1 for k in data.files if k.startswith(f"{arch_name}/{shape}/p"))
    params = tree_rebuild(shapes, [torch.from_numpy(
        data[f"{arch_name}/{shape}/p{i}"]) for i in range(n)])
    model = (nequip.NequIP if arch_name == "nequip" else gnn.GNN)(
        cfg, params)
    state = optim.init_adam(model.params())
    blocks = []
    for a, sh in zip(inputs_of(data, arch_name, shape, cell),
                     cell.in_shardings):
        if isinstance(a, dict):
            blocks.append({k: local_block(v, sh[k], mesh)
                           for k, v in a.items()})
        else:
            blocks.append(local_block(a, sh, mesh))
    _, state, info = cell.fn(model, state, *blocks)
    out = {"loss": info["loss"].numpy(), "gnorm": info["grad_norm"].numpy()}
    for part, tree in (("param", model.params()), ("mu", state.mu)):
        for i, x in enumerate(leaves(tree)):
            out[f"{part}{i}"] = x.detach().numpy()
    return out


def ties_case(r: int) -> tuple:
    """Rank ``r``'s edges of the tie check: ``(ids, values)``. Row 1's
    maximum 3 is reached on every rank, twice on rank 0."""
    return ([1, 1, 2 + r, 5],
            [3.0, 3.0 if r == 0 else 1.0, float(r), -2.0 + r])


def run_ties(mesh) -> dict:
    """``scatter_max`` of 4 edges a rank into 8 rows (``ties_case``): the
    rows' maxima and the gradient of ``sum(y * (row + 1))``, gathered in
    rank order."""
    from repro_torch.legacy.models import spmd
    from repro_torch.legacy.models.gnn_spmd import GraphShard, scatter_max
    g = GraphShard(mesh, 8)
    ids, vals = ties_case(torch.distributed.get_rank())
    idx = torch.tensor(ids, dtype=torch.int32)
    x = torch.tensor(vals)[:, None].requires_grad_(True)
    y = scatter_max(x, idx, g, -1e30)
    w = torch.arange(g.off, g.off + g.rows, dtype=torch.float32)[:, None] + 1
    (grad,) = torch.autograd.grad((y * w).sum(), x)
    axes = tuple(mesh.mesh_dim_names)
    return {"y": spmd.gather(y.detach(), mesh, 0, g.dax,
                             summed=False).numpy(),
            "grad": spmd.gather(grad, mesh, 0, axes, summed=False).numpy()}


def main(case_path: str, out_dir: str, rank: int) -> int:
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import multihost

    with open(case_path) as f:
        case = json.load(f)
    torch.manual_seed(0)
    multihost.initialize(init_method=f"file://{case['store']}",
                         num_processes=case["world"], process_id=rank,
                         backend="gloo", timeout=240)
    try:
        data = np.load(case["inputs"])
        for shape, names in case["meshes"]:
            mesh = init_device_mesh("cpu", tuple(shape),
                                    mesh_dim_names=tuple(names))
            tag = "x".join(map(str, shape))
            for arch, cshape in case["cells"]:
                out = run_cell(arch, cshape, case["shapes"][cshape], data,
                               mesh)
                if rank == 0:
                    np.savez(f"{out_dir}/{tag}_{arch}_{cshape}.npz", **out)
            out = run_ties(mesh)
            if rank == 0:
                np.savez(f"{out_dir}/{tag}_ties.npz", **out)
    finally:
        multihost.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2], int(sys.argv[3])))
