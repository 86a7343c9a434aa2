"""The reference's GNN cells on a mesh of forced host devices (a helper of
tests/test_torch_gnn_mesh.py; the parent sets
``XLA_FLAGS=--xla_force_host_platform_device_count=4``).

    python tests/repro_gnn_mesh_ref.py CASE.json OUT_DIR MESH

For mesh number ``MESH`` of ``CASE.json`` and each of its cells it runs
``repro``'s smoke cell under ``jax.jit(in_shardings=cell.in_shardings)``
for one train step and
writes the loss, the global norm, the parameters and the first moments to
``OUT_DIR/ref_<mesh>_<arch>_<shape>.npz`` under the names
``tests/torch_gnn_mesh_worker.py`` uses. With ``MESH`` 0 the
``ref_only`` cells also run on a 1 x 1 mesh (``ref_1x1_...``). One
process a mesh: the test starts them side by side.
"""

import dataclasses
import json
import sys

import numpy as np


def run_cell(arch_name: str, shape: str, spec: dict, data, mesh) -> dict:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch
    from repro.launch import steps
    from repro.legacy import optim

    arch = get_arch(arch_name)
    spec = dict(spec, **({"fanout": tuple(spec["fanout"])}
                         if "fanout" in spec else {}))
    arch = dataclasses.replace(arch, model=dataclasses.replace(
        arch.model, **arch.smoke), shapes={shape: spec})
    with mesh:
        cell = steps.build_cell(arch, shape, mesh)
        pshapes = cell.args[0]
        leaves, tree = jax.tree.flatten(pshapes)
        pre = f"{arch_name}/{shape}/"
        params = jax.tree.unflatten(tree, [jnp.asarray(data[f"{pre}p{i}"])
                                           for i in range(len(leaves))])
        inputs = []
        for i, a in enumerate(cell.args[2:]):
            if isinstance(a, dict):
                inputs.append({k: jnp.asarray(data[f"{pre}{i}/{k}"])
                               for k in a})
            else:
                x = data[f"{pre}{i}"]
                inputs.append(jnp.asarray(x.astype(np.uint32)
                                          if a.dtype == jnp.uint32 else x))
        p2, o2, info = jax.jit(cell.fn, in_shardings=cell.in_shardings)(
            params, optim.init_adam(params), *inputs)
    out = {"loss": np.asarray(info["loss"]),
           "gnorm": np.asarray(info["grad_norm"])}
    for part, tr in (("param", p2), ("mu", o2.mu)):
        for i, x in enumerate(jax.tree.leaves(tr)):
            out[f"{part}{i}"] = np.asarray(x)
    return out


def main(case_path: str, out_dir: str, which: int) -> int:
    import jax
    from jax.sharding import Mesh

    from repro.configs import base

    base.load_all()
    with open(case_path) as f:
        case = json.load(f)
    data = np.load(case["inputs"])
    s, n = case["meshes"][which]
    meshes = [(tuple(s), tuple(n), case["cells"])]
    if which == 0:
        meshes.append(((1, 1), ("data", "model"), case["ref_only"]))
    for shape, names, cells in meshes:
        k = int(np.prod(shape))
        mesh = Mesh(np.asarray(jax.devices()[:k]).reshape(shape), names)
        tag = "x".join(map(str, shape))
        for arch, cshape in cells:
            np.savez(f"{out_dir}/ref_{tag}_{arch}_{cshape}.npz",
                     **run_cell(arch, cshape, case["shapes"][cshape], data,
                                mesh))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2], int(sys.argv[3])))
