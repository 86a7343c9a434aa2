"""The reference's DLRM cells on a mesh of forced host devices (a helper of
tests/test_torch_dlrm_mesh.py; the parent sets
``XLA_FLAGS=--xla_force_host_platform_device_count=4``).

    python tests/repro_dlrm_mesh_ref.py CASE.json OUT_DIR MESH

For mesh number ``MESH`` of ``CASE.json`` it runs ``repro``'s serve,
retrieval and train cells (``tests/torch_dlrm_mesh_worker.py``'s
``SHAPES`` at its ``CONFIG``) under ``jax.jit(in_shardings=
cell.in_shardings)`` and writes the global results to
``OUT_DIR/ref_<mesh>.npz`` under the names the worker uses. One process a
mesh: the test starts them side by side.
"""

import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_dlrm_mesh_worker import arch_of  # noqa: E402


def main(case_path: str, out_dir: str, which: int) -> int:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.configs import base, get_arch
    from repro.launch import steps
    from repro.legacy import optim

    base.load_all()
    with open(case_path) as f:
        case = json.load(f)
    data = np.load(case["inputs"])
    shape, names = case["meshes"][which]
    mesh = Mesh(np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(
        shape), tuple(names))
    arch = arch_of(get_arch)

    def x(name):
        return jnp.asarray(data[name])

    out = {}
    with mesh:
        cell = steps.build_cell(arch, "serve", mesh)
        leaves, tree = jax.tree.flatten(cell.args[0])
        params = jax.tree.unflatten(tree, [x(f"param{i}")
                                           for i in range(len(leaves))])
        out["serve_p"] = np.asarray(jax.jit(
            cell.fn, in_shardings=cell.in_shardings)(
                params, x("dense"), x("sparse")))
        cell = steps.build_cell(arch, "retrieval", mesh)
        vals, idx = jax.jit(cell.fn, in_shardings=cell.in_shardings)(
            params, x("q_dense"), x("q_sparse"), x("cand"))
        out["ret_vals"], out["ret_idx"] = np.asarray(vals), np.asarray(idx)
        cell = steps.build_cell(arch, "train", mesh)
        p2, o2, info = jax.jit(cell.fn, in_shardings=cell.in_shardings)(
            params, optim.init_adam(params), x("dense"), x("sparse"),
            x("labels"))
    out["loss"] = np.asarray(info["loss"])
    out["gnorm"] = np.asarray(info["grad_norm"])
    for part, tr in (("param", p2), ("mu", o2.mu)):
        for i, leaf in enumerate(jax.tree.leaves(tr)):
            out[f"{part}{i}"] = np.asarray(leaf)
    np.savez(f"{out_dir}/ref_{'x'.join(map(str, shape))}.npz", **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2], int(sys.argv[3])))
