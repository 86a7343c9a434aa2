"""The reference's LM cells on a mesh of forced host devices (a helper of
tests/test_torch_lm_mesh.py; the parent sets
``XLA_FLAGS=--xla_force_host_platform_device_count=4``).

    python tests/repro_lm_mesh_ref.py CASE.json OUT_DIR

For each mesh and arch of ``CASE.json`` it runs ``repro``'s smoke cells
under ``jax.jit(in_shardings=cell.in_shardings)``: prefill, three decode
steps from its cache, one train step (deepseek: also the int8 all_to_all
step), and writes the global results to ``OUT_DIR/<mesh>_<arch>.npz``
under the names ``tests/torch_lm_mesh_worker.py`` uses.
"""

import dataclasses
import json
import sys

import numpy as np

# a batch of 2 splits over the 2 x 2 mesh's data axis; h2o-danube's single
# sequence (as long_500k's) is whole on every rank
BATCH = {"h2o-danube-3-4b": 1}


def shapes_of(name: str) -> dict:
    b = BATCH.get(name, 2)
    return {"t": dict(kind="train", seq=16, batch=b),
            "p": dict(kind="prefill", seq=16, batch=b),
            "d": dict(kind="decode", seq=16, batch=b),
            "t8": dict(kind="train", seq=16, batch=b, moe_a2a_int8=True)}
DECODE_STEPS = 3


def run_arch(name: str, data, mesh) -> dict:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch
    from repro.launch import steps
    from repro.legacy import optim
    from repro.legacy.models import transformer as tfm

    arch = get_arch(name)
    arch = dataclasses.replace(arch, model=dataclasses.replace(
        arch.model, **arch.smoke), shapes=shapes_of(name))
    shapes = jax.eval_shape(lambda: tfm.init_params(jax.random.PRNGKey(0),
                                                    arch.model))
    leaves, tree = jax.tree.flatten(shapes)
    params = jax.tree.unflatten(tree, [jnp.asarray(data[f"{name}/param{i}"])
                                       for i in range(len(leaves))])
    toks = jnp.asarray(data[f"{name}/tokens"])
    labels = jnp.asarray(data[f"{name}/labels"])
    out = {}
    with mesh:
        cp = steps.build_cell(arch, "p", mesh)
        logits, cache = jax.jit(cp.fn, in_shardings=cp.in_shardings)(
            params, toks)
        out["p_logits"] = np.asarray(logits)
        out["p_k"], out["p_v"] = np.asarray(cache.k), np.asarray(cache.v)
        cd = steps.build_cell(arch, "d", mesh)
        step = jax.jit(cd.fn, in_shardings=cd.in_shardings)
        for i in range(DECODE_STEPS):
            logits, cache = step(params, cache, toks[:, i])
            out[f"d{i}_logits"] = np.asarray(logits)
        out["d_pos"] = np.asarray(cache.pos)
        out["d_k"] = np.asarray(cache.k)
        kinds = ["t"] + (["t8"] if arch.model.is_moe and
                         arch.model.n_shared_experts else [])
        for kind in kinds:
            ct = steps.build_cell(arch, kind, mesh)
            p2, o2, info = jax.jit(ct.fn, in_shardings=ct.in_shardings)(
                params, optim.init_adam(params),
                {"tokens": toks, "labels": labels})
            out[f"{kind}_loss"] = np.asarray(info["loss"])
            out[f"{kind}_gnorm"] = np.asarray(info["grad_norm"])
            for part, tr in (("param", p2), ("mu", o2.mu), ("nu", o2.nu)):
                for i, x in enumerate(jax.tree.leaves(tr)):
                    out[f"{kind}_{part}{i}"] = np.asarray(x)
    return out


def main(case_path: str, out_dir: str) -> int:
    from repro.launch.mesh import make_mesh_compat

    with open(case_path) as f:
        case = json.load(f)
    data = dict(np.load(case["inputs"]))
    for shape in case["meshes"]:
        mesh = make_mesh_compat(tuple(shape), ("data", "model"))
        tag = "x".join(map(str, shape))
        for name in case["archs"]:
            np.savez(f"{out_dir}/ref_{tag}_{name}.npz",
                     **run_arch(name, data, mesh))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))
