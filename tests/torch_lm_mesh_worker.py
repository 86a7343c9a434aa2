"""One rank of a spawned world running the port's LM cells on a mesh (a
helper of tests/test_torch_lm_mesh.py; it imports neither jax nor repro).

    python tests/torch_lm_mesh_worker.py CASE.json OUT_DIR RANK

``CASE.json`` names the world size, the rendezvous file, the meshes, the
archs and the inputs' ``.npz`` (each arch's global smoke parameters from
the reference's ``init_params(PRNGKey(0))``, the tokens and labels, and
an MoE layer's weights and tokens). For each mesh and arch every rank
builds the smoke cells on the mesh, takes its blocks, runs prefill, three
decode steps from its cache and one train step (deepseek: also the int8
all_to_all step, and every leaf under FSDP); rank 0 writes the gathered
results to ``OUT_DIR/<mesh>_<arch>.npz``. On the 2 x 2 mesh it also runs
``moe_apply_spmd`` exact and int8 (``<mesh>_moe.npz``).
"""

import dataclasses
import json
import sys

import numpy as np
import torch

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


def to_global(x: torch.Tensor, spec: tuple, mesh) -> np.ndarray:
    """The global array of this rank's block ``x`` laid out by ``spec``."""
    from repro_torch.legacy.models import spmd
    x = x.detach()
    for i, e in enumerate(spec):
        if e is not None:
            x = spmd.gather(x, mesh, i, spmd.spec_axes(e), summed=False)
    return x.numpy()


def run_arch(name: str, data, mesh) -> dict:
    from repro_torch.configs import get_arch
    from repro_torch.launch import shardings as shd
    from repro_torch.launch.steps import build_cell, lm_train_step
    from repro_torch.legacy import optim
    from repro_torch.legacy.models import transformer as tfm
    from repro_torch.legacy.models.spmd import spec_leaves, tree_rebuild
    from repro_torch.legacy.tree import leaves

    arch = get_arch(name)
    arch = dataclasses.replace(arch, model=dataclasses.replace(
        arch.model, **arch.smoke), shapes=shapes_of(name))
    cfg = arch.model
    n = len(tfm.shape_leaves(tfm.param_shapes(cfg)))
    gparams = tree_rebuild(tfm.param_shapes(cfg),
                           [data[f"{name}/param{i}"] for i in range(n)])
    toks = torch.from_numpy(data[f"{name}/tokens"])
    labels = torch.from_numpy(data[f"{name}/labels"])
    out = {}

    # prefill, then decode from its cache
    cp = build_cell(arch, "p", mesh, device="cpu")
    cd = build_cell(arch, "d", mesh, device="cpu")
    model = tfm.Transformer.from_params(gparams, cfg, device="cpu",
                                        mesh=mesh,
                                        specs=cp.state_shardings[0])
    logits, cache = cp.fn(model, shd.local_block(toks, cp.in_shardings[0],
                                                 mesh))
    bspec = cp.in_shardings[0][:1]
    cspec = cd.in_shardings[0].k
    out["p_logits"] = to_global(logits, bspec, mesh)
    out["p_k"] = to_global(cache.k, cspec, mesh)
    out["p_v"] = to_global(cache.v, cspec, mesh)
    for i in range(DECODE_STEPS):
        tok = shd.local_block(toks[:, i].contiguous(), cd.in_shardings[1],
                              mesh)
        logits, cache = cd.fn(model, cache, tok)
        out[f"d{i}_logits"] = to_global(logits, bspec, mesh)
    out["d_pos"] = np.asarray(int(cache.pos))
    out["d_k"] = to_global(cache.k, cspec, mesh)

    # one train step (deepseek: also the int8 exchange, and every leaf
    # under FSDP)
    kinds = ["t"] + (["t8", "t_fsdp"] if cfg.is_moe and
                     cfg.n_shared_experts else [])
    for kind in kinds:
        ct = build_cell(arch, "t" if kind == "t_fsdp" else kind, mesh,
                        device="cpu")
        specs = ct.state_shardings[0]
        if kind == "t_fsdp":
            specs = _all_fsdp(tfm.param_shapes(cfg), mesh)
        m = tfm.Transformer.from_params(gparams, cfg, device="cpu",
                                        mesh=mesh, specs=specs)
        state = optim.init_adam(m.params())
        tb, lb = (shd.local_block(x, ct.in_shardings[0], mesh)
                  for x in (toks, labels))
        if kind == "t_fsdp":
            groups = shd.extent(mesh, ("data",))
            tcfg = dataclasses.replace(cfg, moe_groups=groups,
                                       moe_fsdp=True)
            shard = shd.make_shard_fn(mesh, specs, batch=toks.shape[0])
            _, state, info = lm_train_step(m, state, tb, lb, tcfg,
                                           shard=shard)
        else:
            _, state, info = ct.fn(m, state, tb, lb)
        out[f"{kind}_loss"] = info["loss"].numpy()
        out[f"{kind}_gnorm"] = info["grad_norm"].numpy()
        sl = spec_leaves(specs)
        for part, tr in (("param", m.params()), ("mu", state.mu),
                         ("nu", state.nu)):
            for i, (x, sp) in enumerate(zip(leaves(tr), sl)):
                out[f"{kind}_{part}{i}"] = to_global(x, sp, mesh)
    return out


def _all_fsdp(shapes, mesh):
    """The train specs with every leaf over the data axes (FSDP below the
    reference's 2^16 elements too)."""
    from repro_torch.launch import shardings as shd
    keep, shd.FSDP_MIN = shd.FSDP_MIN, 0
    try:
        return shd.param_specs(shapes, "lm", mesh, fsdp=True)
    finally:
        shd.FSDP_MIN = keep


def run_moe(data, mesh) -> dict:
    from repro_torch.launch import shardings as shd
    from repro_torch.legacy.models import moe
    cfg = moe.MoEConfig(d_model=32, d_expert=64, n_experts=16, top_k=2,
                        n_shared=1, capacity_factor=8.0, n_groups=2)
    keys = ["router", "shared/w_down", "shared/w_gate", "shared/w_up",
            "w_down", "w_gate", "w_up"]
    shapes = {"moe": moe.param_shapes(cfg)}
    specs = _all_fsdp(shapes, mesh)
    p = {}
    for k in keys:
        x = torch.from_numpy(data[f"moe/{k}"])
        path = k.split("/")
        sp = specs["moe"]
        for part in path:
            sp = sp[part]
        d = p
        for part in path[:-1]:
            d = d.setdefault(part, {})
        d[path[-1]] = shd.local_block(x, sp, mesh).clone()
    x = torch.from_numpy(data["moe/x"])
    shard = shd.make_shard_fn(mesh, specs, batch=x.shape[0])
    xb = shd.local_block(x, shd.batch_spec(tuple(x.shape), mesh), mesh)
    out = {}
    for tag, c in (("exact", cfg), ("int8", dataclasses.replace(
            cfg, a2a_int8=True))):
        with torch.no_grad():
            y, aux = moe.moe_apply_spmd(p, specs["moe"], xb, c, shard)
        out[tag] = to_global(y, shd.batch_spec(tuple(x.shape), mesh), mesh)
        out[f"{tag}_aux"] = aux.numpy()
    return out


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
        data = dict(np.load(case["inputs"]))
        for shape in case["meshes"]:
            mesh = init_device_mesh("cpu", tuple(shape),
                                    mesh_dim_names=("data", "model"))
            tag = "x".join(map(str, shape))
            for name in case["archs"]:
                out = run_arch(name, data, mesh)
                if rank == 0:
                    np.savez(f"{out_dir}/{tag}_{name}.npz", **out)
            if tuple(shape) == (2, 2):
                out = run_moe(data, mesh)
                if rank == 0:
                    np.savez(f"{out_dir}/{tag}_moe.npz", **out)
    finally:
        multihost.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2], int(sys.argv[3])))
