"""The LM cells on a mesh against the JAX package:

  * ``launch.shardings.param_specs`` against ``repro.launch.shardings``'s,
    leaf for leaf, for the five LM archs at full size and DLRM-RM2 on the
    16 x 16, 2 x 16 x 16, 2 x 2 and 1 x 4 meshes (shape-only stand-ins:
    both read only a mesh's shape and axis names), FSDP off, on, and on
    with the train cell's ``fsdp_exclude``;
  * the dry run's per-rank ``arg_bytes`` of every LM cell on both
    production meshes against the sum of the local blocks under
    ``repro``'s specs (the parameters, a train cell's AdamW state, the
    batch, a decode cell's cache);
  * a DLRM cell on a mesh is refused, naming Queue 1 item 17;
  * a 4-rank gloo world (``tests/torch_lm_mesh_worker.py``, started before
    the first test so that it runs beside them) on a 2 x 2 and a 1 x 4
    ``(data, model)`` mesh, at the smoke configs of qwen3-4b,
    granite-moe-3b-a800m and deepseek-moe-16b (two sequences, split over
    the data axis) and h2o-danube-3-4b (one, whole on every rank, as
    long_500k's; its window's ring cache), against ``repro``'s cells
    under ``jax.jit(in_shardings=...)`` on 4 forced host devices
    (``tests/repro_lm_mesh_ref.py`` in a subprocess): prefill logits and
    the gathered cache, three decode steps, one train step's loss, global
    norm, gathered parameters and moments (float32, 1e-5; parameters with
    the two packages' gradients' AdamW term of
    ``tests/test_torch_lm_cells.py``); deepseek's int8 all_to_all step
    within 2% of ``repro``'s; the same train step with every leaf under
    FSDP; ``moe_apply_spmd`` against ``repro``'s ``moe_ref`` (rtol 5e-4,
    atol 5e-5 at capacity factor 8) and its int8 exchange within 2%.
"""

import dataclasses
import json
import os
import subprocess
import sys
from functools import lru_cache
from math import prod
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import base as jbase
from repro.configs import get_arch as jget_arch
from repro.launch import shardings as jshd
from repro.legacy import optim as joptim
from repro.legacy.models import moe as jmoe
from repro.legacy.models import transformer as jtfm
from repro_torch.configs import get_arch
from repro_torch.launch import dryrun
from repro_torch.launch import shardings as tshd
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import ShapeMesh
from repro_torch.legacy.data import TokenStream

REPO = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent

jbase.load_all()
LM_ARCHS = ["h2o-danube-3-4b", "qwen3-4b", "stablelm-3b", "deepseek-moe-16b",
            "granite-moe-3b-a800m"]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model"))}
FSDP = {"off": dict(fsdp=False), "on": dict(fsdp=True),
        "exclude": dict(fsdp=True,
                        fsdp_exclude=r"moe/(w_gate|w_up|w_down)$")}
# the spawned world's meshes and archs
WORLD_MESHES = [(2, 2), (1, 4)]
WORLD_ARCHS = ["qwen3-4b", "granite-moe-3b-a800m", "deepseek-moe-16b",
               "h2o-danube-3-4b"]
LM_TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = 1e-5
OPT = joptim.OptimizerConfig()


@pytest.fixture(autouse=True)
def _clear_jax_caches():
    """Shadow conftest's per-test cache clearing; cleared once a module."""
    yield


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_once():
    yield
    jax.clear_caches()


class _JMesh:
    """What ``repro.launch.shardings`` reads of a mesh: its shape by axis
    name and its axis names (no devices)."""

    def __init__(self, shape, names):
        self.shape = dict(zip(names, shape))
        self.axis_names = tuple(names)


# ---------------------------------------------------------------------------
# The spawned world and the reference, started before the first test.
# ---------------------------------------------------------------------------

def _env(**extra) -> dict:
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    env.update(extra)
    return env


def _smoke(name: str):
    arch = jget_arch(name)
    return dataclasses.replace(arch.model, **arch.smoke)


def _inputs(path: Path) -> None:
    data = {}
    for name in WORLD_ARCHS:
        cfg = _smoke(name)
        params = jtfm.init_params(jax.random.PRNGKey(0), cfg)
        for i, x in enumerate(jax.tree.leaves(params)):
            data[f"{name}/param{i}"] = np.asarray(x)
        # h2o-danube: one sequence (long_500k's), whole on every rank
        b = TokenStream(cfg.vocab, 1 if name == "h2o-danube-3-4b" else 2,
                        16, seed=1).batch_at(0, device="cpu")
        data[f"{name}/tokens"] = b["tokens"].numpy()
        data[f"{name}/labels"] = b["labels"].numpy()
    mcfg = jmoe.MoEConfig(d_model=32, d_expert=64, n_experts=16, top_k=2,
                          n_shared=1, capacity_factor=8.0)
    mp = jmoe.moe_init(jax.random.PRNGKey(1), mcfg)
    for path_, x in jax.tree_util.tree_leaves_with_path(mp):
        key = "/".join(str(p.key) for p in path_)
        data[f"moe/{key}"] = np.asarray(x)
    data["moe/x"] = np.asarray(jax.random.normal(jax.random.PRNGKey(2),
                                                 (64, 32), jnp.float32))
    np.savez(path, **data)


@pytest.fixture(scope="module", autouse=True)
def world(tmp_path_factory):
    """Starts the 4-rank world and the reference; yields a function that
    waits for both and returns the output directory."""
    tmp = tmp_path_factory.mktemp("lm_mesh")
    _inputs(tmp / "inputs.npz")
    case = tmp / "case.json"
    case.write_text(json.dumps({
        "world": 4, "store": str(tmp / "store"), "meshes": WORLD_MESHES,
        "archs": WORLD_ARCHS, "inputs": str(tmp / "inputs.npz")}))
    procs = {r: subprocess.Popen(
        [sys.executable, str(TESTS / "torch_lm_mesh_worker.py"), str(case),
         str(tmp), str(r)], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(4)}
    procs["ref"] = subprocess.Popen(
        [sys.executable, str(TESTS / "repro_lm_mesh_ref.py"), str(case),
         str(tmp)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=_env(
            XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    done = []

    def wait() -> Path:
        if not done:
            for key, p in procs.items():
                log, _ = p.communicate(timeout=400)
                assert p.returncode == 0, (key, log[-4000:])
            done.append(True)
        return tmp

    yield wait
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


# ---------------------------------------------------------------------------
# Specs and plans.
# ---------------------------------------------------------------------------

def _key_spec():
    return jax.ShapeDtypeStruct((2,), jnp.uint32)


@lru_cache(maxsize=None)
def _jshapes(name: str):
    arch = jget_arch(name)
    if arch.family == "lm":
        return jax.eval_shape(lambda k: jtfm.init_params(k, arch.model),
                              _key_spec())
    from repro.legacy.models import dlrm as jdlrm
    return jax.eval_shape(lambda k: jdlrm.init_dlrm(k, arch.model),
                          _key_spec())


def _as_shapes(tree):
    """The reference's shape tree as nested dicts and lists of tuples."""
    if isinstance(tree, dict):
        return {k: _as_shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_as_shapes(x) for x in tree]
    return tuple(tree.shape)


def _spec_list(tree) -> list:
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))


@pytest.mark.parametrize("fsdp", list(FSDP))
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", LM_ARCHS + ["dlrm-rm2"])
def test_param_specs_match_repro(name, mesh, fsdp):
    shape, names = MESHES[mesh]
    family = "lm" if name != "dlrm-rm2" else "recsys"
    shapes = _jshapes(name)
    want = _spec_list(jshd.param_specs(shapes, family, _JMesh(shape, names),
                                       **FSDP[fsdp]))
    got_tree = tshd.param_specs(_as_shapes(shapes), family,
                                ShapeMesh(shape, names), **FSDP[fsdp])
    got = tsteps.spec_leaves(got_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == tuple(w), (g, w)
    if family == "lm" and fsdp != "off":
        # AdamW's state: the step whole, mu and nu as the parameters
        oshapes = jax.eval_shape(joptim.init_adam, shapes)
        want = _spec_list(jshd.param_specs(
            oshapes, family, _JMesh(shape, names), **FSDP[fsdp]))
        assert want[0] == jax.sharding.PartitionSpec()
        assert [tuple(w) for w in want[1:]] == got * 2


def _block_bytes(shape, spec, mesh) -> int:
    return prod(tshd.local_shape(shape, spec, mesh))


def _ref_arg_bytes(name: str, shape_name: str, mesh_kind: str) -> int:
    """One rank's bytes of the reference's cell inputs under its specs:
    parameters (and a train cell's AdamW state), batch, cache."""
    arch = jget_arch(name)
    spec = arch.shapes[shape_name]
    shape, names = MESHES["2x16x16" if mesh_kind == "multi" else "16x16"]
    jm, tm = _JMesh(shape, names), ShapeMesh(shape, names)
    kind, B, S = spec["kind"], spec["batch"], spec["seq"]
    moe_fsdp = spec.get("moe_fsdp", kind == "train")
    excl = r"moe/(w_gate|w_up|w_down)$" if not moe_fsdp else None
    shapes = _jshapes(name)
    trees = [shapes]
    if kind == "train":
        trees.append(jax.eval_shape(joptim.init_adam, shapes))
    total = 0
    for tree in trees:
        specs = _spec_list(jshd.param_specs(tree, "lm", jm,
                                            fsdp=kind == "train",
                                            fsdp_exclude=excl))
        for leaf, sp in zip(jax.tree.leaves(tree), specs):
            total += _block_bytes(leaf.shape, tuple(sp), tm) \
                * leaf.dtype.itemsize
    dax = tuple(a for a in names if a in ("pod", "data"))
    gd = prod(jm.shape[a] for a in dax)
    b_loc = B // gd if B % gd == 0 else B
    if kind in ("train", "prefill"):
        total += 4 * b_loc * S * (2 if kind == "train" else 1)
    else:
        cache = jtfm.cache_spec(arch.model, B, S)
        b_c = B // gd if B > 1 else B
        per = cache.k.shape
        total += 2 * 2 * per[0] * b_c * (per[2] // jm.shape["model"]) \
            * per[3] * per[4] + 4 + 4 * b_loc
    return total


def _lm_cells():
    return [(a, s) for a in LM_ARCHS for s in get_arch(a).shape_names()
            if get_arch(a).supports(s)]


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("name,shape", _lm_cells())
def test_dryrun_arg_bytes_match_repro_specs(name, shape, mesh_kind):
    rec = dryrun.run_cell(name, shape, mesh_kind, verbose=False)
    assert rec["status"] == "ok"
    assert rec["devices"] == (256 if mesh_kind == "single" else 512)
    assert rec["arg_bytes"] == _ref_arg_bytes(name, shape, mesh_kind)


@pytest.mark.parametrize("mesh", ["2x2", "16x16"])
def test_recsys_cell_on_a_mesh_names_item_17(mesh):
    """The DLRM cells on a mesh are refused (they used to be built for one
    rank, whole inputs on every rank); at one rank they build as before."""
    arch = get_arch("dlrm-rm2")
    for shape in arch.shape_names():
        with pytest.raises(NotImplementedError,
                           match=r"ROADMAP Queue 1 item 17"):
            tsteps.build_cell(arch, shape, ShapeMesh(*MESHES[mesh]),
                              device="meta")
        cell = tsteps.build_cell(arch, shape, device="meta")
        assert all(sh == () for sh in cell.in_shardings)
    rec = dryrun.run_cell("dlrm-rm2", "train_batch", "single", verbose=False)
    assert (rec["status"], rec["devices"]) == ("ok", 1)


# ---------------------------------------------------------------------------
# The spawned world against the reference.
# ---------------------------------------------------------------------------

def _outputs(world, mesh, name) -> tuple:
    tmp = world()
    tag = "x".join(map(str, mesh))
    return (np.load(tmp / f"{tag}_{name}.npz"),
            np.load(tmp / f"ref_{tag}_{name}.npz"))


WORLD = [(m, a) for m in WORLD_MESHES for a in WORLD_ARCHS]
IDS = [f"{'x'.join(map(str, m))}-{a}" for m, a in WORLD]


@pytest.mark.parametrize("mesh,name", WORLD, ids=IDS)
def test_prefill_and_decode_match_repro(world, mesh, name):
    got, want = _outputs(world, mesh, name)
    for key in ("p_logits", "p_k", "p_v", "d0_logits", "d1_logits",
                "d2_logits", "d_k"):
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], want[key], err_msg=key,
                                   **LM_TOL)
    assert int(got["d_pos"]) == int(want["d_pos"]) == 16 + 3


def _check_step(got, want, kind: str, ref: str = None) -> None:
    """One train step: loss and norm 1e-5; each leaf's first moment (its
    clipped gradient) within GRAD_TOL of the largest, both moments within
    STEP_TOL; each parameter within STEP_TOL plus AdamW's first step's
    magnification of the two clipped gradients' difference."""
    ref = ref or kind
    np.testing.assert_allclose(got[f"{kind}_loss"], want[f"{ref}_loss"],
                               **LM_TOL)
    np.testing.assert_allclose(got[f"{kind}_gnorm"], want[f"{ref}_gnorm"],
                               **LM_TOL)
    n = sum(1 for k in want.files if k.startswith(f"{ref}_param"))
    lr = float(joptim.schedule_lr(OPT, jnp.int32(1)))
    for i in range(n):
        mu, wmu = got[f"{kind}_mu{i}"], want[f"{ref}_mu{i}"]
        assert np.abs(mu - wmu).max() <= GRAD_TOL * np.abs(wmu).max(), i
        for part in ("mu", "nu"):
            np.testing.assert_allclose(got[f"{kind}_{part}{i}"],
                                       want[f"{ref}_{part}{i}"],
                                       err_msg=f"{part}{i}", **STEP_TOL)
        g = mu.astype(np.float64) / (1 - OPT.beta1)
        w = wmu.astype(np.float64) / (1 - OPT.beta1)
        apart = lr * np.abs(g / (np.abs(g) + OPT.eps)
                            - w / (np.abs(w) + OPT.eps))
        p, wp = got[f"{kind}_param{i}"], want[f"{ref}_param{i}"]
        tol = STEP_TOL["atol"] + STEP_TOL["rtol"] * np.abs(wp) + apart
        assert np.all(np.abs(p - wp) <= tol), i


@pytest.mark.parametrize("mesh,name", WORLD, ids=IDS)
def test_train_step_matches_repro(world, mesh, name):
    got, want = _outputs(world, mesh, name)
    _check_step(got, want, "t")


@pytest.mark.parametrize("mesh", WORLD_MESHES,
                         ids=["x".join(map(str, m)) for m in WORLD_MESHES])
def test_every_leaf_under_fsdp_matches_repro(world, mesh):
    """deepseek's train step with every leaf split over the data axes
    (FSDP below 2^16 elements too): the reference's step values."""
    got, want = _outputs(world, mesh, "deepseek-moe-16b")
    _check_step(got, want, "t_fsdp", ref="t")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("mesh", WORLD_MESHES,
                         ids=["x".join(map(str, m)) for m in WORLD_MESHES])
def test_int8_a2a_step_within_2_percent(world, mesh):
    """deepseek's ``train_4k_int8a2a``-style step (int8 on the wire where
    the reference runs its explicit layer: more than one data shard)
    within 2% of ``repro``'s: loss, norm and every first moment."""
    got, want = _outputs(world, mesh, "deepseek-moe-16b")
    assert _rel(got["t8_loss"], want["t8_loss"]) < 0.02
    assert _rel(got["t8_gnorm"], want["t8_gnorm"]) < 0.02
    n = sum(1 for k in want.files if k.startswith("t8_param"))
    for i in range(n):
        assert _rel(got[f"t8_mu{i}"], want[f"t8_mu{i}"]) < 0.02, i
    if mesh == (1, 4):  # one data shard: the exact exchange, as repro's
        _check_step(got, want, "t8")


def test_moe_apply_spmd_matches_moe_ref(world):
    tmp = world()
    got = np.load(tmp / "2x2_moe.npz")
    data = np.load(tmp / "inputs.npz")
    cfg = jmoe.MoEConfig(d_model=32, d_expert=64, n_experts=16, top_k=2,
                         n_shared=1, capacity_factor=8.0)
    p = jmoe.moe_init(jax.random.PRNGKey(1), cfg)
    yr = np.asarray(jmoe.moe_ref(p, jnp.asarray(data["moe/x"]), cfg))
    np.testing.assert_allclose(got["exact"], yr, rtol=5e-4, atol=5e-5)
    assert _rel(got["int8"], yr) < 0.02
    assert _rel(got["int8"], got["exact"]) > 0  # the payload went as int8
