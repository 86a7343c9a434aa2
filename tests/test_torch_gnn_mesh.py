"""The GNN cells on a mesh against the JAX package:

  * a 4-rank gloo world (``tests/torch_gnn_mesh_worker.py``, started
    before the first test so that it runs beside them) on a 2 x 2 and a
    1 x 4 ``(data, model)`` and a 2 x 2 x 1 ``(pod, data, model)`` mesh:
    one train step of every GNN arch's smoke cell on the full-graph,
    molecule, minibatch and ``spmd`` shapes of
    ``tests/test_torch_gnn_cells.py``, against ``repro``'s cell under
    ``jax.jit(in_shardings=...)`` on 4 forced host devices
    (``tests/repro_gnn_mesh_ref.py``, a subprocess a mesh): the loss within
    1e-5, every first moment (the clipped gradient) and parameter within
    1e-4 of its largest magnitude; PNA's ``spmd`` cell with ``model`` > 1
    against ``repro``'s 1 x 1 result, and a pin of the reference's own
    gap there;
  * ``scatter_max``'s forward and its gradient with a maximum reached on
    every rank (twice on one), against a numpy restatement;
  * the sampler's per-rank blocks: the union of the ranks' edges equals
    ``repro.graphs.sampler.sample_subgraph``'s global sample bit for bit;
  * ``Segments.of`` keeps the layouts of the views of one edge array
    (``local_block``) apart;
  * the dry run's per-rank ``arg_bytes`` of every GNN cell on both
    production meshes against the sum of the local blocks under
    ``repro``'s specs.
"""

import dataclasses
import json
import os
import subprocess
import sys
from math import prod
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import get_arch as jget_arch
from repro.graphs import generators as jgen
from repro.graphs import sampler as jsampler
from repro.launch import steps as jsteps
from repro.legacy.models import gnn as jgnn
from repro.legacy.models import nequip as jnequip
from repro.legacy import optim as joptim
from repro_torch.configs import get_arch
from repro_torch.graphs import sampler as tsampler
from repro_torch.kernels.segments import Segments
from repro_torch.launch import dryrun
from repro_torch.launch import shardings as tshd
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import ShapeMesh
from repro_torch.legacy.models import gnn as tgnn
from repro_torch.legacy.models import spmd

REPO = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent
sys.path.insert(0, str(TESTS))
from torch_gnn_mesh_worker import ties_case  # noqa: E402

jbase.load_all()
GNN_ARCHS = ["gin-tu", "pna", "egnn", "nequip"]
# tests/test_torch_gnn_cells.py's smoke shapes
SHAPES = {
    "full": dict(kind="full", n=200, m=900, d_feat=8, n_classes=3),
    "molecule": dict(kind="molecule", nodes=6, edges=8, batch=5, d_feat=8,
                     n_classes=2),
    "minibatch": dict(kind="minibatch", n=200, m=900, d_feat=8, n_classes=3,
                      batch=16, fanout=(3, 2)),
    "spmd": dict(kind="full", n=200, m=900, d_feat=8, n_classes=3,
                 spmd=True),
}
MESHES = [((2, 2), ("data", "model")), ((1, 4), ("data", "model")),
          ((2, 2, 1), ("pod", "data", "model"))]
CELLS = [(a, s) for a in GNN_ARCHS for s in SHAPES]
# the reference's 1 x 1 runs: its SPMD PNA gradient changes with the model
# axis (test_reference_spmd_pna_gradient_gap)
REF_1X1 = [["pna", "spmd"]]
LOSS_RTOL = 1e-5
LEAF_TOL = 1e-4   # of each leaf's largest magnitude
OPT = joptim.OptimizerConfig()


@pytest.fixture(autouse=True)
def _clear_jax_caches():
    """Shadow conftest's per-test cache clearing; cleared once a module."""
    yield


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_once():
    yield
    jax.clear_caches()


def _env(**extra) -> dict:
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    env.update(extra)
    return env


def _graph(spec: dict, n: int, m_pad: int, rng) -> tuple:
    """Edge arrays of ``m_pad`` slots (dump edges ``(n, n)`` past the
    graph's) and a CSR of the same RMAT graph, ``indptr`` of ``n + 2``."""
    g = jgen.rmat(spec["n"], spec["m"], seed=3)
    s = np.full(m_pad, n, np.int32)
    r = np.full(m_pad, n, np.int32)
    k = min(g.m, m_pad)
    s[:k], r[:k] = np.asarray(g.senders)[:k], np.asarray(g.receivers)[:k]
    s = np.where(s >= spec["n"], n, s).astype(np.int32)
    r = np.where(r >= spec["n"], n, r).astype(np.int32)
    indptr = np.zeros(n + 2, np.int32)
    indptr[: spec["n"] + 1] = np.asarray(g.indptr)[: spec["n"] + 1]
    indptr[spec["n"] + 1:] = indptr[spec["n"]]
    return s, r, indptr, np.asarray(g.indices)


def _cell_inputs(name: str, shape: str) -> list:
    """The port cell's inputs (numpy), seeded."""
    spec = SHAPES[shape]
    rng = np.random.default_rng(7)
    nequip = name == "nequip"
    dims = tsteps.gnn_cell_dims(spec)
    n, m_pad, n_real = dims["n"], dims["m_pad"], dims["n_real"]
    if shape == "molecule":
        s = np.full(m_pad, n, np.int32)
        r = np.full(m_pad, n, np.int32)
        nodes, per = spec["nodes"], spec["edges"]
        for b in range(spec["batch"]):
            u = rng.integers(0, nodes, per) + b * nodes
            v = rng.integers(0, nodes, per) + b * nodes
            e = 2 * per * b
            s[e: e + 2 * per] = np.concatenate([u, v])
            r[e: e + 2 * per] = np.concatenate([v, u])
        gids = np.full(n + 1, spec["batch"], np.int32)
        gids[:n_real] = np.repeat(np.arange(spec["batch"]), nodes)
    else:
        s, r, indptr, indices = _graph(spec, n, m_pad, rng)
    # the edge slots in a random order, so that every rank's block holds
    # real edges (the padding would leave all but the first block empty)
    perm = rng.permutation(m_pad)
    s, r = s[perm], r[perm]
    coords = rng.normal(size=(n + 1, 3)).astype(np.float32)
    if nequip:
        feats = {"species": rng.integers(0, 8, n + 1).astype(np.int32),
                 "coords": coords}
    else:
        feats = {"feats": rng.normal(size=(n + 1, spec["d_feat"]))
                 .astype(np.float32)}
        if get_arch(name).model.kind == "egnn":
            feats["coords"] = coords
    if shape == "minibatch":
        m_rows = tsteps.round_up(spec["m"], 8192)
        idx = np.full(m_rows, n, np.int32)
        idx[: int(indptr[-1])] = indices[: int(indptr[-1])]
        seeds = rng.integers(0, n_real, spec["batch"]).astype(np.int32)
        labels = rng.integers(0, spec["n_classes"], n).astype(np.int32)
        key = np.asarray(jax.random.PRNGKey(9)).astype(np.int64)
        return [feats, indptr, idx, seeds, labels, key]
    if shape == "spmd":
        a2 = feats["species"] if nequip else feats["feats"]
        targets = rng.normal(size=(1,)).astype(np.float32) if nequip else \
            rng.integers(0, spec["n_classes"], n + 1).astype(np.int32)
        return [a2, coords, s, r, targets]
    if nequip:
        targets = rng.normal(size=(dims["n_graphs"],)).astype(np.float32)
    else:
        targets = rng.integers(0, spec["n_classes"],
                               dims["n_graphs"] if shape == "molecule"
                               else n).astype(np.int32)
    return [feats, s, r, targets] + ([gids] if shape == "molecule" else [])


def _port_cfg(name: str, shape: str):
    arch = get_arch(name)
    arch = dataclasses.replace(arch, model=dataclasses.replace(
        arch.model, **arch.smoke), shapes={shape: SHAPES[shape]})
    return tsteps.gnn_cell_config(arch, shape)


def _write_inputs(path: Path) -> None:
    data = {}
    for name, shape in CELLS:
        cfg = dataclasses.asdict(_port_cfg(name, shape))
        key = jax.random.PRNGKey(0)
        if name == "nequip":
            p = jnequip.init_nequip(key, jnequip.NequIPConfig(**cfg))
        else:
            p = jgnn.init_gnn(key, jgnn.GNNConfig(**cfg))
        pre = f"{name}/{shape}/"
        for i, x in enumerate(jax.tree.leaves(p)):
            data[f"{pre}p{i}"] = np.asarray(x)
        for i, a in enumerate(_cell_inputs(name, shape)):
            if isinstance(a, dict):
                data.update({f"{pre}{i}/{k}": v for k, v in a.items()})
            else:
                data[f"{pre}{i}"] = a
    np.savez(path, **data)


@pytest.fixture(scope="module", autouse=True)
def world(tmp_path_factory):
    """Starts the 4-rank world and the reference; yields a function that
    waits for both and returns the output directory."""
    tmp = tmp_path_factory.mktemp("gnn_mesh")
    _write_inputs(tmp / "inputs.npz")
    shapes = {k: dict(v, **({"fanout": list(v["fanout"])}
                            if "fanout" in v else {}))
              for k, v in SHAPES.items()}
    case = tmp / "case.json"
    case.write_text(json.dumps({
        "world": 4, "store": str(tmp / "store"), "meshes": MESHES,
        "cells": CELLS, "shapes": shapes, "ref_only": REF_1X1,
        "inputs": str(tmp / "inputs.npz")}))
    procs = {r: subprocess.Popen(
        [sys.executable, str(TESTS / "torch_gnn_mesh_worker.py"), str(case),
         str(tmp), str(r)], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(4)}
    for i in range(len(MESHES)):  # the reference, a process a mesh
        procs[f"ref{i}"] = subprocess.Popen(
            [sys.executable, str(TESTS / "repro_gnn_mesh_ref.py"), str(case),
             str(tmp), str(i)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=_env(
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
# In process.
# ---------------------------------------------------------------------------

def test_segments_cache_keeps_views_of_one_edge_array_apart():
    """The blocks ``local_block`` takes of one global edge array are views
    of one storage: each gets its own layout, and a write to the array
    (one version counter for all views) makes each anew."""
    Segments.clear_cache()
    edges = torch.tensor([3, 0, 2, 2, 1, 0, 3, 1], dtype=torch.int32)
    mesh = ShapeMesh((2, 2), ("data", "model"))
    got = {}
    for d in range(2):
        for m in range(2):
            at = (d * 2 + m) * 2
            block = edges.narrow(0, at, 2)
            segs = Segments.of(block, 4)
            got[at] = segs
            want = np.argsort(block.numpy(), kind="stable")
            np.testing.assert_array_equal(segs.order.numpy(), want)
    assert len({id(s) for s in got.values()}) == 4
    assert tshd.local_shape((8,), (("data", "model"),), mesh) == (2,)
    # the whole array (the same address as block 0) has a layout of its own
    whole = Segments.of(edges, 4)
    assert whole is not got[0] and whole.ids.shape == (8,)
    # an in-place write bumps every view's version: sorted anew
    edges[0] = 1
    again = Segments.of(edges.narrow(0, 0, 2), 4)
    assert again is not got[0]
    np.testing.assert_array_equal(again.order.numpy(), [1, 0])  # [1, 0]
    Segments.clear_cache()


@pytest.mark.parametrize("blocks", [2, 4])
def test_sampler_blocks_are_the_global_sample(blocks):
    """Each rank samples its block of the seeds at its offset: hop by hop,
    the ranks' edges concatenate to ``repro``'s global sample."""
    spec = SHAPES["minibatch"]
    n = tsteps.gnn_cell_dims(spec)["n"]
    _, _, indptr, indices = _graph(spec, n, 8192, None)
    idx = np.full(8192, n, np.int32)
    idx[: int(indptr[-1])] = indices[: int(indptr[-1])]
    rng = np.random.default_rng(1)
    seeds = np.concatenate([rng.integers(0, spec["n"], 15), [n]]) \
        .astype(np.int32)
    key = jax.random.PRNGKey(9)
    fan = (3, 2)
    js, jr = (np.asarray(x) for x in jsampler.sample_subgraph(
        jnp.asarray(indptr), jnp.asarray(idx), jnp.asarray(seeds), key, fan))
    tkey = torch.from_numpy(np.asarray(key).astype(np.int64))
    per = seeds.shape[0] // blocks
    parts = [tsampler.sample_subgraph(
        torch.from_numpy(indptr), torch.from_numpy(idx),
        torch.from_numpy(seeds[b * per: (b + 1) * per]), tkey, fan,
        start=b * per) for b in range(blocks)]
    # the hops' blocks: hop 1 of F rows a rank, hop 2 of F·f0
    cut = [0, per * fan[0], per * fan[0] * (1 + fan[1])]
    B = seeds.shape[0]
    gcut = [0, B * fan[0], B * fan[0] * (1 + fan[1])]
    for h in range(2):
        for which, glob in ((0, js), (1, jr)):
            got = np.concatenate([p[which][cut[h]: cut[h + 1]].numpy()
                                  for p in parts])
            np.testing.assert_array_equal(got, glob[gcut[h]: gcut[h + 1]])


PROD = {"single": ((16, 16), ("data", "model")),
        "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _axes(spec) -> tuple:
    """A spec with each entry as a tuple of axis names (``P("data")`` and
    ``P(("data",))`` alike)."""
    return tuple(spmd.spec_axes(e) for e in spec)


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("name", GNN_ARCHS)
def test_dryrun_arg_bytes_match_repro_specs(name, mesh_kind):
    """Every GNN cell is planned per rank on both production meshes: its
    specs are the reference's (``repro``'s cell built on a one-device
    mesh with the production mesh's axis names), and its ``arg_bytes`` are
    one rank's blocks under them plus the whole parameters and AdamW
    state."""
    shape_, names = PROD[mesh_kind]
    tm = ShapeMesh(shape_, names)
    jm = jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(
        (1,) * len(names)), names)
    for shape in get_arch(name).shape_names():
        rec = dryrun.run_cell(name, shape, mesh_kind, verbose=False)
        assert rec["status"] == "ok", rec
        assert rec["devices"] == prod(shape_)
        tcell = tsteps.build_cell(get_arch(name), shape, tm, device="meta")
        jcell = jsteps.build_cell(jget_arch(name), shape, jm)
        want = tsteps.state_bytes(tcell, tm)
        for a, sh, js in zip(tcell.args, tcell.in_shardings,
                             jcell.in_shardings[2:]):
            pairs = [(a[k], sh[k], js[k]) for k in a] if isinstance(
                a, dict) else [(a, sh, js)]
            assert not isinstance(a, dict) or sorted(a) == sorted(js)
            for x, got, ref in pairs:
                assert _axes(got) == _axes(ref.spec), (shape, got, ref)
                want += prod(tshd.local_shape(tuple(x.shape), tuple(
                    ref.spec), tm)) * x.element_size()
        assert rec["arg_bytes"] == want, shape


# ---------------------------------------------------------------------------
# The spawned world against the reference.
# ---------------------------------------------------------------------------

def _outputs(world, mesh, name, shape, ref_mesh=None) -> tuple:
    tmp = world()
    tag = "x".join(map(str, mesh))
    rtag = "x".join(map(str, ref_mesh or mesh))
    return (np.load(tmp / f"{tag}_{name}_{shape}.npz"),
            np.load(tmp / f"ref_{rtag}_{name}_{shape}.npz"))


def _check_step(got, want) -> None:
    """The loss within LOSS_RTOL, the norm and every first moment (the
    clipped gradient) within LEAF_TOL of the largest magnitude; every
    parameter within LEAF_TOL of its largest plus AdamW's first step's
    magnification of the two gradients' difference (``lr · |g / (|g| +
    eps) - w / (|w| + eps)|``, as tests/test_torch_lm_mesh.py holds it: a
    bias that starts at 0 moves by ``lr`` in the sign of a gradient that
    may be a rounding away from 0)."""
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL,
                               atol=0)
    np.testing.assert_allclose(got["gnorm"], want["gnorm"], rtol=LEAF_TOL)
    n = sum(1 for k in want.files if k.startswith("param"))
    assert n == sum(1 for k in got.files if k.startswith("param"))
    lr = float(joptim.schedule_lr(OPT, jnp.int32(1)))
    for i in range(n):
        mu, wmu = got[f"mu{i}"], want[f"mu{i}"]
        assert mu.shape == wmu.shape, i
        scale = max(float(np.abs(wmu).max()), 1e-30)
        assert float(np.abs(mu - wmu).max()) <= LEAF_TOL * scale, (
            "mu", i, float(np.abs(mu - wmu).max()) / scale)
        g = mu.astype(np.float64) / (1 - OPT.beta1)
        w = wmu.astype(np.float64) / (1 - OPT.beta1)
        apart = lr * np.abs(g / (np.abs(g) + OPT.eps)
                            - w / (np.abs(w) + OPT.eps))
        p, wp = got[f"param{i}"], want[f"param{i}"]
        tol = LEAF_TOL * float(np.abs(wp).max()) + apart
        assert np.all(np.abs(p - wp) <= tol), ("param", i)


def _pna_spmd_on_model(mesh, name, shape) -> bool:
    return name == "pna" and shape == "spmd" and mesh[-1] > 1


WORLD = [(m, a, s) for m, _ in MESHES for a, s in CELLS]
IDS = [f"{'x'.join(map(str, m))}-{a}-{s}" for m, a, s in WORLD]


@pytest.mark.parametrize("mesh,name,shape", WORLD, ids=IDS)
def test_train_step_matches_repro(world, mesh, name, shape):
    """One step on the mesh against the reference's cell on the same
    mesh; PNA's ``spmd`` cell with ``model`` > 1 against the reference's
    1 x 1 result (its own gradient there is not the one-rank one: see
    test_reference_spmd_pna_gradient_gap)."""
    ref = (1, 1) if _pna_spmd_on_model(mesh, name, shape) else None
    _check_step(*_outputs(world, mesh, name, shape, ref))


def test_reference_spmd_pna_gradient_gap(world):
    """The reference's SPMD PNA on 2 x 2: layer 0's ``post`` gradient is
    more than 10% from its 1 x 1 gradient; the port's within LEAF_TOL."""
    tmp = world()
    got = np.load(tmp / "2x2_pna_spmd.npz")
    ref22 = np.load(tmp / "ref_2x2_pna_spmd.npz")
    ref11 = np.load(tmp / "ref_1x1_pna_spmd.npz")
    paths = [p for p, _ in tshd.tree_paths(tgnn.param_shapes(
        _port_cfg("pna", "spmd")))]
    post0 = [i for i, p in enumerate(paths) if p.startswith("layers/0/post")]
    assert post0
    gap = max(np.linalg.norm(ref22[f"mu{i}"] - ref11[f"mu{i}"])
              / np.linalg.norm(ref11[f"mu{i}"]) for i in post0)
    assert gap > 0.1
    for i in post0:
        scale = np.abs(ref11[f"mu{i}"]).max()
        assert np.abs(got[f"mu{i}"] - ref11[f"mu{i}"]).max() <= \
            LEAF_TOL * scale


@pytest.mark.parametrize("mesh", [m for m, _ in MESHES],
                         ids=["x".join(map(str, m)) for m, _ in MESHES])
def test_scatter_max_splits_ties_over_the_mesh(world, mesh):
    """The maximum of every rank's edges by row, and the gradient of
    ``sum(y * (row + 1))``: an even share to every entry equal to its
    row's maximum, on any rank (one rank's ``segment_max``'s)."""
    tmp = world()
    got = np.load(tmp / f"{'x'.join(map(str, mesh))}_ties.npz")
    ids, vals = map(np.concatenate, zip(*(map(np.asarray, ties_case(r))
                                          for r in range(4))))
    want_y = np.full(8, -1e30, np.float32)
    np.maximum.at(want_y, ids, vals.astype(np.float32))
    hit = vals == want_y[ids]
    cnt = np.bincount(ids[hit], minlength=8)
    want_g = np.where(hit, (ids + 1) / np.maximum(cnt[ids], 1), 0.0)
    np.testing.assert_array_equal(got["y"][:, 0], want_y)
    np.testing.assert_allclose(got["grad"][:, 0], want_g, rtol=1e-6)
    assert cnt[1] == 5  # row 1: five entries on four ranks
