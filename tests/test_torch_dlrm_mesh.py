"""The DLRM cells on a mesh against the JAX package, and the row windows of
the ``embedding_bag`` forward and backward they run on:

  * a 4-rank gloo world (``tests/torch_dlrm_mesh_worker.py``, started
    before the first test so that it runs beside them) on a 2 x 2 and a
    1 x 4 ``(data, model)`` and a 2 x 2 x 1 ``(pod, data, model)`` mesh:
    26 tables of 1,000 ids at D = 16, two ids a bag (wrapped negatives
    among them, other ids in every data block), the serve cell, the
    retrieval cell over 4,096 candidates and one train step, against
    ``repro``'s ``_dlrm_cell`` under ``jax.jit(in_shardings=...)`` on 4
    forced host devices (``tests/repro_dlrm_mesh_ref.py``, a subprocess a
    mesh): probabilities within 1e-5; the top-100 indices equal and the
    values within 1e-6, with tied (zero) scores in several ranks' blocks;
    the loss and global norm within 1e-5, every first moment (the clipped
    gradient) and parameter within 1e-5 of its largest magnitude; the
    tables of ``init_dlrm(key, mesh=, specs=)`` the one-rank init's rows;
  * in process: the windowed plain forward summed over 2 and 4 windows
    (cut mid-range) equal to the whole table's bag (``torch.equal`` at
    L = 1, the float32 reordering bound at L = 4), the windowed plain
    backward's shards concatenated equal to the whole table's gradient,
    wrapped and clamped ids among them; ``mean`` and ``max`` refusing a
    window; the dispatcher's autograd route keeping the windows for the
    backward; the chunked restatement of the kernel's order against the
    plain backward; ``random.normal(start=)`` a block of the whole draw;
  * the dry run's per-rank ``arg_bytes`` of every DLRM cell on both
    production meshes against the local blocks under ``repro``'s specs;
  * the windowed kernel on the card: ``tests/test_torch_bags.py``'s
    ``gpu`` cases.
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
from repro.launch import steps as jsteps
from repro.legacy import optim as joptim
from repro.legacy.models import dlrm as jdlrm
from repro_torch import random as trandom
from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.kernels.legacy import embedding_bags, embedding_bags_backward
from repro_torch.kernels.legacy.embedding_bag.ref import (
    embedding_bag_backward_ref,
    embedding_bag_ref,
    embedding_bags_backward_chunked_ref,
    wrap_and_clamp,
)
from repro_torch.launch import dryrun
from repro_torch.launch import shardings as tshd
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import ShapeMesh
from repro_torch.legacy.models import dlrm as tdlrm
from repro_torch.legacy.models import spmd

REPO = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent
sys.path.insert(0, str(TESTS))
from torch_dlrm_mesh_worker import SHAPES, arch_of  # noqa: E402

jbase.load_all()
MESHES = [((2, 2), ("data", "model")), ((1, 4), ("data", "model")),
          ((2, 2, 1), ("pod", "data", "model"))]
MESH_IDS = ["x".join(map(str, m)) for m, _ in MESHES]
PROB_TOL = 1e-5
SCORE_TOL = 1e-6
LOSS_RTOL = 1e-5
LEAF_TOL = 1e-5   # of each leaf's largest magnitude
OPT = joptim.OptimizerConfig()
# candidates: this many score above 0, and this many are zero rows in each
# 1,024-row block (the top-100's ties, ordered by index across ranks)
N_POSITIVE = 40
ZEROS_A_BLOCK = 20


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


def _jcfg() -> jdlrm.DLRMConfig:
    return arch_of(jget_arch).model


def _candidates(params, q_dense, q_sparse, n: int, rng) -> np.ndarray:
    """``n`` candidate rows: N_POSITIVE score above the query by at least
    0.01, ZEROS_A_BLOCK zero rows (score 0) in every block of 1,024, the
    rest below it by at least 0.01."""
    q = jdlrm.mlp_apply(params["bot"], jnp.asarray(q_dense),
                        act=jax.nn.relu, final_act=jax.nn.relu)[0]
    for i, t in enumerate(params["tables"]):
        q = q + jdlrm.embedding_bag(t, jnp.asarray(q_sparse[:, i]))[0]
    q = np.asarray(q)
    cand = rng.normal(size=(n, q.shape[0])).astype(np.float32)
    score = cand @ q
    while (small := np.abs(score) < 0.01).any():
        cand[small] = rng.normal(size=(int(small.sum()), q.shape[0]))
        score = cand @ q
    positive = rng.choice(n, N_POSITIVE, replace=False)
    sign = np.where(score > 0, -1.0, 1.0).astype(np.float32)
    sign[positive] *= -1.0
    cand *= sign[:, None]
    zeros = np.concatenate([
        b + rng.choice(1024, ZEROS_A_BLOCK, replace=False)
        for b in range(0, n, 1024)])
    cand[np.setdiff1d(zeros, positive)] = 0.0
    return cand


def _write_inputs(path: Path) -> None:
    cfg = _jcfg()
    params = jdlrm.init_dlrm(jax.random.PRNGKey(0), cfg)
    data = {f"param{i}": np.asarray(x)
            for i, x in enumerate(jax.tree.leaves(params))}
    rng = np.random.default_rng(5)
    B = SHAPES["train"]["batch"]
    rows = tdlrm.table_rows(cfg.vocab_sizes[0])
    data["dense"] = rng.normal(size=(B, cfg.n_dense)).astype(np.float32)
    # wrapped negatives (jnp.take's, the port's wrap); no id at or past
    # the table, which repro's take fills with NaN
    sparse = rng.integers(-rows, cfg.vocab_sizes[0],
                          (B, cfg.n_sparse, cfg.multi_hot)).astype(np.int32)
    sparse[0, :, 0] = -1      # the dump row
    sparse[1, :, 1] = rows - 2
    data["sparse"] = sparse
    data["labels"] = (rng.random(B) < 0.3).astype(np.int32)
    data["q_dense"] = data["dense"][:1] * 2.0
    data["q_sparse"] = sparse[5:6]
    data["cand"] = _candidates(params, data["q_dense"], data["q_sparse"],
                               SHAPES["retrieval"]["n_candidates"], rng)
    np.savez(path, **data)


@pytest.fixture(scope="module", autouse=True)
def world(tmp_path_factory):
    """Starts the 4-rank world and the reference; yields a function that
    waits for both and returns the output directory."""
    tmp = tmp_path_factory.mktemp("dlrm_mesh")
    _write_inputs(tmp / "inputs.npz")
    case = tmp / "case.json"
    case.write_text(json.dumps({
        "world": 4, "store": str(tmp / "store"), "meshes": MESHES,
        "inputs": str(tmp / "inputs.npz")}))
    procs = {r: subprocess.Popen(
        [sys.executable, str(TESTS / "torch_dlrm_mesh_worker.py"),
         str(case), str(tmp), str(r)], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(4)}
    for i in range(len(MESHES)):  # the reference, a process a mesh
        procs[f"ref{i}"] = subprocess.Popen(
            [sys.executable, str(TESTS / "repro_dlrm_mesh_ref.py"),
             str(case), str(tmp), str(i)], stdout=subprocess.PIPE,
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
# The spawned world against the reference.
# ---------------------------------------------------------------------------

def _outputs(world, mesh) -> tuple:
    tmp = world()
    tag = "x".join(map(str, mesh))
    return np.load(tmp / f"{tag}.npz"), np.load(tmp / f"ref_{tag}.npz")


@pytest.mark.parametrize("mesh", [m for m, _ in MESHES], ids=MESH_IDS)
def test_serve_cell_matches_repro(world, mesh):
    got, want = _outputs(world, mesh)
    assert got["serve_p"].shape == (SHAPES["serve"]["batch"],)
    np.testing.assert_allclose(got["serve_p"], want["serve_p"],
                               rtol=PROB_TOL, atol=PROB_TOL)


@pytest.mark.parametrize("mesh", [m for m, _ in MESHES], ids=MESH_IDS)
def test_retrieval_cell_takes_repros_top_k_order(world, mesh):
    """The top-100: N_POSITIVE scores above 0, then zero scores in index
    order, from the blocks of more than one rank."""
    got, want = _outputs(world, mesh)
    np.testing.assert_array_equal(got["ret_idx"], want["ret_idx"])
    np.testing.assert_allclose(got["ret_vals"], want["ret_vals"],
                               rtol=SCORE_TOL, atol=SCORE_TOL)
    tied = got["ret_idx"][got["ret_vals"] == 0]
    assert len(tied) == 100 - N_POSITIVE
    assert np.all(np.diff(tied) > 0) and len(set(tied // 1024)) >= 3


@pytest.mark.parametrize("mesh", [m for m, _ in MESHES], ids=MESH_IDS)
def test_train_step_matches_repro(world, mesh):
    """The loss and global norm within LOSS_RTOL; every first moment (the
    clipped gradient) within LEAF_TOL of its largest magnitude, and every
    parameter within LEAF_TOL of its largest plus AdamW's first step's
    magnification of the two gradients' difference (``lr · |g / (|g| +
    eps) - w / (|w| + eps)|``, as tests/test_torch_gnn_mesh.py holds
    it)."""
    got, want = _outputs(world, mesh)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL,
                               atol=0)
    np.testing.assert_allclose(got["gnorm"], want["gnorm"], rtol=LOSS_RTOL)
    n = sum(1 for k in want.files if k.startswith("param"))
    assert n == sum(1 for k in got.files if k.startswith("param")) == 38
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


@pytest.mark.parametrize("mesh", [m for m, _ in MESHES], ids=MESH_IDS)
def test_mesh_init_draws_the_one_rank_rows(world, mesh):
    """``init_dlrm(key, mesh=, specs=)``: each rank draws only its rows of
    each table, which gathered are the one-rank init's bit for bit."""
    got, _ = _outputs(world, mesh)
    cfg = tdlrm.DLRMConfig(**dataclasses.asdict(_jcfg()))
    one = tdlrm.init_dlrm(cfg, key=trandom.PRNGKey(3, device="cpu"))
    for t, table in enumerate(one.tables):
        assert np.array_equal(got[f"init{t}"], table.detach().numpy()), t


# ---------------------------------------------------------------------------
# In process: the row windows.
# ---------------------------------------------------------------------------

def _bag_case(rows: int, D: int, B: int, L: int, seed: int) -> tuple:
    """A float32 table with tied rows, ids with wrapped negatives, the dump
    row, ids at and past the table and below -rows (the clamp), and the
    (B, D) cotangent."""
    rng = np.random.default_rng(seed)
    table = np.round(rng.normal(size=(rows, D)), 1).astype(np.float32)
    table[3] = table[rows - 7]
    idx = rng.integers(-rows, rows, size=(B, L)).astype(np.int32)
    idx[0, 0], idx[1, 0], idx[2, 0] = rows - 1, rows, rows + 9
    idx[3, 0], idx[4, 0] = -rows - 5, -1
    g = rng.normal(size=(B, D)).astype(np.float32)
    return (torch.from_numpy(table), torch.from_numpy(idx),
            torch.from_numpy(g))


# windows that cut a 1,000-row table mid-range (and evenly)
CUTS = {2: (0, 613, 1000), 4: (0, 97, 500, 811, 1000)}


@pytest.mark.parametrize("L", [1, 4])
@pytest.mark.parametrize("n", [2, 4])
def test_windowed_plain_bags_sum_to_the_whole_tables(n, L):
    table, idx, _ = _bag_case(1000, 8, 300, L, seed=n + L)
    whole = embedding_bag_ref(table, idx)
    cuts = CUTS[n]
    parts = [embedding_bag_ref(table[a:b], idx, row_lo=a, rows_global=1000)
             for a, b in zip(cuts[:-1], cuts[1:])]
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    if L == 1:  # one window holds the row: a copy plus zeros
        assert torch.equal(total, whole)
        # the clamped last row lives in the last window alone
        assert torch.equal(parts[-1][1], whole[1]) and not parts[0][1].any()
    else:  # the windows' partial sums, added in window order
        mag = table[wrap_and_clamp(idx, 1000)].abs().sum(dim=1)
        bound = 2 * (L - 1) * 2.0 ** -24 * mag
        assert bool(((total - whole).abs() <= bound).all())


@pytest.mark.parametrize("L", [1, 4])
@pytest.mark.parametrize("n", [2, 4])
def test_windowed_plain_backward_is_the_whole_gradient_cut(n, L):
    table, idx, g = _bag_case(1000, 8, 300, L, seed=10 + n + L)
    whole = embedding_bag_backward_ref(table, idx, g)
    cuts = CUTS[n]
    parts = [embedding_bag_backward_ref(table[a:b], idx, g, row_lo=a,
                                        rows_global=1000)
             for a, b in zip(cuts[:-1], cuts[1:])]
    assert [p.shape[0] for p in parts] == list(np.diff(cuts))
    assert torch.equal(torch.cat(parts), whole)


@pytest.mark.parametrize("mode", ["mean", "max"])
def test_a_window_takes_sum_bags_only(mode):
    table, idx, g = _bag_case(1000, 8, 20, 2, seed=1)
    with pytest.raises(ValueError, match="sum bags only"):
        embedding_bag_ref(table[:500], idx, mode, row_lo=0, rows_global=1000)
    with pytest.raises(ValueError, match="sum bags only"):
        embedding_bag_backward_ref(table[500:], idx, g, mode, row_lo=500,
                                   rows_global=1000)
    with pytest.raises(ValueError, match="sum bags only"):
        embedding_bags([table[:500]], idx[None], mode=mode,
                       windows=[(0, 1000)])
    with pytest.raises(ValueError, match="does not lie"):
        embedding_bag_ref(table[:500], idx, row_lo=600, rows_global=1000)
    # the whole table as its own window is the one-rank call
    assert torch.equal(embedding_bag_ref(table, idx, mode, row_lo=0,
                                         rows_global=1000),
                       embedding_bag_ref(table, idx, mode))


def test_dispatcher_keeps_the_windows_for_the_backward():
    """``embedding_bags(windows=)`` through the autograd function: the bags
    and the gradients are the windowed plain versions', table by table;
    nothing is launched on the CPU."""
    cases = [_bag_case(1000, 8, 50, 2, seed=s) for s in range(3)]
    wins = [(0, 1000), (250, 1000), (613, 1000)]
    blocks = [c[0][lo:lo + 387].clone().requires_grad_(True)
              for c, (lo, _) in zip(cases, wins)]
    idx = torch.stack([c[1] for c in cases])
    before = ops.launch_counts()
    outs = embedding_bags(blocks, idx, windows=wins)
    torch.autograd.backward(outs, [c[2] for c in cases])
    assert ops.launch_counts() == before
    for b, c, (lo, whole), out in zip(blocks, cases, wins, outs):
        assert torch.equal(out, embedding_bag_ref(
            b.detach(), c[1], row_lo=lo, rows_global=whole))
        assert torch.equal(b.grad, embedding_bag_backward_ref(
            b.detach(), c[1], c[2], row_lo=lo, rows_global=whole))
    grads = embedding_bags_backward([b.detach() for b in blocks], idx,
                                    [c[2] for c in cases], windows=wins)
    assert all(torch.equal(a, b.grad) for a, b in zip(grads, blocks))


@pytest.mark.parametrize("windows", [False, True])
def test_chunked_restatement_is_the_plain_backward_reordered(windows):
    """The kernel's order in plain torch: within the reordering bound of
    ``index_add_``, and its bits where every row's positions lie in one
    chunk (here: fewer than CHUNK positions in all)."""
    cases = [_bag_case(r, 6, 300, 2, seed=r) for r in (50, 1000, 700)]
    tables = [c[0] for c in cases]
    wins = [(5, 50), (100, 1000), (0, 700)] if windows else None
    if windows:
        tables = [t[lo:lo + 40] for t, (lo, _) in zip(tables, wins)]
    idx = torch.stack([c[1] for c in cases])
    idx[0, 100:, 0] = 7  # a hub over several chunks
    g = [c[2] for c in cases]
    kw = [dict(row_lo=lo, rows_global=wh) for lo, wh in wins] if windows \
        else [{}] * 3
    got = embedding_bags_backward_chunked_ref(tables, idx, g, wins)
    for t in range(3):
        want = embedding_bag_backward_ref(tables[t], idx[t], g[t], **kw[t])
        mag = embedding_bag_backward_ref(tables[t], idx[t], g[t].abs(),
                                         **kw[t])
        assert bool(((got[t] - want).abs() <= 2 * 300 * 2.0 ** -24 * mag)
                    .all())
    small = embedding_bags_backward_chunked_ref(tables, idx[:, :20],
                                                [x[:20] for x in g], wins)
    for t in range(3):
        assert torch.equal(small[t], embedding_bag_backward_ref(
            tables[t], idx[t, :20], g[t][:20], **kw[t]))


def test_normal_from_an_offset_is_a_block_of_the_draw():
    key = trandom.PRNGKey(7, device="cpu")
    whole = trandom.normal(key, (96, 16))
    block = trandom.normal(key, (40, 16), start=33 * 16)
    assert torch.equal(block, whole[33:73])


# ---------------------------------------------------------------------------
# Plans.
# ---------------------------------------------------------------------------

PROD = {"single": ((16, 16), ("data", "model")),
        "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _axes(spec) -> tuple:
    return tuple(spmd.spec_axes(e) for e in spec)


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
def test_dryrun_arg_bytes_match_repro_specs(mesh_kind):
    """Every DLRM cell is planned per rank on both production meshes: its
    inputs' specs are the reference's (``repro``'s cell on a one-device
    mesh with the production axis names; every split divides), its state
    specs ``repro``'s ``param_specs``, and its ``arg_bytes`` one rank's
    blocks of the inputs, the parameters and a train cell's AdamW state."""
    shape_, names = PROD[mesh_kind]
    tm = ShapeMesh(shape_, names)
    jm = jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(
        (1,) * len(names)), names)
    arch, jarch = get_arch("dlrm-rm2"), jget_arch("dlrm-rm2")
    for shape in arch.shape_names():
        rec = dryrun.run_cell("dlrm-rm2", shape, mesh_kind, verbose=False)
        assert rec["status"] == "ok" and rec["devices"] == prod(shape_)
        tcell = tsteps.build_cell(arch, shape, tm, device="meta")
        jcell = jsteps.build_cell(jarch, shape, jm)
        n_state = 2 if shape == "train_batch" else 1
        want = 0
        for tree, specs, jshard in zip(tcell.state, tcell.state_shardings,
                                       jcell.in_shardings[:n_state]):
            leaves = [x for _, x in spmd.tree_paths(tree)]
            jspecs = jax.tree.leaves(jshard, is_leaf=lambda s: isinstance(
                s, jax.sharding.NamedSharding))
            assert len(leaves) == len(jspecs) == len(spmd.spec_leaves(specs))
            for x, sp, js in zip(leaves, spmd.spec_leaves(specs), jspecs):
                assert _axes(sp) == _axes(js.spec), (shape, sp, js.spec)
                want += prod(tshd.local_shape(tuple(x.shape), tuple(
                    js.spec), tm)) * x.element_size()
        for a, sh, js in zip(tcell.args, tcell.in_shardings,
                             jcell.in_shardings[n_state:]):
            assert _axes(sh) == _axes(js.spec), (shape, sh, js.spec)
            want += prod(tshd.local_shape(tuple(a.shape), tuple(js.spec),
                                          tm)) * a.element_size()
        assert rec["arg_bytes"] == want, shape
        assert tsteps.state_bytes(tcell, tm) + tsteps.local_bytes(
            tcell, tm) == want
