"""The port's ``connectit`` arch, its production cells and the dry run,
against the JAX package.

  * ``CONNECTIT_SHAPES``, ``ARCH_IDS`` and ``ConnectItConfig`` equal
    ``repro``'s key for key; the families still to port name their queue
    item;
  * each of the four cells, its shape dict cut to n = 2^10 and m = 2^13
    (the ingest cell: a 2^12-edge batch and 2^9 queries): ``repro``'s cell
    on its 1 x 1 smoke mesh under ``jax.jit`` on the CPU, and the port's at
    one in-process rank on the same seeded numpy edges; labels (and the
    ingest cell's answers) bit for bit, rounds exactly, and the placement
    each declares string for string;
  * the dry run's per-rank ``arg_bytes`` of every cell on the production
    meshes (16 x 16 and 2 x 16 x 16, shape-only) against sizes worked out
    by hand from ``CONNECTIT_SHAPES`` (the reference's production meshes
    need 512 fake devices, which this process cannot make), and the CLI;
  * a spawned world of 4 gloo ranks on a 2 x 2 ``(data, model)`` mesh
    (tests/torch_cells_worker.py, a ``FileStore`` under ``tmp_path``): every
    cell's gathered labels and rounds, and the ingest cell's answers to each
    rank's query block, on every rank equal ``repro``'s 1 x 1 run; and the
    legacy mesh factories of ``core/distributed.py`` (the settings of
    tests/test_torch_legacy.py) on the same world, their gathered labels
    (and ``make_streaming_ingest``'s answers) against ``repro``'s 1 x 1
    factory, or, for the fused round, whose hops read each rank's own
    proposals before the merge, the min over the two data blocks of
    ``repro``'s 1 x 1 step on each;
  * ``gpu``-marked: the cells on the card equal the CPU run.

``repro.launch.dryrun`` is not imported: it sets ``XLA_FLAGS`` at import.
"""

import dataclasses
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import base as jbase
from repro.configs import get_arch as jget_arch
from repro.core import distributed as jdist
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps

from repro_torch.configs import base as tbase
from repro_torch.configs import get_arch
from repro_torch.launch import dryrun, multihost
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps

REPO = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent
N, M = 1 << 10, 1 << 13
BATCH, QUERIES = 1 << 12, 1 << 9
SHAPES = list(jbase.CONNECTIT_SHAPES)


def _small(shapes: dict) -> dict:
    return {k: dict(v, n=N, m=M, batch=BATCH, queries=QUERIES)
            for k, v in shapes.items()}


def _inputs() -> dict:
    """Per cell, its global inputs at one rank: labels ``arange(n + 1)``
    and a symmetric seeded edge list, or the ingest cell's one-direction
    batch and query pairs."""
    rng = np.random.default_rng(7)
    u = rng.integers(0, N, M // 2).astype(np.int32)
    v = rng.integers(0, N, M // 2).astype(np.int32)
    u[-64:] = v[-64:] = N  # dump-padded tail
    s, r = np.concatenate([u, v]), np.concatenate([v, u])
    bu = rng.integers(0, N, BATCH).astype(np.int32)
    bv = rng.integers(0, N, BATCH).astype(np.int32)
    qa = rng.integers(0, N, QUERIES).astype(np.int32)
    qb = rng.integers(0, N, QUERIES).astype(np.int32)
    lab = np.arange(N + 1, dtype=np.int32)
    return {shape: ([lab, s, r] if spec["kind"] == "static"
                    else [lab, bu, bv, qa, qb])
            for shape, spec in jbase.CONNECTIT_SHAPES.items()}


INPUTS = _inputs()

# the legacy mesh factories and settings of tests/test_torch_legacy.py, on
# the 2 x 2 mesh: (edge axes[, label axis], keywords)
LEGACY_FACTORIES = {
    "make_replicated_step": (("data", "model"), {"jumps": 3}),
    "make_replicated_connectivity": (("data", "model"), {"rounds": 3}),
    "make_sharded_step": (("data",), "model", {}),
    "make_sharded_connectivity": (("data",), "model", {"rounds": 3}),
    "make_sharded_connectivity[rs]": (("data",), "model",
                                      {"rounds": 2,
                                       "use_reduce_scatter": True}),
    "make_sharded_step_fused": (("data",), "model", {"jumps": 3}),
    "make_sharded_connectivity_fused": (("data",), "model",
                                        {"rounds": 3, "jumps": 1}),
    "make_streaming_ingest": (("data", "model"), {"rounds": 2}),
}


def _legacy_inputs() -> dict:
    """Labels ``arange(n + 1)``, a symmetric seeded edge list with
    dump-padded slots, shuffled so that no rank's block mirrors another's,
    and query pairs (half of them edge ends)."""
    rng = np.random.default_rng(11)
    n, m = 300, 512
    u = rng.integers(0, n, m // 2).astype(np.int32)
    v = rng.integers(0, n, m // 2).astype(np.int32)
    u[-10:] = v[-10:] = n
    order = rng.permutation(m)
    s, r = np.concatenate([u, v])[order], np.concatenate([v, u])[order]
    qa, qb = (rng.integers(0, n + 1, 64).astype(np.int32) for _ in range(2))
    qa[:32], qb[:32] = s[:32], r[:32]
    return dict(labels=np.arange(n + 1, dtype=np.int32), s=s, r=r, qa=qa,
                qb=qb)


LEGACY = _legacy_inputs()


def _legacy_want(factory: str) -> tuple:
    """``repro``'s labels (and answers) for the factory's 2 x 2 run, from
    its 1 x 1 mesh."""
    *args, kw = LEGACY_FACTORIES[factory]
    name = factory.split("[")[0]
    jm = jmesh.make_smoke_mesh()
    lab, s, r, qa, qb = (jnp.asarray(LEGACY[k])
                         for k in ("labels", "s", "r", "qa", "qb"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        if name == "make_streaming_ingest":
            fn = jdist.make_streaming_ingest(jm, *args, **kw)
            return tuple(np.asarray(x) for x in fn(lab, s, r, qa, qb))
        if "fused" not in name:
            fn = getattr(jdist, name)(jm, *args, **kw)
            return (np.asarray(jax.jit(fn)(lab, s, r)),)
        step = jax.jit(jdist.make_sharded_step_fused(
            jm, *args, jumps=kw.get("jumps", 2)))
    # the fused round merges each data rank's hops over its own proposals:
    # a round is the min over the data blocks of the 1 x 1 step on each,
    # on the labels padded to two windows with a self-rooted slot
    P = jnp.arange(lab.shape[0] + 1, dtype=jnp.int32)
    half = s.shape[0] // 2
    for _ in range(kw.get("rounds", 1)):
        P = jnp.minimum(step(P, s[:half], r[:half]),
                        step(P, s[half:], r[half:]))
    return (np.asarray(P[: lab.shape[0]]),)
J_ARCH = dataclasses.replace(jget_arch("connectit"),
                             shapes=_small(jbase.CONNECTIT_SHAPES))
T_ARCH = dataclasses.replace(get_arch("connectit"),
                             shapes=_small(tbase.CONNECTIT_SHAPES))


def _jax_run(shape: str) -> tuple:
    cell = jsteps.build_cell(J_ARCH, shape, jmesh.make_smoke_mesh())
    return tuple(np.asarray(x) for x in
                 jax.jit(cell.fn)(*map(jnp.asarray, INPUTS[shape])))


@pytest.fixture(scope="module")
def jax_runs() -> dict:
    return {shape: _jax_run(shape) for shape in SHAPES}


def _env() -> dict:
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module", autouse=True)
def world(tmp_path_factory):
    """The 4-rank gloo world, started before the first test so that it runs
    beside the in-process tests; yields a function that waits for it."""
    tmp = tmp_path_factory.mktemp("cells")
    case = tmp / "case.json"
    inputs = {k: [x.tolist() for x in v] for k, v in INPUTS.items()}
    for k, spec in jbase.CONNECTIT_SHAPES.items():
        if spec.get("labels") == "sharded":  # padded to 2 label windows
            inputs[k][0] = list(range(N + 2))
    legacy = {"runs": {k: {"name": k.split("[")[0], "args": v[:-1],
                           "kw": v[-1]}
                       for k, v in LEGACY_FACTORIES.items()},
              **{k: v.tolist() for k, v in LEGACY.items()}}
    case.write_text(json.dumps({"world": 4, "store": str(tmp / "store"),
                                "shapes": T_ARCH.shapes, "inputs": inputs,
                                "legacy": legacy}))
    procs = [subprocess.Popen(
        [sys.executable, str(TESTS / "torch_cells_worker.py"), str(case),
         str(tmp / f"out{r}.json"), str(r)], env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]

    outs = []

    def wait() -> list:
        if not outs:
            for r, p in enumerate(procs):
                log, _ = p.communicate(timeout=240)
                assert p.returncode == 0, (r, log[-3000:])
                outs.append(json.loads((tmp / f"out{r}.json").read_text()))
        return outs

    yield wait
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()
    multihost.shutdown()


@pytest.fixture(scope="module")
def one_rank_mesh():
    multihost.initialize()
    return tmesh.make_smoke_mesh("cpu")


# ---------------------------------------------------------------------------
# The registry.
# ---------------------------------------------------------------------------

def test_connectit_shapes_match_repro():
    assert tbase.CONNECTIT_SHAPES == jbase.CONNECTIT_SHAPES
    assert list(tbase.CONNECTIT_SHAPES) == list(jbase.CONNECTIT_SHAPES)
    for k in jbase.CONNECTIT_SHAPES:
        assert list(tbase.CONNECTIT_SHAPES[k]) == \
            list(jbase.CONNECTIT_SHAPES[k])
    assert tbase.ARCH_IDS == jbase.ARCH_IDS
    arch, jarch = get_arch("connectit"), jget_arch("connectit")
    assert (arch.name, arch.family, arch.smoke) == \
        (jarch.name, jarch.family, jarch.smoke)
    assert dataclasses.asdict(arch.model) == dataclasses.asdict(jarch.model)
    assert arch.shape_names() == jarch.shape_names()
    assert all(arch.supports(s) for s in arch.shape_names())


@pytest.mark.parametrize("family", ["lm", "gnn"])
def test_unported_families_name_item_16(family):
    """The LM family is ported: its train cell builds at one rank and runs
    a step at the smoke config, and builds on a shape-only mesh (item 16's
    second part (b), done). The GNN family is ported (item 16's third
    part): its train cell builds and takes a step at the smoke config, and
    builds on a production mesh with its node features over the data axes
    and its edges over every axis."""
    from repro_torch import random as trandom
    from repro_torch.legacy import optim as toptim
    if family == "lm":
        from repro_torch.legacy.data import TokenStream
        from repro_torch.legacy.models import transformer as ttfm
        lm = get_arch("qwen3-4b")
        mesh = tmesh.make_production_mesh()
        cell = tsteps.build_cell(lm, "train_4k", mesh, device="meta")
        assert cell.in_shardings == (("data", None),) * 2
        assert cell.state_shardings[0]["layers"]["wk"] == \
            (None, "data", "model")
        cfg = dataclasses.replace(lm.model, **lm.smoke)
        arch = dataclasses.replace(lm, model=cfg, shapes={
            "s": dict(kind="train", seq=16, batch=2)})
        cell = tsteps.build_cell(arch, "s")
        assert cell.donate == (0, 1) and cell.meta["tokens"] == 32
        model = ttfm.init_transformer(cfg, key=trandom.PRNGKey(0,
                                                               device="cpu"))
        b = TokenStream(cfg.vocab, 2, 16).batch_at(0, device="cpu")
        _, state, info = cell.fn(model, toptim.init_adam(model.params()),
                                 b["tokens"], b["labels"])
        assert int(state.step) == 1 and bool(torch.isfinite(info["loss"]))
    else:
        from repro_torch.graphs import generators as tgen
        from repro_torch.legacy.models import gnn as tgnn
        gin = get_arch("gin-tu")
        cell = tsteps.build_cell(gin, "ogb_products",
                                 tmesh.make_production_mesh(), device="meta")
        assert cell.in_shardings == ({"feats": ("data", None)},
                                     (("data", "model"),),
                                     (("data", "model"),), ())
        cfg = dataclasses.replace(gin.model, **gin.smoke)
        g = tgen.rmat(64, 256, seed=0, device="cpu")
        arch = dataclasses.replace(gin, model=cfg, shapes={
            "s": dict(kind="full", n=g.n, m=g.m_pad, d_feat=8,
                      n_classes=3)})
        cell = tsteps.build_cell(arch, "s")
        assert cell.donate == (0, 1) and cell.meta["edges"] == 8192
        n = cell.args[0]["feats"].shape[0] - 1
        model = tgnn.init_gnn(tsteps.gnn_cell_config(arch, "s"),
                              key=trandom.PRNGKey(0, device="cpu"))
        s = torch.full((8192,), n, dtype=torch.int32)
        r = s.clone()
        s[: g.m_pad], r[: g.m_pad] = g.senders, g.receivers
        s = torch.where(s >= g.n, n, s)
        r = torch.where(r >= g.n, n, r)
        gen = torch.Generator().manual_seed(0)
        feats = {"feats": torch.randn(n + 1, 8, generator=gen)}
        labels = torch.randint(0, 3, (n,), generator=gen, dtype=torch.int32)
        _, state, info = cell.fn(model, toptim.init_adam(model.params()),
                                 feats, s, r, labels)
        assert int(state.step) == 1 and bool(torch.isfinite(info["loss"]))
    # the recsys family's train cell is built, and the dry run plans it
    cell = tsteps.build_cell(get_arch("dlrm-rm2"), "train_batch")
    assert cell.fn is tsteps.train_step and cell.donate == (0, 1)


@pytest.mark.parametrize("shape", SHAPES)
def test_exec_spec_matches_repro(one_rank_mesh, shape):
    spec = jbase.CONNECTIT_SHAPES[shape]
    want = jsteps._connectit_exec_spec(spec, jmesh.make_smoke_mesh())
    got = tsteps._connectit_exec_spec(spec, one_rank_mesh)
    assert str(got) == str(want)


# ---------------------------------------------------------------------------
# The cells at one rank against repro's 1 x 1 run.
# ---------------------------------------------------------------------------

def _port_run(shape: str, mesh, device="cpu") -> tuple:
    cell = tsteps.build_cell(T_ARCH, shape, mesh, device=device)
    args = INPUTS[shape]
    assert [tuple(a.shape) for a in cell.args] == [x.shape for x in args]
    assert all(a.device.type == "meta" for a in cell.args)
    out = cell.fn(*(torch.from_numpy(x).to(device) for x in args))
    return tuple(np.asarray(x.cpu() if torch.is_tensor(x) else x)
                 for x in out)


@pytest.mark.parametrize("shape", SHAPES)
def test_cell_matches_repro(jax_runs, one_rank_mesh, shape):
    want = jax_runs[shape]
    got = _port_run(shape, one_rank_mesh)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert int(got[-1]) == jbase.CONNECTIT_SHAPES[shape]["rounds"]
    # the labels are the partition's: the cells reach the fixpoint
    assert int((want[0][:N] != np.arange(N)).sum()) > 0


@pytest.mark.parametrize("shape", SHAPES)
def test_cell_meta_matches_repro(one_rank_mesh, shape):
    jc = jsteps.build_cell(jget_arch("connectit"), shape,
                           jmesh.make_smoke_mesh())
    tc = tsteps.build_cell(get_arch("connectit"), shape, one_rank_mesh,
                           device="cpu")
    assert tc.meta == jc.meta
    assert tc.donate == jc.donate
    assert [tuple(a.shape) for a in tc.args] == [a.shape for a in jc.args]
    assert [a.dtype for a in tc.args] == [torch.int32] * len(jc.args)


def test_spawned_2x2_world_matches_repro(world, jax_runs):
    outs = world()
    for rank, out in enumerate(outs):
        assert set(out) == set(SHAPES) | {"legacy"}
        for shape in SHAPES:
            assert out[shape]["mesh"] == [2, 2]
            np.testing.assert_array_equal(
                np.asarray(out[shape]["labels"])[: N + 1],
                jax_runs[shape][0][: N + 1], err_msg=f"{shape} rank {rank}")
            assert out[shape]["rounds"] == int(jax_runs[shape][-1])
            if "answers" in out[shape]:
                ans, lo = out[shape]["answers"], out[shape]["query_lo"]
                assert len(ans) == QUERIES // 4
                np.testing.assert_array_equal(
                    ans, jax_runs[shape][1][lo: lo + len(ans)],
                    err_msg=f"{shape} rank {rank} answers")
    # every rank answered its own quarter of the queries
    lows = sorted(out["ingest_256m_batch"]["query_lo"] for out in outs)
    assert lows == [i * QUERIES // 4 for i in range(4)]


@pytest.mark.parametrize("factory", list(LEGACY_FACTORIES))
def test_spawned_2x2_legacy_factories_match_repro(world, factory):
    want = _legacy_want(factory)
    outs = world()
    for rank, out in enumerate(outs):
        got = out["legacy"][factory]
        np.testing.assert_array_equal(got["labels"], want[0],
                                      err_msg=f"{factory} rank {rank}")
        if len(want) == 2:
            lo = got["query_lo"]
            np.testing.assert_array_equal(
                got["answers"], want[1][lo: lo + len(got["answers"])],
                err_msg=f"{factory} rank {rank} answers")
    assert (want[0] != LEGACY["labels"]).any()
    if len(want) == 2:
        assert sorted(out["legacy"][factory]["query_lo"] for out in outs) \
            == [0, 16, 32, 48]
        assert want[1].any() and not want[1].all()


# ---------------------------------------------------------------------------
# The dry run.
# ---------------------------------------------------------------------------

def _hand_arg_bytes(shape: str, multi: bool) -> int:
    """One rank's inputs, by hand: replicated labels of n + 1 int32 (the
    sharded ones padded to 16 windows), and the edge-aligned int32 arrays
    over every rank (the static replicated and ingest cells) or over the
    data ranks (pod x data; sharded)."""
    spec = jbase.CONNECTIT_SHAPES[shape]
    n, ranks = spec["n"], 512 if multi else 256
    if spec["kind"] == "ingest":
        return (4 * (n + 1) + 2 * 4 * spec["batch"] // ranks
                + 2 * 4 * spec["queries"] // ranks)
    if spec["labels"] == "replicated":
        return 4 * (n + 1) + 2 * 4 * spec["m"] // ranks
    n1 = -(-(n + 1) // 16) * 16
    return 4 * n1 // 16 + 2 * 4 * spec["m"] // (ranks // 16)


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("shape", SHAPES)
def test_dryrun_arg_bytes_by_hand(shape, multi):
    rec = dryrun.run_cell("connectit", shape, "multi" if multi else "single",
                          verbose=False)
    assert rec["status"] == "ok"
    assert rec["devices"] == (512 if multi else 256)
    assert rec["arg_bytes"] == _hand_arg_bytes(shape, multi)
    assert rec["fits"]
    spec = jbase.CONNECTIT_SHAPES[shape]
    edges = spec["m"] if spec["kind"] == "static" else spec["batch"]
    touched = spec["rounds"] * (edges * 8 + spec["n"] * 8)
    assert rec["memory_term_s"] == pytest.approx(
        touched / rec["devices"] / tmesh.HBM_BW)
    assert rec["compute_term_s"] == 0 and rec["dominant"] == "memory"


def test_dryrun_cli_plans_every_cell(tmp_path, capsys):
    out = tmp_path / "dryrun.csv"
    assert dryrun.main(["--all", "--mesh", "both", "--csv", str(out)]) == 0
    text = capsys.readouterr().out
    # the connectit and dlrm-rm2 cells (4 each), the 17 LM cells the archs
    # support (long_500k only on h2o-danube's sliding window) and the 20
    # GNN cells (4 archs x 5 shapes, per rank), on both meshes
    assert "DRY-RUN SUMMARY: 90 ok, 0 not ported, 0 failed" in text
    assert "NOT PORTED" not in text
    rows = out.read_text().splitlines()
    assert len(rows) == 91 and rows[0].startswith("arch,shape,mesh")


def test_dryrun_plans_the_dlrm_train_cell_by_hand():
    """A rank of the 16 x 16 mesh holds its 1/16 of each table's rows,
    the MLPs whole, AdamW's two moments (each the parameters' size), its
    int32 step and its 1/16 of the batch: ~1.26 GB of 80 (one card holding
    the whole cell would need ~20 GB)."""
    cfg = get_arch("dlrm-rm2").model
    rows = -(-(cfg.vocab_sizes[0] + 1) // 512) * 512
    params = 26 * rows // 16 * 64
    for widths in ((13, 512, 256, 64), (351 + 64, 512, 512, 256, 1)):
        params += sum(a * b + b for a, b in zip(widths[:-1], widths[1:]))
    B = 65536
    want = 3 * 4 * params + 4 + B // 16 * (13 + 26 + 1) * 4
    rec = dryrun.run_cell("dlrm-rm2", "train_batch", "single", verbose=False)
    assert (rec["status"], rec["devices"]) == ("ok", 256)
    assert rec["arg_bytes"] == want and rec["fits"]
    assert 1.2e9 < want < 1.3e9


def test_production_meshes_are_shapes_only():
    single = tmesh.make_production_mesh()
    multi = tmesh.make_production_mesh(multi_pod=True)
    assert (single.shape, single.mesh_dim_names) == ((16, 16),
                                                     ("data", "model"))
    assert (multi.shape, multi.mesh_dim_names) == (
        (2, 16, 16), ("pod", "data", "model"))
    assert (single.size(), multi.size()) == (256, 512)
    assert tmesh.data_axes(multi) == ("pod", "data")
    assert tmesh.all_axes(single) == ("data", "model")
    # the card's numbers, no TPU's
    assert (tmesh.HBM_BW, tmesh.PEAK_FLOPS_BF16, tmesh.NVLINK_BW) == \
        (3.35e12, 989e12, 450e9)


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES)
def test_cell_on_card_matches_cpu(cuda, one_rank_mesh, shape):
    want = _port_run(shape, one_rank_mesh)
    got = _port_run(shape, tmesh.make_smoke_mesh("cuda"), device="cuda")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
