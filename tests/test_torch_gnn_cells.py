"""The port's GNN cells, trainables, sampler and stream against
``repro.launch.steps``, ``repro.launch.train``, ``repro.graphs.sampler``
and ``repro.legacy.data``, and the ``segment_sum`` kernel's plain version
against ``jax.ops.segment_sum``:

  * ``GNN_SHAPES`` and the four GNN configs equal the reference's;
  * ``sample_neighbors`` / ``sample_subgraph`` and ``GraphNodeStream`` give
    the reference's draws bit for bit (degree-0 and dump seeds included);
  * ``build_cell`` of every GNN arch × shape plans on the ``meta`` device
    with the reference's meta and argument shapes; at the smoke configs a
    step of each kind of cell (full graph, molecule, minibatch, the
    one-rank ``spmd`` shape) matches the reference's jitted cell; on a mesh
    of more than one rank the cell builds with the reference's layout;
  * ``build_trainable``: three steps of each GNN arch within TOL of the
    reference's losses;
  * the dry run's per-rank plan of ``gin-tu × ogb_products``, worked out
    by hand;
  * ``segment_sum`` (the plain version and ``Segments``) against
    ``jax.ops.segment_sum``, ids out of range dropped; on the card (``gpu``)
    the kernel within the float32 reordering bound of the plain version,
    the same bits on a second run.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import get_arch as jget_arch
from repro.graphs import generators as jgen
from repro.graphs import sampler as jsampler
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.legacy import optim as joptim
from repro.legacy.data import GraphNodeStream as JGraphNodeStream
from repro.legacy.models import gnn as jgnn
from repro.legacy.models import nequip as jnequip
from repro_torch.configs import base as tbase
from repro_torch.configs import get_arch
from repro_torch.graphs import sampler as tsampler
from repro_torch.kernels import ops
from repro_torch.kernels.segment.ref import segment_sum_ref
from repro_torch.kernels.segments import Segments, gather, segment_sum
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.legacy import optim as toptim
from repro_torch.legacy.data import GraphNodeStream
from repro_torch.legacy.models import gnn as tgnn
from repro_torch.legacy.models import nequip as tnequip
from repro_torch.legacy.tree import leaves

jbase.load_all()

GNN_ARCHS = ["pna", "egnn", "gin-tu", "nequip"]
TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = 1e-5   # of each leaf's largest magnitude


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


# ---------------------------------------------------------------------------
# The registry.
# ---------------------------------------------------------------------------

def test_gnn_shapes_and_configs_match_repro():
    assert tbase.GNN_SHAPES == jbase.GNN_SHAPES
    assert list(tbase.GNN_SHAPES) == list(jbase.GNN_SHAPES)
    for name in GNN_ARCHS:
        a, j = get_arch(name), jget_arch(name)
        assert (a.family, a.smoke, a.shapes) == (j.family, j.smoke, j.shapes)
        assert dataclasses.asdict(a.model) == dataclasses.asdict(j.model)
        assert a.shape_names() == j.shape_names()
        assert all(a.supports(s) for s in a.shape_names())


# ---------------------------------------------------------------------------
# Sampling and the seed stream.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def csr():
    # a graph with degree-0 vertices (ids past the edges' range)
    g = jgen.rmat(300, 700, seed=4)
    return np.asarray(g.indptr), np.asarray(g.indices), g.n


@pytest.mark.parametrize("fanout", [1, 5])
def test_sample_neighbors_is_the_references(csr, fanout):
    indptr, indices, n = csr
    deg = np.diff(indptr)[:n]
    zero = np.flatnonzero(deg == 0)[:3]
    assert zero.size
    nodes = np.concatenate([np.arange(0, n, 7), zero, [n, n]]) \
        .astype(np.int32)
    key = jax.random.PRNGKey(11)
    want = jsampler.sample_neighbors(indptr, indices, nodes, key, fanout)
    got = tsampler.sample_neighbors(_t(indptr), _t(indices), _t(nodes),
                                    _t(np.asarray(key).astype(np.int64)),
                                    fanout)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # degree-0 and dump nodes emit dump edges
    per = got.numpy().reshape(-1, fanout)
    assert np.all(per[-2 - zero.size:] == n)


@pytest.mark.parametrize("step", [0, 3])
def test_graph_node_stream_and_subgraph_are_the_references(csr, step):
    indptr, indices, n = csr
    want = JGraphNodeStream(n_nodes=n, batch=32, seed=5).batch_at(step)
    got = GraphNodeStream(n_nodes=n, batch=32, seed=5).batch_at(
        step, device="cpu")
    assert got["seeds"].dtype == torch.int32
    np.testing.assert_array_equal(got["seeds"].numpy(),
                                  np.asarray(want["seeds"]))
    np.testing.assert_array_equal(got["key"].numpy(),
                                  np.asarray(want["key"]).astype(np.int64))
    seeds = np.concatenate([np.asarray(want["seeds"]), [n]]).astype(np.int32)
    js, jr = jsampler.sample_subgraph(indptr, indices, seeds, want["key"],
                                      (4, 3))
    ts, tr = tsampler.sample_subgraph(_t(indptr), _t(indices), _t(seeds),
                                      got["key"], (4, 3))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert ts.shape == (33 * 4 + 33 * 4 * 3,)


# ---------------------------------------------------------------------------
# The cells.
# ---------------------------------------------------------------------------

def _shapes(tree):
    return [tuple(x.shape) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("name", GNN_ARCHS)
def test_cell_meta_and_shapes_match_repro(name):
    jm = jmesh.make_smoke_mesh()
    for shape in tbase.GNN_SHAPES:
        jc = jsteps.build_cell(jget_arch(name), shape, jm)
        tc = tsteps.build_cell(get_arch(name), shape, device="meta")
        assert tc.meta == jc.meta and tc.donate == jc.donate == (0, 1)
        assert all(x.device.type == "meta" for a in tc.args
                   for x in leaves(a))
        # the reference's args are (params, opt_state, *inputs): the port
        # keeps the first two in ``state``
        jp, jo, *jin = jc.args
        assert [tuple(x.shape) for x in leaves(tc.state[0])] == _shapes(jp)
        assert [tuple(x.shape) for x in leaves(tc.state[1])] == _shapes(jo)
        assert len(tc.args) == len(jin)
        for a, b in zip(tc.args, jin):
            if isinstance(b, dict):
                assert sorted(a) == sorted(b)
                a, b = [a[k] for k in sorted(a)], [b[k] for k in sorted(b)]
            for x, y in zip(leaves(a), jax.tree.leaves(b)):
                assert tuple(x.shape) == tuple(y.shape)
                # the key is a (2,) int64 threefry key in the port
                assert (str(x.dtype).split(".")[-1], y.dtype.name) in (
                    ("float32", "float32"), ("int32", "int32"),
                    ("int64", "uint32"))


def test_cells_on_a_mesh_name_item_16_part_b():
    """Item 16's third part (b) is done: every GNN cell builds on both
    production meshes with the reference's layout (node features over the
    data axes, edges over every axis, NequIP's species and coordinates
    whole, minibatch seeds over the data axes), and plans per rank; the
    cells run on spawned meshes in tests/test_torch_gnn_mesh.py."""
    for multi in (False, True):
        mesh = tmesh.make_production_mesh(multi_pod=multi)
        dax = ("pod", "data") if multi else "data"
        every = ("pod", "data", "model") if multi else ("data", "model")
        for name in GNN_ARCHS:
            for shape in get_arch(name).shape_names():
                cell = tsteps.build_cell(get_arch(name), shape, mesh,
                                         device="meta")
                feats, *rest = cell.in_shardings
                kind = get_arch(name).shapes[shape]
                if kind.get("spmd"):  # the features as one array
                    assert feats == (() if name == "nequip" else (dax, None))
                elif name == "nequip":
                    assert feats == {"species": (), "coords": ()}
                else:
                    assert feats["feats"] == (dax, None)
                if kind["kind"] == "minibatch":
                    assert rest[2] == (dax,) and rest[0] == rest[1] == ()
                elif kind.get("spmd"):
                    assert rest[1:3] == [(every,), (every,)]
                else:
                    assert rest[:2] == [(every,), (every,)]
                assert all(sp == () for sp in tsteps.spec_leaves(
                    cell.state_shardings[0]))


SMOKE_SHAPES = {
    "full": dict(kind="full", n=200, m=900, d_feat=8, n_classes=3),
    "molecule": dict(kind="molecule", nodes=6, edges=8, batch=5, d_feat=8,
                     n_classes=2),
    "minibatch": dict(kind="minibatch", n=200, m=900, d_feat=8, n_classes=3,
                      batch=16, fanout=(3, 2)),
    "spmd": dict(kind="full", n=200, m=900, d_feat=8, n_classes=3,
                 spmd=True),
}


def _smoke(name, shape):
    ja, ta = jget_arch(name), get_arch(name)
    shapes = {shape: SMOKE_SHAPES[shape]}
    return (dataclasses.replace(ja, model=dataclasses.replace(
                ja.model, **ja.smoke), shapes=shapes),
            dataclasses.replace(ta, model=dataclasses.replace(
                ta.model, **ta.smoke), shapes=shapes))


def _cell_inputs(name, shape, cell):
    """numpy inputs of the port's cell ``cell`` (its meta args), seeded."""
    spec = SMOKE_SHAPES[shape]
    rng = np.random.default_rng(7)
    nequip = name == "nequip"
    dims = tsteps.gnn_cell_dims(spec)
    n, m_pad = dims["n"], dims["m_pad"]
    n_real = dims["n_real"]
    if shape == "molecule":
        nodes, per = spec["nodes"], spec["edges"]
        gid = np.repeat(np.arange(spec["batch"]), nodes)
        s = np.full(m_pad, n, np.int32)
        r = np.full(m_pad, n, np.int32)
        e = 0
        for b in range(spec["batch"]):
            u = rng.integers(0, nodes, per) + b * nodes
            v = rng.integers(0, nodes, per) + b * nodes
            s[e: e + 2 * per] = np.concatenate([u, v])
            r[e: e + 2 * per] = np.concatenate([v, u])
            e += 2 * per
        gids = np.full(n + 1, spec["batch"], np.int32)
        gids[:n_real] = gid
    else:
        g = jgen.rmat(spec["n"], spec["m"], seed=3)
        s = np.full(m_pad, n, np.int32)
        r = np.full(m_pad, n, np.int32)
        k = min(g.m, m_pad)
        s[:k], r[:k] = np.asarray(g.senders)[:k], np.asarray(g.receivers)[:k]
        s = np.where(s >= spec["n"], n, s).astype(np.int32)
        r = np.where(r >= spec["n"], n, r).astype(np.int32)
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
        g = jgen.rmat(spec["n"], spec["m"], seed=3)
        indptr = np.zeros(n + 2, np.int32)
        indptr[: spec["n"] + 1] = np.asarray(g.indptr)[: spec["n"] + 1]
        indptr[spec["n"] + 1:] = indptr[spec["n"]]
        indices = np.full(cell.args[2].shape[0], n, np.int32)
        deg_total = int(indptr[-1])
        indices[:deg_total] = np.asarray(g.indices)[:deg_total]
        seeds = rng.integers(0, n_real, spec["batch"]).astype(np.int32)
        labels = rng.integers(0, spec["n_classes"], n).astype(np.int32)
        key = np.asarray(jax.random.PRNGKey(9))
        return (feats, indptr, indices, seeds, labels, key)
    if shape == "spmd":
        a2 = feats["species"] if nequip else feats["feats"]
        targets = rng.normal(size=(1,)).astype(np.float32) if nequip else \
            rng.integers(0, spec["n_classes"], n + 1).astype(np.int32)
        return (a2, coords, s, r, targets)
    if nequip:
        targets = rng.normal(size=(dims["n_graphs"],)).astype(np.float32)
    else:
        targets = rng.integers(0, spec["n_classes"],
                               dims["n_graphs"] if shape == "molecule"
                               else n).astype(np.int32)
    return (feats, s, r, targets) + ((gids,) if shape == "molecule" else ())


def _to_torch(x):
    if isinstance(x, dict):
        return {k: _to_torch(v) for k, v in x.items()}
    if x.dtype == np.uint32:  # a threefry key
        return _t(x.astype(np.int64))
    return _t(x)


@pytest.mark.parametrize("name,shape", [
    ("gin-tu", "full"), ("gin-tu", "molecule"), ("gin-tu", "minibatch"),
    ("gin-tu", "spmd"), ("pna", "full"), ("egnn", "molecule"),
    ("nequip", "molecule"), ("nequip", "spmd")])
def test_smoke_cell_step_matches_repro(name, shape):
    ja, ta = _smoke(name, shape)
    mesh = jmesh.make_smoke_mesh()
    jcell = jsteps.build_cell(ja, shape, mesh)
    tcell = tsteps.build_cell(ta, shape)
    inputs = _cell_inputs(name, shape, tcell)
    mcfg = tsteps.gnn_cell_config(ta, shape)
    if name == "nequip":
        jp = jnequip.init_nequip(jax.random.PRNGKey(0), mcfg)
        model = tnequip.NequIP.from_params(jax.tree.map(np.asarray, jp),
                                           mcfg, device="cpu")
    else:
        jp = jgnn.init_gnn(jax.random.PRNGKey(0),
                           jgnn.GNNConfig(**dataclasses.asdict(mcfg)))
        model = tgnn.GNN.from_params(jax.tree.map(np.asarray, jp), mcfg,
                                     device="cpu")
    with mesh:
        jp2, jo2, jinfo = jax.jit(jcell.fn)(
            jp, joptim.init_adam(jp), *jax.tree.map(jnp.asarray, inputs))
    _, state, info = tcell.fn(model, toptim.init_adam(model.params()),
                              *(_to_torch(x) for x in inputs))
    np.testing.assert_allclose(float(info["loss"]), float(jinfo["loss"]),
                               **TOL)
    np.testing.assert_allclose(float(info["grad_norm"]),
                               float(jinfo["grad_norm"]), **TOL)
    assert int(state.step) == int(jo2.step) == 1
    for a, b in zip(jax.tree.leaves((jp2, jo2.mu)),
                    leaves((model.params(), state.mu))):
        a, b = np.asarray(a, np.float64), b.detach().double().numpy()
        assert np.abs(a - b).max() <= STEP_TOL * max(np.abs(a).max(), 1e-30)


@pytest.mark.parametrize("name", GNN_ARCHS)
def test_build_trainable_three_steps_match_repro(name):
    jp, jo, jstep, jdata = jtrain.build_trainable(name, seed=0)
    model, state, step_fn, data_fn = ttrain.build_trainable(name, seed=0,
                                                            device="cpu")
    for step in range(3):
        jp, jo, jl = jstep(jp, jo, jdata(step))
        model, state, tl = step_fn(model, state, data_fn(step))
        np.testing.assert_allclose(float(tl), float(jl), **TOL)
    assert int(state.step) == 3


def test_train_cli_runs_a_gnn_arch(tmp_path, capsys):
    _, losses = ttrain.train("egnn", 3, log_every=1, device="cpu")
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert "[train] step=2" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# The dry run.
# ---------------------------------------------------------------------------

def test_dryrun_plans_gin_ogb_products_by_hand():
    """gin-tu × ogb_products per rank: n = round_up(2,449,029 + 1, 512) - 1
    = 2,449,407 node rows plus the dump, m_pad = round_up(61,859,140,
    8,192) = 61,865,984 edge slots. A rank's inputs: its block of the
    float32 features (n + 1) x 100 over the data axes (16, or 2 x 16), its
    block of the two int32 edge arrays over every rank (256, or 512), the
    int32 targets (n,) whole. State, whole on every rank: the parameters
    (five layers, 100 -> 64 -> 64 then four of 64 -> 64 -> 64, each with
    eps; the head 64 -> 64 -> 47), AdamW's two moments of them, the int32
    step. model_flops = 6 m_pad · 64 · 5 over the ranks."""
    n, m_pad = 2_449_407, 61_865_984
    layer0 = 100 * 64 + 64 + 64 * 64 + 64 + 1
    layer = 64 * 64 + 64 + 64 * 64 + 64 + 1
    head = 64 * 64 + 64 + 64 * 47 + 47
    n_params = layer0 + 4 * layer + head
    for mesh_kind, gd, world in (("single", 16, 256), ("multi", 32, 512)):
        rec = dryrun.run_cell("gin-tu", "ogb_products", mesh_kind,
                              verbose=False)
        assert rec["status"] == "ok" and rec["devices"] == world
        inputs = 4 * ((n + 1) // gd * 100 + 2 * m_pad // world + n)
        assert rec["arg_bytes"] == inputs + 3 * 4 * n_params + 4
        flops = 6 * m_pad * 64 * 5 / world
        assert rec["model_flops_per_dev"] == flops
        assert rec["bytes_per_dev"] == inputs
        assert rec["compute_term_s"] == pytest.approx(
            flops / tmesh.PEAK_FLOPS_BF16)
        assert rec["memory_term_s"] == pytest.approx(inputs / tmesh.HBM_BW)
        assert rec["dominant"] == "memory" and rec["fits"]


# ---------------------------------------------------------------------------
# segment_sum.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", [1, 3, 16, 75])
def test_segment_sum_plain_matches_jax_dropping_out_of_range(width):
    rng = np.random.default_rng(width)
    m, R = 500, 37
    ids = rng.integers(-4, R + 4, m).astype(np.int32)  # some out of range
    vals = rng.normal(size=(m, width)).astype(np.float32)
    want = np.asarray(jax.ops.segment_sum(vals, ids, R))
    segs = Segments(_t(ids), R)
    assert not segs.all_valid
    assert int(segs.offsets[-1]) == int(((ids >= 0) & (ids < R)).sum())
    got = ops.segment_sum(_t(vals), segs.order, segs.offsets)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(
        segment_sum_ref(_t(vals), segs.order, segs.offsets).numpy(), want,
        **TOL)
    # autograd: the gradient of a sum is the gather, zero where dropped
    v = _t(vals).requires_grad_(True)
    out = segment_sum(v, segs)
    w = rng.normal(size=(R, width)).astype(np.float32)
    (g,) = torch.autograd.grad((out * _t(w)).sum(), v)
    jg = jax.grad(lambda x: jnp.sum(jax.ops.segment_sum(x, ids, R) * w))(
        vals)
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    # the empty segments are zero
    empty = np.setdiff1d(np.arange(R), ids)
    assert np.all(got.numpy()[empty] == 0)


def test_gather_gradient_is_a_segment_sum():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(20, 4)).astype(np.float32)
    ids = rng.integers(0, 20, 300).astype(np.int32)
    w = rng.normal(size=(300, 4)).astype(np.float32)
    xt = _t(x).requires_grad_(True)
    (g,) = torch.autograd.grad((gather(xt, Segments.of(_t(ids), 20))
                                * _t(w)).sum(), xt)
    jg = jax.grad(lambda a: jnp.sum(a[ids] * w))(x)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), **TOL)
    with pytest.raises(ValueError, match="gather"):
        gather(xt, Segments(_t(ids), 19))


def test_segments_are_sorted_once_per_id_array():
    ids = torch.tensor([3, 1, 1, 0], dtype=torch.int32)
    a = Segments.of(ids, 4)
    assert Segments.of(ids, 4) is a           # cached
    assert Segments.of(ids, 5) is not a       # another segment count
    ids[0] = 2                                # an in-place write
    b = Segments.of(ids, 4)
    assert b is not a and b.order.tolist() == [3, 1, 2, 0]
    assert b.offsets.tolist() == [0, 1, 3, 4, 4]


def test_segment_sum_wrapper_rejects_what_it_cannot_take():
    fn = ops.KERNELS["segment_sum"]
    before = fn.launches
    vals = torch.zeros(6, 4)
    order = torch.arange(6, dtype=torch.int32)
    offsets = torch.tensor([0, 3, 6], dtype=torch.int32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fn(vals.double(), order, offsets)
    with pytest.raises(ValueError, match="contiguous"):
        fn(vals.t(), order, offsets)
    with pytest.raises(ValueError, match="CUDA device"):
        fn(vals, order, offsets)          # on the CPU
    with pytest.raises(TypeError, match="int32"):
        fn(vals, order.long(), offsets)
    assert fn.launches == before


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [1, 3, 16, 64, 100, 160])
def test_segment_sum_kernel_matches_plain_on_card(cuda, dtype, width):
    """Rows of 0 to ~2,000 entries (a hub) with ids out of range: the kernel
    against the plain version in float64 within the float32 reordering
    bound (m eps sum|x| a row, and one rounding to bfloat16), the same bits
    on a second run, one launch a call."""
    gen = torch.Generator(device="cuda").manual_seed(width)
    m, R = 200_000, 5_000
    ids = torch.randint(-10, R + 10, (m,), generator=gen, device=cuda,
                        dtype=torch.int32)
    ids[:2000] = 17                      # a hub
    vals = torch.randn(m, width, generator=gen, device=cuda).to(dtype)
    segs = Segments(ids, R)
    before = ops.KERNELS["segment_sum"].launches
    got = ops.segment_sum(vals, segs.order, segs.offsets)
    again = ops.segment_sum(vals, segs.order, segs.offsets)
    torch.cuda.synchronize()
    assert ops.KERNELS["segment_sum"].launches == before + 2
    assert got.dtype == dtype and torch.equal(got, again)
    want = segment_sum_ref(vals.double(), segs.order, segs.offsets)
    absum = segment_sum_ref(vals.double().abs(), segs.order, segs.offsets)
    counts = (segs.offsets[1:] - segs.offsets[:-1]).double()[:, None]
    bound = counts * 2.0 ** -24 * absum
    if dtype == torch.bfloat16:
        bound = bound + 2.0 ** -8 * want.abs()
    assert bool(((got.double() - want).abs() <= bound + 1e-30).all())
