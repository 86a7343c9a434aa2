"""The port's GIN, PNA and EGNN against ``repro.legacy.models.gnn`` at the
archs' ``smoke`` overrides (float32), on ``rmat(512, 2048)`` (the graph
``build_trainable`` uses) and on a hand-made graph with duplicate edges
and dump edges: ``init_gnn`` from ``PRNGKey(0)``, logits and coordinates,
the loss, every gradient leaf and one AdamW step (the reference's weights
carried across by ``GNN.from_params``), the node and graph readouts with a
label mask, ``remat`` on and off, EGNN's E(n) equivariance, and PNA's max
and min where a receiver's messages tie or are all the ``-1e30`` fill.

Tolerances: init within INIT_ULPS of ``jax.random.normal``'s draws;
logits, coordinates and losses within TOL (float32 sums in another
order); a gradient or stepped leaf within GRAD_TOL of its largest.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.graphs import generators as jgen
from repro.legacy import optim as joptim
from repro.legacy.models import gnn as jgnn
from repro_torch import random as trandom
from repro_torch.configs import get_arch
from repro_torch.legacy import optim as toptim
from repro_torch.legacy.models import gnn as tgnn
from repro_torch.legacy.models.spmd import tree_paths
from repro_torch.legacy.tree import leaves

jbase.load_all()

ARCHS = {"gin": "gin-tu", "pna": "pna", "egnn": "egnn"}
INIT_ULPS = 4
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = 1e-5
D_IN, N_CLASSES = 16, 4


def _cfg(kind: str, **kw) -> tgnn.GNNConfig:
    arch = get_arch(ARCHS[kind])
    return dataclasses.replace(arch.model, **arch.smoke, d_in=D_IN,
                               n_classes=N_CLASSES, **kw)


def _jcfg(cfg: tgnn.GNNConfig) -> jgnn.GNNConfig:
    return jgnn.GNNConfig(**dataclasses.asdict(cfg))


def _hand_graph():
    """8 nodes + dump: duplicate edges beside one other in-edge (receivers
    1, 3 and 7: two distinct messages, so the copies are every column's
    max or min, a tie), nodes with no in-edge (4, 5, 6), and dump edges
    (sender and receiver 8) at the end."""
    s = [0, 0, 0, 5, 2, 2, 4, 6, 6, 3, 1, 3, 8, 8, 8, 8]
    r = [1, 1, 1, 1, 3, 3, 3, 7, 7, 7, 0, 2, 8, 8, 8, 8]
    return np.asarray(s, np.int32), np.asarray(r, np.int32), 8


@pytest.fixture(scope="module")
def graphs():
    g = jgen.rmat(512, 2048, seed=0)
    out = {"rmat": (np.asarray(g.senders), np.asarray(g.receivers), g.n),
           "hand": _hand_graph()}
    rng = np.random.default_rng(0)
    inputs = {}
    for name, (s, r, n) in out.items():
        n1 = n + 1
        inputs[name] = dict(
            s=s, r=r, n=n,
            feats=rng.normal(size=(n1, D_IN)).astype(np.float32),
            coords=rng.normal(size=(n1, 3)).astype(np.float32),
            labels=rng.integers(0, N_CLASSES, size=(n,)).astype(np.int32),
            mask=(rng.random(n) < 0.7).astype(np.float32))
    return inputs


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _models(cfg):
    jparams = jgnn.init_gnn(jax.random.PRNGKey(0), _jcfg(cfg))
    model = tgnn.GNN.from_params(jax.tree.map(np.asarray, jparams), cfg,
                                 device="cpu")
    return jparams, model


def _close_leaves(got, want, tol=GRAD_TOL):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("kind", ["gin", "pna", "egnn"])
def test_init_matches_repro(kind):
    cfg = _cfg(kind)
    jparams = jgnn.init_gnn(jax.random.PRNGKey(0), _jcfg(cfg))
    model = tgnn.init_gnn(cfg, key=trandom.PRNGKey(0, device="cpu"))
    got, want = leaves(model.params()), jax.tree.leaves(jparams)
    assert [tuple(x.shape) for x in got] == [x.shape for x in want]
    for a, b in zip(want, got):
        ulps = np.abs(np.asarray(a).view(np.int32).astype(np.int64)
                      - b.detach().numpy().view(np.int32).astype(np.int64))
        assert int(ulps.max()) <= INIT_ULPS
    assert [tuple(x.shape) for x in got] == [
        s for _, s in tree_paths(tgnn.param_shapes(cfg))]


def _kw(kind, x, with_coords=True):
    return dict(coords=x["coords"] if kind == "egnn" and with_coords
                else None)


@pytest.mark.parametrize("graph", ["rmat", "hand"])
@pytest.mark.parametrize("kind", ["gin", "pna", "egnn"])
def test_forward_loss_grads_and_step_match_repro(graphs, kind, graph):
    x = graphs[graph]
    cfg = _cfg(kind)
    jcfg = _jcfg(cfg)
    jparams, model = _models(cfg)
    jlog, jx = jax.jit(lambda p: jgnn.gnn_forward(
        p, jcfg, x["feats"], x["s"], x["r"], **_kw(kind, x)))(jparams)
    with torch.no_grad():
        tlog, tx = model(_t(x["feats"]), _t(x["s"]), _t(x["r"]),
                         coords=_t(x["coords"]) if kind == "egnn" else None)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    assert tlog.dtype == torch.float32
    if kind == "egnn":
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)

    def jloss(p):
        return jgnn.gnn_loss(p, jcfg, x["feats"], x["s"], x["r"],
                             x["labels"], **_kw(kind, x))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jparams)
    params = model.params()
    tl = tgnn.gnn_loss(params, cfg, _t(x["feats"]), _t(x["s"]), _t(x["r"]),
                       _t(x["labels"]),
                       coords=_t(x["coords"]) if kind == "egnn" else None)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    tg = torch.autograd.grad(tl, leaves(params), allow_unused=True,
                             materialize_grads=True)
    _close_leaves([g.numpy() for g in tg], jax.tree.leaves(jg))
    # one AdamW step each from the same state, on each one's gradients
    ocfg = dict(lr=1e-3, warmup_steps=10, total_steps=1000)
    jp, jstate, _ = jax.jit(lambda p, g: joptim.update(
        joptim.OptimizerConfig(**ocfg), p, g, joptim.init_adam(p)))(
            jparams, jg)
    _, tstate, _ = toptim.update(
        toptim.OptimizerConfig(**ocfg), params,
        toptim.tree_unflatten(params, tg), toptim.init_adam(params))
    _close_leaves([p.detach().numpy() for p in leaves(model.params())],
                  jax.tree.leaves(jp))
    _close_leaves([m.numpy() for m in leaves(tstate.mu)],
                  jax.tree.leaves(jstate.mu))
    # nu is the gradient squared: twice its relative difference
    _close_leaves([m.numpy() for m in leaves(tstate.nu)],
                  jax.tree.leaves(jstate.nu), tol=2 * GRAD_TOL)


@pytest.mark.parametrize("kind", ["gin", "pna", "egnn"])
def test_graph_readout_and_label_mask_match_repro(graphs, kind):
    x = graphs["rmat"]
    n1 = x["n"] + 1
    n_graphs = 5
    gid = (np.arange(n1) % n_graphs).astype(np.int32)
    glabels = np.arange(n_graphs, dtype=np.int32) % N_CLASSES
    for readout in ("graph", "node"):
        cfg = _cfg(kind, readout=readout)
        jcfg = _jcfg(cfg)
        jparams, model = _models(cfg)
        labels = glabels if readout == "graph" else x["labels"]
        mask = None if readout == "graph" else x["mask"]
        jl = jax.jit(lambda p: jgnn.gnn_loss(
            p, jcfg, x["feats"], x["s"], x["r"], labels, graph_ids=gid,
            n_graphs=n_graphs, label_mask=mask, **_kw(kind, x)))(jparams)
        with torch.no_grad():
            tl = model.loss(_t(x["feats"]), _t(x["s"]), _t(x["r"]),
                            _t(labels), graph_ids=_t(gid), n_graphs=n_graphs,
                            label_mask=None if mask is None else _t(mask),
                            coords=_t(x["coords"]) if kind == "egnn"
                            else None)
        np.testing.assert_allclose(float(tl), float(jl), **TOL)
        if readout == "graph":
            jlog, _ = jax.jit(lambda p: jgnn.gnn_forward(
                p, jcfg, x["feats"], x["s"], x["r"], graph_ids=gid,
                n_graphs=n_graphs, **_kw(kind, x)))(jparams)
            with torch.no_grad():
                tlog, _ = model(_t(x["feats"]), _t(x["s"]), _t(x["r"]),
                                graph_ids=_t(gid), n_graphs=n_graphs,
                                coords=_t(x["coords"]) if kind == "egnn"
                                else None)
            assert tlog.shape == (n_graphs, N_CLASSES)
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)


@pytest.mark.parametrize("kind", ["gin", "pna", "egnn"])
def test_remat_on_and_off_are_equal(graphs, kind):
    x = graphs["rmat"]
    grads = []
    for remat in (False, True):
        cfg = _cfg(kind, remat=remat)
        model = tgnn.init_gnn(cfg, key=trandom.PRNGKey(1, device="cpu"))
        params = model.params()
        loss = tgnn.gnn_loss(
            params, cfg, _t(x["feats"]), _t(x["s"]), _t(x["r"]),
            _t(x["labels"]),
            coords=_t(x["coords"]) if kind == "egnn" else None)
        grads.append([loss.detach()] + list(torch.autograd.grad(
            loss, leaves(params), allow_unused=True,
            materialize_grads=True)))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_egnn_equivariance():
    """Mirrors the reference's test_egnn_equivariance, on its inputs (the
    same keys): rotating and translating the coordinates leaves the logits
    and moves the output coordinates alike."""
    g = jgen.rmat(80, 300, seed=1)
    s, r = _t(g.senders), _t(g.receivers)
    n1 = g.n + 1
    cfg = tgnn.GNNConfig(name="egnn", kind="egnn", n_layers=3, d_hidden=16,
                         d_in=16, n_classes=3)
    model = tgnn.init_gnn(cfg, key=trandom.PRNGKey(3, device="cpu"))
    coords = _t(jax.random.normal(jax.random.PRNGKey(4), (n1, 3)))
    feats = _t(jax.random.normal(jax.random.PRNGKey(5), (n1, 16)))
    rng = np.random.default_rng(0)
    Q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    t = rng.normal(size=(3,)).astype(np.float32)
    with torch.no_grad():
        out1, x1 = model(feats, s, r, coords=coords)
        coords2 = coords @ torch.from_numpy(Q.T.astype(np.float32)) \
            + torch.from_numpy(t)
        out2, x2 = model(feats, s, r, coords=coords2)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), atol=3e-4)
    np.testing.assert_allclose(x1.numpy() @ Q.T + t, x2.numpy(), atol=3e-4)


def test_pna_ties_and_all_fill_rows_match_repro(graphs):
    """On the hand-made graph, node 1 receives three copies of node 0's
    message and one other (a three-way tie in every column's max or min,
    whose gradient splits evenly), node 6 receives nothing, and the dump
    row receives only the masked ``-1e30`` fill; the parts and their
    gradients are the reference's."""
    x = graphs["hand"]
    cfg = _cfg("pna")
    jcfg = _jcfg(cfg)
    n1 = x["n"] + 1
    rng = np.random.default_rng(5)
    msgs = rng.normal(size=(x["s"].shape[0], 4)).astype(np.float32)
    msgs[1] = msgs[2] = msgs[0]        # exact ties at receiver 1
    valid = x["s"] < n1 - 1
    deg = np.asarray(jax.ops.segment_sum(valid.astype(np.float32), x["r"],
                                         n1))
    w = rng.normal(size=(12, 4)).astype(np.float32)
    # std's gradient is left out: where a receiver's messages are equal
    # (one in-edge, or copies) its variance is a rounding residue under
    # sqrt(. + 1e-5), whose derivative (~158) scales the residue's
    # gradient in both packages alike; std's values are compared below
    w[9:] = 0.0

    def jparts(m):
        parts = list(jgnn._pna_parts(m, x["r"], n1, jnp.asarray(deg), jcfg,
                                     jnp.asarray(valid), lambda a, _: a))
        return sum(jnp.sum(p * w[i]) for i, p in enumerate(parts)), parts

    (jval, jp), jgrad = jax.value_and_grad(jparts, has_aux=True)(msgs)
    tm = _t(msgs).requires_grad_(True)
    tp = list(tgnn._pna_parts(tm, _t(x["r"]), n1, _t(deg), cfg,
                              _t(valid)))
    tval = sum(torch.sum(p * _t(w[i])) for i, p in enumerate(tp))
    (tgrad,) = torch.autograd.grad(tval, tm)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), **TOL)
    # the tie: each copy takes a third of the max's gradient
    g = tgrad.numpy()
    np.testing.assert_allclose(g[0], g[1], rtol=0, atol=0)
    # the dump row's fill takes no gradient, and node 6's parts are zero
    assert np.all(g[-4:] == 0)
    assert all(np.all(p.detach().numpy()[6] == 0) for i, p in enumerate(tp)
               if i // 3 in (1, 2))
