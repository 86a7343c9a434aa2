"""The port's NequIP and its irreps against ``repro.legacy.models`` at the
arch's ``smoke`` overrides (float32) on ``rmat(512, 2048)``: the real
spherical harmonics, the Gaunt tensors and the allowed paths bit for bit
(the same numpy code), ``sh_torch`` against ``sh_jnp`` (l = 0 and 1 bit
for bit, l = 2 within an ulp of the float32 values), ``bessel_basis``,
``init_nequip`` from ``PRNGKey(0)``, the energy (whole batch and per
graph), the loss and every gradient leaf (the reference's weights carried
across by ``NequIP.from_params``), ``remat`` on and off, and the energy's
E(3) invariance.

Tolerances: init within INIT_ULPS; values within TOL; a gradient leaf
within GRAD_TOL of its largest.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.graphs import generators as jgen
from repro.legacy.models import irreps as jirreps
from repro.legacy.models import nequip as jnequip
from repro_torch import random as trandom
from repro_torch.configs import get_arch
from repro_torch.legacy.models import irreps as tirreps
from repro_torch.legacy.models import nequip as tnequip
from repro_torch.legacy.models.spmd import tree_paths
from repro_torch.legacy.tree import leaves

jbase.load_all()

INIT_ULPS = 4
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = 1e-5


def _cfg(**kw) -> tnequip.NequIPConfig:
    arch = get_arch("nequip")
    return dataclasses.replace(arch.model, **arch.smoke, **kw)


def _jcfg(cfg):
    return jnequip.NequIPConfig(**dataclasses.asdict(cfg))


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


@pytest.fixture(scope="module")
def inputs():
    g = jgen.rmat(512, 2048, seed=0)
    n1 = g.n + 1
    rng = np.random.default_rng(1)
    return dict(s=np.asarray(g.senders), r=np.asarray(g.receivers), n=g.n,
                species=rng.integers(0, 8, size=(n1,)).astype(np.int32),
                coords=(2.0 * rng.normal(size=(n1, 3))).astype(np.float32),
                gid=(np.arange(n1) % 3).astype(np.int32),
                targets=rng.normal(size=(3,)).astype(np.float32))


@pytest.mark.parametrize("l_max", [0, 1, 2])
def test_irreps_equal_repro_bit_for_bit(l_max):
    assert tirreps.allowed_paths(l_max) == jirreps.allowed_paths(l_max)
    for p in tirreps.allowed_paths(l_max):
        np.testing.assert_array_equal(tirreps.gaunt(*p), jirreps.gaunt(*p))
    pts = np.random.default_rng(2).normal(size=(64, 3))
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    for l in range(l_max + 1):
        np.testing.assert_array_equal(tirreps.sh_np(l, pts),
                                      jirreps.sh_np(l, pts))
        x = pts.astype(np.float32)
        np.testing.assert_allclose(tirreps.sh_torch(l, _t(x)).numpy(),
                                   np.asarray(jirreps.sh_jnp(l, x)),
                                   rtol=1e-6, atol=1e-7)
        R = np.linalg.qr(np.random.default_rng(l).normal(size=(3, 3)))[0]
        np.testing.assert_array_equal(tirreps.wigner_d_numeric(l, R),
                                      jirreps.wigner_d_numeric(l, R))


def test_bessel_basis_matches_repro():
    r = np.concatenate([[0.0, 1e-7], np.linspace(0.01, 6.0, 97)]) \
        .astype(np.float32)
    for n_rbf, cutoff in ((4, 5.0), (8, 5.0), (8, 3.3)):
        np.testing.assert_allclose(
            tnequip.bessel_basis(_t(r), n_rbf, cutoff).numpy(),
            np.asarray(jnequip.bessel_basis(r, n_rbf, cutoff)), **TOL)


def test_init_matches_repro():
    cfg = _cfg()
    jparams = jnequip.init_nequip(jax.random.PRNGKey(0), _jcfg(cfg))
    model = tnequip.init_nequip(cfg, key=trandom.PRNGKey(0, device="cpu"))
    got, want = leaves(model.params()), jax.tree.leaves(jparams)
    assert [tuple(x.shape) for x in got] == [x.shape for x in want] == [
        s for _, s in tree_paths(tnequip.param_shapes(cfg))]
    for a, b in zip(want, got):
        ulps = np.abs(np.asarray(a).view(np.int32).astype(np.int64)
                      - b.detach().numpy().view(np.int32).astype(np.int64))
        assert int(ulps.max()) <= INIT_ULPS


@pytest.mark.parametrize("per_graph", [False, True])
def test_energy_loss_and_grads_match_repro(inputs, per_graph):
    x = inputs
    cfg = _cfg()
    jcfg = _jcfg(cfg)
    jparams = jnequip.init_nequip(jax.random.PRNGKey(0), jcfg)
    model = tnequip.NequIP.from_params(jax.tree.map(np.asarray, jparams),
                                       cfg, device="cpu")
    kw = dict(graph_ids=x["gid"], n_graphs=3) if per_graph else {}
    tkw = dict(graph_ids=_t(x["gid"]), n_graphs=3) if per_graph else {}
    targets = x["targets"] if per_graph else x["targets"][:1]

    def jloss(p):
        return jnequip.nequip_loss(p, jcfg, x["species"], x["coords"],
                                   x["s"], x["r"], targets, **kw)

    je = jax.jit(lambda p: jnequip.nequip_forward(
        p, jcfg, x["species"], x["coords"], x["s"], x["r"], **kw))(jparams)
    jl, jg = jax.jit(jax.value_and_grad(jloss))(jparams)
    args = (_t(x["species"]), _t(x["coords"]), _t(x["s"]), _t(x["r"]))
    with torch.no_grad():
        te = model(*args, **tkw)
    assert te.shape == (3 if per_graph else 1,)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), **TOL)
    params = model.params()
    tl = tnequip.nequip_loss(params, cfg, *args, _t(targets), **tkw)
    np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
    # the last layer's l > 0 outputs never reach the energy: their leaves
    # take zero gradients, as jax.grad gives them
    tg = torch.autograd.grad(tl, leaves(params), allow_unused=True,
                             materialize_grads=True)
    for a, b in zip(tg, jax.tree.leaves(jg)):
        b = np.asarray(b, np.float64)
        assert np.abs(a.double().numpy() - b).max() <= \
            GRAD_TOL * np.abs(b).max()


def test_remat_on_and_off_are_equal(inputs):
    x = inputs
    args = (_t(x["species"]), _t(x["coords"]), _t(x["s"]), _t(x["r"]),
            _t(x["targets"][:1]))
    out = []
    for remat in (False, True):
        cfg = _cfg(remat=remat)
        model = tnequip.init_nequip(cfg, key=trandom.PRNGKey(2,
                                                             device="cpu"))
        params = model.params()
        loss = tnequip.nequip_loss(params, cfg, *args)
        out.append([loss.detach(), *torch.autograd.grad(
            loss, leaves(params), allow_unused=True,
            materialize_grads=True)])
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_nequip_energy_e3_invariance():
    """Mirrors the reference's test_nequip_energy_e3_invariance, on its
    inputs (the same keys)."""
    g = jgen.rmat(60, 200, seed=2)
    n1 = g.n + 1
    cfg = tnequip.NequIPConfig(name="nequip", n_layers=2, channels=8,
                               n_rbf=4, n_species=3)
    model = tnequip.init_nequip(cfg, key=trandom.PRNGKey(6, device="cpu"))
    species = _t(jax.random.randint(jax.random.PRNGKey(7), (n1,), 0, 3))
    coords = _t(jax.random.normal(jax.random.PRNGKey(8), (n1, 3)))
    s, r = _t(g.senders), _t(g.receivers)
    rng = np.random.default_rng(3)
    Q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    with torch.no_grad():
        e1 = model(species, coords, s, r)
        coords2 = coords @ torch.from_numpy(Q.T.astype(np.float32)) + 2.5
        e2 = model(species, coords2, s, r)
    np.testing.assert_allclose(e1.numpy(), e2.numpy(), rtol=1e-4, atol=1e-4)
