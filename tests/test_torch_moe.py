"""The port's MoE layer against ``repro.legacy.models.moe``: ``moe_init``
from the same key, ``moe_apply`` (grouped dispatch, capacity drops, the
aux loss) and the dense oracle ``moe_ref``, and ``moe_apply``'s gradients,
on granite's and deepseek's smoke MoE configs and the reference test's.

Tolerances: init within INIT_ULPS of ``jax.random.normal``'s draws (the
threefry's ``normal``, tests/test_torch_random.py); outputs, aux and
gradients within MOE_TOL (float32 sums in another order). Top-k ties go
to the lower expert id, as ``jax.lax.top_k``'s.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import get_arch as jget_arch
from repro.legacy.models import moe as jmoe
from repro_torch import random as trandom
from repro_torch.legacy import optim as toptim
from repro_torch.legacy.models import moe as tmoe
from repro_torch.legacy.tree import leaves

# the reference's registry loads its configs only while it is empty: a
# module that imported one config first (tests/test_torch_dlrm.py) leaves
# it holding just that one
jbase.load_all()

INIT_ULPS = 4
MOE_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _clear_jax_caches():
    """Shadow conftest's per-test cache clearing; cleared once a module."""
    yield


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_once():
    yield
    jax.clear_caches()


def _smoke_moe(arch: str, **kw) -> dict:
    a = jget_arch(arch)
    m = dataclasses.replace(a.model, **a.smoke)
    base = dict(d_model=m.d_model, d_expert=m.d_expert or m.d_ff,
                n_experts=m.n_experts, top_k=m.top_k,
                n_shared=m.n_shared_experts,
                capacity_factor=m.capacity_factor)
    base.update(kw)
    return base


CONFIGS = {
    "granite": _smoke_moe("granite-moe-3b-a800m"),
    "granite_g2": _smoke_moe("granite-moe-3b-a800m", n_groups=2),
    "deepseek": _smoke_moe("deepseek-moe-16b"),
    "deepseek_g2": _smoke_moe("deepseek-moe-16b", n_groups=2),
    # capacity 8 for 48 choices a group over 4 experts: drops
    "drops": dict(d_model=16, d_expert=16, n_experts=4, top_k=2,
                  capacity_factor=1.0),
    "drops_g2": dict(d_model=16, d_expert=16, n_experts=4, top_k=2,
                     capacity_factor=0.5, n_groups=2),
    # the reference's own oracle test
    "oracle_g4": dict(d_model=32, d_expert=64, n_experts=8, top_k=2,
                      n_shared=1, capacity_factor=8.0, n_groups=4),
}


def _params(name: str, seed: int = 1):
    jcfg = jmoe.MoEConfig(**CONFIGS[name])
    tcfg = tmoe.MoEConfig(**CONFIGS[name])
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg)
    tp = jax.tree.map(lambda a: torch.tensor(np.asarray(a)), jp)
    return jcfg, tcfg, jp, tp


def _tokens(cfg, T=96, seed=2) -> np.ndarray:
    return np.random.default_rng(seed).normal(
        size=(T, cfg.d_model)).astype(np.float32)


def test_config_matches_jax():
    for kw in CONFIGS.values():
        j, t = jmoe.MoEConfig(**kw), tmoe.MoEConfig(**kw)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert j.n_experts_padded == t.n_experts_padded
    assert tmoe.MoEConfig(1536, 512, 40, 8).n_experts_padded == 48


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_moe_init_matches_jax(name):
    jcfg, tcfg, _, _ = _params(name)
    jl = [np.asarray(x) for x in jax.tree.leaves(
        jmoe.moe_init(jax.random.PRNGKey(5), jcfg))]
    tp = tmoe.moe_init(trandom.PRNGKey(5, device="cpu"), tcfg)
    tl = [x.numpy() for x in leaves(tp)]
    assert [a.shape for a in jl] == [b.shape for b in tl]
    for a, b in zip(jl, tl):
        ulps = np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64))
        assert int(ulps.max()) <= INIT_ULPS
    assert tp["w_gate"].shape[0] == tcfg.n_experts_padded
    assert tp["router"].shape[1] == tcfg.n_experts


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_moe_apply_matches_jax(name):
    jcfg, tcfg, jp, tp = _params(name)
    x = _tokens(tcfg)
    y, aux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg)
    ty, taux = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), **MOE_TOL)
    np.testing.assert_allclose(float(taux), float(aux), **MOE_TOL)
    # the oracle takes no capacity: equal where nothing drops
    np.testing.assert_allclose(
        tmoe.moe_ref(tp, torch.from_numpy(x), tcfg).numpy(),
        np.asarray(jmoe.moe_ref(jp, jnp.asarray(x), jcfg)), **MOE_TOL)


@pytest.mark.parametrize("name", ["drops", "drops_g2"])
def test_capacity_drops_tokens(name):
    _, tcfg, jp, tp = _params(name)
    x = torch.from_numpy(_tokens(tcfg))
    C, share = tmoe.dropped_share(tcfg, x, tp["router"])
    Tg = x.shape[0] // tcfg.n_groups
    c = int(np.ceil(tcfg.capacity_factor * Tg * tcfg.top_k
                    / tcfg.n_experts_padded))
    assert C == tmoe.capacity(tcfg, Tg) == max(8, -(-c // 8) * 8)
    assert 0 < share < 1
    y, _ = tmoe.moe_apply(tp, x, tcfg)
    assert not torch.allclose(y, tmoe.moe_ref(tp, x, tcfg), atol=1e-3)


@pytest.mark.parametrize("name", ["granite", "deepseek_g2", "drops"])
def test_moe_apply_grads_match_jax(name):
    jcfg, tcfg, jp, tp = _params(name)
    x = _tokens(tcfg, T=32)
    w = np.random.default_rng(4).normal(size=x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux = jmoe.moe_apply(p, xx, jcfg)
        return jnp.sum(y * w) + aux

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    tl = leaves(tp)
    for t in tl:
        t.requires_grad_(True)
    y, aux = tmoe.moe_apply(tp, tx, tcfg)
    loss = torch.sum(y * torch.from_numpy(w)) + aux
    grads = torch.autograd.grad(loss, tl + [tx])
    for a, b in zip(jax.tree.leaves(jg) + [jgx], grads):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-5)


def test_top_k_ties_go_to_the_lower_id():
    rng = np.random.default_rng(6)
    probs = np.round(rng.random((64, 12)), 1).astype(np.float32)  # ties
    probs[0] = 0.25
    for k in (1, 3, 6):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        tv, ti = tmoe.top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_router_tie_routes_as_jax():
    """A zero router: every expert ties on every token, so both packages
    route every token to experts 0..K-1 and drop past capacity."""
    jcfg, tcfg, jp, tp = _params("granite")
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    x = _tokens(tcfg, T=64)
    y, aux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg)
    ty, taux = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), **MOE_TOL)
    np.testing.assert_allclose(float(taux), float(aux), **MOE_TOL)
    _, share = tmoe.dropped_share(tcfg, torch.from_numpy(x), tp["router"])
    C = tmoe.capacity(tcfg, 64)
    assert share == pytest.approx(max(0, 64 - C) / 64)


@pytest.mark.gpu
def test_moe_grads_repeat_bit_for_bit_on_card():
    """``moe_apply``'s gradients twice on the card, at granite's width and
    4,096 tokens: the same bits (a token's K dispatch copies add up in a
    fixed order, not with atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.configs import get_arch
    cfg = get_arch("granite-moe-3b-a800m").model.moe_cfg
    p = tmoe.moe_init(trandom.PRNGKey(0, device="cuda"), cfg)
    x = torch.from_numpy(np.random.default_rng(9).normal(
        size=(4096, cfg.d_model)).astype(np.float32)).cuda().bfloat16()
    w = torch.from_numpy(np.random.default_rng(10).normal(
        size=(4096, cfg.d_model)).astype(np.float32)).cuda()
    runs = []
    for _ in range(2):
        tl = [t.clone().requires_grad_(True) for t in leaves(p)]
        tp = toptim.tree_unflatten(p, tl)
        tx = x.clone().requires_grad_(True)
        y, aux = tmoe.moe_apply(tp, tx, cfg)
        loss = torch.sum(y.float() * w) + aux
        runs.append(torch.autograd.grad(loss, tl + [tx]))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
