"""The port's transformer LM against ``repro.legacy.models.transformer``,
for each of the five LM archs at its ``smoke`` overrides (float32):
``init_params`` from ``PRNGKey(0)``, ``forward``'s logits and aux,
``lm_loss``' loss, nll and aux, and the gradient of every leaf. The
reference's weights go across through ``Transformer.from_params``.

Tolerances: init within INIT_ULPS of ``jax.random.normal``'s draws;
logits and losses within LM_TOL (float32 products and sums in torch's
order); a gradient leaf within GRAD_TOL of its largest magnitude.
Prefill, decode and bfloat16 are in tests/test_torch_lm_decode.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import get_arch as jget_arch
from repro.legacy.models import transformer as jtfm
from repro_torch import random as trandom
from repro_torch.configs import get_arch
from repro_torch.legacy.models import transformer as ttfm
from repro_torch.legacy.tree import leaves

# the reference's registry loads its configs only while it is empty: a
# module that imported one config first (tests/test_torch_dlrm.py) leaves
# it holding just that one
jbase.load_all()

LM_ARCHS = ["h2o-danube-3-4b", "qwen3-4b", "stablelm-3b", "deepseek-moe-16b",
            "granite-moe-3b-a800m"]
INIT_ULPS = 4
LM_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = 1e-5
B, S = 2, 40


@pytest.fixture(autouse=True)
def _clear_jax_caches():
    """Shadow conftest's per-test cache clearing; cleared once a module."""
    yield


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_once():
    yield
    jax.clear_caches()


def smoke_cfgs(name: str, **kw):
    ja, ta = jget_arch(name), get_arch(name)
    return (dataclasses.replace(ja.model, **{**ja.smoke, **kw}),
            dataclasses.replace(ta.model, **{**ta.smoke, **kw}))


def batch(cfg, seed: int = 0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(-1, cfg.vocab, (B, S)).astype(np.int32)
    return toks, labels


_REF = {}


def reference(name: str) -> dict:
    """The reference's init, forward, loss and gradients of ``name``'s
    smoke config, computed once for the module."""
    if name not in _REF:
        jcfg, tcfg = smoke_cfgs(name)
        jp = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
        toks, labels = batch(tcfg)
        logits, aux = jtfm.forward(jp, jnp.asarray(toks), jcfg)
        (loss, metrics), grads = jax.value_and_grad(
            lambda p: jtfm.lm_loss(p, jnp.asarray(toks), jnp.asarray(labels),
                                   jcfg), has_aux=True)(jp)
        _REF[name] = dict(
            params=jax.tree.map(np.asarray, jp), tcfg=tcfg, toks=toks,
            labels=labels, logits=np.asarray(logits), aux=float(aux),
            loss=float(loss), nll=float(metrics["nll"]),
            maux=float(metrics["aux"]),
            grads=[np.asarray(g) for g in jax.tree.leaves(grads)])
    return _REF[name]


def test_configs_match_jax():
    for name in LM_ARCHS:
        ja, ta = jget_arch(name), get_arch(name)
        assert dataclasses.asdict(ja.model) == dataclasses.asdict(ta.model)
        assert ja.model.param_count() == ta.model.param_count()
        jc, tc = smoke_cfgs(name)
        assert jc.head_dim == tc.head_dim and jc.is_moe == tc.is_moe
        if tc.is_moe:
            assert dataclasses.asdict(jc.moe_cfg) == \
                dataclasses.asdict(tc.moe_cfg)


@pytest.mark.parametrize("name", LM_ARCHS)
def test_init_params_match_jax(name):
    ref = reference(name)
    tp = ttfm.init_params(trandom.PRNGKey(0, device="cpu"), ref["tcfg"])
    want = jax.tree.leaves(ref["params"])
    got = [x.numpy() for x in leaves(tp)]
    assert [a.shape for a in want] == [b.shape for b in got]
    assert [tuple(s) for s in ttfm.shape_leaves(ttfm.param_shapes(
        ref["tcfg"]))] == [a.shape for a in want]
    for a, b in zip(want, got):
        assert a.dtype == b.dtype == np.float32
        ulps = np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64))
        assert int(ulps.max()) <= INIT_ULPS
    assert ttfm.param_bytes(ref["tcfg"]) == 4 * sum(a.size for a in want)


@pytest.mark.parametrize("name", LM_ARCHS)
def test_forward_matches_jax(name):
    ref = reference(name)
    model = ttfm.Transformer.from_params(ref["params"], ref["tcfg"],
                                         device="cpu")
    with torch.no_grad():
        logits, aux = model(torch.from_numpy(ref["toks"]))
    assert logits.shape == (B, S, ref["tcfg"].vocab)
    np.testing.assert_allclose(logits.numpy(), ref["logits"], **LM_TOL)
    np.testing.assert_allclose(float(aux), ref["aux"], **LM_TOL)


@pytest.mark.parametrize("name", LM_ARCHS)
def test_lm_loss_and_grads_match_jax(name):
    ref = reference(name)
    model = ttfm.Transformer.from_params(ref["params"], ref["tcfg"],
                                         device="cpu")
    params = model.params()
    loss, metrics = ttfm.lm_loss(params, torch.from_numpy(ref["toks"]),
                                 torch.from_numpy(ref["labels"]),
                                 ref["tcfg"])
    np.testing.assert_allclose(float(loss.detach()), ref["loss"], **LM_TOL)
    np.testing.assert_allclose(float(metrics["nll"].detach()), ref["nll"],
                               **LM_TOL)
    np.testing.assert_allclose(float(metrics["aux"].detach()), ref["maux"],
                               **LM_TOL)
    grads = torch.autograd.grad(loss, leaves(params))
    assert len(grads) == len(ref["grads"])
    for g, want in zip(grads, ref["grads"]):
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(g.numpy() - want).max()) <= GRAD_TOL * scale


def test_remat_gives_the_same_grads():
    ref = reference("qwen3-4b")
    cfg = dataclasses.replace(ref["tcfg"], remat=True)
    toks, labels = (torch.from_numpy(ref[k]) for k in ("toks", "labels"))
    out = []
    for c in (ref["tcfg"], cfg):
        model = ttfm.Transformer.from_params(ref["params"], c, device="cpu")
        params = model.params()
        loss, _ = ttfm.lm_loss(params, toks, labels, c)
        out.append(torch.autograd.grad(loss, leaves(params)))
    assert all(torch.equal(a, b) for a, b in zip(*out))


def test_labels_below_zero_are_masked():
    ref = reference("stablelm-3b")
    model = ttfm.Transformer.from_params(ref["params"], ref["tcfg"],
                                         device="cpu")
    toks = torch.from_numpy(ref["toks"])
    labels = torch.full_like(toks, -1)
    labels[0, :5] = toks[0, 1:6]
    x, _ = ttfm.forward_hidden(model.params(), toks, ref["tcfg"])
    nll = ttfm.sharded_xent(x, model.params()["lm_head"], labels)
    loss, m = model.lm_loss(toks, labels)
    assert torch.isfinite(nll).all()
    np.testing.assert_allclose(float(m["nll"].detach()),
                               float(nll[0, :5].detach().mean()), rtol=1e-6)


def test_from_params_checks_shapes():
    ref = reference("qwen3-4b")
    bad = dict(ref["params"], lm_head=ref["params"]["lm_head"][:, :3])
    with pytest.raises(ValueError, match="parameter shapes"):
        ttfm.Transformer.from_params(bad, ref["tcfg"], device="cpu")
    model = ttfm.Transformer.from_params(ref["params"], ref["tcfg"],
                                         device="cpu")
    got = model.params()
    assert sorted(got) == sorted(ref["params"])
    # params() holds the module's own parameters, not copies
    assert all(any(p is q for q in model.parameters()) for p in leaves(got))
