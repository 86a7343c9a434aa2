"""The port's LM serving path against ``repro.legacy.models.transformer``,
for each of the five LM archs at its ``smoke`` overrides: ``prefill``
then four ``decode_step``s, the logits and the KV caches after each step
(h2o-danube's 16-slot window is full after the 32-token prompt, so every
decode step overwrites a ring slot), and one arch in bfloat16.

Tolerances: float32 logits and caches within LM_TOL (as
tests/test_torch_lm.py); bfloat16 within BF16_TOL, a few roundings of a
bfloat16 activation of magnitude ~1. The decode-against-forward property
of the reference's own test (tests/test_models.py) within its DEC_TOL.
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
from repro_torch.configs import get_arch
from repro_torch.legacy.models import transformer as ttfm

# the reference's registry loads its configs only while it is empty: a
# module that imported one config first (tests/test_torch_dlrm.py) leaves
# it holding just that one
jbase.load_all()

LM_ARCHS = ["h2o-danube-3-4b", "qwen3-4b", "stablelm-3b", "deepseek-moe-16b",
            "granite-moe-3b-a800m"]
LM_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
DEC_TOL = dict(rtol=3e-3, atol=3e-3)
B, PROMPT, STEPS = 2, 32, 4


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


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy().copy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _snap(jl, tl, jc, tc) -> tuple:
    """A step's logits and caches as host arrays: the port's decode writes
    its cache in place, so a later step changes the tensors."""
    return (np.asarray(jl), tl.numpy(), (_f32(jc.k), _f32(jc.v),
            int(jc.pos)), (_f32(tc.k), _f32(tc.v), int(tc.pos), tc.k.dtype))


def run_both(name: str, **kw):
    """Prefill then STEPS decode steps in both packages from the
    reference's weights → per step ``(ref logits, port logits, ref cache,
    port cache)`` as host arrays."""
    jcfg, tcfg = smoke_cfgs(name, **kw)
    jp = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    model = ttfm.Transformer.from_params(jax.tree.map(np.asarray, jp), tcfg,
                                         device="cpu")
    toks = np.random.default_rng(1).integers(
        0, tcfg.vocab, (B, PROMPT + STEPS)).astype(np.int32)
    max_len = PROMPT + STEPS
    jl, jc = jtfm.prefill(jp, jnp.asarray(toks[:, :PROMPT]), jcfg, max_len)
    with torch.no_grad():
        tl, tc = model.prefill(torch.from_numpy(toks[:, :PROMPT]), max_len)
    out = [_snap(jl, tl, jc, tc)]
    for i in range(STEPS):
        tok = toks[:, PROMPT + i]
        jl, jc = jtfm.decode_step(jp, jc, jnp.asarray(tok), jcfg)
        with torch.no_grad():
            tl, tc = model.decode_step(tc, torch.from_numpy(tok))
        out.append(_snap(jl, tl, jc, tc))
    return out


@pytest.mark.parametrize("name", LM_ARCHS)
def test_prefill_then_decode_match_jax(name):
    steps = run_both(name)
    for i, (jl, tl, jc, tc) in enumerate(steps):
        assert tl.dtype == np.float32 and tl.shape == jl.shape
        np.testing.assert_allclose(tl, jl, **LM_TOL,
                                   err_msg=f"{name} step {i} logits")
        assert tc[0].shape == jc[0].shape and tc[2] == jc[2]
        np.testing.assert_allclose(tc[0], jc[0], **LM_TOL)
        np.testing.assert_allclose(tc[1], jc[1], **LM_TOL)
    # h2o-danube's window: a 16-slot ring, in phase after the prompt
    if name == "h2o-danube-3-4b":
        assert steps[0][3][0].shape[2] == 16 and steps[-1][3][2] == 36


def test_bfloat16_prefill_and_decode_match_jax():
    for jl, tl, jc, tc in run_both("qwen3-4b", dtype="bfloat16"):
        assert tc[3] == torch.bfloat16
        np.testing.assert_allclose(tl, jl, **BF16_TOL)
        np.testing.assert_allclose(tc[0], jc[0], **BF16_TOL)


def test_bfloat16_forward_matches_jax():
    jcfg, tcfg = smoke_cfgs("granite-moe-3b-a800m", dtype="bfloat16")
    jp = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    model = ttfm.Transformer.from_params(jax.tree.map(np.asarray, jp), tcfg,
                                         device="cpu")
    toks = np.random.default_rng(2).integers(0, tcfg.vocab, (B, 24)).astype(
        np.int32)
    jl, jaux = jtfm.forward(jp, jnp.asarray(toks), jcfg)
    with torch.no_grad():
        tl, taux = model(torch.from_numpy(toks))
    assert tl.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(tl), _f32(jl), **BF16_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **BF16_TOL)


@pytest.mark.parametrize("variant", ["dense", "qknorm", "swa", "moe"])
def test_decode_from_an_empty_cache_matches_forward(variant):
    """The reference's property: decoding every token from an empty cache
    gives the full forward's last logits (the port's own paths)."""
    base = dict(name="tiny", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                d_ff=64, vocab=100, dtype="float32", remat=False, q_chunk=8,
                k_chunk=8)
    base.update({"dense": {}, "qknorm": dict(qk_norm=True),
                 "swa": dict(swa_window=8),
                 "moe": dict(n_kv_heads=4, d_ff=0, n_experts=4, top_k=2,
                             d_expert=32, capacity_factor=8.0)}[variant])
    cfg = ttfm.TransformerConfig(**base)
    from repro_torch import random as trandom
    model = ttfm.init_transformer(cfg, key=trandom.PRNGKey(3, device="cpu"))
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 16)).astype(np.int32))
    with torch.no_grad():
        full, _ = model(toks)
        cache = ttfm.init_cache(cfg, 2, 16, device="cpu")
        for t in range(16):
            logits, cache = model.decode_step(cache, toks[:, t])
    np.testing.assert_allclose(logits.numpy(), full[:, -1].numpy(),
                               **DEC_TOL)


def test_prefill_cache_of_a_short_prompt_is_the_references():
    """By design (ROADMAP Queue 3): a prompt shorter than ``max_len`` on a
    full-attention model gets a cache of the prompt's length, as the
    reference's ``k[:, -s_cache:]`` gives, so the next decode step writes
    slot ``S % S`` = 0 over the first token. Smallest input: one prompt
    token, ``max_len`` 2, one decode step. Both packages agree, and both
    differ from the two-token forward."""
    jcfg, tcfg = smoke_cfgs("qwen3-4b")
    jp = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    model = ttfm.Transformer.from_params(jax.tree.map(np.asarray, jp), tcfg,
                                         device="cpu")
    toks = np.array([[5, 9]], np.int32)
    _, jc = jtfm.prefill(jp, jnp.asarray(toks[:, :1]), jcfg, 2)
    jl, _ = jtfm.decode_step(jp, jc, jnp.asarray(toks[:, 1]), jcfg)
    with torch.no_grad():
        _, tc = model.prefill(torch.from_numpy(toks[:, :1]), 2)
        assert tc.size == 1 and jc.k.shape[2] == 1
        tl, _ = model.decode_step(tc, torch.from_numpy(toks[:, 1]))
        full, _ = model(torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LM_TOL)
    assert not np.allclose(tl.numpy(), full[:, -1].numpy(), **DEC_TOL)


def test_decode_updates_the_cache_in_place():
    jcfg, tcfg = smoke_cfgs("stablelm-3b")
    from repro_torch import random as trandom
    model = ttfm.init_transformer(tcfg, key=trandom.PRNGKey(0, device="cpu"))
    cache = ttfm.init_cache(tcfg, 2, 8, device="cpu")
    k0 = cache.k
    with torch.no_grad():
        _, new = model.decode_step(cache, torch.tensor([1, 2]))
    assert new.k is k0 and int(new.pos) == 1 and int(cache.pos) == 0
    assert k0[:, :, 0].abs().sum() > 0 and k0[:, :, 1:].abs().sum() == 0
    spec = ttfm.cache_spec(tcfg, 2, 8)
    assert spec.k.device.type == "meta" and spec.k.shape == k0.shape
