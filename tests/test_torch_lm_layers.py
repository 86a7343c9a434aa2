"""The port's transformer layers against ``repro.legacy.models.layers``:
``rms_norm``, ``rope_frequencies``, ``apply_rope``, ``chunked_attention``
and ``dot_attention_ref``, on numpy inputs from a seed.

Tolerances: float32 results within LAYER_TOL (the same float32 ops, in
torch's order and libm's ``sin``/``cos``/``pow`` where XLA has its own);
bfloat16 results within one bfloat16 rounding of each other (BF16_TOL);
the attention as the reference's own test holds its chunked attention
against its O(S²) oracle (ATTN_TOL, ``tests/test_models.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.legacy.models import layers as jlayers
from repro_torch.legacy.models import layers as tlayers

LAYER_TOL = dict(rtol=1e-6, atol=1e-6)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)
ATTN_TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(autouse=True)
def _clear_jax_caches():
    """Shadow conftest's per-test cache clearing; cleared once a module."""
    yield


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_once():
    yield
    jax.clear_caches()


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(a: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a).astype(dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return j, t


def test_no_shard_is_the_identity():
    x = torch.arange(6.0)
    assert tlayers.no_shard(x, ("data", None)) is x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 16), (2, 5, 4, 8), (1, 7, 64)],
                         ids=str)
def test_rms_norm_matches_jax(shape, dtype):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=shape) * 3).astype(np.float32)
    gamma = rng.normal(size=shape[-1:]).astype(np.float32)
    jx, tx = _pair(x, dtype)
    want = jlayers.rms_norm(jx, jnp.asarray(gamma))
    got = tlayers.rms_norm(tx, torch.from_numpy(gamma))
    assert got.dtype == getattr(torch, dtype) and got.shape == shape
    np.testing.assert_allclose(_np(got), _np(want),
                               **(LAYER_TOL if dtype == "float32"
                                  else BF16_TOL))


@pytest.mark.parametrize("d_head,theta", [(8, 1e4), (64, 1e4), (128, 1e6)])
def test_rope_frequencies_match_jax(d_head, theta):
    np.testing.assert_allclose(
        tlayers.rope_frequencies(d_head, theta).numpy(),
        np.asarray(jlayers.rope_frequencies(d_head, theta)), **LAYER_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset", [0, 37, 4093])
def test_apply_rope_matches_jax(offset, dtype):
    rng = np.random.default_rng(1)
    B, S, H, dh = 2, 9, 3, 16
    x = rng.normal(size=(B, S, H, dh)).astype(np.float32)
    pos = (offset + np.arange(S, dtype=np.int32))[None].repeat(B, 0)
    jx, tx = _pair(x, dtype)
    want = jlayers.apply_rope(jx, jnp.asarray(pos))
    got = tlayers.apply_rope(tx, torch.from_numpy(pos))
    assert got.dtype == getattr(torch, dtype)
    # angles up to ~4100 rad: sin and cos of float32 angles from two libms
    tol = dict(rtol=2e-5, atol=2e-5) if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got), _np(want), **tol)


# the reference's grid (tests/test_models.py): GQA, MHA, SWA, uneven
# chunks; then q_offset (a query block later in the sequence) and a window
# wider than the chunks
ATTN_GRID = [
    (2, 64, 64, 4, 2, 16, None, 16, 16, 0),
    (1, 100, 100, 8, 8, 8, None, 32, 16, 0),
    (2, 64, 64, 4, 1, 16, 24, 16, 32, 0),
    (1, 37, 37, 2, 2, 8, None, 64, 64, 0),
    (1, 20, 52, 4, 2, 16, None, 8, 16, 32),
    (2, 24, 70, 6, 3, 8, 40, 16, 16, 46),
]


def _qkv(B, Sq, Sk, Hq, Hkv, dh, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, Hq, dh)).astype(np.float32),
            rng.normal(size=(B, Sk, Hkv, dh)).astype(np.float32),
            rng.normal(size=(B, Sk, Hkv, dh)).astype(np.float32))


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,dh,win,qc,kc,off", ATTN_GRID)
def test_chunked_attention_matches_jax(B, Sq, Sk, Hq, Hkv, dh, win, qc, kc,
                                       off):
    q, k, v = _qkv(B, Sq, Sk, Hq, Hkv, dh)
    kw = dict(causal=True, window=win, q_offset=off)
    want = jlayers.chunked_attention(*map(jnp.asarray, (q, k, v)),
                                     q_chunk=qc, k_chunk=kc, **kw)
    got = tlayers.chunked_attention(*map(torch.from_numpy, (q, k, v)),
                                    q_chunk=qc, k_chunk=kc, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    # and both against the O(S²) oracles
    ref = tlayers.dot_attention_ref(*map(torch.from_numpy, (q, k, v)), **kw)
    jref = jlayers.dot_attention_ref(*map(jnp.asarray, (q, k, v)), **kw)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jref), **LAYER_TOL)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **ATTN_TOL)


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,dh,win,qc,kc,off", ATTN_GRID[:3])
def test_chunked_attention_passes_and_tensor_offset(monkeypatch, B, Sq, Sk,
                                                    Hq, Hkv, dh, win, qc,
                                                    kc, off):
    """A pass of one query chunk at a time (the reference's map), and a
    0-d tensor ``q_offset`` (masks built on the device), give the same
    bits as one pass over every chunk."""
    q, k, v = map(torch.from_numpy, _qkv(B, Sq, Sk, Hq, Hkv, dh, seed=3))
    kw = dict(causal=True, window=win, q_chunk=qc, k_chunk=kc)
    whole = tlayers.chunked_attention(q, k, v, q_offset=off, **kw)
    monkeypatch.setattr(tlayers, "SCORE_BUDGET", 1)
    one = tlayers.chunked_attention(q, k, v, q_offset=off, **kw)
    dev = tlayers.chunked_attention(q, k, v, q_offset=torch.tensor(off),
                                    **kw)
    assert torch.equal(whole, one) and torch.equal(whole, dev)


@pytest.mark.parametrize("window", [None, 24])
def test_chunked_attention_bfloat16_matches_jax(window):
    q, k, v = _qkv(2, 64, 64, 4, 2, 16, seed=5)
    jq, tq = _pair(q, "bfloat16")
    jk, tk = _pair(k, "bfloat16")
    jv, tv = _pair(v, "bfloat16")
    kw = dict(causal=True, window=window, q_chunk=16, k_chunk=32)
    want = jlayers.chunked_attention(jq, jk, jv, **kw)
    got = tlayers.chunked_attention(tq, tk, tv, **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)


def test_scores_accumulate_in_float32():
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.normal(size=(3, 5, 16)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(3, 7, 16)).astype(np.float32))
    got = tlayers.scores(a.bfloat16(), b.bfloat16())
    assert got.dtype == torch.float32
    want = torch.bmm(a.bfloat16().float(), b.bfloat16().float().mT)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8, 4096, 1024, 128), (3, 5, 7, 16)],
                         ids=str)
def test_card_scores_match_float32_autograd(cuda, shape, monkeypatch):
    """``scores`` of bfloat16 operands on the card (bmm with a float32
    output and its hand-written backward) against float32 ``bmm`` autograd
    of the same values: the forward within float32 reassociation, each
    gradient within one bfloat16 rounding of the float32 gradient."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    N, M, K, d = shape
    rng = np.random.default_rng(8)
    q, k = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
        cuda).bfloat16() for s in ((N, M, d), (N, K, d)))
    w = torch.from_numpy(rng.normal(size=(N, M, K)).astype(np.float32)).to(
        cuda)
    qb, kb = (t.clone().requires_grad_(True) for t in (q, k))
    got = tlayers.scores(qb, kb)
    assert got.dtype == torch.float32
    dq, dk = torch.autograd.grad((got * w).sum(), (qb, kb))
    assert dq.dtype == dk.dtype == torch.bfloat16
    qf, kf = (t.float().requires_grad_(True) for t in (q, k))
    want = torch.bmm(qf, kf.mT)
    wq, wk = torch.autograd.grad((want * w).sum(), (qf, kf))
    mag = float(want.detach().abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * mag
    for g, f in ((dq, wq), (dk, wk)):
        bound = 2.0 ** -8 * f.abs() + 1e-5 * float(f.abs().max())
        assert bool(((g.float() - f).abs() <= bound).all())
