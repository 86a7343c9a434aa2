"""``repro_torch.random`` (threefry2x32) against ``jax.random``, and the
draws of the port's sampled paths against ``repro``'s.

  * keys (``PRNGKey``, ``split``, ``fold_in``), ``bits`` and ``randint``
    (a scalar and an array ``maxval``, spans of 0 included) and ``uniform``
    bit for bit, on a few shapes and seeds;
  * ``normal`` within NORMAL_ULPS and ``exponential`` within EXP_ULPS of
    ``jax.random``'s: the same bits go through torch's ``log1p`` where XLA
    has its own (measured here: at most 3 ulps for ``normal``, 1 for
    ``exponential``, on ~1% and ~7% of the draws);
  * with no ``key``, ``ConnectIt(v).connectivity(g)`` gives ``repro``'s
    labels and every ``ConnectivityStats`` field ``repro`` fills, for the
    main variant, the BFS and LDD variants and every k-out selection, on
    ``variant_grid_graphs()`` and an RMAT graph: no replayed draw;
  * ``launch.ingest``'s query pairs are ``repro``'s.

``gpu``-marked: the same draws on the card equal the CPU's bit for bit,
and the threefry kernels equal their plain versions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import variant_grid_graphs
from repro import api as japi
from repro.graphs import generators as jgen
from repro_torch import api as tapi
from repro_torch import random as trandom
from repro_torch.graphs import graph_from_arrays
from repro_torch.kernels import ops
from repro_torch.launch import ingest as tingest

NORMAL_ULPS = 4
EXP_ULPS = 2
SEEDS = (0, 42, -7, 2**31 - 1)
SHAPES = ((), (1,), (7,), (3, 5), (1001,))


@pytest.fixture(autouse=True)
def _clear_jax_caches():
    """Shadow conftest's per-test cache clearing: the programs here are
    small and shared across tests. Cleared once per module."""
    yield


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_once():
    yield
    jax.clear_caches()


def _key(seed):
    return jax.random.PRNGKey(seed), trandom.PRNGKey(seed, device="cpu")


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    """The largest distance in float32 steps between two arrays."""
    def mono(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.abs(mono(a) - mono(b)).max())


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_match_jax(seed):
    jk, tk = _key(seed)
    np.testing.assert_array_equal(_u32(tk), np.asarray(jk))
    np.testing.assert_array_equal(trandom.key_to_numpy(tk), np.asarray(jk))
    assert torch.equal(trandom.key_from_numpy(np.asarray(jk), device="cpu"),
                       tk)
    for num in (1, 2, 3, 28):
        np.testing.assert_array_equal(_u32(trandom.split(tk, num)),
                                      np.asarray(jax.random.split(jk, num)))
    for data in (0, 1, 5, 12345, 2**31 + 3, 2**32 - 1):
        np.testing.assert_array_equal(
            _u32(trandom.fold_in(tk, data)),
            np.asarray(jax.random.fold_in(jk, data)))
    # a chain, as the samplers and streams walk keys
    j2, t2 = jk, tk
    for step in range(4):
        j2, sub = jax.random.split(jax.random.fold_in(j2, step))
        t2, tsub = trandom.split(trandom.fold_in(t2, step))
        np.testing.assert_array_equal(_u32(t2), np.asarray(j2))
        np.testing.assert_array_equal(_u32(tsub), np.asarray(sub))


def test_seed_range_and_key_checks():
    # a seed past int32 is jax.random's key (0, seed mod 2**32); one past
    # int64 raises as there
    np.testing.assert_array_equal(
        _u32(trandom.PRNGKey(2**31, device="cpu")),
        np.asarray(jax.random.PRNGKey(2**31)))
    with pytest.raises(OverflowError, match="int64"):
        trandom.PRNGKey(2**63, device="cpu")
    with pytest.raises(TypeError, match="key"):
        trandom.bits(torch.zeros(3, dtype=torch.int64), (2,))
    with pytest.raises(ValueError, match="uint32"):
        trandom.key_from_numpy(np.zeros(2, np.int64), device="cpu")
    with pytest.raises(ValueError, match="not both"):
        trandom.choose(trandom.PRNGKey(0, device="cpu"), torch.Generator())
    assert trandom.choose(None, None) is None
    assert torch.equal(trandom.resolve(None, "cpu"),
                       trandom.PRNGKey(0, device="cpu"))


# both ends of each range jax.random takes: seeds in [-2**63, 2**63) (the
# key is (0, seed mod 2**32)), fold_in data in [0, 2**32)
KEY_SEEDS = (2**31, 3_000_000_000, -2**31 - 1, 2**63 - 1, -2**63)
BAD_SEEDS = (2**63, -2**63 - 1)
FOLD_DATA = (0, 2**31, 2**32 - 1)
BAD_FOLD_DATA = (2**32, -1)


@pytest.mark.parametrize("seed", KEY_SEEDS)
def test_prngkey_takes_jax_seed_range(seed):
    np.testing.assert_array_equal(_u32(trandom.PRNGKey(seed, device="cpu")),
                                  np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", BAD_SEEDS)
def test_prngkey_raises_outside_jax_seed_range(seed):
    with pytest.raises(OverflowError):
        jax.random.PRNGKey(seed)
    with pytest.raises(OverflowError):
        trandom.PRNGKey(seed, device="cpu")


@pytest.mark.parametrize("data", FOLD_DATA)
def test_fold_in_takes_uint32_data(data):
    jk, tk = _key(0)
    np.testing.assert_array_equal(_u32(trandom.fold_in(tk, data)),
                                  np.asarray(jax.random.fold_in(jk, data)))


@pytest.mark.parametrize("data", BAD_FOLD_DATA)
def test_fold_in_raises_outside_uint32(data):
    jk, tk = _key(0)
    with pytest.raises(OverflowError):
        jax.random.fold_in(jk, data)
    with pytest.raises(OverflowError):
        trandom.fold_in(tk, data)


def test_recsys_stream_negative_step_raises_as_jax():
    from repro.legacy.data import RecsysStream as JStream
    from repro_torch.legacy.data import RecsysStream as TStream
    with pytest.raises(OverflowError):
        JStream(4, 13, 26, 1000).batch_at(-1)
    with pytest.raises(OverflowError):
        TStream(4, 13, 26, 1000).batch_at(-1, device="cpu")


def test_train_seed_past_int32_is_the_references():
    from repro.launch import train as jtrain
    from repro_torch.launch import train as ttrain
    seed = 2**31
    _, _, _, jdata = jtrain.build_trainable("dlrm-rm2", seed=seed)
    model, state, step_fn, data_fn = ttrain.build_trainable(
        "dlrm-rm2", seed=seed, device="cpu")
    want, got = jdata(0), data_fn(0)
    for k in ("sparse", "labels"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_allclose(got["dense"].numpy(), np.asarray(want["dense"]),
                               rtol=4e-7, atol=0)
    _, state, loss = step_fn(model, state, got)
    assert int(state.step) == 1 and bool(torch.isfinite(loss))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bits_and_uniform_match_jax_bit_for_bit(seed, shape):
    jk, tk = _key(seed)
    np.testing.assert_array_equal(_u32(trandom.bits(tk, shape)),
                                  np.asarray(jax.random.bits(jk, shape)))
    for lo, hi in ((0.0, 1.0), (1e-6, 1.0), (-3.0, 5.5)):
        want = np.asarray(jax.random.uniform(jk, shape, minval=lo,
                                             maxval=hi))
        got = trandom.uniform(tk, shape, lo, hi).numpy()
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_randint_with_scalar_bounds_matches_jax(seed, shape):
    jk, tk = _key(seed)
    for lo, hi in ((0, 10), (0, 1), (3, 3), (5, 2), (-5, 17),
                   (0, 2**31 - 1), (-2**31, 2**31 - 1)):
        want = np.asarray(jax.random.randint(jk, shape, lo, hi))
        got = trandom.randint(tk, shape, lo, hi)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=(lo, hi))


@pytest.mark.parametrize("seed", SEEDS)
def test_randint_with_an_array_maxval_matches_jax(seed):
    """The k-out columns' draw: ``randint(key, (n,), 0, max(deg, 1))``, and
    a raw degree array whose zeros make empty spans."""
    jk, tk = _key(seed)
    deg = np.random.default_rng(seed & 0xFF).integers(0, 40, 997).astype(
        np.int32)
    deg[::50] = 0
    deg[1] = 2**31 - 1
    for maxval in (np.maximum(deg, 1), deg):
        want = np.asarray(jax.random.randint(jk, (997,), 0,
                                             jnp.asarray(maxval)))
        got = trandom.randint(tk, (997,), 0, torch.from_numpy(maxval))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("start", [1, 250, 996])
def test_randint_from_an_offset_is_a_block_of_the_whole_draw(seed, start):
    """``randint(..., start=s)`` over the maxval block ``[s, s + F)`` is that
    block of the whole draw: a mesh rank's share of a split draw."""
    jk, tk = _key(seed)
    deg = np.random.default_rng(seed & 0xFF).integers(0, 40, 997).astype(
        np.int32)
    deg[::50] = 0
    want = np.asarray(jax.random.randint(jk, (997,), 0, jnp.asarray(deg)))
    block = deg[start: start + 300]
    got = trandom.randint(tk, block.shape, 0, torch.from_numpy(block),
                          start=start)
    np.testing.assert_array_equal(got.numpy(), want[start: start + 300])


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_and_exponential_within_their_ulps(seed):
    jk, tk = _key(seed)
    shape = (1 << 14,)
    want = np.asarray(jax.random.normal(jk, shape))
    got = trandom.normal(tk, shape).numpy()
    assert got.dtype == np.float32
    assert _ulps(got, want) <= NORMAL_ULPS
    want = np.asarray(jax.random.exponential(jk, shape))
    got = trandom.exponential(tk, shape).numpy()
    assert _ulps(got, want) <= EXP_ULPS
    # a draw in slices equals one at once
    np.testing.assert_array_equal(
        trandom.normal(tk, (77, 53)).numpy(),
        trandom.normal(tk, (77 * 53,)).numpy().reshape(77, 53))


def test_large_draws_go_in_slices(monkeypatch):
    jk, tk = _key(3)
    monkeypatch.setattr(trandom, "_SLICE", 1000)
    np.testing.assert_array_equal(_u32(trandom.bits(tk, (77, 53))),
                                  np.asarray(jax.random.bits(jk, (77, 53))))
    got = trandom.uniform(tk, (4321,), 1e-6).numpy()
    want = np.asarray(jax.random.uniform(jk, (4321,), minval=1e-6))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_erfinv_is_xlas_polynomial():
    x = np.linspace(-0.999, 0.999, 4001, dtype=np.float32)
    x = np.concatenate([x, np.float32([0.0, 1e-30, -1e-7, 0.9999999])])
    want = np.asarray(jax.scipy.special.erfinv(jnp.asarray(x)))
    got = trandom.erfinv(torch.from_numpy(x)).numpy()
    assert _ulps(got, want) <= NORMAL_ULPS
    edge = trandom.erfinv(torch.tensor([1.0, -1.0])).tolist()
    assert edge == [float("inf"), float("-inf")]


def test_threefry_wrappers_refuse_what_they_cannot_take():
    bits, rint = (ops.KERNELS[x] for x in ("threefry_bits",
                                           "threefry_randint"))
    before = (bits.launches, rint.launches)
    with pytest.raises(TypeError, match="int64"):
        bits(torch.empty(4, dtype=torch.int32), 1, 2, 0)
    with pytest.raises(ValueError, match="CUDA device"):
        bits(torch.empty(4, dtype=torch.int64), 1, 2, 0)
    with pytest.raises(TypeError, match="int32"):
        rint(torch.ones(4, dtype=torch.int64), 0, (1, 2), (3, 4))
    with pytest.raises(ValueError, match="contiguous"):
        rint(torch.ones(8, dtype=torch.int32)[::2], 0, (1, 2), (3, 4))
    with pytest.raises(ValueError, match="CUDA device"):
        rint(torch.ones(4, dtype=torch.int32), 0, (1, 2), (3, 4))
    assert (bits.launches, rint.launches) == before
    # the CPU takes the plain versions, which launch nothing
    counts = ops.launch_counts()
    out = ops.threefry_bits(torch.empty(5, dtype=torch.int64), 1, 2, 7)
    want = jax.random.bits(jnp.asarray(np.uint32([1, 2])), (12,))
    np.testing.assert_array_equal(_u32(out), np.asarray(want)[7:])
    ops.threefry_randint(torch.ones(5, dtype=torch.int32), 0, (1, 2), (3, 4))
    assert ops.launch_counts() == counts


# ---------------------------------------------------------------------------
# The sampled paths with the reference's default key.
# ---------------------------------------------------------------------------

def _port(jg):
    return graph_from_arrays(jg.senders, jg.receivers, jg.indptr, jg.indices,
                             jg.n, jg.m, device="cpu")


GRAPHS = {**variant_grid_graphs(), "rmat": jgen.rmat(512, 2048, seed=5)}
SAMPLED = ("kout_hybrid_k2+uf_sync_full", "bfs_c3+uf_sync_full",
           "bfs_c3+liu_tarjan_PUFA", "ldd_b0.2+uf_sync_full",
           "kout_pure_k2+uf_sync_full", "kout_maxdeg_k3+uf_sync_full",
           "kout_hybrid_k2+liu_tarjan_CRFA")


def _stats(st) -> dict:
    return {f.name: getattr(st, f.name)
            for f in dataclasses.fields(st)}


@pytest.mark.parametrize("variant,fused", [
    *((v, False) for v in SAMPLED), (SAMPLED[0], True), (SAMPLED[3], True)])
def test_sampled_stats_equal_repro_with_no_replay(variant, fused):
    jci, tci = japi.ConnectIt(variant), tapi.ConnectIt(variant, device="cpu")
    for name, jg in GRAPHS.items():
        want, jst = jci.connectivity(jg, fused=fused, return_stats=True)
        got, tst = tci.connectivity(_port(jg), fused=fused,
                                    return_stats=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=name)
        assert _stats(tst) == _stats(jst), name


@pytest.mark.parametrize("variant", [v for v in SAMPLED
                                     if v.endswith("uf_sync_full")])
def test_an_explicit_key_is_the_references(variant):
    jg = GRAPHS["rmat"]
    jci, tci = japi.ConnectIt(variant), tapi.ConnectIt(variant, device="cpu")
    for seed in (1, 9):
        jk, tk = _key(seed)
        jci.connectivity(jg, key=jk)
        tci.connectivity(_port(jg), key=tk)
        assert _stats(tci.stats) == _stats(jci.stats), seed
        edges = tci.spanning_forest(_port(jg), key=tk)
        want = jci.spanning_forest(jg, key=jk)
        np.testing.assert_array_equal(edges, np.asarray(want))
    with pytest.raises(ValueError, match="not both"):
        tci.connectivity(_port(jg), key=tk, generator=torch.Generator())


def test_ingest_queries_are_the_references():
    for step in (0, 3):
        qa, qb = tingest._queries(step, 1000, 4096, torch.device("cpu"))
        for q, s in ((qa, step), (qb, step + 1)):
            want = jax.random.randint(jax.random.PRNGKey(s), (1000,), 0,
                                      4096)
            np.testing.assert_array_equal(q.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# On the card: the same draws, bit for bit.
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
def test_card_draws_equal_the_cpus(cuda, seed):
    ck, gk = trandom.PRNGKey(seed, device="cpu"), trandom.PRNGKey(
        seed, device=cuda)
    assert torch.equal(trandom.split(gk, 5).cpu(), trandom.split(ck, 5))
    assert torch.equal(trandom.fold_in(gk, 77).cpu(), trandom.fold_in(ck, 77))
    assert torch.equal(trandom.bits(gk, (3, 1001)).cpu(),
                       trandom.bits(ck, (3, 1001)))
    maxval = torch.arange(5000, dtype=torch.int32) % 37
    assert torch.equal(trandom.randint(gk, (5000,), 0, maxval.to(cuda)).cpu(),
                       trandom.randint(ck, (5000,), 0, maxval))
    assert torch.equal(trandom.uniform(gk, (5000,), 1e-6).cpu(),
                       trandom.uniform(ck, (5000,), 1e-6))


@pytest.mark.gpu
@pytest.mark.parametrize("start", [0, 5, 2**32 - 3])
def test_threefry_kernels_match_plain_on_card(cuda, start):
    """Each kernel against its plain version, bit for bit, from an offset
    (across the counter's high word): bits, and randint over spans of 0, 1,
    and up to 2^31 - 1 with a negative minval."""
    from repro_torch.kernels.threefry.ref import (
        threefry_bits_ref,
        threefry_randint_ref,
    )
    bits, rint = (ops.KERNELS[x] for x in ("threefry_bits",
                                           "threefry_randint"))
    before = (bits.launches, rint.launches)
    n = 100_003
    got = bits(torch.empty(n, dtype=torch.int64, device=cuda), 0x9E3779B9,
               12345, start)
    want = threefry_bits_ref(torch.empty(n, dtype=torch.int64), 0x9E3779B9,
                             12345, start)
    assert torch.equal(got.cpu(), want)
    maxval = torch.from_numpy(np.random.default_rng(start % 97).integers(
        -5, 2**31 - 1, n).astype(np.int32))
    maxval[:100] = torch.arange(100, dtype=torch.int32) % 3 - 1
    for minval in (0, -7):
        keys = ((0xDEADBEEF, 7), (3, 0xFFFFFFFF))
        got = rint(maxval.to(cuda), minval, *keys, start)
        assert torch.equal(got.cpu(), threefry_randint_ref(maxval, minval,
                                                           *keys, start))
    assert (bits.launches, rint.launches) == (before[0] + 1, before[1] + 2)
