"""The port's batch-incremental streams (paper §3.5 / Algorithm 3) against
the JAX package.

The cases of ``test_streaming.py``, each run through ``repro`` and
``repro_torch`` (on the CPU) from the same numpy batches: after every batch
the labels and the finish rounds are equal, and so are the query answers;
``Stream.stats`` is equal field by field. Every comparison is exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import streaming as jstreaming
from repro.graphs import components_oracle
from repro.graphs import generators as jgen
from repro_torch import api as tapi
from repro_torch.core import streaming as tstreaming

FINISHES = ("uf_sync_full", "shiloach_vishkin", "liu_tarjan_CRFA")


@pytest.fixture(autouse=True)
def _clear_jax_caches():
    """Shadow conftest's per-test cache clearing: the JAX programs here run
    at a few small shapes. Cleared once per module."""
    yield


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_once():
    yield
    jax.clear_caches()


def _pair(variant: str, n: int):
    """The same stream in both packages."""
    return (japi.ConnectIt(variant).stream(n),
            tapi.ConnectIt(variant, device="cpu").stream(n))


def _same_state(js, ts, what="") -> None:
    np.testing.assert_array_equal(ts.state.P.numpy(), np.asarray(js.state.P),
                                  err_msg=what)
    assert ts._rounds == int(js._rounds), what


def _same_stats(ts, js) -> None:
    """Field by field (the two packages' stats are different classes)."""
    assert dataclasses.asdict(ts.stats) == dataclasses.asdict(js.stats)


def _undirected(jg, seed: int = 0):
    s = np.asarray(jg.senders)[: jg.m]
    r = np.asarray(jg.receivers)[: jg.m]
    keep = s < r
    perm = np.random.default_rng(seed).permutation(int(keep.sum()))
    return s[keep][perm], r[keep][perm]


@pytest.mark.parametrize("finish", FINISHES)
def test_incremental_matches_jax_and_static(finish):
    """Ragged batches with queries: labels, rounds and answers equal after
    every batch; the end is the static partition; the stats are equal."""
    jg = jgen.rmat(256, 1000, seed=3)
    oracle = components_oracle(jg)
    s, r = _undirected(jg)
    rng = np.random.default_rng(1)
    js, ts = _pair(f"none+{finish}", jg.n)
    B = 96
    for i in range(0, len(s), B):
        qa, qb = rng.integers(0, jg.n, (2, 24)).astype(np.int32)
        want = js.process(s[i: i + B], r[i: i + B], qa, qb)
        got = ts.process(s[i: i + B], r[i: i + B], qa, qb)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        _same_state(js, ts, f"batch {i // B}")
    reps = np.full(jg.n, jg.n)
    np.minimum.at(reps, ts.labels.numpy(), np.arange(jg.n))
    np.testing.assert_array_equal(reps[ts.labels.numpy()], oracle)
    assert ts.num_components() == js.num_components()
    _same_stats(ts, js)
    assert ts.stats.batch_shapes == (64, 128)
    assert ts.stats.edges_finish == 2 * ts.edges_inserted == 2 * len(s)


def test_stream_fns_match_jax():
    """The functional forms, from a state carried across mid-stream."""
    jg = jgen.rmat(128, 600, seed=9)
    s, r = _undirected(jg, seed=2)
    fin = "none+shiloach_vishkin"
    jfn = japi.VariantSpec.parse(fin).build_finish()
    tfn = tapi.VariantSpec.parse(fin).build_finish()
    jst = jstreaming.init_stream(jg.n)
    B = 64
    prev = jg.n
    for i in range(0, len(s), B):
        bu = np.full((B,), jg.n, np.int32)
        bv = np.full((B,), jg.n, np.int32)
        k = min(B, len(s) - i)
        bu[:k], bv[:k] = s[i: i + k], r[i: i + k]
        tst = tstreaming.state_from_arrays(np.asarray(jst.P), device="cpu")
        jst, jrounds = jstreaming.insert_batch_rounds_fn(
            jst, jnp.asarray(bu), jnp.asarray(bv), jfn)
        tst, trounds = tstreaming.insert_batch_rounds_fn(
            tst, torch.from_numpy(bu), torch.from_numpy(bv), tfn)
        assert trounds == int(jrounds)
        np.testing.assert_array_equal(tst.P.numpy(), np.asarray(jst.P))
        ncomp = len(np.unique(tst.P[: jg.n].numpy()))
        assert ncomp <= prev  # the component count never grows
        prev = ncomp
    pad = torch.full((8,), jg.n, dtype=torch.int32)
    assert torch.equal(tstreaming.insert_batch_fn(tst, pad, pad, tfn).P,
                       tst.P)  # an all-padding batch changes nothing
    qa = torch.arange(jg.n, dtype=torch.int32)
    qb = torch.flip(qa, [0])
    tst2, ans = tstreaming.process_batch_fn(
        tst, torch.full((8,), jg.n, dtype=torch.int32),
        torch.full((8,), jg.n, dtype=torch.int32), qa, qb, tfn)
    assert torch.equal(tst2.P, tst.P)
    np.testing.assert_array_equal(
        ans.numpy(), np.asarray(jstreaming.query_batch(
            jst, jnp.asarray(qa.numpy()), jnp.asarray(qb.numpy()))))


def test_queries_linearize_after_inserts():
    g = jgen.planted_components(64, 4, 3.0, seed=1)
    oracle = components_oracle(g)
    s = np.asarray(g.senders)[: g.m]
    r = np.asarray(g.receivers)[: g.m]
    qa, qb = np.arange(32), np.arange(32, 64)
    js, ts = _pair("none+uf_sync_full", g.n)
    want = js.process(s, r, qa, qb)
    got = ts.process(s, r, qa, qb)
    np.testing.assert_array_equal(got.numpy(), oracle[qa] == oracle[qb])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _same_state(js, ts)


def test_empty_batch_is_identity():
    js, ts = _pair("none+uf_sync_full", 32)
    before = ts.state.P.clone()
    for st in (js, ts):
        st.insert(np.full(16, 32, np.int32), np.full(16, 32, np.int32))
        st.insert([], [])
    assert torch.equal(ts.state.P, before)
    _same_state(js, ts)
    _same_stats(ts, js)
    assert ts.edges_inserted == 0


def test_duplicate_edge_inserts_are_idempotent():
    js, ts = _pair("none+uf_sync_full", 16)
    for st in (js, ts):
        st.insert([0, 1], [1, 2])
    before = ts.labels.clone()
    for _ in range(3):
        for st in (js, ts):
            st.insert([0, 1, 1], [1, 2, 0])  # repeats, both orientations
        _same_state(js, ts)
    assert torch.equal(ts.labels, before)
    assert ts.num_components() == js.num_components() == 14
    _same_stats(ts, js)


def test_self_loop_inserts_are_inert():
    js, ts = _pair("none+uf_sync_full", 16)
    ids = np.arange(8, dtype=np.int32)
    for st in (js, ts):
        st.insert(ids, ids)
    assert ts.num_components() == 16
    assert torch.equal(ts.labels, torch.arange(16, dtype=torch.int32))
    _same_state(js, ts)


def test_query_only_and_stream_knobs():
    js, ts = _pair("kout_hybrid_k2+uf_sync_naive", 12)
    for st in (js, ts):
        st.insert([0, 2, 4], [1, 3, 5])
    qa, qb = [0, 2, 1, 4], [1, 3, 2, 5]
    np.testing.assert_array_equal(ts.query(qa, qb).numpy(),
                                  np.asarray(js.query(qa, qb)))
    ci = tapi.ConnectIt("none+uf_sync_full", device="cpu")
    with pytest.raises(ValueError, match="dynamic"):
        ci.stream(16, log=64)
    assert isinstance(ci.stream(16), tapi.Stream)


SWEEP_FINISHES = FINISHES + ("liu_tarjan_PUFA", "stergiou", "label_prop")


def id_sweep(n: int) -> np.ndarray:
    """Vertex ids outside [0, n): below -(n + 1), at it, -2 and -1, the
    dump id n and past it, and the int32 extremes."""
    i32 = np.iinfo(np.int32)
    return np.array([-(n + 1) - 3, -(n + 1), -2, -1, n, n + 3, i32.min,
                     i32.max], np.int32)


def all_pairs(n: int):
    """Every pair of the sweep's ids and the real vertices, as (qa, qb)."""
    q = np.concatenate([id_sweep(n), np.arange(n, dtype=np.int32)])
    return np.repeat(q, len(q)), np.tile(q, len(q))


def sweep_inserts(n: int):
    """One batch for each swept id, on either end of an edge to a real
    vertex, beside a real edge."""
    for x in id_sweep(n):
        yield np.array([x, 1, 2], np.int32), np.array([0, x, 3], np.int32)


@pytest.mark.parametrize("finish", SWEEP_FINISHES)
def test_out_of_range_ids_answer_as_jax(finish):
    """Inserts and queries with ids outside [0, n) answer as repro's: its
    gathers clamp (an id of n or more reads the dump row) and wrap a
    negative id by n + 1 once, and a negative end of a batch reaches the
    finish method as it is. Labels, rounds and every answer are equal
    after every batch."""
    n = 6
    js, ts = _pair(f"none+{finish}", n)
    qa, qb = all_pairs(n)
    for i, (u, v) in enumerate(sweep_inserts(n)):
        for st in (js, ts):
            st.insert(u, v)
        _same_state(js, ts, f"{finish} batch {i}: {u[0]}")
        np.testing.assert_array_equal(ts.query(qa, qb).numpy(),
                                      np.asarray(js.query(qa, qb)))
    want = js.process([0], [n + 9], qa, qb)
    np.testing.assert_array_equal(ts.process([0], [n + 9], qa, qb).numpy(),
                                  np.asarray(want))
    _same_state(js, ts)
    _same_stats(ts, js)


def test_out_of_range_ids_of_the_reference_probe():
    """repro clamps an insert's id 7 onto the dump row of n = 4 (joining
    vertex 0 to it) and answers queries at 9 and -9: the port does the
    same."""
    js, ts = _pair("none+uf_sync_full", 4)
    for st in (js, ts):
        st.insert([7, 0], [0, 1])
    for qa, qb in (([0, 1, 2, 3], [4, 4, 4, 0]), ([9, -9], [4, 4])):
        got = ts.query(qa, qb).numpy()
        np.testing.assert_array_equal(got, np.asarray(js.query(qa, qb)))
    assert ts.query([0, 1, 2, 3], [4, 4, 4, 0]).tolist() == [
        True, True, False, False]
    _same_state(js, ts)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("finish", SWEEP_FINISHES)
def test_out_of_range_ids_on_card_match_cpu(cuda, finish):
    """The sweep on the card (edge_rewrite, hook_compress and the other
    kernels take the out-of-range ends) gives the CPU path's labels,
    rounds and answers."""
    n = 6
    ci = tapi.ConnectIt(f"none+{finish}", device="cpu")
    cc = tapi.ConnectIt(f"none+{finish}", device="cuda")
    ts, tc = ci.stream(n), cc.stream(n)
    qa, qb = all_pairs(n)
    for u, v in sweep_inserts(n):
        for st in (ts, tc):
            st.insert(u, v)
        assert torch.equal(tc.state.P.cpu(), ts.state.P)
        assert tc._rounds == ts._rounds
        assert torch.equal(tc.query(qa, qb).cpu(), ts.query(qa, qb))
