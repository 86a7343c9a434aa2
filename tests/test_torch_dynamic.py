"""The port's batch-dynamic connectivity against the JAX package.

The single-placement schedules of ``test_dynamic.py`` run through
``repro`` and ``repro_torch`` (on the CPU) from the same numpy batches.
After every batch the five arrays of ``DynamicState`` (labels, forest
slots, edge log) and the batch's rounds are equal, the query answers are
equal, and they equal a scipy recompute over the live edge multiset. Every
comparison is exact.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.dynamic import engine as jengine
from repro.graphs import generators as jgen
from repro_torch import api as tapi
from repro_torch.dynamic import engine as tengine
from repro_torch.graphs import generators as tgen
from test_dynamic import live_oracle, replay

VARIANT = "none+uf_sync_full"
EMPTY = np.zeros((0,), np.int32)


@pytest.fixture(autouse=True)
def _clear_jax_caches():
    """Shadow conftest's per-test cache clearing: the JAX update programs
    here run at a few small shapes, shared by one session per variant.
    Cleared once per module."""
    yield


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_once():
    yield
    jax.clear_caches()


@functools.lru_cache(maxsize=None)
def _jsession(variant: str):
    # one session per variant: its backend keeps the jitted update programs
    return japi.ConnectIt(variant)


class Pair:
    """One dynamic stream in both packages, held equal after each batch."""

    def __init__(self, n, variant=VARIANT, **kw):
        self.n = n
        self.j = _jsession(variant).stream(n, dynamic=True, **kw)
        self.t = tapi.ConnectIt(variant, device="cpu").stream(
            n, dynamic=True, **kw)
        self.live: list = []

    def check_state(self, what="") -> None:
        for leaf in tengine.DynamicState._fields:
            np.testing.assert_array_equal(
                getattr(self.t.state, leaf).numpy(),
                np.asarray(getattr(self.j.state, leaf)),
                err_msg=f"{what}: {leaf}")
        assert self.t._rounds == int(self.j._rounds), what

    def process(self, dels, ins, qa=EMPTY, qb=EMPTY):
        dels = np.asarray(dels, np.int32).reshape(-1, 2)
        ins = np.asarray(ins, np.int32).reshape(-1, 2)
        args = (dels[:, 0], dels[:, 1], ins[:, 0], ins[:, 1], qa, qb)
        want = np.asarray(self.j.process(*args))
        got = self.t.process(*args).numpy()
        replay(self.live, ins, dels)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, live_oracle(self.n, self.live, qa, qb))
        self.check_state(f"batch {self.t.batches}")
        return got

    def insert(self, u, v):
        return self.process(EMPTY, np.stack([u, v], 1))

    def delete(self, u, v):
        return self.process(np.stack([u, v], 1), EMPTY)

    def query(self, qa, qb):
        got = self.t.query(qa, qb).numpy()
        np.testing.assert_array_equal(got, np.asarray(self.j.query(qa, qb)))
        return got

    def check_end(self) -> None:
        """Exact components, forest ⊆ survivors, the log counts them."""
        n, t = self.n, self.t
        ids = np.arange(n, dtype=np.int32)
        np.testing.assert_array_equal(
            t.labels.numpy() == t.labels.numpy()[:, None],
            live_oracle(n, self.live, np.repeat(ids, n),
                        np.tile(ids, n)).reshape(n, n))
        forest = [tuple(sorted(e)) for e in t.forest_edges().tolist()]
        np.testing.assert_array_equal(t.forest_edges(), self.j.forest_edges())
        assert len(forest) == len(set(forest))
        assert set(forest) <= {tuple(sorted(e)) for e in self.live}
        assert t.log_used() == self.j.log_used() == len(self.live)
        assert t.num_components() == self.j.num_components()
        assert (dataclasses.asdict(t.stats)
                == dataclasses.asdict(self.j.stats))


# ---------------------------------------------------------------------------
# Engine pieces.
# ---------------------------------------------------------------------------

def test_default_log_cap():
    for n in (1, 256, 1000, 1 << 16):
        assert tengine.default_log_cap(n) == jengine.default_log_cap(n)


def test_pair_matching_matches_jax():
    """Sorted delete pairs and their membership sets, with pads, self-loops,
    repeats, both orientations, and sentinel queries."""
    rng = np.random.default_rng(0)
    n = 16
    du, dv = rng.integers(-1, n + 1, (2, 40)).astype(np.int32)
    du[:4], dv[:4] = n, n
    du[4:6] = dv[4:6]
    qu, qv = rng.integers(-1, n + 1, (2, 300)).astype(np.int32)
    qu[:40], qv[:40] = dv, du
    jlo, jhi = jengine.sorted_pairs(jnp.asarray(du), jnp.asarray(dv), n)
    tlo, thi = tengine.sorted_pairs(torch.from_numpy(du),
                                    torch.from_numpy(dv), n)
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))
    want = jengine.pairs_member(jlo, jhi, jnp.asarray(qu), jnp.asarray(qv))
    got = tengine.pairs_member(tlo, thi, torch.from_numpy(qu),
                               torch.from_numpy(qv))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool(got[:40].any()) and not bool(got.all())


def test_log_and_affected_helpers_match_jax():
    rng = np.random.default_rng(1)
    n, cap = 12, 32
    log_u = np.where(rng.random(cap) < 0.5, rng.integers(0, n, cap), n)
    log_v = np.where(log_u < n, rng.integers(0, n, cap), n)
    bu, bv = rng.integers(0, n + 1, (2, 8))
    bu, bv = (jnp.asarray(x, jnp.int32) for x in jengine.sanitize_pairs(
        jnp.asarray(bu, jnp.int32), jnp.asarray(bv, jnp.int32), n))
    args = [np.array(x, np.int32) for x in (log_u, log_v, bu, bv)]
    want = jengine.append_log(*map(jnp.asarray, args), n)
    got = tengine.append_log(*map(torch.from_numpy, args), n)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    P = np.array([0, 0, 2, 2, 2, 5, 5, 7, 8, 8, 10, 11, 12], np.int32)
    fu = np.array([-1, 0, -1, 2, 3, -1, 5, -1, -1, 8, -1, -1, -1], np.int32)
    hit = fu == 3
    aff = tengine.affected_mask(*map(torch.from_numpy, (P, fu, hit)))
    np.testing.assert_array_equal(aff.numpy(), np.asarray(
        jengine.affected_mask(*map(jnp.asarray, (P, fu, hit)))))
    assert aff.numpy().tolist() == [x == 2 for x in P.tolist()]
    s, r = tengine.masked_log_edges(torch.from_numpy(args[0]),
                                    torch.from_numpy(args[1]), aff, n)
    js, jr = jengine.masked_log_edges(jnp.asarray(args[0]),
                                      jnp.asarray(args[1]),
                                      jnp.asarray(aff.numpy()), n)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))


def test_stream_knob_validation():
    ci = tapi.ConnectIt(VARIANT, device="cpu")
    with pytest.raises(ValueError, match="dynamic"):
        ci.stream(16, log=64)
    with pytest.raises(ValueError, match="power of two"):
        ci.stream(16, dynamic=True, log=100)
    with pytest.raises(ValueError, match="root-based"):
        tapi.ConnectIt("none+label_prop", device="cpu").stream(
            16, dynamic=True)
    st = ci.stream(16, dynamic=True)
    assert isinstance(st, tapi.DynamicStream)
    assert st._ops.log_cap == 1024 and st.stats.exec == "single:dynamic"


# ---------------------------------------------------------------------------
# Engine semantics, schedule by schedule.
# ---------------------------------------------------------------------------

def test_delete_miss_is_tombstone_only():
    p = Pair(8, log=64)
    p.insert([0, 1, 2, 0], [1, 2, 3, 2])  # (0,2) is a non-forest extra
    before = p.t.labels.clone()
    p.process([[0, 2]], EMPTY, [0], [3])
    assert torch.equal(p.t.labels, before)
    assert p.t.log_used() == 3
    p.check_end()


def test_forest_hit_finds_replacement():
    p = Pair(8, log=64)
    p.insert([0, 1, 2, 3, 0], [1, 2, 3, 0, 2])  # a 4-cycle + chord
    victim = tuple(sorted(p.t.forest_edges().tolist()[0]))
    assert bool(p.process([victim], EMPTY, [0], [3])[0])
    assert p.t.num_components() == 4 + 1
    p.check_end()


def test_forest_hit_splits_component():
    p = Pair(8, log=64)
    p.insert([0, 1], [1, 2])
    assert not p.process([[1, 2]], EMPTY, [0, 0], [2, 1])[0]
    assert 2 not in {x for e in p.t.forest_edges().tolist() for x in e}
    p.check_end()


def test_self_loops_never_enter_forest_or_log():
    p = Pair(8, log=64)
    p.insert([3, 3, 0], [3, 3, 1])
    assert p.t.log_used() == 1 and p.t.forest_edges().shape == (1, 2)
    assert p.t.num_components() == 7
    p.check_end()


def test_duplicate_inserts_all_removed_by_one_delete():
    p = Pair(8, log=64)
    p.insert([0, 1, 0, 0], [1, 0, 1, 2])
    assert p.t.log_used() == 4
    ans = p.process([[1, 0]], EMPTY, [0, 0], [1, 2])  # either orientation
    assert p.t.log_used() == 1 and ans.tolist() == [False, True]
    p.check_end()


def test_deleted_then_reinserted_in_one_batch_survives():
    p = Pair(8, log=64)
    p.insert([0], [1])
    assert p.process([[0, 1]], [[0, 1]], [0], [1]).tolist() == [True]
    assert p.t.log_used() == 1
    p.check_end()


def test_log_capacity_guard():
    p = Pair(64, log=16)
    rng = np.random.default_rng(0)
    u = rng.integers(0, 32, 12).astype(np.int32)
    v = rng.integers(32, 64, 12).astype(np.int32)
    p.insert(u, v)
    with pytest.raises(ValueError, match="edge log full"):
        p.t.insert(u, v)
    # deletions free capacity and the guard reads the true occupancy
    p.delete(u, v)
    p.insert(u[:4], v[:4])
    p.check_end()


def test_tombstoned_slots_are_reused():
    p = Pair(64, log=16)
    for r in range(6):  # 6 x 8 inserts through 16 slots
        u = np.arange(8, dtype=np.int32)
        v = u + 8 + 8 * (r % 2)
        p.insert(u, v)
        p.delete(u, v)
    assert p.t.log_used() == 0
    p.check_end()


def test_bounded_search_falls_back_to_a_rebuild():
    """A long path: with search_rounds=1 the replacement search exhausts its
    bound and rebuilds; the rounds still count as the reference's."""
    n = 32
    p = Pair(n, log=256, search_rounds=1)
    u = np.arange(n - 1, dtype=np.int32)
    p.insert(u, u + 1)
    p.insert([0], [n - 1])  # close the cycle
    before = p.t._rounds
    assert p.process([[n // 2, n // 2 + 1]], EMPTY, [0], [n - 1])[0]
    assert p.t._rounds - before > 2  # the search and its rebuild
    assert p.t.num_components() == 1
    assert not p.process([[0, n - 1]], EMPTY, [n // 2], [n // 2 + 1])[0]
    assert p.t.num_components() == 2
    p.check_end()


def test_mixed_schedule_from_a_carried_state():
    """A random mixed schedule; halfway, the port restarts from the JAX
    state carried across with ``state_from_arrays``."""
    n = 48
    rng = np.random.default_rng(5)
    p = Pair(n, log=512)
    for step in range(10):
        ins = rng.integers(0, n, size=(int(rng.integers(0, 8)), 2))
        ndel = int(rng.integers(0, 4)) if p.live else 0
        dels = (np.asarray([p.live[i] for i in
                            rng.integers(0, len(p.live), ndel)])
                if ndel else np.zeros((0, 2)))
        qa, qb = rng.integers(0, n, (2, 6)).astype(np.int32)
        p.process(dels, ins, qa, qb)
        if step == 4:
            p.t.state = tengine.state_from_arrays(
                *(np.asarray(x) for x in p.j.state), device="cpu")
    p.check_end()


@pytest.mark.parametrize("schedule", ["sliding_window", "flash_crowd",
                                      "partition_heal"])
def test_churn_schedules_match_jax_and_scipy(schedule):
    n = 64
    kw = dict(steps=6, batch=32, queries=8, seed=3)
    if schedule == "sliding_window":
        kw["window"] = 2
    steps = list(getattr(tgen, schedule)(n, **kw))
    for (a, b, c), want in zip(steps, getattr(jgen, schedule)(n, **kw)):
        for x, y in zip((a, b, c), want):
            assert x.dtype == y.dtype == np.int32
            np.testing.assert_array_equal(x, y)
    p = Pair(n, log=1024)
    for ins, dels, q in steps:
        p.process(dels, ins, q[:, 0], q[:, 1])
    p.check_end()


# ---------------------------------------------------------------------------
# Ids outside [0, n): the port answers as repro does.
# ---------------------------------------------------------------------------

def _id_sweep(n: int) -> np.ndarray:
    i32 = np.iinfo(np.int32)
    return np.array([-(n + 1) - 3, -(n + 1), -2, -1, n, n + 3, i32.min,
                     i32.max], np.int32)


@pytest.mark.parametrize("variant", [VARIANT, "none+shiloach_vishkin"])
def test_out_of_range_ids_answer_as_jax(variant):
    """Each swept id on either end of an insert and a delete, and in every
    query pair with the real vertices: repro drops such an insert or
    delete (its endpoints are sanitized to the dump pair) and answers the
    queries through its clamping, wrapping gather. All five state arrays,
    the rounds and every answer are equal after every batch; the stats
    too."""
    n = 6
    p = Pair(n, variant, log=64)
    ids = _id_sweep(n)
    q = np.concatenate([ids, np.arange(n, dtype=np.int32)])
    qa, qb = np.repeat(q, len(q)), np.tile(q, len(q))

    def both(*args):
        got = p.t.process(*args).numpy()
        np.testing.assert_array_equal(got, np.asarray(p.j.process(*args)))
        p.check_state(f"{variant} batch {p.t.batches}")

    both(EMPTY, EMPTY, np.array([0, 1, 3], np.int32),
         np.array([1, 2, 4], np.int32), qa, qb)
    for x in ids:
        e = np.array([x, 0], np.int32)
        f = np.array([0, x], np.int32)
        both(e, f, f, e, qa, qb)
        both(np.array([0], np.int32), np.array([1], np.int32), e, f, qa, qb)
        got = p.t.query(qa, qb).numpy()
        np.testing.assert_array_equal(got, np.asarray(p.j.query(qa, qb)))
    assert p.t.num_components() == p.j.num_components()
    assert dataclasses.asdict(p.t.stats) == dataclasses.asdict(p.j.stats)
