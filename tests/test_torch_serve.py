"""The port's serving subsystem (``repro_torch.serve``) against the JAX
package's (``repro.serve``).

The same seeded numpy traffic goes through ``repro`` (single placement) and
``repro_torch`` on the CPU. After every commit the committed label buffer
(and, on a dynamic server, every array of the ``DynamicState``) is equal
bit for bit; epochs, ``epoch_edges``, ``epoch_deletes``, ``rounds_total``
and every ``ServerStats`` / ``TenantStats`` field are equal; every answer
equals scipy's on the edges of its epoch. The behaviour tests of
``test_serve.py`` and the serve tests of ``test_dynamic.py`` are mirrored
against the port with scipy as the oracle. Card tests (``gpu``) hold the
servers on the card against the port's CPU path.
"""

import asyncio
import dataclasses
import functools
import threading

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.serve import ServeConfig as JServeConfig
from repro.serve import loadgen as jloadgen
from repro_torch import api as tapi
from repro_torch.dynamic import engine as tengine
from repro_torch.serve import (
    ServeConfig,
    TenantRegistry,
    closed_loop,
    loadgen,
    open_loop,
    run_sync,
)
from test_dynamic import live_oracle, replay
from test_serve import pairs_oracle

VARIANTS = ("none+uf_sync_full", "none+shiloach_vishkin",
            "none+liu_tarjan_CRFA")
MAIN = "none+uf_sync_full"


@pytest.fixture(autouse=True)
def _clear_jax_caches():
    """Shadow conftest's per-test cache clearing: the JAX commit programs
    here run at a few small shapes, shared by one session per variant.
    Cleared once per module."""
    yield


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_once():
    yield
    jax.clear_caches()


@functools.lru_cache(maxsize=None)
def _jsession(variant: str):
    # one session per variant: its backend keeps the jitted commit programs
    return japi.ConnectIt(variant)


def small(**kw) -> dict:
    base = dict(max_batch_edges=256, max_batch_queries=256, flush_ms=0.5,
                warmup=False)
    base.update(kw)
    return base


def port_server(variant=MAIN, n=None, *, device="cpu", **kw):
    """A port server with the small admission caps; ``kw`` takes
    ``tenants``, ``dynamic``, ``log`` and ServeConfig knobs."""
    serve_kw = {k: kw.pop(k) for k in ("tenants", "dynamic", "log")
                if k in kw}
    return tapi.ConnectIt(variant, device=device).serve(
        n, config=ServeConfig(**small(**kw)), **serve_kw)


def server_pair(variant=MAIN, n=None, **kw):
    """The same server in both packages."""
    serve_kw = {k: kw.pop(k) for k in ("tenants", "dynamic", "log")
                if k in kw}
    j = _jsession(variant).serve(n, config=JServeConfig(**small(**kw)),
                                 **serve_kw)
    t = port_server(variant, n, **serve_kw, **kw)
    return j, t


def state_arrays(store) -> dict:
    """The committed state's arrays, as numpy, by name."""
    st = store._committed
    if store.dynamic:
        return {f: np.asarray(getattr(st, f).cpu() if isinstance(
            getattr(st, f), torch.Tensor) else getattr(st, f))
            for f in tengine.DynamicState._fields}
    return {"P": np.asarray(st.cpu() if isinstance(st, torch.Tensor)
                            else st)}


def assert_same(j, t, what="") -> None:
    """Committed state, epochs and counters equal in both packages."""
    a, b = state_arrays(j.store), state_arrays(t.store)
    for name in a:
        np.testing.assert_array_equal(b[name], a[name],
                                      err_msg=f"{what}: {name}")
    for attr in ("epoch", "epoch_edges", "epoch_deletes", "rounds_total"):
        assert getattr(t.store, attr) == getattr(j.store, attr), \
            f"{what}: {attr}"


def assert_same_stats(j, t) -> None:
    assert dataclasses.asdict(t.stats()) == dataclasses.asdict(j.stats())


def rand_edges(rng, n, k):
    return (rng.integers(0, n, size=k).astype(np.int32),
            rng.integers(0, n, size=k).astype(np.int32))


# ---------------------------------------------------------------------------
# Parity with repro.serve: state after every commit, epochs, rounds, stats.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", VARIANTS)
def test_sync_commits_match_jax(variant):
    n = 64
    rng = np.random.default_rng(3)
    j, t = server_pair(variant, n)
    all_s, all_r = [], []
    for rnd in range(5):
        u, v = rand_edges(rng, n, int(rng.integers(1, 40)))
        assert t.commit_now(u, v) == j.commit_now(u, v) == rnd + 1
        all_s.append(u)
        all_r.append(v)
        assert_same(j, t, f"commit {rnd + 1}")
        qa, qb = rand_edges(rng, n, 33)
        (ja, je), (ta, te) = j.query_now(qa, qb), t.query_now(qa, qb)
        assert te == je == rnd + 1
        np.testing.assert_array_equal(ta, np.asarray(ja))
        np.testing.assert_array_equal(
            ta, pairs_oracle(n, np.concatenate(all_s), np.concatenate(all_r),
                             qa, qb))
    assert t.num_components() == j.num_components()
    assert_same_stats(j, t)


@pytest.mark.parametrize("variant", VARIANTS)
def test_async_traffic_matches_jax(variant):
    """Requests awaited one at a time cut one batch each, so the two
    servers coalesce alike and every counter agrees; two tenants share the
    state."""
    tenants = {"alpha": 40, "beta": 24}
    j, t = server_pair(variant, tenants=tenants)
    rng = np.random.default_rng(8)
    script = []
    for rnd in range(6):
        name = "alpha" if rnd % 2 == 0 else "beta"
        size = tenants[name]
        script.append((name, *rand_edges(rng, size, int(rng.integers(1, 30))),
                       *rand_edges(rng, size, int(rng.integers(1, 20)))))

    def drive(server):
        out = []

        async def main():
            async with server:
                for name, u, v, qa, qb in script:
                    epoch = await server.submit_inserts(u, v, tenant=name)
                    ans, at = await server.query(qa, qb, tenant=name)
                    out.append((epoch, at, np.asarray(ans)))
        asyncio.run(main())
        return out

    got, want = drive(t), drive(j)
    for (te, ta_epoch, ta), (je, ja_epoch, ja) in zip(got, want, strict=True):
        assert (te, ta_epoch) == (je, ja_epoch)
        np.testing.assert_array_equal(ta, ja)
    assert_same(j, t, "end")
    assert_same_stats(j, t)
    for name in tenants:
        assert t.num_components(name) == j.num_components(name)


@pytest.mark.parametrize("variant", ("none+uf_sync_full",
                                     "none+shiloach_vishkin"))
def test_dynamic_commits_match_jax(variant):
    """Mixed batches through both dynamic stores (forest hits included),
    then sequential async traffic with deletes: every array of the state
    after every commit, the live-multiset answers and the stats."""
    n = 48
    rng = np.random.default_rng(21)
    j, t = server_pair(variant, n, dynamic=True, log=512)
    live: list = []
    for rnd in range(6):
        ins = rng.integers(0, n, size=(int(rng.integers(1, 24)), 2)).astype(
            np.int32)
        dels = np.zeros((0, 2), np.int32)
        if live:
            idx = rng.integers(0, len(live), size=(int(rng.integers(1, 6)),))
            dels = np.asarray([live[i] for i in idx], np.int32)
        args = (ins[:, 0], ins[:, 1], dels[:, 0], dels[:, 1])
        assert t.store.commit(*args) == j.store.commit(*args) == rnd + 1
        replay(live, ins, dels)
        assert_same(j, t, f"commit {rnd + 1}")
        qa, qb = rand_edges(rng, n, 24)
        ta, _ = t.store.query(qa, qb)
        np.testing.assert_array_equal(ta.numpy(), live_oracle(n, live, qa, qb))
        np.testing.assert_array_equal(ta.numpy(),
                                      np.asarray(j.store.query(qa, qb)[0]))
    hit = live[0]
    for server in (j, t):
        server.delete_now([hit[0]], [hit[1]])
    replay(live, np.zeros((0, 2), np.int32), np.asarray([hit], np.int32))
    assert_same(j, t, "delete_now")

    def drive(server):
        async def main():
            async with server:
                r = np.random.default_rng(5)
                for _ in range(3):
                    u, v = rand_edges(r, n, 10)
                    await server.submit_inserts(u, v)
                    await server.submit_deletes(u[:3], v[:3])
                    await server.query(*rand_edges(r, n, 8))
        asyncio.run(main())

    drive(j)
    drive(t)
    assert_same(j, t, "async")
    assert_same_stats(j, t)
    assert t.store.epoch_deletes[-1] > 0


@pytest.mark.parametrize("dynamic", (False, True))
def test_donate_gives_identical_epochs_and_labels(dynamic):
    """``donate=True`` drops the shadow before the commit; the epochs,
    labels, rounds and answers are those of ``donate=False``."""
    n = 40
    kw = dict(dynamic=True, log=256) if dynamic else {}
    on = port_server(MAIN, n, donate=True, **kw)
    off = port_server(MAIN, n, donate=False, **kw)
    rng = np.random.default_rng(4)
    for rnd in range(4):
        u, v = rand_edges(rng, n, 12)
        for server in (on, off):
            pending = server.store.begin_commit(u, v)
            # donation drops the shadow before the commit; without it the
            # shadow is held until the rotation
            assert (server.store._shadow is None) == (server is on)
            server.store.finish_commit(pending)
        a, b = state_arrays(on.store), state_arrays(off.store)
        for name in a:
            np.testing.assert_array_equal(a[name], b[name])
        qa, qb = rand_edges(rng, n, 16)
        np.testing.assert_array_equal(on.query_now(qa, qb)[0],
                                      off.query_now(qa, qb)[0])
    for attr in ("epoch", "epoch_edges", "epoch_deletes", "rounds_total"):
        assert getattr(on.store, attr) == getattr(off.store, attr)


@pytest.mark.parametrize("dynamic", (False, True))
def test_commit_never_writes_the_committed_buffer(dynamic):
    n = 32
    kw = dict(dynamic=True, log=256) if dynamic else {}
    server = port_server(MAIN, n, **kw)
    server.commit_now(np.arange(0, 10), np.arange(1, 11))
    before = {k: v.copy() for k, v in state_arrays(server.store).items()}
    held = server.store._committed
    pending = server.store.begin_commit(np.arange(10, 20), np.arange(11, 21))
    assert server.store._committed is held
    for name, arr in state_arrays(server.store).items():
        np.testing.assert_array_equal(arr, before[name], err_msg=name)
    server.store.finish_commit(pending)
    assert server.store._shadow is held


def test_loadgen_traffic_matches_jax():
    for seed in (0, 7):
        a = loadgen._traffic(np.random.default_rng(seed), 100, 16, 8)
        b = jloadgen._traffic(np.random.default_rng(seed), 100, 16, 8)
        for x, y in zip(a, b, strict=True):
            np.testing.assert_array_equal(x, y)
        hist = [(i, i + 1) for i in range(10)]
        a = loadgen._sample_deletes(np.random.default_rng(seed), hist, 5)
        b = jloadgen._sample_deletes(np.random.default_rng(seed), hist, 5)
        for x, y in zip(a, b, strict=True):
            np.testing.assert_array_equal(x, y)
    lat = np.random.default_rng(1).exponential(size=97).tolist()
    assert loadgen.percentiles(lat) == jloadgen.percentiles(lat)
    assert loadgen.percentiles([]) == jloadgen.percentiles([])


def test_full_edge_log_raises_as_jax():
    j, t = server_pair(MAIN, 16, dynamic=True, log=32)
    u = np.arange(0, 15, dtype=np.int32)
    for server in (j, t):
        server.commit_now(u, u + 1)
        server.commit_now(u, u + 1)
    errors = []
    for server in (j, t):
        with pytest.raises(ValueError, match="edge log full") as e:
            server.commit_now(u, u + 1)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert_same(j, t, "after the refused batch")


def test_serve_argument_checks_raise_as_jax():
    """A non-forest finish with ``dynamic``, a ``log`` that is not a power
    of two, ``log=`` without ``dynamic`` and ``n`` with ``tenants``."""
    cases = (
        ("none+label_prop", dict(dynamic=True), ValueError, "root-based"),
        (MAIN, dict(dynamic=True, log=100), ValueError, "power of two"),
        (MAIN, dict(log=64), ValueError, "dynamic-serving knob"),
        (MAIN, dict(tenants={"a": 4}), ValueError, "pass n or tenants"),
    )
    for variant, kw, exc, match in cases:
        for ci in (japi.ConnectIt(variant),
                   tapi.ConnectIt(variant, device="cpu")):
            with pytest.raises(exc, match=match):
                ci.serve(16, **kw)


def test_serve_runs_on_the_sessions_device():
    server = tapi.ConnectIt(MAIN, device="cpu").serve(8)
    assert server.store.device == torch.device("cpu")
    assert server.store._stream is None
    assert server.stats().exec == "single" and server.stats().devices == 1


def test_cli_matches_jax_on_the_same_seed():
    """The CLIs commit every submitted edge: the final labels agree,
    however the concurrent clients' requests were coalesced."""
    from repro.launch.serve import serve as jserve
    from repro_torch.launch.serve import serve as tserve
    kw = dict(batches=4, batch_edges=32, queries=8, clients=2, seed=7,
              verbose=False)
    _, js = jserve(128, **kw)
    _, ts = tserve(128, device="cpu", **kw)
    np.testing.assert_array_equal(ts.store.labels.numpy(),
                                  np.asarray(js.store.labels))
    assert ts.stats().edges_committed == js.stats().edges_committed


# ---------------------------------------------------------------------------
# test_serve.py, mirrored against the port (scipy as the oracle).
# ---------------------------------------------------------------------------


def test_interleaved_traffic_matches_oracle():
    n = 128
    rng = np.random.default_rng(5)
    server = port_server(MAIN, n)
    all_s, all_r = [], []

    async def main():
        async with server:
            for rnd in range(6):
                u, v = rand_edges(rng, n, int(rng.integers(1, 40)))
                epoch = await server.submit_inserts(u, v)
                assert epoch == rnd + 1
                all_s.append(u)
                all_r.append(v)
                qa, qb = rand_edges(rng, n, 33)
                ans, at_epoch = await server.query(qa, qb)
                assert at_epoch == epoch
                expect = pairs_oracle(n, np.concatenate(all_s),
                                      np.concatenate(all_r), qa, qb)
                np.testing.assert_array_equal(ans, expect)

    asyncio.run(main())
    assert server.epoch == 6
    assert server.epoch_edges[-1] == sum(len(s) for s in all_s)


@pytest.mark.parametrize("variant", ["none+shiloach_vishkin",
                                     "none+liu_tarjan_CRFA"])
def test_serving_other_finish_variants(variant):
    n = 96
    rng = np.random.default_rng(11)
    u, v = rand_edges(rng, n, 150)
    server = port_server(variant, n)
    server.commit_now(u, v)
    qa, qb = rand_edges(rng, n, 40)
    ans, epoch = server.query_now(qa, qb)
    assert epoch == 1
    np.testing.assert_array_equal(ans, pairs_oracle(n, u, v, qa, qb))


def test_snapshot_isolation_race():
    n = 128
    server = port_server(MAIN, n)
    store = server.store
    store.commit(np.arange(0, 20, dtype=np.int32),
                 np.arange(1, 21, dtype=np.int32))
    assert store.epoch == 1
    # compute an insert batch but hold the epoch boundary open
    pending = store.begin_commit(np.array([20], np.int32),
                                 np.array([40], np.int32))
    qa = np.array([0, 0, 0], np.int32)
    qb = np.array([20, 40, 41], np.int32)
    ans, epoch = store.query(qa, qb)
    # the racing query reads exactly the prior epoch: 0-20 connected, the
    # uncommitted (20, 40) edge invisible
    assert epoch == 1
    assert ans.tolist() == [True, False, False]
    assert store.finish_commit(pending) == 2
    ans2, epoch2 = store.query(qa, qb)
    assert epoch2 == 2
    assert ans2.tolist() == [True, True, False]
    assert store.epoch_edges == [0, 20, 21]


def test_snapshot_store_rejects_overlapping_commits():
    server = port_server(MAIN, 32)
    u = np.array([0], np.int32)
    v = np.array([1], np.int32)
    pending = server.store.begin_commit(u, v)
    with pytest.raises(RuntimeError, match="already in flight"):
        server.store.begin_commit(u, v)
    server.store.finish_commit(pending)
    with pytest.raises(RuntimeError, match="stale"):
        server.store.finish_commit(pending)


def test_concurrent_traffic_linearizes():
    """Mixed async traffic: every query response equals the oracle of the
    edge prefix its epoch tag claims (the FIFO admission queue makes the
    committed edges of each epoch a prefix of submission order)."""
    n = 96
    rng = np.random.default_rng(9)
    server = port_server(MAIN, n, flush_ms=2.0, max_batch_edges=64)
    submitted_s, submitted_r = [], []
    results = []

    async def main():
        async with server:
            tasks = []
            for i in range(24):
                u, v = rand_edges(rng, n, int(rng.integers(1, 12)))
                submitted_s.append(u)
                submitted_r.append(v)
                tasks.append(asyncio.create_task(server.submit_inserts(u, v)))
                qa, qb = rand_edges(rng, n, 7)

                async def q(qa=qa, qb=qb):
                    ans, epoch = await server.query(qa, qb)
                    results.append((qa, qb, ans, epoch))

                tasks.append(asyncio.create_task(q()))
                if i % 5 == 0:
                    await asyncio.sleep(0.002)
            await asyncio.gather(*tasks)

    asyncio.run(main())
    all_s = np.concatenate(submitted_s)
    all_r = np.concatenate(submitted_r)
    log = server.epoch_edges
    assert log[-1] == all_s.shape[0]  # every submitted edge committed
    assert len(results) == 24
    for qa, qb, ans, epoch in results:
        m = log[epoch]
        np.testing.assert_array_equal(
            ans, pairs_oracle(n, all_s[:m], all_r[:m], qa, qb))


def test_tenant_isolation_and_stats():
    server = port_server(MAIN, tenants={"alpha": 64, "beta": 48})

    async def main():
        async with server:
            await server.submit_inserts(np.arange(0, 30), np.arange(1, 31),
                                        tenant="alpha")
            await server.submit_inserts(np.zeros(20, np.int32),
                                        np.arange(1, 21), tenant="beta")
            ans_a, _ = await server.query([0, 0], [30, 31], tenant="alpha")
            ans_b, _ = await server.query([1, 21], [2, 22], tenant="beta")
            return ans_a, ans_b

    ans_a, ans_b = asyncio.run(main())
    assert ans_a.tolist() == [True, False]
    assert ans_b.tolist() == [True, False]
    assert server.num_components("alpha") == 64 - 30
    assert server.num_components("beta") == 48 - 20
    st = server.stats()
    assert st.tenants["alpha"].edges_committed == 30
    assert st.tenants["beta"].edges_committed == 20
    assert st.tenants["alpha"].queries == 2
    assert st.tenants["beta"].positives == 1
    assert st.epoch >= 1


def test_tenant_id_validation():
    server = port_server(MAIN, tenants={"a": 16, "b": 16})
    with pytest.raises(ValueError, match="out of range"):
        server.query_now([0], [16], tenant="a")
    with pytest.raises(KeyError, match="unknown tenant"):
        server.query_now([0], [1], tenant="nope")
    reg = TenantRegistry({"a": 16, "b": 16})
    assert reg.total == 32
    assert reg.get("b").base == 16
    with pytest.raises(ValueError):
        TenantRegistry.build(n=8, tenants={"a": 4})
    with pytest.raises(ValueError):
        TenantRegistry({"bad name": 4})


def test_coalescing_merges_concurrent_requests():
    server = port_server(MAIN, 256, flush_ms=5.0)

    async def main():
        async with server:
            tasks = [asyncio.create_task(
                server.query(np.array([i], np.int32),
                             np.array([i + 1], np.int32)))
                for i in range(50)]
            await asyncio.gather(*tasks)

    asyncio.run(main())
    st = server.stats()
    assert st.queries_answered == 50
    assert st.query_batches < 50
    for shape in st.query_shapes:
        assert shape & (shape - 1) == 0  # pow2 dispatch shapes


def test_backpressure_bounds_queue_depth():
    server = port_server(MAIN, 512, max_batch_edges=32, max_pending_edges=64,
                         flush_ms=0.0)

    async def main():
        async with server:
            tasks = [asyncio.create_task(server.submit_inserts(
                np.full(16, i, np.int32), np.full(16, i + 1, np.int32)))
                for i in range(30)]
            return await asyncio.gather(*tasks)

    epochs = asyncio.run(main())
    assert len(epochs) == 30 and max(epochs) >= 1
    st = server.stats()
    assert st.edges_committed == 30 * 16
    # admission never held more than the threshold plus one request
    assert st.peak_pending_edges <= 64 + 16


def test_flush_timer_dispatches_partial_batches():
    server = port_server(MAIN, 64, flush_ms=2.0, max_batch_edges=4096)

    async def main():
        async with server:
            # far below the admission cap: only the flush timer can cut it
            return await asyncio.wait_for(
                server.submit_inserts(np.array([1], np.int32),
                                      np.array([2], np.int32)),
                timeout=5.0)

    assert asyncio.run(main()) == 1


@pytest.mark.parametrize("dynamic", (False, True))
def test_warmup_leaves_the_state_untouched(dynamic):
    kw = dict(dynamic=True, log=256) if dynamic else {}
    server = port_server(MAIN, 64, warmup="all", max_batch_edges=32,
                         max_batch_queries=32, **kw)
    before = {k: v.copy() for k, v in state_arrays(server.store).items()}

    async def main():
        async with server:
            assert server.epoch == 0                  # no epoch consumed
            assert server.num_components() == 64      # no edge committed
            return await server.query([0], [1])

    ans, epoch = asyncio.run(main())
    assert epoch == 0 and ans.tolist() == [False]
    assert server.epoch_edges == [0] and server.store.rounds_total == 0
    for name, arr in state_arrays(server.store).items():
        np.testing.assert_array_equal(arr, before[name], err_msg=name)
    st = server.stats()
    assert (st.commit_batches, st.query_batches) == (0, 1)


def test_serve_config_validation_matches_jax():
    bad = (dict(max_batch_edges=0), dict(flush_ms=-1),
           dict(max_batch_edges=128, max_pending_edges=64),
           dict(warmup="sometimes"), dict(max_batch_queries=1.5))
    for kw in bad:
        msgs = []
        for cls in (ServeConfig, JServeConfig):
            with pytest.raises(ValueError) as e:
                cls(**kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    assert dataclasses.asdict(ServeConfig()) == dataclasses.asdict(
        JServeConfig())
    assert ServeConfig(flush_ms=2).flush_s == 0.002


def test_serve_cli_accepts_seed_flag():
    from repro_torch.launch.serve import main
    assert main(["--n", "128", "--batches", "4", "--batch", "32",
                 "--queries", "8", "--clients", "2", "--seed", "7",
                 "--flush-ms", "0.5", "--device", "cpu"]) == 0


def test_serve_driver_excludes_warmup_from_workload():
    from repro_torch.launch.serve import serve
    qps, server = serve(256, batches=4, batch_edges=64, queries=16,
                        clients=2, seed=3, device="cpu", verbose=False)
    assert qps > 0
    st = server.stats()
    assert st.edges_committed == st.tenants["default"].edges_submitted
    assert server.epoch_edges[-1] == st.edges_committed


# ---------------------------------------------------------------------------
# test_dynamic.py's serve tests, mirrored against the port.
# ---------------------------------------------------------------------------


def test_serve_mixed_traffic_matches_oracle():
    n = 96
    rng = np.random.default_rng(7)
    server = port_server(MAIN, n, dynamic=True, log=1024)
    multiset: list = []

    async def main():
        async with server:
            for _ in range(5):
                ins = rng.integers(0, n, size=(20, 2)).astype(np.int32)
                await server.submit_inserts(ins[:, 0], ins[:, 1])
                replay(multiset, ins, np.zeros((0, 2), np.int32))
                idx = rng.integers(0, len(multiset), size=(4,))
                dels = np.asarray([multiset[i] for i in idx], np.int32)
                await server.submit_deletes(dels[:, 0], dels[:, 1])
                replay(multiset, np.zeros((0, 2), np.int32), dels)
                qa, qb = rand_edges(rng, n, 16)
                ans, _ = await server.query(qa, qb)
                assert (ans == live_oracle(n, multiset, qa, qb)).all()
            st = server.stats()
            assert st.edges_deleted == 20
            assert st.tenants["default"].deletes_committed == 20

    asyncio.run(main())


def test_snapshot_race_with_deletions():
    """A query admitted while a delete commit is in flight reads exactly
    the prior epoch; after finish_commit the flip is visible, with an exact
    epoch tag."""
    server = port_server(MAIN, 32, dynamic=True, log=256)
    store = server.store
    store.commit([0, 1], [1, 2])
    assert store.epoch == 1
    pending = store.begin_commit([], [], [1], [2])    # delete mid-flight
    ans, epoch = store.query([0], [2])
    assert epoch == 1 and bool(ans[0])               # prior epoch
    assert store.finish_commit(pending) == 2
    ans, epoch = store.query([0], [2])
    assert epoch == 2 and not bool(ans[0])
    assert store.epoch_deletes == [0, 0, 1]


def test_serve_delete_requires_dynamic():
    server = port_server(MAIN, 16)
    with pytest.raises(RuntimeError, match="dynamic"):
        server.delete_now([0], [1])
    with pytest.raises(RuntimeError, match="dynamic"):
        server.store.begin_commit([0], [1], [0], [1])

    async def main():
        async with server:
            with pytest.raises(RuntimeError, match="dynamic"):
                await server.submit_deletes([0], [1])

    asyncio.run(main())


def test_serve_dynamic_sync_path_and_warmup():
    server = port_server(MAIN, 48, dynamic=True, log=512, warmup=True)

    async def main():
        async with server:
            pass

    asyncio.run(main())                  # warmup runs the delete shapes
    server.commit_now([0, 1], [1, 2])
    server.delete_now([1], [2])
    ans, _ = server.query_now([0, 0], [1, 2])
    assert bool(ans[0]) and not bool(ans[1])


def test_loadgen_delete_frac():
    server = port_server(MAIN, 64, dynamic=True, log=4096)
    res = run_sync(server, closed_loop, clients=2, requests_per_client=4,
                   query_pairs=8, insert_every=2, insert_edges=16,
                   delete_frac=0.5, seed=0)
    assert res.deletes > 0
    assert server.stats().edges_deleted > 0
    # delete_frac=0.0 stays on the static path (works on a static server)
    server2 = port_server(MAIN, 64)
    res2 = run_sync(server2, closed_loop, clients=2, requests_per_client=4,
                    query_pairs=8, insert_every=2, insert_edges=16,
                    delete_frac=0.0, seed=0)
    assert res2.deletes == 0


def test_open_loop_commits_and_answers():
    server = port_server(MAIN, 64)
    res = run_sync(server, open_loop, qps=2000.0, requests=16,
                   query_pairs=8, insert_every=4, insert_edges=8, seed=1)
    assert (res.mode, res.queries, res.inserts) == ("open", 16, 4)
    assert server.epoch_edges[-1] == 4 * 8
    assert res.p50_ms <= res.p99_ms <= res.max_ms


# ---------------------------------------------------------------------------
# On the card: the servers against the port's CPU path.
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _traffic_script(n, seed, dynamic):
    rng = np.random.default_rng(seed)
    script, live = [], []
    for _ in range(5):
        ins = rng.integers(0, n, size=(int(rng.integers(1, 300)), 2)).astype(
            np.int32)
        dels = np.zeros((0, 2), np.int32)
        if dynamic and live:
            idx = rng.integers(0, len(live), size=(int(rng.integers(1, 40)),))
            dels = np.asarray([live[i] for i in idx], np.int32)
        replay(live, ins, dels)
        script.append((ins, dels, *rand_edges(rng, n, 500)))
    return script


@pytest.mark.gpu
@pytest.mark.parametrize("variant,dynamic", [
    ("none+uf_sync_full", False), ("none+uf_sync_full", True),
    ("none+liu_tarjan_CRFA", False), ("none+liu_tarjan_PUFA", False),
    ("kout_hybrid_k2+uf_sync_full", False),
])
def test_servers_on_card_match_cpu(cuda, variant, dynamic):
    """Sync commits and sequential async traffic through a server on the
    card and one on the CPU: state after every commit, rounds, answers
    and stats equal. Liu-Tarjan commits launch scatter_min (CRFA's connect
    rule) or edge_relabel (PUFA's parent-connect rule)."""
    from repro_torch.kernels import ops
    n = 1 << 12
    kw = dict(dynamic=True, log=1 << 14) if dynamic else {}
    cpu = port_server(variant, n, **kw)
    card = port_server(variant, n, device="cuda", **kw)
    ops.reset_launch_counts()
    for ins, dels, qa, qb in _traffic_script(n, 2, dynamic):
        for server in (cpu, card):
            server.store.commit(ins[:, 0], ins[:, 1],
                                *((dels[:, 0], dels[:, 1]) if dynamic
                                  else ()))
        a, b = state_arrays(cpu.store), state_arrays(card.store)
        for name in a:
            np.testing.assert_array_equal(b[name], a[name], err_msg=name)
        assert card.store.rounds_total == cpu.store.rounds_total
        np.testing.assert_array_equal(card.query_now(qa, qb)[0],
                                      cpu.query_now(qa, qb)[0])
    counts = ops.launch_counts()
    assert counts["pointer_jump"] > 0
    if variant.endswith("CRFA"):
        assert counts["scatter_min"] > 0
    if variant.endswith("PUFA"):
        assert counts["edge_relabel"] > 0
    if variant.endswith("uf_sync_full") and not dynamic:
        assert counts["edge_rewrite"] == 5   # one a commit

    def drive(server):
        async def main():
            async with server:
                r = np.random.default_rng(6)
                for _ in range(4):
                    u, v = rand_edges(r, n, 200)
                    await server.submit_inserts(u, v)
                    if dynamic:
                        await server.submit_deletes(u[:20], v[:20])
                    await server.query(*rand_edges(r, n, 100))
        asyncio.run(main())

    drive(cpu)
    drive(card)
    a, b = state_arrays(cpu.store), state_arrays(card.store)
    for name in a:
        np.testing.assert_array_equal(b[name], a[name], err_msg=name)
    assert dataclasses.asdict(card.stats()) == dataclasses.asdict(cpu.stats())


@pytest.mark.gpu
@pytest.mark.parametrize("dynamic", (False, True))
def test_query_during_in_flight_commit_on_card_reads_prior_epoch(cuda,
                                                                 dynamic):
    """A commit runs in a worker thread on the store's stream while the
    main thread queries: every answer carries epoch 1 and equals epoch 1's
    until the rotation; then epoch 2's."""
    n = 1 << 20
    kw = dict(dynamic=True, log=1 << 22) if dynamic else {}
    server = port_server(MAIN, n, device="cuda", **kw)
    store = server.store
    half = n // 2
    store.commit(np.arange(0, half - 1), np.arange(1, half))   # one path
    rng = np.random.default_rng(0)
    u = rng.integers(half, n, size=1 << 18).astype(np.int32)
    qa = np.array([0, 0, half], np.int32)
    qb = np.array([half - 1, half, n - 1], np.int32)
    want1 = [True, False, False]
    box = {}

    def work():
        box["pending"] = store.begin_commit(u, np.roll(u, 1))
        store.wait(box["pending"])

    worker = threading.Thread(target=work)
    worker.start()
    seen = 0
    while worker.is_alive() or seen == 0:
        ans, epoch = store.query(qa, qb)
        assert epoch == 1 and ans.cpu().tolist() == want1
        seen += 1
    worker.join(timeout=60)
    assert not worker.is_alive() and "pending" in box
    assert store.finish_commit(box["pending"]) == 2
    ans, epoch = store.query(qa, qb)
    expect = pairs_oracle(n, np.concatenate([np.arange(0, half - 1), u]),
                          np.concatenate([np.arange(1, half),
                                          np.roll(u, 1)]), qa, qb)
    assert epoch == 2 and ans.cpu().tolist() == expect.tolist()
    assert store._stream is not None and seen >= 1
