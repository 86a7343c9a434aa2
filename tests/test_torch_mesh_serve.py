"""The port's serving on the replicated and sharded placements, at one
in-process rank, against the JAX package at one device.

The serve tests of ``test_serve.py`` and ``test_dynamic.py`` that run over
``EXECS`` are mirrored here over the mesh placements (and the
``single:dynamic,log=N`` exec form): the same numpy traffic goes through
``repro.serve`` and ``repro_torch.serve``; after every commit the committed
state (whole labels, and on a dynamic server the forest slots and the edge
log) is equal, and so are the epochs, ``epoch_edges``, ``epoch_deletes``,
``rounds_total`` and every ``ServerStats`` field; every answer equals scipy
on the edges of its epoch. The snapshot races hold on the placements: a
query reads whole labels and enters no collective (the sharded placement
gathers them at the end of the commit). ``gpu``-marked: the servers on the
card (one rank over NCCL) equal the CPU path.
"""

import asyncio
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.serve import ServeConfig as JServeConfig
from repro_torch import api as tapi
from repro_torch.core.execution import ShardedEpoch, served_labels
from repro_torch.launch import multihost
from repro_torch.serve import ServeConfig
from test_dynamic import live_oracle, replay
from test_serve import pairs_oracle

EXECS = ["replicated(x)", "sharded(x)", "sharded(x):fused"]
MAIN = "none+uf_sync_full"


@pytest.fixture(autouse=True)
def _clear_jax_caches():
    """Shadow conftest's per-test cache clearing: the JAX commit programs
    here run at a few small shapes, one session per exec. Cleared once per
    module."""
    yield


@pytest.fixture(scope="module", autouse=True)
def _module_scope():
    yield
    jax.clear_caches()
    multihost.shutdown()


@functools.lru_cache(maxsize=None)
def _jsession(exec_str: str):
    # one session per exec: its backend keeps the jitted commit programs
    return japi.ConnectIt(MAIN, exec=exec_str)


def small(**kw) -> dict:
    base = dict(max_batch_edges=256, max_batch_queries=256, flush_ms=0.5,
                warmup=False)
    base.update(kw)
    return base


def server_pair(exec_str, n, **kw):
    """The same server in both packages; ``kw`` takes ``dynamic``, ``log``
    and ServeConfig knobs."""
    serve_kw = {k: kw.pop(k) for k in ("dynamic", "log") if k in kw}
    j = _jsession(exec_str).serve(n, config=JServeConfig(**small(**kw)),
                                  **serve_kw)
    t = tapi.ConnectIt(MAIN, exec=exec_str, device="cpu").serve(
        n, config=ServeConfig(**small(**kw)), **serve_kw)
    return j, t


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def state_arrays(store) -> dict:
    """The committed state's whole arrays, by name (at one rank a label
    window and a log block are whole)."""
    st = store._committed
    if isinstance(st, ShardedEpoch):  # the whole labels are the window
        assert torch.equal(served_labels(st), getattr(st.state, "P",
                                                      st.state))
        st = st.state
    if not store.dynamic:
        return {"P": _np(st)}
    return {f: _np(getattr(st, f))
            for f in ("P", "fu", "fv", "log_u", "log_v")}


def assert_same(j, t, what="") -> None:
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


@pytest.mark.parametrize("exec_str", EXECS)
def test_interleaved_traffic_matches_jax_and_oracle(exec_str):
    """test_serve.py::test_interleaved_traffic_matches_oracle on both
    packages: requests awaited one at a time, so the servers coalesce
    alike; the state after every commit and every counter agree."""
    n = 128
    rng = np.random.default_rng(5)
    script = [(rand_edges(rng, n, int(rng.integers(1, 40))),
               rand_edges(rng, n, 33)) for _ in range(6)]
    j, t = server_pair(exec_str, n)
    seen = {}

    def drive(server, tag):
        out = []

        async def main():
            async with server:
                for rnd, ((u, v), (qa, qb)) in enumerate(script):
                    epoch = await server.submit_inserts(u, v)
                    assert epoch == rnd + 1
                    if tag == "t":  # the state after this commit
                        seen[epoch] = state_arrays(server.store)
                    ans, at_epoch = await server.query(qa, qb)
                    out.append((at_epoch, np.asarray(ans)))
        asyncio.run(main())
        return out

    got = drive(t, "t")
    want = drive(j, "j")
    all_s, all_r = [], []
    for rnd, ((u, v), (qa, qb)) in enumerate(script):
        all_s.append(u)
        all_r.append(v)
        assert got[rnd][0] == want[rnd][0] == rnd + 1
        np.testing.assert_array_equal(got[rnd][1], want[rnd][1])
        np.testing.assert_array_equal(got[rnd][1], pairs_oracle(
            n, np.concatenate(all_s), np.concatenate(all_r), qa, qb))
    # the port's state after each commit, against repro replaying them
    js = _jsession(exec_str).serve(n, config=JServeConfig(**small()))
    for rnd, ((u, v), _) in enumerate(script):
        js.commit_now(u, v)
        for name, arr in state_arrays(js.store).items():
            np.testing.assert_array_equal(seen[rnd + 1][name], arr)
    assert_same(j, t, "end")
    assert_same_stats(j, t)
    assert t.stats().exec == exec_str


@pytest.mark.parametrize("exec_str", EXECS)
def test_sync_and_dynamic_commits_match_jax(exec_str):
    """Mixed batches through both dynamic stores (forest hits included):
    every array of the state after every commit, the live answers, the
    stats; then the static server's sync commits."""
    n = 48
    rng = np.random.default_rng(21)
    j, t = server_pair(exec_str, n, dynamic=True, log=512)
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
    assert t.num_components() == j.num_components()
    assert_same_stats(j, t)
    j, t = server_pair(exec_str, 64)
    for rnd in range(4):
        u, v = rand_edges(rng, 64, int(rng.integers(1, 40)))
        assert t.commit_now(u, v) == j.commit_now(u, v) == rnd + 1
        assert_same(j, t, f"static commit {rnd + 1}")
    assert_same_stats(j, t)


@pytest.mark.parametrize("exec_str", EXECS)
def test_snapshot_isolation_race(exec_str):
    """A query between begin_commit and finish_commit reads exactly the
    prior epoch, on the placement."""
    server = tapi.ConnectIt(MAIN, exec=exec_str, device="cpu").serve(
        128, config=ServeConfig(**small()))
    store = server.store
    store.commit(np.arange(0, 20, dtype=np.int32),
                 np.arange(1, 21, dtype=np.int32))
    assert store.epoch == 1
    pending = store.begin_commit(np.array([20], np.int32),
                                 np.array([40], np.int32))
    qa = np.array([0, 0, 0], np.int32)
    qb = np.array([20, 40, 41], np.int32)
    ans, epoch = store.query(qa, qb)
    assert epoch == 1
    assert ans.tolist() == [True, False, False]
    assert store.finish_commit(pending) == 2
    ans2, epoch2 = store.query(qa, qb)
    assert epoch2 == 2
    assert ans2.tolist() == [True, True, False]
    assert store.epoch_edges == [0, 20, 21]


@pytest.mark.parametrize("exec_str", EXECS)
def test_snapshot_race_with_deletions(exec_str):
    server = tapi.ConnectIt(MAIN, exec=exec_str, device="cpu").serve(
        32, dynamic=True, log=256, config=ServeConfig(**small()))
    store = server.store
    store.commit([0, 1], [1, 2])
    assert store.epoch == 1
    pending = store.begin_commit([], [], [1], [2])    # delete mid-flight
    ans, epoch = store.query([0], [2])
    assert epoch == 1 and bool(ans[0])                # prior epoch
    assert store.finish_commit(pending) == 2
    ans, epoch = store.query([0], [2])
    assert epoch == 2 and not bool(ans[0])
    assert store.epoch_deletes == [0, 0, 1]


@pytest.mark.parametrize("exec_str", EXECS)
def test_concurrent_traffic_linearizes(exec_str):
    """Mixed async traffic on the placement: every answer equals the
    oracle of the edge prefix its epoch tag claims."""
    n = 96
    rng = np.random.default_rng(9)
    server = tapi.ConnectIt(MAIN, exec=exec_str, device="cpu").serve(
        n, config=ServeConfig(**small(flush_ms=2.0, max_batch_edges=64)))
    submitted_s, submitted_r = [], []
    results = []

    async def main():
        async with server:
            tasks = []
            for i in range(16):
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
    assert log[-1] == all_s.shape[0]
    for qa, qb, ans, epoch in results:
        m = log[epoch]
        np.testing.assert_array_equal(
            ans, pairs_oracle(n, all_s[:m], all_r[:m], qa, qb))


@pytest.mark.parametrize("exec_str", EXECS)
def test_serve_mixed_traffic_matches_oracle(exec_str):
    """test_dynamic.py's dynamic serving on the placement."""
    n = 96
    rng = np.random.default_rng(7)
    server = tapi.ConnectIt(MAIN, exec=exec_str, device="cpu").serve(
        n, dynamic=True, log=1024, config=ServeConfig(**small()))
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
                qa = rng.integers(0, n, size=(16,)).astype(np.int32)
                qb = rng.integers(0, n, size=(16,)).astype(np.int32)
                ans, _ = await server.query(qa, qb)
                assert (ans == live_oracle(n, multiset, qa, qb)).all()
            st = server.stats()
            assert st.edges_deleted == 20
            assert st.tenants["default"].deletes_committed == 20

    asyncio.run(main())


@pytest.mark.parametrize("exec_str", ["single:dynamic,log=512",
                                      "sharded(x):dynamic,log=512"])
def test_dynamic_exec_serves_dynamic_with_warmup(exec_str):
    """test_dynamic.py::test_serve_dynamic_sync_path_and_warmup: the
    ``:dynamic,log=N`` exec gives a dynamic server; the warmup commits on
    scratch buffers and leaves the served state and epochs as repro's."""
    j = japi.ConnectIt(MAIN, exec=exec_str).serve(
        48, config=JServeConfig(**small(warmup=True)))
    t = tapi.ConnectIt(MAIN, exec=exec_str, device="cpu").serve(
        48, config=ServeConfig(**small(warmup=True)))
    assert t.store.dynamic and t.store._ops.log_cap == 512
    for server in (j, t):
        async def main(server=server):
            async with server:
                pass

        asyncio.run(main())
        server.commit_now([0, 1], [1, 2])
        server.delete_now([1], [2])
    ans, _ = t.query_now([0, 0], [1, 2])
    np.testing.assert_array_equal(ans, np.asarray(j.query_now([0, 0],
                                                              [1, 2])[0]))
    assert bool(ans[0]) and not bool(ans[1])
    assert_same(j, t)
    assert_same_stats(j, t)
    assert t.stats().exec == exec_str


def test_single_dynamic_exec_gives_dynamic_handles():
    ci = tapi.ConnectIt(MAIN, exec="single:dynamic,log=256", device="cpu")
    assert isinstance(ci.stream(16), tapi.DynamicStream)
    server = ci.serve(48)
    assert server.store.dynamic and server.store._ops.log_cap == 256
    assert not ci.serve(48, dynamic=False).store.dynamic
    with pytest.raises(ValueError, match="dynamic-serving knob"):
        tapi.ConnectIt(MAIN, exec="sharded(x)", device="cpu").serve(
            48, log=64)


def test_cli_with_exec_matches_jax_on_the_same_seed():
    """``launch.serve --exec``: every submitted edge committed under the
    placement, the final labels equal repro's CLI under it."""
    from repro.launch.serve import serve as jserve
    from repro_torch.launch.serve import main
    from repro_torch.launch.serve import serve as tserve
    kw = dict(batches=4, batch_edges=32, queries=8, clients=2, seed=7,
              verbose=False, exec="sharded(x)")
    _, js = jserve(128, **kw)
    _, ts = tserve(128, device="cpu", **kw)
    np.testing.assert_array_equal(ts.store.labels.numpy(),
                                  np.asarray(js.store.labels))
    assert ts.stats().edges_committed == js.stats().edges_committed
    assert ts.stats().exec == "sharded(x)"
    assert main(["--device", "cpu", "--exec", "replicated(x)", "--n", "64",
                 "--batches", "2", "--batch", "8", "--queries", "4",
                 "--clients", "1"]) == 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dynamic", (False, True))
@pytest.mark.parametrize("exec_str", ["replicated(x)", "sharded(x)"])
def test_mesh_servers_on_card_match_cpu(cuda, exec_str, dynamic):
    """The served placements on the card (one rank over NCCL, commits on
    the store's stream): the state after every commit, the answers and the
    stats equal the CPU path's."""
    n = 64
    rng = np.random.default_rng(4)
    kw = dict(dynamic=True, log=512) if dynamic else {}
    servers = [tapi.ConnectIt(MAIN, exec=exec_str, device=d).serve(
        n, config=ServeConfig(**small()), **kw) for d in ("cpu", "cuda")]
    for _ in range(5):
        u, v = rand_edges(rng, n, 30)
        for s in servers:
            s.commit_now(u, v)
            if dynamic:
                s.delete_now(u[:4], v[:4])
        a, b = (state_arrays(s.store) for s in servers)
        for name in a:
            np.testing.assert_array_equal(b[name], a[name], err_msg=name)
        qa, qb = rand_edges(rng, n, 20)
        np.testing.assert_array_equal(servers[1].query_now(qa, qb)[0],
                                      servers[0].query_now(qa, qb)[0])
    assert dataclasses.asdict(servers[1].stats()) == \
        dataclasses.asdict(servers[0].stats())
