"""The port's dynamic streams and mesh streams on the replicated and sharded
placements, at one in-process rank, against the JAX package at one device.

  * Mixed delete/insert/query batches under ``replicated(x)``,
    ``sharded(x)`` and ``sharded(x):fused``: after every batch the labels,
    the forest slots ``fu``/``fv``, the edge log, the rounds and the answers
    equal ``repro``'s, and the answers equal scipy over the live edges.
  * The exec forms ``...:dynamic,log=N`` give dynamic handles, as in
    ``repro``.
  * Insert ends outside ``[0, n]`` on a mesh stream, under all 22 finishes
    of ``enumerate_variants()``: the labels after every insert, the rounds
    and the answers equal ``repro``'s (a mesh stream hands its finish raw
    batch ends, as ``repro``'s does). ``gpu``-marked: the same on the card
    against the CPU path.

Every comparison is exact.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro_torch import api as tapi
from repro_torch.dynamic import engine as tengine
from repro_torch.launch import multihost
from test_dynamic import live_oracle, replay

EXECS = ["replicated(x)", "sharded(x)", "sharded(x):fused"]
VARIANT = "none+uf_sync_full"
LOG = 512
FINISHES = tapi.default_finish_grid()
OOR_EXECS = ["replicated(x)", "sharded(x)"]
# insert ends past the dump row, on either side, and the int32 extreme
OOR_INSERTS = (([11], [0]), ([0], [11]), ([10], [3]), ([2147483647], [1]))
OOR_N = 9


@pytest.fixture(autouse=True)
def _clear_jax_caches():
    """Shadow conftest's per-test cache clearing: the JAX mesh programs
    here run at a few small shapes. Cleared once per module."""
    yield


@pytest.fixture(scope="module", autouse=True)
def _module_scope():
    yield
    jax.clear_caches()
    multihost.shutdown()


def _dyn(exec_str: str) -> str:
    return f"{exec_str}{',' if ':' in exec_str else ':'}dynamic,log={LOG}"


@functools.lru_cache(maxsize=None)
def _jsession(exec_str: str):
    # one session per exec: its backend keeps the jitted mesh programs
    return japi.ConnectIt(VARIANT, exec=_dyn(exec_str))


def _schedule(n: int, steps: int, seed: int):
    """Ragged mixed batches: inserts of random pairs (self-loops and
    repeats included), deletes of live pairs, queries."""
    rng = np.random.default_rng(seed)
    live: list = []
    for _ in range(steps):
        ins = rng.integers(0, n, size=(int(rng.integers(0, 12)), 2))
        k = int(rng.integers(0, 5)) if live else 0
        dels = np.asarray([live[i] for i in rng.integers(0, len(live),
                                                         size=k)])
        dels = dels.reshape(-1, 2).astype(np.int32)
        q = rng.integers(0, n, size=(2, 7)).astype(np.int32)
        yield dels, ins.astype(np.int32), q[0], q[1]
        replay(live, ins, dels)


def _state_arrays(st) -> dict:
    """The dynamic state of a handle: the labels through the handle, and
    the state's arrays (at one rank the label window and the log block
    are whole)."""
    return {"labels": np.asarray(st.labels),
            **{f: np.asarray(getattr(st.state, f))
               for f in tengine.DynamicState._fields}}


@pytest.mark.parametrize("exec_str", EXECS)
def test_mixed_batches_match_repro(exec_str):
    n = 40
    js = _jsession(exec_str).stream(n)
    ts = tapi.ConnectIt(VARIANT, exec=_dyn(exec_str),
                        device="cpu").stream(n)
    assert isinstance(ts, tapi.DynamicStream)
    live: list = []
    for i, (dels, ins, qa, qb) in enumerate(_schedule(n, 10, 3)):
        args = (dels[:, 0], dels[:, 1], ins[:, 0], ins[:, 1], qa, qb)
        want = np.asarray(js.process(*args))
        got = ts.process(*args).numpy()
        replay(live, ins, dels)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, live_oracle(n, live, qa, qb))
        a, b = _state_arrays(ts), _state_arrays(js)
        for f in a:
            np.testing.assert_array_equal(a[f], b[f], err_msg=f"{i}: {f}")
        assert ts._rounds == int(js._rounds), i
    assert ts.log_used() == js.log_used() == len(live)
    assert ts.num_components() == js.num_components()
    np.testing.assert_array_equal(ts.forest_edges(), js.forest_edges())
    assert dataclasses.asdict(ts.stats) == dataclasses.asdict(js.stats)
    assert ts.stats.exec == _dyn(exec_str)


@pytest.mark.parametrize("exec_str", EXECS)
def test_forest_hits_and_the_search_bound_match_repro(exec_str):
    """A long path closed into a cycle: a deletion on the path is a forest
    hit whose replacement search runs out of its bound (one round) and
    goes on to the rebuild; a second deletion splits the component."""
    n = 24
    js = japi.ConnectIt(VARIANT, exec=exec_str).stream(
        n, dynamic=True, log=128, search_rounds=1)
    ts = tapi.ConnectIt(VARIANT, exec=exec_str, device="cpu").stream(
        n, dynamic=True, log=128, search_rounds=1)
    u = np.arange(n - 1, dtype=np.int32)
    for st in (js, ts):
        st.insert(u, u + 1)
        st.insert([0], [n - 1])
        st.delete([n // 2], [n // 2 + 1])
    assert ts._rounds == int(js._rounds)
    assert bool(ts.query([0], [n - 1])[0]) and ts.num_components() == 1
    for st in (js, ts):
        st.delete([0], [n - 1])
    a, b = _state_arrays(ts), _state_arrays(js)
    for f in a:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    assert ts._rounds == int(js._rounds)
    assert ts.num_components() == js.num_components() == 2


def test_dynamic_exec_forms_give_dynamic_handles():
    """``single:dynamic,log=N`` and the mesh forms parse and run; a knob of
    the handle overrides the exec's."""
    for exec_str in ("single:dynamic,log=256", "sharded(x):dynamic"):
        ci = tapi.ConnectIt(VARIANT, exec=exec_str, device="cpu")
        st = ci.stream(16)
        assert isinstance(st, tapi.DynamicStream)
        assert st.stats.exec == exec_str
        assert isinstance(ci.stream(16, dynamic=False), tapi.Stream)
    st = tapi.ConnectIt(VARIANT, exec="single:dynamic,log=256",
                        device="cpu").stream(16, log=64)
    assert st._ops.log_cap == 64
    with pytest.raises(ValueError, match="root-based"):
        tapi.ConnectIt("none+label_prop", exec="replicated(x):dynamic",
                       device="cpu").stream(16)
    with pytest.raises(ValueError, match="dynamic-stream knob"):
        tapi.ConnectIt(VARIANT, exec="replicated(x)",
                       device="cpu").stream(16, log=64)


def test_mesh_log_capacity_is_per_shard_as_repro():
    """The per-shard bound and the error of a full log."""
    jst = japi.ConnectIt(VARIANT, exec="sharded(x)").stream(
        8, dynamic=True, log=4)
    tst = tapi.ConnectIt(VARIANT, exec="sharded(x)", device="cpu").stream(
        8, dynamic=True, log=4)
    assert tst._ops.log_cap == jst._ops.log_cap
    for st in (jst, tst):
        st.insert([0, 1, 2], [1, 2, 3])
    with pytest.raises(ValueError) as want:
        jst.insert([4, 5], [5, 6])
    with pytest.raises(ValueError) as got:
        tst.insert([4, 5], [5, 6])
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# Out-of-range insert ends on a mesh stream (the fix of parents_of).
# ---------------------------------------------------------------------------

def _oor_pair(finish: str, exec_str: str, device="cpu"):
    return (japi.ConnectIt(f"none+{finish}", exec=exec_str).stream(OOR_N),
            tapi.ConnectIt(f"none+{finish}", exec=exec_str,
                           device=device).stream(OOR_N))


@pytest.mark.parametrize("exec_str", OOR_EXECS)
@pytest.mark.parametrize("finish", FINISHES)
def test_out_of_range_inserts_on_a_mesh_answer_as_jax(finish, exec_str):
    """Each insert's end of n + 1 or more reads the last label slot, as
    ``repro``'s gathers clamp: labels after every insert, rounds and
    answers are ``repro``'s."""
    js, ts = _oor_pair(finish, exec_str)
    ids = np.arange(-2, OOR_N + 3, dtype=np.int32)
    qa, qb = np.repeat(ids, len(ids)), np.tile(ids, len(ids))
    for u, v in OOR_INSERTS:
        js.insert(u, v)
        ts.insert(u, v)
        np.testing.assert_array_equal(ts.labels.numpy(),
                                      np.asarray(js.labels),
                                      err_msg=f"{finish} {u}, {v}")
        np.testing.assert_array_equal(ts.query(qa, qb).numpy(),
                                      np.asarray(js.query(qa, qb)))
    assert ts.stats.finish_rounds == js.stats.finish_rounds


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("exec_str", OOR_EXECS)
def test_out_of_range_inserts_on_a_mesh_on_card_match_cpu(cuda, exec_str):
    """The 22 finishes' kernels take the raw ends on the card (one rank over
    NCCL) and give the CPU path's labels, rounds and answers."""
    ids = np.arange(-2, OOR_N + 3, dtype=np.int32)
    qa, qb = np.repeat(ids, len(ids)), np.tile(ids, len(ids))
    for finish in FINISHES:
        v = f"none+{finish}"
        ts = tapi.ConnectIt(v, exec=exec_str, device="cpu").stream(OOR_N)
        tc = tapi.ConnectIt(v, exec=exec_str, device="cuda").stream(OOR_N)
        for u, w in OOR_INSERTS:
            ts.insert(u, w)
            tc.insert(u, w)
            assert torch.equal(tc.labels.cpu(), ts.labels), (finish, u, w)
            assert torch.equal(tc.query(qa, qb).cpu(), ts.query(qa, qb))
        assert tc.stats.finish_rounds == ts.stats.finish_rounds


@pytest.mark.gpu
@pytest.mark.parametrize("exec_str", EXECS)
def test_mixed_batches_on_card_match_cpu(cuda, exec_str):
    """The merged forest rounds on the card (scatter_min into the stacked
    endpoint buffer, pointer_jump) give the CPU path's state, rounds and
    answers after every batch."""
    n = 40
    ts = tapi.ConnectIt(VARIANT, exec=_dyn(exec_str),
                        device="cpu").stream(n)
    tc = tapi.ConnectIt(VARIANT, exec=_dyn(exec_str),
                        device="cuda").stream(n)
    for dels, ins, qa, qb in _schedule(n, 10, 3):
        args = (dels[:, 0], dels[:, 1], ins[:, 0], ins[:, 1], qa, qb)
        assert torch.equal(tc.process(*args).cpu(), ts.process(*args))
        for f in tengine.DynamicState._fields:
            assert torch.equal(getattr(tc.state, f).cpu(),
                               getattr(ts.state, f)), f
        assert tc._rounds == ts._rounds
