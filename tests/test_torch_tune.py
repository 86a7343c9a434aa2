"""The port's autotuning (``repro_torch.tune``, ``ConnectIt("auto")``, the
``tune`` exec opt, ``launch.tune``) against the JAX package's ``repro.tune``.

On the CPU, in one process, each test with its own cache files for both
packages (``tmp_path``):

  * the TuneSpec grammar round-trips and rejects as ``repro``'s; the
    fingerprints equal ``repro``'s on a bucket grid, the variant-grid graphs
    and the tuning proxies;
  * under one scripted fake clock, ``tune_block_m``, ``tune_variant`` and
    ``tune_families`` give ``repro``'s rows and winners, and the two cache
    files hold the same keys and winners (a block winner compared by its
    place in a three-point ladder: the port's own is one point, 256 threads
    a block, so the block sweep's selection runs on a stand-in ladder,
    which the plain versions ignore as they ignore every block size);
  * resolution precedence, block-size validation, schema and contract
    invalidation, a corrupt file and a crash mid-write, as
    ``tests/test_tune.py`` holds ``repro``'s;
  * the port's cache is its own file (``REPRO_TUNE_CACHE`` is never read)
    and a ``device="cpu"`` key never reads a ``cuda/...`` entry;
  * ``ConnectIt("auto", device="cpu")`` on a cold cache and on a cache that
    names ``none+liu_tarjan_CRFA`` gives ``repro``'s labels and
    deterministic stats, and its warm path measures nothing;
  * ``launch.tune --smoke --device cpu`` and the three generators the
    proxies added (``barabasi_albert``, ``torus``, ``empty_graph``).

Everything is compared exactly. ``gpu``-marked (skipped without a card):
every connectivity kernel at the ladder's block size against its plain
version bit for bit, ``time_fn``'s synchronization, and the block size a
cached winner resolves to on the card.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from conftest import variant_grid_graphs
from repro import api as japi
from repro import tune as jtune
from repro.graphs import generators as jgen
from repro.launch import tune as jlaunch
from repro_torch import api as tapi
from repro_torch import tune as ttune
from repro_torch.graphs import generators as tgen
from repro_torch.graphs import graph_from_arrays
from repro_torch.kernels import ops
from repro_torch.kernels.edge_relabel.ref import (
    edge_relabel_ref,
    edge_rewrite_ref,
)
from repro_torch.kernels.hook_compress.ref import hook_compress_ref
from repro_torch.kernels.pointer_jump.ref import pointer_jump_ref
from repro_torch.kernels.scatter_min.ref import scatter_min_ref
from repro_torch.launch import tune as tlaunch
from repro_torch.tune import cache as tcache
from repro_torch.tune import harness as tharness
from repro_torch.tune import tuner as ttuner

CPU = "cpu"
STATS_FIELDS = ("variant", "exec", "placement", "devices", "edges_total",
                "edges_finish", "edges_finish_padded", "edges_per_device",
                "dispatch_sizes", "lmax_count", "finish_rounds", "fused")
RANDOM_STATS = ("variant", "exec", "placement", "devices", "edges_total",
                "fused")


@pytest.fixture(autouse=True)
def _clear_jax_caches():
    """Shadow conftest's per-test cache clearing: the tuners run the same
    few small JAX programs in many tests. Cleared once per module."""
    yield


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_once():
    yield
    jax.clear_caches()


@pytest.fixture()
def caches(tmp_path, monkeypatch):
    """``(repro's cache, the port's cache)``: fresh files under
    ``tmp_path``, each installed as its package's process default."""
    jpath, tpath = str(tmp_path / "repro.json"), str(tmp_path / "torch.json")
    monkeypatch.setenv("REPRO_TUNE_CACHE", jpath)
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", tpath)
    for pkg in (jtune, ttune):
        pkg.reset_default_cache()
    ops.clear_tuned_blocks()
    from repro.kernels import ops as jops
    jops.clear_tuned_blocks()
    yield jtune.SelectionCache(jpath), ttune.SelectionCache(tpath)
    for pkg in (jtune, ttune):
        pkg.reset_default_cache()
    ops.clear_tuned_blocks()
    jops.clear_tuned_blocks()


class FakeClock:
    """Injectable timer (``tests/test_tune.py``'s): consecutive reads are
    spaced by a scripted delta sequence, so each timed call costs exactly
    the next delta."""

    def __init__(self, deltas):
        self.deltas = list(deltas)
        self.now = 0.0
        self.reading = False
        self.reads = 0

    def __call__(self):
        self.reads += 1
        if self.reading:
            self.now += self.deltas.pop(0)
        self.reading = not self.reading
        return self.now


def _script(k: int, seed: int) -> list:
    """``k`` deltas with ties, from a seed (each package gets a copy)."""
    return np.random.default_rng(seed).integers(1, 6, k).astype(float).tolist()


def _port(jg, device=CPU):
    return graph_from_arrays(jg.senders, jg.receivers, jg.indptr, jg.indices,
                             jg.n, jg.m, device=device)


def _entries(cache) -> dict:
    """``{key: entry}`` of a cache file without ``tuned_at``/``contract``."""
    with open(cache.path) as f:
        data = json.load(f)
    return {k: {f: v for f, v in e.items() if f not in ("tuned_at",
                                                         "contract")}
            for k, e in data["entries"].items()}


# ---------------------------------------------------------------------------
# TuneSpec grammar.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("text", [
    "tune", "tune(grid=full)", "tune(trials=5)", "tune(warmup=0)",
    "tune(grid=full,trials=7,warmup=2)", "tune(trials=1,warmup=3)",
    " tune( grid=fast , trials=3 ) ",
])
def test_tune_spec_parses_as_repro(text):
    got, want = ttune.TuneSpec.parse(text), jtune.TuneSpec.parse(text)
    assert str(got) == str(want)
    assert ttune.TuneSpec.parse(str(got)) == got
    assert (got.grid, got.trials, got.warmup) == \
        (want.grid, want.trials, want.warmup)
    if " " not in text:
        assert str(got) == text


@pytest.mark.parametrize("text", [
    "tune(grid=medium)", "tune(trials=0)", "tune(warmup=-1)",
    "tune(block=8)", "tune(grid)", "tunes", "tune(trials=two)",
])
def test_tune_spec_rejects_as_repro(text):
    with pytest.raises(ValueError) as want:
        jtune.TuneSpec.parse(text)
    with pytest.raises(ValueError) as got:
        ttune.TuneSpec.parse(text)
    assert str(got.value) == str(want.value)


def test_tune_spec_grids():
    fast, full = ttune.TuneSpec(), ttune.TuneSpec(grid="full")
    jfast, jfull = jtune.TuneSpec(), jtune.TuneSpec(grid="full")
    assert fast.variant_candidates() == jfast.variant_candidates()
    assert full.variant_candidates() == jfull.variant_candidates()
    assert len(full.variant_candidates()) == 148
    assert fast.block_m_candidates() == full.block_m_candidates() == \
        (ops.DEFAULT_BLOCK_M,)
    assert fast.block_b_candidates() == jfast.block_b_candidates()
    assert full.block_b_candidates() == jfull.block_b_candidates()
    assert fast.policy_candidates() == full.policy_candidates() == ("auto",)
    assert ops.DEFAULT_BLOCK_M == 256
    with pytest.raises(TypeError):
        ttune.as_tune_spec(3)


# ---------------------------------------------------------------------------
# Fingerprints.
# ---------------------------------------------------------------------------

def test_fingerprint_buckets_match_repro():
    for n in (0, 1, 2, 3, 255, 256, 1023, 1024, 4096, 1 << 22):
        for per in (0, 1, 3.99, 4, 15.99, 16, 100):
            m = int(per * n)
            for skew in (None, 0.5, 1.0, 7.99, 8.0, 50.0):
                assert ttune.fingerprint(n, m, skew) == \
                    jtune.fingerprint(n, m, skew), (n, m, skew)


def test_fingerprint_graph_matches_repro():
    graphs = dict(variant_grid_graphs())
    graphs.update({f"proxy {k}": v for k, v in
                   jlaunch.family_proxies(smoke=True).items()})
    graphs["empty"] = jgen.empty_graph(5)
    for name, jg in graphs.items():
        assert ttune.fingerprint_graph(_port(jg)) == \
            jtune.fingerprint_graph(jg), name
    tproxies = tlaunch.family_proxies(smoke=True, device=CPU)
    for name, jg in jlaunch.family_proxies(smoke=True).items():
        assert ttune.fingerprint_graph(tproxies[name]) == \
            jtune.fingerprint_graph(jg), name


# ---------------------------------------------------------------------------
# The tuners under one scripted clock.
# ---------------------------------------------------------------------------

# a three-point block ladder for the CPU tests of the block sweep's
# selection: the port's ladder is one point, and the plain versions ignore
# the block size
STAND_IN_LADDER = (128, 256, 512)


def test_tune_block_m_matches_repro(caches, monkeypatch):
    jc, tc = caches
    monkeypatch.setattr(ttune.space, "BLOCK_M_FAST", STAND_IN_LADDER)
    spec = dict(trials=3, warmup=1)
    names = ("scatter_min", "pointer_jump", "hook_compress")
    k = 3 * len(names) * 3
    jclock, tclock = FakeClock(_script(k, 1)), FakeClock(_script(k, 1))
    want = jtune.tune_block_m(jtune.TuneSpec(**spec), cache=jc, n=256,
                              primitives=names, policy="ref", timer=jclock)
    got = ttune.tune_block_m(ttune.TuneSpec(**spec), cache=tc, n=256,
                             primitives=names, timer=tclock, device=CPU)
    assert jclock.reads == tclock.reads == 2 * k
    jladder = jtune.TuneSpec(**spec).block_m_candidates()
    tladder = ttune.TuneSpec(**spec).block_m_candidates()
    assert [(r["primitive"], jladder.index(r["block_m"]), r["time_s"],
             r["winner"]) for r in want] == \
        [(r["primitive"], tladder.index(r["block_m"]), r["time_s"],
          r["winner"]) for r in got]
    jent, tent = _entries(jc), _entries(tc)
    assert sorted(jent) == sorted(tent)
    for key, e in jent.items():
        assert jladder.index(e["winner"]) == tladder.index(
            tent[key]["winner"]), key
        assert e["time_s"] == tent[key]["time_s"]
        assert sorted(e["candidates"].values()) == \
            sorted(tent[key]["candidates"].values())


def test_tune_block_m_tie_breaks_to_smaller_block(caches, monkeypatch):
    _, tc = caches
    monkeypatch.setattr(ttune.space, "BLOCK_M_FAST", STAND_IN_LADDER)
    spec = ttune.TuneSpec(trials=1, warmup=0)
    clock = FakeClock([1.0] * len(spec.block_m_candidates()))
    ttune.tune_block_m(spec, cache=tc, n=256, primitives=("pointer_jump",),
                       timer=clock, device=CPU)
    assert tc.winner(ttune.make_key("block_m:pointer_jump", device=CPU)) \
        == 128


def test_tune_variant_matches_repro(caches):
    jc, tc = caches
    jg = jgen.random_graph(64, 256, seed=0)
    spec = dict(trials=3, warmup=1)
    k = 3 * len(ttune.TuneSpec().variant_candidates())
    jclock, tclock = FakeClock(_script(k, 2)), FakeClock(_script(k, 2))
    want = jtune.tune_variant(jg, jtune.TuneSpec(**spec), cache=jc,
                              kernels="ref", timer=jclock)
    got = ttune.tune_variant(_port(jg), ttune.TuneSpec(**spec), cache=tc,
                             timer=tclock)
    assert got == want
    jent, tent = _entries(jc), _entries(tc)
    assert sorted(jent) == sorted(tent) == [
        f"cpu/cpu/{jtune.fingerprint_graph(jg)}/variant"]
    for key, e in jent.items():
        for f in ("winner", "time_s", "candidates", "exec", "n", "m"):
            assert tent[key][f] == e[f], f


def test_tune_variant_tie_breaks_to_candidate_order(caches):
    _, tc = caches
    g = tgen.random_graph(64, 256, seed=0, device=CPU)
    candidates = ("none+uf_sync_full", "none+uf_sync_naive")
    clock = FakeClock([1.0] * len(candidates))
    winner = ttune.tune_variant(g, ttune.TuneSpec(trials=1, warmup=0),
                                cache=tc, candidates=candidates, timer=clock)
    assert winner == candidates[0]
    assert tc.winner(ttune.make_key("variant", ttune.fingerprint_graph(g),
                                    device=CPU)) == winner
    with pytest.raises(ValueError, match="no variant candidates"):
        ttune.tune_variant(g, cache=tc, candidates=())


def test_tune_families_matches_repro(caches):
    jc, tc = caches
    candidates = ("none+uf_sync_full", "none+uf_sync_naive",
                  "none+liu_tarjan_CRFA")
    spec = dict(trials=1, warmup=0)
    # the two families vote for different variants, so the first family's
    # winner takes the device-global key
    deltas = [3.0, 1.0, 2.0, 2.0, 3.0, 1.0]
    want = jtune.tune_families(jlaunch.family_proxies(smoke=True),
                               jtune.TuneSpec(**spec), cache=jc,
                               kernels="ref", candidates=candidates,
                               timer=FakeClock(deltas))
    got = ttune.tune_families(tlaunch.family_proxies(smoke=True, device=CPU),
                              ttune.TuneSpec(**spec), cache=tc,
                              candidates=candidates, timer=FakeClock(deltas))
    assert got == want
    jent, tent = _entries(jc), _entries(tc)
    assert sorted(jent) == sorted(tent)
    assert {k: e["winner"] for k, e in jent.items()} == \
        {k: e["winner"] for k, e in tent.items()}
    assert tent["cpu/cpu/*/variant"] == {"winner": "none+uf_sync_naive",
                                         "families": 2}


def test_time_fn_median_and_validation():
    clock = FakeClock([1.0, 5.0, 2.0])
    assert ttune.time_fn(lambda: None, trials=3, warmup=0, timer=clock) == 2.0
    with pytest.raises(ValueError):
        ttune.time_fn(lambda: None, trials=0)
    with pytest.raises(ValueError):
        ttune.time_fn(lambda: None, warmup=-1)


def test_measure_primitives_rows():
    rows = ttune.measure_primitives(
        n=64, m=256, spec=ttune.TuneSpec(trials=1, warmup=0),
        timer=FakeClock([1.0] * 5), device=CPU)
    assert [(r["primitive"], r["policy"], r["block_m"], r["time_s"])
            for r in rows] == [(p, "auto", None, 1.0)
                               for p in ttune.PRIMITIVES]


def test_primitive_problem_matches_repro():
    """The drivers' problem is the reference's, from the seed."""
    P, s, r, vals = ttune.primitive_problem(300, 1000, seed=4, device=CPU)
    rng = np.random.default_rng(4)
    np.testing.assert_array_equal(
        P.numpy(), np.minimum(rng.integers(0, 300, 301), np.arange(301)))
    for t in (s, r, vals):
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), rng.integers(0, 300, 1000))
    drivers = ttune.primitive_drivers(300, 1000, seed=4, device=CPU)
    assert sorted(drivers) == sorted(ttune.PRIMITIVES)
    np.testing.assert_array_equal(drivers["pointer_jump"](block_m=64).numpy(),
                                  pointer_jump_ref(P, k=3).numpy())


# ---------------------------------------------------------------------------
# Resolution and the cache's durability.
# ---------------------------------------------------------------------------

def test_resolve_variant_precedence(caches):
    _, tc = caches
    fam = "n8-mid-lo"
    key = lambda f: ttune.make_key("variant", f, device=CPU)  # noqa: E731
    assert ttune.resolve_variant(fam, cache=tc, device=CPU) == \
        ttune.PAPER_DEFAULT_VARIANT == jtune.PAPER_DEFAULT_VARIANT
    tc.put(key("*"), "none+uf_sync_full")
    assert ttune.resolve_variant(fam, cache=tc, device=CPU) == \
        "none+uf_sync_full"
    tc.put(key(fam), "none+shiloach_vishkin")
    assert ttune.resolve_variant(fam, cache=tc, device=CPU) == \
        "none+shiloach_vishkin"
    for bad in ("not+a+variant", "auto", 7):
        tc.put(key(fam), bad)
        assert ttune.resolve_variant(fam, cache=tc, device=CPU) == \
            "none+uf_sync_full"
    # the process default reads the environment's file
    assert str(tapi.VariantSpec.parse("auto", device=CPU)) == \
        "none+uf_sync_full"


def test_resolve_block_m_validates_winner(caches):
    _, tc = caches
    key = ttune.make_key("block_m:scatter_min", device=CPU)
    assert ttune.resolve_block_m("scatter_min", cache=tc, device=CPU) == 256
    for good in (256, "256"):
        tc.put(key, good)
        assert ttune.resolve_block_m("scatter_min", cache=tc, device=CPU) \
            == int(good)
    assert ttune.resolve_block_m("scatter_min", cache=tc, default=128,
                                 device=CPU) == 256
    for bad in (64, 128, 512, 1024, 999, 32, "huge", None, True, [256]):
        tc.put(key, bad)
        assert ttune.resolve_block_m("scatter_min", cache=tc, device=CPU) \
            == 256, bad


def test_wrappers_refuse_block_sizes_they_were_not_built_for(monkeypatch):
    """On the card an op refuses an explicit block size other than the one
    its kernel is built for; on the CPU the plain versions ignore it."""
    P = torch.arange(9, dtype=torch.int32)
    s = torch.zeros(4, dtype=torch.int32)
    calls = {
        "scatter_min": lambda b: ops.scatter_min(P, s, s, block_m=b),
        "pointer_jump": lambda b: ops.pointer_jump(P, block_m=b),
        "hook_compress": lambda b: ops.hook_compress(P, s, s, block_m=b),
        "edge_relabel": lambda b: ops.edge_relabel(P, s, s, block_m=b),
        "edge_rewrite": lambda b: ops.edge_rewrite(P, s, s, block_m=b),
    }
    # the plain versions take a block size and ignore it
    for b in (None, 64, 100, 256):
        np.testing.assert_array_equal(calls["scatter_min"](b).numpy(),
                                      scatter_min_ref(P, s, s).numpy())
    # take the CUDA branch of the dispatch with CPU tensors
    monkeypatch.setattr(ops, "on_cuda", lambda t: True)
    for name, call in calls.items():
        for bad in (32, 64, 128, 512, 1024, 0):
            with pytest.raises(ValueError, match="built for 256 threads"):
                call(bad)
        # the built size, or none, passes to the wrapper's device check
        for ok in (None, 256):
            with pytest.raises(ValueError, match="CUDA device"):
                call(ok)


def test_tuned_block_m_memo(caches, monkeypatch):
    reads = []
    resolve = ttune.tuner.resolve_block_m

    def counted(primitive, **kw):
        reads.append(primitive)
        return resolve(primitive, **kw)

    monkeypatch.setattr(ttune.tuner, "resolve_block_m", counted)
    assert ops.tuned_block_m("scatter_min", CPU) == 256
    assert ops.tuned_block_m("scatter_min", CPU) == 256  # memoized
    assert reads == ["scatter_min"]
    ops.clear_tuned_blocks()
    assert ops.tuned_block_m("scatter_min", CPU) == 256
    assert ops.tuned_block_m("pointer_jump", CPU) == 256
    assert reads == ["scatter_min", "scatter_min", "pointer_jump"]


def test_cache_roundtrip(caches):
    _, tc = caches
    key = ttune.make_key("variant", "n10-mid-lo", device=CPU)
    assert key == "cpu/cpu/n10-mid-lo/variant"
    assert tc.get(key) is None
    tc.put(key, "none+uf_sync_full", time_s=0.5, n=1024)
    fresh = ttune.SelectionCache(tc.path)
    entry = fresh.get(key)
    assert entry["winner"] == "none+uf_sync_full"
    assert entry["time_s"] == 0.5 and entry["n"] == 1024
    assert entry["contract"] == ops.KERNEL_CONTRACT_VERSION
    assert fresh.keys() == [key] and len(fresh) == 1
    fresh.discard(key)
    assert ttune.SelectionCache(tc.path).get(key) is None


def test_cache_schema_version_invalidation(caches):
    _, tc = caches
    key = ttune.make_key("variant", device=CPU)
    tc.put(key, "none+uf_sync_full")
    with open(tc.path) as f:
        data = json.load(f)
    assert data["schema"] == ttune.SCHEMA_VERSION == jtune.SCHEMA_VERSION
    data["schema"] = ttune.SCHEMA_VERSION + 1
    with open(tc.path, "w") as f:
        json.dump(data, f)
    assert ttune.SelectionCache(tc.path).winner(key) is None


def test_cache_contract_invalidation(caches):
    _, tc = caches
    key = ttune.make_key("block_m:scatter_min", device=CPU)
    tc.put(key, 512)
    assert ttune.SelectionCache(tc.path).winner(key) == 512
    bumped = ttune.SelectionCache(
        tc.path, contract=ops.KERNEL_CONTRACT_VERSION + 1)
    assert bumped.winner(key) is None


def test_cache_corrupt_file_degrades_to_empty(caches):
    _, tc = caches
    with open(tc.path, "w") as f:
        f.write("{not json")
    cache = ttune.SelectionCache(tc.path)
    assert len(cache) == 0
    key = ttune.make_key("variant", device=CPU)
    cache.put(key, "none+uf_sync_full")
    assert ttune.SelectionCache(tc.path).winner(key) == "none+uf_sync_full"


def test_cache_atomic_write_crash_safety(caches, monkeypatch):
    _, tc = caches
    key = ttune.make_key("variant", "n10-mid-lo", device=CPU)
    tc.put(key, "none+uf_sync_full")
    with open(tc.path) as f:
        before = f.read()

    def boom(src, dst):
        raise OSError("simulated crash mid-replace")

    monkeypatch.setattr(os, "replace", boom)
    with pytest.raises(OSError):
        ttune.SelectionCache(tc.path).put(key, "none+uf_sync_naive")
    monkeypatch.undo()
    with open(tc.path) as f:
        assert f.read() == before
    assert ttune.SelectionCache(tc.path).winner(key) == "none+uf_sync_full"
    assert [f for f in os.listdir(os.path.dirname(tc.path))
            if f.endswith(".tmp")] == []


def test_cache_is_its_own_file(tmp_path, monkeypatch):
    """The port reads REPRO_TORCH_TUNE_CACHE, never REPRO_TUNE_CACHE: a
    file that repro wrote with a winner is not the port's."""
    jpath = str(tmp_path / "repro.json")
    monkeypatch.setenv("REPRO_TUNE_CACHE", jpath)
    monkeypatch.delenv("REPRO_TORCH_TUNE_CACHE", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    jtune.reset_default_cache()
    ttune.reset_default_cache()
    try:
        jtune.default_cache().put(jtune.make_key("variant", "*"),
                                  "none+uf_sync_full")
        assert jtune.resolve_variant() == "none+uf_sync_full"
        assert ttune.cache_path() == str(
            tmp_path / "home" / ".cache" / "repro_torch" / "tune.json")
        assert ttune.default_cache().path != jpath
        assert ttune.resolve_variant(device=CPU) == \
            ttune.PAPER_DEFAULT_VARIANT
        monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE",
                           str(tmp_path / "torch.json"))
        assert ttune.default_cache().path == str(tmp_path / "torch.json")
        assert ttune.cache_path(str(tmp_path / "explicit.json")).endswith(
            "explicit.json")
    finally:
        jtune.reset_default_cache()
        ttune.reset_default_cache()


def test_cpu_key_never_reads_a_card_entry(caches):
    _, tc = caches
    card = "cuda/nvidia-h100-80gb-hbm3"
    tc.put(f"{card}/*/variant", "none+liu_tarjan_CRFA")
    tc.put(f"{card}/*/block_m:scatter_min", 512)
    assert ttune.backend_key(CPU) == ("cpu", "cpu")
    assert ttune.resolve_variant(device=CPU) == ttune.PAPER_DEFAULT_VARIANT
    assert ttune.resolve_block_m("scatter_min", device=CPU) == 256
    ci = tapi.ConnectIt("auto", device=CPU)
    assert str(ci.spec) == ttune.PAPER_DEFAULT_VARIANT


def test_backend_key_of_the_default_device():
    if torch.cuda.is_available():
        assert ttune.backend_key()[0] == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            ttune.backend_key()


# ---------------------------------------------------------------------------
# ConnectIt("auto") and the tune opt.
# ---------------------------------------------------------------------------

def _auto_pair(jg):
    """(repro's (labels, stats), the port's) of ConnectIt("auto")."""
    jci = japi.ConnectIt("auto")
    want = jci.connectivity(jg, return_stats=True)
    tci = tapi.ConnectIt("auto", device=CPU)
    got = tci.connectivity(_port(jg), return_stats=True)
    return jci, want, tci, got


@pytest.mark.parametrize("winner", [None, "none+liu_tarjan_CRFA"])
def test_auto_matches_repro(caches, winner):
    jc, tc = caches
    jg = jgen.rmat(256, 1024, seed=2)
    if winner is not None:
        jc.put(jtune.make_key("variant", jtune.fingerprint_graph(jg)), winner)
        tc.put(ttune.make_key("variant", ttune.fingerprint_graph(_port(jg)),
                              device=CPU), winner)
    jci, (jl, js), tci, (tl, ts) = _auto_pair(jg)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert ts.variant == js.variant == (winner or ttune.PAPER_DEFAULT_VARIANT)
    fields = STATS_FIELDS if winner else RANDOM_STATS
    for f in fields:
        assert getattr(ts, f) == getattr(js, f), f
    # the other surfaces bind the device-global winner (here the default)
    assert str(tci.spec) == str(jci.spec) == ttune.PAPER_DEFAULT_VARIANT


def test_auto_warm_path_measures_nothing(caches, monkeypatch):
    _, tc = caches
    g = tgen.rmat(128, 512, seed=1, device=CPU)
    tc.put(ttune.make_key("variant", ttune.fingerprint_graph(g), device=CPU),
           "none+uf_sync_full")
    ci = tapi.ConnectIt("auto", device=CPU)
    first = ci.connectivity(g)

    def no_clock(*a, **k):
        raise AssertionError("the warm path measured")

    monkeypatch.setattr(ttuner, "tune_variant", no_clock)
    monkeypatch.setattr(tharness, "time_fn", no_clock)
    monkeypatch.setattr(ttuner, "time_fn", no_clock)
    monkeypatch.setattr(tcache.SelectionCache, "winner", no_clock)
    warm = ci.connectivity(g)
    assert ci.stats.variant == "none+uf_sync_full"
    np.testing.assert_array_equal(warm.numpy(), first.numpy())
    np.testing.assert_array_equal(
        warm.numpy(),
        tapi.ConnectIt("none+uf_sync_full", device=CPU).connectivity(g)
        .numpy())


def test_tune_opt_measures_once_per_family(caches, monkeypatch):
    _, tc = caches
    calls = []
    real = ttuner.time_fn

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(ttuner, "time_fn", counting)
    g = tgen.rmat(128, 512, seed=1, device=CPU)
    ci = tapi.ConnectIt("auto", exec="single:tune", device=CPU)
    a = ci.connectivity(g)
    n_first = len(calls)
    assert n_first == len(ttune.TuneSpec().variant_candidates())
    b = ci.connectivity(g)
    assert len(calls) == n_first
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    winner = tc.reload().winner(ttune.make_key(
        "variant", ttune.fingerprint_graph(g), device=CPU))
    assert ci.stats.variant == winner and ci.stats.exec == "single:tune"
    # a non-auto session with the tune opt runs as without it
    ci = tapi.ConnectIt("none+uf_sync_full", exec="single:tune", device=CPU)
    ci.connectivity(g)
    assert len(calls) == n_first


# ---------------------------------------------------------------------------
# The CLI and the generators.
# ---------------------------------------------------------------------------

def test_launch_tune_smoke(tmp_path, capsys):
    path = str(tmp_path / "cli.json")
    assert tlaunch.main(["--smoke", "--device", "cpu", "--cache", path,
                         "--trials", "1", "--warmup", "0"]) == 0
    out = capsys.readouterr().out
    assert "smoke: cache re-read ok" in out
    cache = ttune.SelectionCache(path)
    for prim in ttune.PRIMITIVES:
        assert cache.winner(f"cpu/cpu/*/block_m:{prim}") == 256
    assert cache.winner("cpu/cpu/*/variant") in \
        ttune.TuneSpec().variant_candidates()
    with pytest.raises(SystemExit, match="empty"):
        tlaunch.verify_roundtrip(str(tmp_path / "none.json"), device=CPU)


@pytest.mark.parametrize("name,args", [
    ("barabasi_albert", (64, 3)), ("barabasi_albert", (50, 1)),
    ("torus", ((4, 5, 3),)), ("torus", ((7,),)), ("empty_graph", (7,)),
])
def test_new_generators_match_repro(name, args):
    kw = {"seed": 3} if name == "barabasi_albert" else {}
    jg = getattr(jgen, name)(*args, **kw)
    tg = getattr(tgen, name)(*args, **kw, device=CPU)
    assert (tg.n, tg.m, tg.m_pad) == (jg.n, jg.m, jg.m_pad)
    for f in ("senders", "receivers", "indptr", "indices"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      np.asarray(getattr(jg, f)), err_msg=f)


def test_full_proxies_match_repro():
    jp = jlaunch.family_proxies()
    tp = tlaunch.family_proxies(device=CPU)
    assert list(jp) == list(tp)
    for name, jg in jp.items():
        tg = tp[name]
        assert (tg.n, tg.m) == (jg.n, jg.m), name
        np.testing.assert_array_equal(tg.senders[: tg.m].numpy(),
                                      np.asarray(jg.senders)[: jg.m])
        assert ttune.fingerprint_graph(tg) == jtune.fingerprint_graph(jg)


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


PLAIN = {
    "scatter_min": lambda P, s, r, v: scatter_min_ref(P, s, v),
    "pointer_jump": lambda P, s, r, v: pointer_jump_ref(P, k=3),
    "hook_compress": lambda P, s, r, v: hook_compress_ref(P, s, r, k=1),
    "edge_relabel": lambda P, s, r, v: edge_relabel_ref(P, s, r),
    "edge_rewrite": lambda P, s, r, v: edge_rewrite_ref(P, s, r),
}


def _equal(got, want) -> bool:
    if isinstance(want, tuple):
        return all(torch.equal(a, b) for a, b in zip(got, want))
    return torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("block", ttune.space.BLOCK_M_FULL)
@pytest.mark.parametrize("name", ttune.PRIMITIVES)
def test_every_block_size_matches_plain_on_card(cuda, name, block):
    """At every block size of the ladder, on the drivers' problem (ragged,
    and at 2^23 edges with grid-stride passes) and on a view 4 bytes past a
    16-byte boundary (the scalar launch)."""
    for n, m in ((4097, 50_001), (1 << 20, 1 << 23)):
        problem = ttune.primitive_problem(n, m, seed=5, device=cuda)
        drivers = ttune.primitive_drivers(n, m, seed=5, device=cuda)
        got = drivers[name](block_m=block)
        assert _equal(got, PLAIN[name](*problem)), (n, m)
    P, s, r, v = ttune.primitive_problem(4097, 50_001, seed=6, device=cuda)
    s1, r1, v1 = s[1:], r[1:], v[1:]
    buf = torch.empty_like(P)
    buf[1:] = P[:-1]
    P1 = buf[1:]  # a parent forest 4 bytes past a 16-byte boundary
    view = {"scatter_min": lambda: ops.scatter_min(P, s1, v1, block_m=block),
            "pointer_jump": lambda: ops.pointer_jump(P1, k=3, block_m=block),
            "hook_compress": lambda: ops.hook_compress(P, s1, r1,
                                                       block_m=block),
            "edge_relabel": lambda: ops.edge_relabel(P, s1, r1,
                                                     block_m=block),
            "edge_rewrite": lambda: ops.edge_rewrite(P, s1, r1,
                                                     block_m=block)}[name]
    want = {"scatter_min": lambda: scatter_min_ref(P, s1, v1),
            "pointer_jump": lambda: pointer_jump_ref(P1, k=3),
            "hook_compress": lambda: hook_compress_ref(P, s1, r1, k=1),
            "edge_relabel": lambda: edge_relabel_ref(P, s1, r1),
            "edge_rewrite": lambda: edge_rewrite_ref(P, s1, r1)}[name]
    assert _equal(view(), want())


@pytest.mark.gpu
def test_time_fn_synchronizes_on_card(cuda):
    """A kernel that spins on purpose: the synchronized median holds its
    device time; without the device the clock reads the enqueue."""
    cycles = 50_000_000
    torch.cuda._sleep(cycles)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize()
    device_s = start.elapsed_time(end) / 1e3
    synced = ttune.time_fn(torch.cuda._sleep, cycles, trials=3, warmup=1,
                           device=cuda)
    torch.cuda.synchronize()
    unsynced = ttune.time_fn(torch.cuda._sleep, cycles, trials=3, warmup=1)
    torch.cuda.synchronize()
    assert synced >= 0.9 * device_s
    assert unsynced < 0.5 * device_s


@pytest.mark.gpu
def test_block_sizes_resolve_on_card(cuda, caches):
    """A cached block winner outside the ladder resolves to 256 on the card,
    an explicit one is refused, and ``"auto"`` runs as on the CPU."""
    _, tc = caches
    for p in ttune.PRIMITIVES:
        assert ops.tuned_block_m(p, cuda) == 256
    tc.put(ttune.make_key("block_m:hook_compress", device=cuda), 64)
    ttune.reset_default_cache()
    ops.clear_tuned_blocks()
    assert ops.tuned_block_m("hook_compress", cuda) == 256
    P, s, r, _ = ttune.primitive_problem(4097, 50_001, seed=6, device=cuda)
    with pytest.raises(ValueError, match="built for 256 threads"):
        ops.hook_compress(P, s, r, block_m=64)
    g = tgen.rmat(1 << 12, 1 << 15, seed=0, device=cuda)
    ci = tapi.ConnectIt("auto", device=cuda)
    got = ci.connectivity(g)
    want = tapi.ConnectIt("auto", device=CPU).connectivity(
        tgen.rmat(1 << 12, 1 << 15, seed=0, device=CPU))
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    ops.clear_tuned_blocks()
