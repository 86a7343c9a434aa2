"""The port's execution placements against the JAX package.

``repro_torch.core.execution`` carries the reference's ExecutionSpec grammar,
mesh planning and backends; ``core/distributed.py`` its replicated and
sharded mesh programs over ``torch.distributed``. Here:

  * the grammar: canonical strings, normalization, pinned knobs and the
    errors of bad strings equal ``repro``'s, string for string;
  * the planning helpers and ``compact_mask`` equal ``repro``'s;
  * one rank in this process (a one-rank gloo group): every placement of
    ``tests/test_distributed.py``'s EXECS × VARIANTS on its planted graph,
    labels equal to ``repro``'s at one device and to scipy, and every stats
    field equal to ``repro``'s (the sampled variants replay ``repro``'s
    sampler output, so that no random stream differs);
  * 2 and 4 spawned ranks (tests/torch_mesh_worker.py, a ``FileStore``
    rendezvous under ``tmp_path``): labels equal to scipy on every rank, the
    ranks' sampler outputs equal, and at 4 ranks the stats, stream answers
    and SCAN output equal to ``repro``'s on 4 forced host devices (this file
    run as a script in a subprocess with
    ``XLA_FLAGS=--xla_force_host_platform_device_count=4``); dynamic streams
    and AMSF forests equal to ``repro``'s there, and a served run with rank 0
    serving and the other ranks following, whose state equals rank 0's;
  * a 2-rank world of ``ConnectIt("auto", exec="sharded(x)")`` whose ranks
    read tuning caches with conflicting winners runs rank 0's variant on
    both ranks, and under ``:tune`` both ranks elect one winner that only
    rank 0 writes;
  * streams and SCAN on the placements, the refusals, a failed rendezvous,
    the multihost CLI; ``gpu``-marked: the one-rank NCCL placements on the
    card equal to the CPU path.

Every comparison is exact.
"""

import asyncio
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent

EXECS = [
    "replicated(pod,data,model)",
    "sharded(x)",
    "sharded(pod,data|model)",
    "sharded(pod,data|model):fused",
    "sharded(x):overlap",
    "sharded(x):frontier=8",
    "sharded(x,y)",
    "sharded(x,y):fused,overlap",
]
VARIANTS = [
    "none+uf_sync_full",
    "kout_hybrid_k2+uf_sync_naive",
    "none+shiloach_vishkin",
    "ldd_b0.2+liu_tarjan_CRFA",
]
SAMPLED = [v for v in VARIANTS if not v.startswith("none+")]
STREAM_EXECS = ["replicated(x)", "sharded(x)"]
SCAN_CASES = [("sharded(x)", "scan(eps=0.3,mu=2)"),
              ("sharded(x)", "scan(eps=0.6,mu=3)"),
              ("replicated(x)", "scan(eps=0.3,mu=2)")]
STREAM_SIZES = (200, 37, 300, 1, 64, 129)
DYN_EXECS = ["replicated(x):dynamic,log=256", "sharded(x):dynamic,log=256"]
AMSF_CASES = [("replicated(x)", "amsf"), ("sharded(x)", "amsf(skip=lmax)")]
SERVE_EXECS = ["replicated(x)", "sharded(x):dynamic,log=256"]
SERVE_CONFIG = dict(max_batch_edges=256, max_batch_queries=256, flush_ms=0.5,
                    warmup=True)
STATS = ("variant", "exec", "placement", "devices", "edges_total",
         "edges_finish", "edges_finish_padded", "edges_per_device",
         "dispatch_sizes", "batch_shapes", "lmax_count", "finish_rounds",
         "fused")
# the stats that do not depend on the device count
RANK_FREE = ("variant", "exec", "placement", "edges_total", "edges_finish",
             "edges_finish_padded", "lmax_count")


def _graph():
    from repro.graphs import generators as jgen
    return jgen.planted_components(256, 4, 4.0, seed=2)


def _stats(st) -> dict:
    d = dataclasses.asdict(st)
    return {k: list(d[k]) if isinstance(d[k], tuple) else d[k]
            for k in STATS}


def _stream_batches(jg) -> list:
    """Mixed ragged insert batches of the graph's directed edges, each with
    64 query pairs."""
    s = np.asarray(jg.senders)[: jg.m]
    r = np.asarray(jg.receivers)[: jg.m]
    rng = np.random.default_rng(5)
    out, lo, i = [], 0, 0
    while lo < jg.m:
        hi = min(lo + STREAM_SIZES[i % len(STREAM_SIZES)], jg.m)
        q = rng.integers(0, jg.n, size=(2, 64))
        out.append([s[lo:hi].tolist(), r[lo:hi].tolist(), q[0].tolist(),
                    q[1].tolist()])
        lo, i = hi, i + 1
    return out


def _dynamic_batches(jg, steps: int = 8) -> list:
    """Mixed batches: 16 of the graph's edges inserted, from the third step
    4 earlier inserts deleted, 8 query pairs (one shape each, so that the
    reference compiles its update once)."""
    s = np.asarray(jg.senders)[: jg.m]
    r = np.asarray(jg.receivers)[: jg.m]
    rng = np.random.default_rng(7)
    out, live = [], []
    for i in range(steps):
        e = rng.integers(0, jg.m, size=16)
        d = ([live[j] for j in rng.integers(0, len(live), size=4)]
             if i >= 2 else [])
        q = rng.integers(0, jg.n, size=(2, 8))
        out.append([[a for a, _ in d], [b for _, b in d], s[e].tolist(),
                    r[e].tolist(), q[0].tolist(), q[1].tolist()])
        live += list(zip(s[e].tolist(), r[e].tolist()))
    return out


def _serve_ops(jg, dynamic: bool) -> list:
    """Requests one at a time: inserts, deletes of inserted edges on a
    dynamic server, and queries."""
    s = np.asarray(jg.senders)[: jg.m]
    r = np.asarray(jg.receivers)[: jg.m]
    rng = np.random.default_rng(13)
    ops = []
    for i in range(5):
        e = rng.integers(0, jg.m, size=24)
        ops.append(["ins", s[e].tolist(), r[e].tolist()])
        if dynamic:
            ops.append(["del", s[e[:5]].tolist(), r[e[:5]].tolist()])
        q = rng.integers(0, jg.n, size=(2, 16))
        ops.append(["q", q[0].tolist(), q[1].tolist()])
    return ops


def _weights(jg) -> list:
    from repro.graphs import generators as jgen
    return np.asarray(jgen.with_weights(jg, seed=1)).tolist()


def _cases(jg, sims, replays: dict) -> dict:
    """Every case a world runs, in order: connectivity with the session's
    own sampler, then with ``repro``'s sampler output replayed; streams;
    SCAN."""
    conn = [{"exec": e, "variant": v, "replay": None}
            for e in EXECS for v in VARIANTS]
    conn += [{"exec": e, "variant": v, "replay": replays[v]}
             for e in EXECS for v in SAMPLED]
    batches = _stream_batches(jg)
    return {
        "graph": {k: np.asarray(getattr(jg, k)).tolist()
                  for k in ("senders", "receivers", "indptr", "indices")}
        | {"n": jg.n, "m": jg.m},
        "connectivity": conn,
        "stream": [{"exec": e, "variant": "none+uf_sync_full",
                    "batches": batches} for e in STREAM_EXECS],
        "scan": [{"exec": e, "variant": "none+uf_sync_full", "spec": sp,
                  "sims": np.asarray(sims).tolist()}
                 for e, sp in SCAN_CASES],
        "weights": _weights(jg),
        "dynamic": [{"exec": e, "variant": "none+uf_sync_full",
                     "batches": _dynamic_batches(jg)} for e in DYN_EXECS],
        "amsf": [{"exec": e, "variant": "kout_afforest_k2+uf_sync_full",
                  "spec": sp} for e, sp in AMSF_CASES],
        "serve": [{"exec": e, "variant": "none+uf_sync_full",
                   "ops": _serve_ops(jg, "dynamic" in e)}
                  for e in SERVE_EXECS],
    }


# ---------------------------------------------------------------------------
# The reference on 4 forced host devices: this file run as a script.
# ---------------------------------------------------------------------------

def _served_arrays(store, n: int) -> dict:
    """The committed served state's whole labels (and forest), by name."""
    st = store._committed
    P = np.asarray(st.P if store.dynamic else st)
    out = {"P": P[: n + 1].tolist(), "epoch": store.epoch,
           "epoch_edges": store.epoch_edges, "rounds": store.rounds_total}
    if store.dynamic:
        out.update(fu=np.asarray(st.fu).tolist(),
                   fv=np.asarray(st.fv).tolist())
    return out


def _jax_reference(cases_path: str, out_path: str) -> int:
    import jax
    from repro.api import ConnectIt
    from repro.serve import ServeConfig

    with open(cases_path) as f:
        cases = json.load(f)
    jg = _graph()
    assert np.asarray(jg.senders).tolist() == cases["graph"]["senders"]
    out = {"devices": jax.device_count(), "connectivity": [], "stream": [],
           "scan": [], "dynamic": [], "amsf": [], "serve": []}
    for c in cases["connectivity"]:
        if c["replay"] is not None:  # the reference draws its own P0
            continue
        labels, st = ConnectIt(c["variant"], exec=c["exec"]).connectivity(
            jg, return_stats=True)
        out["connectivity"].append({"labels": np.asarray(labels).tolist(),
                                    "stats": _stats(st)})
    for c in cases["stream"]:
        h = ConnectIt(c["variant"], exec=c["exec"]).stream(jg.n)
        answers = [np.asarray(h.process(*map(np.asarray, b))).tolist()
                   for b in c["batches"]]
        out["stream"].append({"answers": answers,
                              "labels": np.asarray(h.labels).tolist(),
                              "stats": _stats(h.stats)})
    for c in cases["scan"]:
        labels, cores, st = ConnectIt(c["variant"], exec=c["exec"]).scan(
            jg, np.asarray(c["sims"], np.float32), c["spec"],
            return_stats=True)
        out["scan"].append({"labels": np.asarray(labels).tolist(),
                            "cores": np.asarray(cores).tolist(),
                            "stats": _stats(st)})
    for c in cases["dynamic"]:
        h = ConnectIt(c["variant"], exec=c["exec"]).stream(jg.n)
        answers = [np.asarray(h.process(*(np.asarray(x, np.int32)
                                          for x in b))).tolist()
                   for b in c["batches"]]
        out["dynamic"].append({
            "answers": answers, "labels": np.asarray(h.labels).tolist(),
            **{f: np.asarray(getattr(h.state, f)).tolist()
               for f in ("fu", "fv", "log_u", "log_v")},
            "used": h.log_used(), "stats": _stats(h.stats)})
    w = np.asarray(cases["weights"], np.float32)
    for c in cases["amsf"]:
        edges, st = ConnectIt(c["variant"], exec=c["exec"]).amsf(
            jg, w, c["spec"], return_stats=True)
        out["amsf"].append({"edges": np.asarray(edges).tolist(),
                            "stats": _stats(st), "buckets": st.buckets,
                            "edges_per_bucket": list(st.edges_per_bucket)})
    for c in cases["serve"]:
        server = ConnectIt(c["variant"], exec=c["exec"]).serve(
            jg.n, config=ServeConfig(**SERVE_CONFIG))
        answers = []

        async def main():
            async with server:
                for op, a, b in c["ops"]:
                    a, b = np.asarray(a, np.int32), np.asarray(b, np.int32)
                    if op == "ins":
                        await server.submit_inserts(a, b)
                    elif op == "del":
                        await server.submit_deletes(a, b)
                    else:
                        ans, epoch = await server.query(a, b)
                        answers.append([np.asarray(ans).tolist(), epoch])

        asyncio.run(main())
        stats = dataclasses.asdict(server.stats())
        stats = {k: list(v) if isinstance(v, tuple) else v
                 for k, v in stats.items()}
        out["serve"].append({"answers": answers, "stats": stats,
                             **_served_arrays(server.store, jg.n)})
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(_jax_reference(sys.argv[1], sys.argv[2]))


# ---------------------------------------------------------------------------
# Everything below runs under pytest.
# ---------------------------------------------------------------------------

import jax  # noqa: E402

from conftest import scipy_canonical  # noqa: E402
from repro import api as japi  # noqa: E402
from repro.core import execution as jexe  # noqa: E402
from repro.core.apps import scan as jscan  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch.core import execution as texe  # noqa: E402
from repro_torch.graphs import generators as tgen  # noqa: E402
from repro_torch.graphs import graph_from_arrays  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import multihost  # noqa: E402


@pytest.fixture(autouse=True)
def _clear_jax_caches():
    """Shadow conftest's per-test cache clearing: the reference's mesh
    programs compile once per (spec, variant) and are reused by the stats,
    stream and SCAN cases. Cleared once per module."""
    yield


@pytest.fixture(scope="module", autouse=True)
def _module_scope():
    yield
    jax.clear_caches()
    multihost.shutdown()


JG = _graph()
ORACLE = scipy_canonical(JG)


def _port(jg, device="cpu"):
    return graph_from_arrays(jg.senders, jg.receivers, jg.indptr, jg.indices,
                             jg.n, jg.m, device=device)


def _replay_array(variant: str) -> np.ndarray:
    """``repro``'s sampler output on JG, as its session draws it (key 0)."""
    fn = japi.VariantSpec.parse(variant).sampling.build()
    return np.array(fn(JG, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def replays() -> dict:
    return {v: _replay_array(v).tolist() for v in SAMPLED}


@pytest.fixture(scope="module")
def sims():
    return jscan.build_index(JG)


# ---------------------------------------------------------------------------
# Grammar: every string as repro parses it, errors included.
# ---------------------------------------------------------------------------

ROUNDTRIP = [
    "single", "single:fused", "single:pad=256", "single:fused,pad=16",
    "replicated(x)", "replicated(pod,data,model)",
    "replicated(pod,data):donate,rounds=8", "sharded(x)", "sharded(x):fused",
    "sharded(pod,data|model)",
    "sharded(pod,data|model):fused,pad=32,donate,rounds=4",
    "sharded(x,y|x)", "sharded(x,y)", "sharded(pod,data,model)",
    "sharded(x):overlap", "sharded(x):frontier=1024", "sharded(x):frontier=0",
    "sharded(x,y):fused,overlap,frontier=512,donate",
    "sharded(x):overlap,rounds=6", "single:dynamic,log=64",
    "sharded(x):dynamic", "single:tune", "single:kernels=interpret",
    "replicated(x):kernels=ref",
]
NORMALIZED = ["replicated", "sharded", "sharded(x):frontier=-1",
              "single:pad=pow2", " sharded( pod , data | model ) : fused ",
              "single:donate", "replicated(x):fused,overlap,frontier=4",
              "single:rounds=3"]
BAD = ["quantum", "single(x)", "replicated()", "sharded(9bad)", "sharded(x|",
       "replicated(a|b)", "single:bogus", "single:rounds", "sharded(x):pad=",
       "replicated(a,a)", "sharded(x):frontier=zz", "sharded(x):frontier=-2",
       "sharded(x):overlap=1", "single:log=64", "single:dynamic,log=3",
       "single:kernels=fast", "sharded(x|Y)", "single:rounds=-1",
       "single:pad=0"]


@pytest.mark.parametrize("text", ROUNDTRIP + NORMALIZED)
def test_spec_strings_parse_as_repro(text):
    got = texe.ExecutionSpec.parse(text)
    want = jexe.ExecutionSpec.parse(text)
    assert str(got) == str(want)
    assert texe.ExecutionSpec.parse(str(got)) == got
    assert got.mesh_axes == want.mesh_axes
    if text in ROUNDTRIP:
        assert str(got) == text
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


@pytest.mark.parametrize("bad", BAD)
def test_bad_spec_strings_raise_as_repro(bad):
    with pytest.raises(ValueError) as want:
        jexe.ExecutionSpec.parse(bad)
    with pytest.raises(ValueError) as got:
        texe.ExecutionSpec.parse(bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [
    dict(placement="replicated", axes=("Bad-Axis",)), dict(pad="fibonacci"),
    dict(pad_multiple=0), dict(placement="sharded", rounds=-1),
    dict(placement="sharded", frontier=-2), dict(placement="warp"),
    dict(kernels="fast"), dict(log=8), dict(rounds=1.5),
])
def test_bad_spec_fields_raise_as_repro(kw):
    with pytest.raises(ValueError) as want:
        jexe.ExecutionSpec(**kw)
    with pytest.raises(ValueError) as got:
        texe.ExecutionSpec(**kw)
    assert str(got.value) == str(want.value)


def test_unused_knobs_are_pinned_as_repro():
    E = texe.ExecutionSpec
    assert E("single", donate=True, rounds=7) == E()
    assert E("replicated", fused=True) == E("replicated")
    assert E("single", overlap=True, frontier=64) == E()
    assert E("replicated", overlap=True, frontier=64) == E("replicated")
    assert E(pad="pow2", pad_multiple=64) == E()
    assert E("sharded", axes=("pod", "data"), label_axis="model") == \
        E.parse("sharded(pod,data|model)")
    assert texe.as_execution_spec("sharded(x)") is not None
    with pytest.raises(TypeError):
        texe.as_execution_spec(3)


# ---------------------------------------------------------------------------
# Planning helpers and compact_mask.
# ---------------------------------------------------------------------------

def test_planning_helpers_match_repro():
    for ndev in range(1, 65):
        for naxes in (1, 2, 3):
            assert texe._balanced_factors(ndev, naxes) == \
                jexe._balanced_factors(ndev, naxes), (ndev, naxes)
    for k in (0, 1, 7, 8, 9, 100, 1000, 1024, 1025, 4097):
        for pad, mult in (("pow2", 8), ("multiple", 8), ("multiple", 256),
                          ("multiple", 3)):
            for shards in (1, 2, 3, 4, 6, 8):
                assert texe.bucket_size(k, pad=pad, pad_multiple=mult,
                                        shards=shards) == \
                    jexe.bucket_size(k, pad=pad, pad_multiple=mult,
                                     shards=shards)
    for size, shards in ((16, 1), (16, 4), (1024, 4), (1026, 6), (8, 8)):
        for k in range(0, size + 1, max(size // 16, 1)):
            assert texe._per_chunk_counts(k, size, shards) == \
                jexe._per_chunk_counts(k, size, shards)


@pytest.mark.parametrize("case", ["empty", "full", "sparse", "over_cap",
                                  "exact_cap"])
def test_compact_mask_matches_repro(case):
    rng = np.random.default_rng(11)
    m, cap = 300, 64
    mask = {"empty": np.zeros(m, bool), "full": np.ones(m, bool),
            "sparse": rng.random(m) < 0.1,
            "over_cap": rng.random(m) < 0.5,
            "exact_cap": np.isin(np.arange(m), rng.permutation(m)[:cap])}[case]
    vals = rng.integers(-1, 1000, size=m).astype(np.int32)
    want = jops.compact_mask(jax.numpy.asarray(mask),
                             jax.numpy.asarray(vals), cap)
    got = tops.compact_mask(torch.from_numpy(mask), torch.from_numpy(vals),
                            cap)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# One rank, in this process.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_connectivity():
    """repro's (labels, stats) of one (exec, variant) at one device, run
    once a module."""
    memo = {}

    def run(exec_str, variant):
        if (exec_str, variant) not in memo:
            labels, st = japi.ConnectIt(variant, exec=exec_str).connectivity(
                JG, return_stats=True)
            memo[exec_str, variant] = (np.asarray(labels), st)
        return memo[exec_str, variant]

    return run


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("exec_str", EXECS)
def test_one_rank_matches_repro(jax_connectivity, exec_str, variant):
    want, jst = jax_connectivity(exec_str, variant)
    g = _port(JG)
    ci = tapi.ConnectIt(variant, exec=exec_str, device="cpu")
    labels, st = ci.connectivity(g, return_stats=True)
    np.testing.assert_array_equal(labels.numpy(), want)
    np.testing.assert_array_equal(labels.numpy(), ORACLE)
    assert st.exec == str(texe.ExecutionSpec.parse(exec_str)) == exec_str
    assert st.devices == 1 and st.placement == exec_str.split("(")[0]
    assert sum(st.edges_per_device) == st.edges_finish
    assert sum(st.dispatch_sizes) == st.edges_finish_padded
    if variant in SAMPLED:  # replay repro's sampler output: every stat
        P0 = torch.from_numpy(_replay_array(variant))
        labels, st = ci._backend.connectivity(
            g, lambda g, gen: P0.clone(), ci._finish, variant=variant)
        np.testing.assert_array_equal(labels.numpy(), want)
    assert _stats(st) == _stats(jst)


@pytest.mark.parametrize("exec_str", EXECS)
def test_one_rank_rounds_budget_and_donation(exec_str):
    sep = "," if ":" in exec_str else ":"
    ci = tapi.ConnectIt("none+uf_sync_full",
                        exec=f"{exec_str}{sep}donate,rounds=16", device="cpu")
    labels = ci.connectivity(_port(JG))
    np.testing.assert_array_equal(labels.numpy(), ORACLE)
    assert ci.stats.finish_rounds == 16


@pytest.mark.parametrize("exec_str", STREAM_EXECS + ["single"])
def test_one_rank_stream_matches_repro(exec_str):
    h = japi.ConnectIt("none+uf_sync_full", exec=exec_str).stream(JG.n)
    t = tapi.ConnectIt("none+uf_sync_full", exec=exec_str,
                       device="cpu").stream(JG.n)
    for u, v, qa, qb in _stream_batches(JG):
        want = np.asarray(h.process(*map(np.asarray, (u, v, qa, qb))))
        got = t.process(u, v, qa, qb)
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(t.labels.numpy(), np.asarray(h.labels))
    assert t.num_components() == h.num_components() == len(np.unique(ORACLE))
    assert _stats(t.stats) == _stats(h.stats)


@pytest.mark.parametrize("exec_str,spec", SCAN_CASES + [
    ("sharded(x,y):fused", "scan(eps=0.3,mu=2)")])
def test_one_rank_scan_matches_repro(sims, exec_str, spec):
    jl, jc, jst = japi.ConnectIt("none+uf_sync_full", exec=exec_str).scan(
        JG, sims, spec, return_stats=True)
    tl, tc, st = tapi.ConnectIt("none+uf_sync_full", exec=exec_str,
                                device="cpu").scan(
        _port(JG), torch.from_numpy(sims), spec, return_stats=True)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert _stats(st) == _stats(jst)


def test_sharded_labels_pad_to_the_label_shards():
    """n + 1 = 257 slots; a padded window keeps its self-rooted tail."""
    multihost.initialize()
    b = texe.make_backend("sharded(x)", device="cpu")
    P = b._place_labels(torch.arange(257, dtype=torch.int32))
    assert torch.equal(b._full_labels(P)[:257], torch.arange(257,
                                                             dtype=torch.int32))


def test_forest_and_ingest_run_single_device_under_a_placement():
    from repro_torch.graphs import ArrayEdgeSource
    g = _port(JG)
    v = "kout_afforest_k2+uf_sync_full"
    single = tapi.ConnectIt(v, device="cpu")
    mesh = tapi.ConnectIt(v, exec="sharded(x)", device="cpu")
    np.testing.assert_array_equal(mesh.spanning_forest(g),
                                  single.spanning_forest(g))
    assert single.stats == mesh.stats
    edges = np.stack([np.asarray(JG.senders)[: JG.m],
                      np.asarray(JG.receivers)[: JG.m]], 1)
    src = ArrayEdgeSource(edges, JG.n, chunk=256)
    assert torch.equal(mesh.from_chunks(src, generator=None),
                       single.from_chunks(src))


def test_one_rank_group_warns_where_there_are_more_cards(monkeypatch):
    """With no rendezvous a placement runs on one card; the reference
    shards over every local device, so the one-rank group says so."""
    multihost.shutdown()
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: None)
    try:
        with pytest.warns(UserWarning, match="cuda:0 of the 4 cards"):
            topo = multihost.initialize(backend="gloo")
        assert topo.num_processes == 1 and not topo.distributed
    finally:
        multihost.shutdown()


def test_plan_mesh_and_backends():
    spec = texe.ExecutionSpec.parse("sharded(pod,data|model)")
    multihost.initialize()
    mesh = texe.make_axis_mesh(("pod", "data", "model"), "cpu")
    assert texe.plan_mesh(spec, mesh, "cpu") is mesh
    assert tuple(mesh.shape) == (1, 1, 1)
    with pytest.raises(ValueError, match="do not provide"):
        texe.plan_mesh(spec, texe.make_axis_mesh(("x",), "cpu"), "cpu")
    with pytest.raises(ValueError, match="session on 'cuda'"):
        texe.plan_mesh(spec, mesh, "cuda")
    assert texe.plan_mesh(texe.ExecutionSpec()) is None
    # one backend a session; the mesh it plans is memoized per group
    a = texe.make_backend("replicated(x)", device="cpu")
    b = texe.make_backend(texe.ExecutionSpec.parse("replicated(x)"),
                          device="cpu")
    assert a is not b and a.spec == b.spec and a.mesh is b.mesh
    ci = tapi.ConnectIt("none+uf_sync_full", exec=spec, mesh=mesh,
                        device="cpu")
    np.testing.assert_array_equal(ci.connectivity(_port(JG)).numpy(), ORACLE)
    assert ci._backend.mesh is mesh
    assert repr(ci) == ("ConnectIt('none+uf_sync_full', "
                        "exec='sharded(pod,data|model)', device='cpu')")
    assert repr(tapi.ConnectIt("uf_sync", device="cpu")) == \
        "ConnectIt('none+uf_sync_naive', device='cpu')"


def test_fused_override_is_refused_on_a_placement():
    g = _port(JG)
    with pytest.raises(ValueError, match="no fused variant"):
        tapi.ConnectIt("uf_sync", exec="replicated(x)",
                       device="cpu").connectivity(g, fused=True)
    with pytest.raises(ValueError, match="sharded\\(x\\):fused"):
        tapi.ConnectIt("uf_sync", exec="sharded(x)",
                       device="cpu").connectivity(g, fused=True)
    ci = tapi.ConnectIt("uf_sync", exec="single", device="cpu")
    ci.connectivity(g, fused=True)
    assert ci.stats.exec == "single:fused" and ci.stats.fused
    ci = tapi.ConnectIt("uf_sync", exec="single:fused,pad=16", device="cpu")
    ci.connectivity(g, fused=False)
    assert ci.stats.exec == "single:pad=16"


@pytest.mark.parametrize("policy", ["pallas", "interpret", "ref"])
def test_kernel_policies_are_refused(policy):
    with pytest.raises(ValueError, match="dispatches by tensor device"):
        tapi.ConnectIt("uf_sync", exec=f"sharded(x):kernels={policy}",
                       device="cpu")


# ---------------------------------------------------------------------------
# Spawned worlds: 2 and 4 ranks, and the reference on 4 host devices.
# ---------------------------------------------------------------------------

def _env(**extra) -> dict:
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    env.update(extra)
    return env


# the 2-rank auto world: each rank's tuning cache names other winners
# (device-global, and for the graph's family)
TUNE_WINNERS = [("none+liu_tarjan_CRFA", "none+uf_sync_full"),
                ("none+uf_sync_naive", "none+shiloach_vishkin")]


class _Spawned:
    """The subprocesses of this module, started together before its first
    test so that they run beside the in-process tests: the 2-rank and
    4-rank worlds, the 4-device reference, a rendezvous that must fail, the
    multihost CLI on 2 ranks and the 2-rank auto world."""

    def __init__(self, tmp: Path, cases: dict):
        self.tmp, self.cases, self.procs = tmp, cases, {}
        self._start_tune_world(tmp, cases["graph"])
        for world in (2, 4):
            path = tmp / f"cases{world}.json"
            with open(path, "w") as f:
                json.dump(dict(cases, world=world,
                               store=str(tmp / f"store{world}")), f)
            for rank in range(world):
                self._start(("world", world, rank),
                            [str(TESTS / "torch_mesh_worker.py"), str(path),
                             str(tmp / f"out{world}_{rank}.json"), str(rank)])
        self._start("jax", [__file__, str(tmp / "cases4.json"),
                            str(tmp / "jax4.json")],
                    XLA_FLAGS="--xla_force_host_platform_device_count=4")
        self._start("rendezvous", ["-c", (
            "from repro_torch.launch import multihost\n"
            f"multihost.initialize(init_method='file://{tmp}/nobody', "
            "num_processes=2, process_id=0, backend='gloo', timeout=1)\n"
            "print('degraded')\n")])
        for r in range(2):
            self._start(("cli", r), [
                "-m", "repro_torch.launch.multihost", "--device", "cpu",
                "--exec", "sharded(x)", "--n", "512", "--num-processes", "2",
                "--init-method", f"file://{tmp}/cli", "--process-id", str(r)])

    def _start_tune_world(self, tmp: Path, graph: dict):
        """Each rank's cache names the winners of ``TUNE_WINNERS``. The
        first case runs on the whole world, the second on a mesh over rank
        1 alone."""
        from repro_torch import tune as ttune
        fam = ttune.fingerprint_graph(_port(JG))
        caches = [str(tmp / f"tune{r}.json") for r in range(2)]
        for path, (glob, family) in zip(caches, TUNE_WINNERS):
            cache = ttune.SelectionCache(path)
            cache.put(ttune.make_key("variant", device="cpu"), glob)
            cache.put(ttune.make_key("variant", fam, device="cpu"), family)
        path = tmp / "tune_cases.json"
        with open(path, "w") as f:
            json.dump({"graph": graph, "world": 2,
                       "store": str(tmp / "store_tune"),
                       "tune": [{"exec": "sharded(x)", "caches": caches,
                                 "fresh": [str(tmp / f"fresh{r}.json")
                                           for r in range(2)]},
                                {"exec": "sharded(x)", "caches": caches,
                                 "ranks": [1],
                                 "fresh": [str(tmp / f"sub_fresh{r}.json")
                                           for r in range(2)]}]}, f)
        for rank in range(2):
            self._start(("tune", rank),
                        [str(TESTS / "torch_mesh_worker.py"), str(path),
                         str(tmp / f"tune_out{rank}.json"), str(rank)])

    def _start(self, key, args, **env):
        self.procs[key] = subprocess.Popen(
            [sys.executable] + args, env=_env(**env), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)

    def wait(self, key) -> tuple:
        """(return code, output) of one subprocess."""
        out, _ = self.procs[key].communicate(timeout=240)
        return self.procs[key].returncode, out

    def close(self):
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
            p.communicate()


@pytest.fixture(scope="module", autouse=True)
def spawned(tmp_path_factory, replays, sims):
    sp = _Spawned(tmp_path_factory.mktemp("spawned"),
                  _cases(JG, sims, replays))
    yield sp
    sp.close()


@pytest.fixture(scope="module")
def worlds(spawned):
    """``{2: [rank outputs], 4: [...], "jax": the reference's}``."""
    outs = {2: [], 4: []}
    for world in (2, 4):
        for rank in range(world):
            rc, log = spawned.wait(("world", world, rank))
            assert rc == 0, (world, rank, log[-3000:])
            with open(spawned.tmp / f"out{world}_{rank}.json") as f:
                outs[world].append(json.load(f))
    rc, log = spawned.wait("jax")
    assert rc == 0, log[-3000:]
    with open(spawned.tmp / "jax4.json") as f:
        outs["jax"] = json.load(f)
    assert outs["jax"]["devices"] == 4
    outs["cases"] = spawned.cases
    return outs


def test_spawned_auto_runs_rank_0s_variant(spawned):
    """Two ranks whose caches name different winners run rank 0's: the
    device-global winner at construction, the family's for the graph. Under
    ``:tune`` every rank measures, the ranks elect one winner (the times'
    pmax), and only rank 0 writes its cache file. On a mesh over rank 1
    alone, rank 1 resolves from its own cache and writes its own file."""
    outs = []
    for rank in range(2):
        rc, log = spawned.wait(("tune", rank))
        assert rc == 0, (rank, log[-3000:])
        with open(spawned.tmp / f"tune_out{rank}.json") as f:
            outs.append(json.load(f)["tune"])
    from repro_torch import tune as ttune
    key = ttune.make_key("variant", ttune.fingerprint_graph(_port(JG)),
                         device="cpu")
    for case, (glob, family), ranks, prefix in (
            (0, TUNE_WINNERS[0], (0, 1), "fresh"),
            (1, TUNE_WINNERS[1], (1,), "sub_fresh")):
        for rank in ranks:
            out = outs[rank][case]
            assert (out["global"], out["variant"]) == (glob, family)
            assert out["tuned_exec"] == "sharded(x):tune"
            for name in ("labels", "tuned_labels"):
                np.testing.assert_array_equal(np.asarray(out[name]), ORACLE)
        assert len({outs[r][case]["tuned"] for r in ranks}) == 1
        fresh = [spawned.tmp / f"{prefix}{r}.json" for r in range(2)]
        assert [p.exists() for p in fresh] == [r == ranks[0]
                                               for r in range(2)]
        assert ttune.SelectionCache(str(fresh[ranks[0]])).winner(key) == \
            outs[ranks[0]][case]["tuned"]
    assert outs[0][1] == {}


def _conn_index(exec_str, variant, replay=False) -> int:
    cases = [(e, v, False) for e in EXECS for v in VARIANTS]
    cases += [(e, v, True) for e in EXECS for v in SAMPLED]
    return cases.index((exec_str, variant, replay))


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("exec_str", EXECS)
@pytest.mark.parametrize("world", [2, 4])
def test_spawned_ranks_agree_and_match_scipy(worlds, world, exec_str,
                                             variant):
    ranks = worlds[world]
    res = [r["connectivity"][_conn_index(exec_str, variant)] for r in ranks]
    for r in res:
        np.testing.assert_array_equal(np.asarray(r["labels"]), ORACLE)
        st = r["stats"]
        assert st["exec"] == exec_str and st["devices"] == world
        assert sum(st["edges_per_device"]) == st["edges_finish"]
        assert sum(st["dispatch_sizes"]) == st["edges_finish_padded"]
        assert st == res[0]["stats"] and r["P0"] == res[0]["P0"]
    want = worlds["jax"]["connectivity"][_conn_index(exec_str, variant)]
    np.testing.assert_array_equal(np.asarray(want["labels"]), ORACLE)
    if variant in SAMPLED:  # the replayed run holds every stat
        res = [r["connectivity"][_conn_index(exec_str, variant, True)]
               for r in ranks]
        for r in res:
            np.testing.assert_array_equal(np.asarray(r["labels"]), ORACLE)
    for r in res:
        if world == 4:
            assert r["stats"] == want["stats"]
        else:
            for f in RANK_FREE:
                assert r["stats"][f] == want["stats"][f], f


@pytest.mark.parametrize("exec_str", STREAM_EXECS)
@pytest.mark.parametrize("world", [2, 4])
def test_spawned_streams_match_repro(worlds, world, exec_str):
    i = STREAM_EXECS.index(exec_str)
    want = worlds["jax"]["stream"][i]
    batches = worlds["cases"]["stream"][i]["batches"]
    for r in worlds[world]:
        got = r["stream"][i]
        assert got["answers"] == want["answers"]
        for (_, _, qa, qb), ans in zip(batches[-1:], got["answers"][-1:]):
            np.testing.assert_array_equal(ans, ORACLE[qa] == ORACLE[qb])
        assert got["labels"] == want["labels"]
        assert got["ncomp"] == len(np.unique(ORACLE))
        if world == 4:
            assert got["stats"] == want["stats"]
        else:
            for f in RANK_FREE + ("batch_shapes",):
                assert got["stats"][f] == want["stats"][f], f


@pytest.mark.parametrize("case", range(len(SCAN_CASES)))
@pytest.mark.parametrize("world", [2, 4])
def test_spawned_scan_matches_repro(worlds, world, case):
    want = worlds["jax"]["scan"][case]
    for r in worlds[world]:
        got = r["scan"][case]
        assert got["labels"] == want["labels"]
        assert got["cores"] == want["cores"]
        if world == 4:
            assert got["stats"] == want["stats"]


@pytest.mark.parametrize("exec_str", DYN_EXECS)
@pytest.mark.parametrize("world", [2, 4])
def test_spawned_dynamic_streams_match_repro(worlds, world, exec_str):
    """Answers after every batch, labels, the forest, rounds and the live
    log equal repro's; the edge ids are global, so the forest is the same
    at 2 ranks; at 4 the ranks' log blocks concatenate to repro's log."""
    i = DYN_EXECS.index(exec_str)
    want = worlds["jax"]["dynamic"][i]
    got = [r["dynamic"][i] for r in worlds[world]]
    for g in got:
        for f in ("answers", "labels", "fu", "fv", "used"):
            assert g[f] == want[f], f
        for f in RANK_FREE + ("batch_shapes",):
            assert g["stats"][f] == want["stats"][f], f
        assert g["stats"]["finish_rounds"] == want["stats"]["finish_rounds"]
    log = [sum((g[f] for g in got), []) for f in ("log_u", "log_v")]
    if world == 4:
        assert log == [want["log_u"], want["log_v"]]
        assert all(g["stats"] == want["stats"] for g in got)
    else:  # the same live edges, in blocks of 2 ranks
        assert sorted(zip(*log)) == sorted(zip(want["log_u"],
                                               want["log_v"]))


@pytest.mark.parametrize("case", range(len(AMSF_CASES)))
@pytest.mark.parametrize("world", [2, 4])
def test_spawned_amsf_matches_repro(worlds, world, case):
    want = worlds["jax"]["amsf"][case]
    for r in worlds[world]:
        got = r["amsf"][case]
        assert got["edges"] == want["edges"]
        for f in ("buckets", "edges_per_bucket"):
            assert got[f] == want[f], f
        for f in RANK_FREE + ("finish_rounds",):
            assert got["stats"][f] == want["stats"][f], f
        if world == 4:
            assert got["stats"] == want["stats"]


@pytest.mark.parametrize("exec_str", SERVE_EXECS)
@pytest.mark.parametrize("world", [2, 4])
def test_spawned_serving_follows_rank_0(worlds, world, exec_str):
    """Rank 0 serves one request at a time; the other ranks follow its
    warmup and commits. Rank 0's answers, epochs, state and counters equal
    repro's on the same requests; every follower ends in rank 0's state."""
    i = SERVE_EXECS.index(exec_str)
    want = worlds["jax"]["serve"][i]
    leader, *followers = [r["serve"][i] for r in worlds[world]]
    assert leader["role"] == "leader"
    assert leader["answers"] == want["answers"]
    state = ("P", "fu", "fv", "epoch", "epoch_edges", "rounds")
    for f in state:
        assert leader.get(f) == want.get(f), f
    stats = dict(want["stats"], devices=world)
    assert leader["stats"] == stats
    commits = leader["epoch"]
    for fo in followers:
        assert fo["role"] == "follower" and fo["errors"] == []
        assert fo["replayed"] == commits + 1  # and the warmup
        for f in state:
            assert fo.get(f) == leader.get(f), f


def test_failed_rendezvous_raises(spawned):
    """A configured rendezvous that cannot complete raises; it does not
    degrade to one process (the reference's initialize does)."""
    rc, log = spawned.wait("rendezvous")
    assert rc != 0 and "degraded" not in log
    assert "timeout" in log.lower(), log[-2000:]


def test_multihost_cli_two_ranks(spawned):
    (rc0, log0), (rc1, log1) = (spawned.wait(("cli", r)) for r in (0, 1))
    assert (rc0, rc1) == (0, 0), (log0, log1)
    g = tgen.rmat(512, 4096, seed=7, device="cpu")
    comps = len(np.unique(tapi.ConnectIt("none+uf_sync_full", device="cpu")
                          .connectivity(g).numpy()))
    assert (f"processes=2 distributed=True mesh={{'x': 2}} exec=sharded(x) "
            f"n=512 components={comps}") in log0, log0
    assert "processes=" not in log1


# ---------------------------------------------------------------------------
# The card: one rank over NCCL.
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("exec_str", EXECS + ["replicated(x)",
                                              "sharded(x):frontier=0"])
def test_one_rank_on_card_matches_cpu(cuda, exec_str):
    g, gc = _port(JG), _port(JG, "cuda")
    for variant in ("none+uf_sync_full", "kout_afforest_k2+uf_sync_full",
                    "none+liu_tarjan_PUFA"):
        want, wst = tapi.ConnectIt(variant, exec=exec_str,
                                   device="cpu").connectivity(
            g, return_stats=True)
        got, st = tapi.ConnectIt(variant, exec=exec_str,
                                 device="cuda").connectivity(
            gc, return_stats=True)
        assert torch.equal(got.cpu(), want)
        assert _stats(st) == _stats(wst)
    t = tapi.ConnectIt("none+uf_sync_full", exec=exec_str,
                       device="cuda").stream(JG.n)
    w = tapi.ConnectIt("none+uf_sync_full", exec=exec_str,
                       device="cpu").stream(JG.n)
    for u, v, qa, qb in _stream_batches(JG):
        assert torch.equal(t.process(u, v, qa, qb).cpu(),
                           w.process(u, v, qa, qb))
    assert torch.equal(t.labels.cpu(), w.labels)
