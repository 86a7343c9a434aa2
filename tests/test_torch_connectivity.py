"""The port's static connectivity slice against the JAX package.

One graph, built by ``repro.graphs`` and carried across verbatim with
``graph_from_arrays``, goes through ``repro.api.ConnectIt`` and
``repro_torch.api.ConnectIt`` (on the CPU). Labels must be bit-identical for
every variant; ``ConnectivityStats`` must be equal where no random stream
enters (``none+…`` and ``kout_afforest``). The primitives, every finish
method, the k-out edge selection and the BFS traversal are held against
their JAX counterparts the same way. Every comparison is exact integer
equality. The whole variant grid runs in test_torch_variants.py.

The last test scans the port's sources: nothing in ``src/repro_torch``,
``chip_smoke.py``, ``compare_kernels.py`` or ``compare_paths.py`` may
import ``jax`` or ``repro``.
"""

import ast
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import variant_grid_graphs
from repro import api as japi
from repro.core import primitives as jprim
from repro.core.finish import make_finish as j_make_finish
from repro.core.sampling import _bfs_from as j_bfs_from
from repro.core.sampling import _select_kout_edges as j_select_kout
from repro.core.sampling import make_sampler as j_make_sampler
from repro.graphs import generators as jgen
from repro_torch import api as tapi
from repro_torch.core import primitives as tprim
from repro_torch.core.finish import _compress, make_finish
from repro_torch.core.sampling import _bfs_from, _select_kout_edges, make_sampler
from repro_torch.graphs import components_oracle, graph_from_arrays

REPO = Path(__file__).resolve().parents[1]
RNG = np.random.default_rng(3)

VARIANTS = ("none+uf_sync_naive", "none+uf_sync_halve", "none+uf_sync_full",
            "kout_afforest_k2+uf_sync_full", "kout_hybrid_k2+uf_sync_full")
DETERMINISTIC = VARIANTS[:4]
STATS_FIELDS = ("variant", "exec", "placement", "devices", "edges_total",
                "edges_finish", "edges_finish_padded", "edges_per_device",
                "dispatch_sizes", "lmax_count", "finish_rounds", "fused")


@pytest.fixture(autouse=True)
def _clear_jax_caches():
    """Shadow conftest's per-test cache clearing: every test here runs the
    same few JAX programs at one small shape. Cleared once per module."""
    yield


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_once():
    yield
    jax.clear_caches()


def _graphs():
    gs = dict(variant_grid_graphs())
    gs["rmat"] = jgen.rmat(256, 1024, seed=2)
    return gs


GRAPHS = _graphs()


def _port(jg):
    return graph_from_arrays(jg.senders, jg.receivers, jg.indptr, jg.indices,
                             jg.n, jg.m, device="cpu")


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# The slice end to end.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True], ids=["compacted", "fused"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_connectivity_matches_jax(variant, fused):
    jci = japi.ConnectIt(variant)
    tci = tapi.ConnectIt(variant, device="cpu")
    for name, jg in GRAPHS.items():
        want, jstats = jci.connectivity(jg, fused=fused, return_stats=True)
        got, tstats = tci.connectivity(_port(jg), fused=fused,
                                       return_stats=True)
        assert got.dtype == torch.int32 and tci.stats is tstats
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"{variant} on {name}")
        fields = (STATS_FIELDS if variant in DETERMINISTIC
                  else ("variant", "exec", "edges_total", "fused"))
        for f in fields:
            assert getattr(tstats, f) == getattr(jstats, f), (f, name)
        assert 0 <= tstats.edges_finish <= tstats.edges_finish_padded


@pytest.mark.parametrize("variant", ["kout_hybrid_k2+uf_sync_full",
                                     "bfs_c3+liu_tarjan_PUFA",
                                     "ldd_b0.2+uf_sync_full"])
def test_random_columns_come_from_the_generator(variant):
    """A sampler's draws (k-out columns, BFS sources, LDD shifts) come from
    the generator: its labels do not depend on the draw; its stats may."""
    jg = GRAPHS["rmat"]
    ci = tapi.ConnectIt(variant, device="cpu")
    outs = []
    for seed in (0, 1, 2):
        gen = torch.Generator().manual_seed(seed)
        outs.append(ci.connectivity(_port(jg), generator=gen))
    for out in outs[1:]:
        assert torch.equal(out, outs[0])
    np.testing.assert_array_equal(outs[0].numpy(),
                                  components_oracle(_port(jg)))


# ---------------------------------------------------------------------------
# Finish, sampler, primitives.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compress", ["naive", "halve", "full"])
@pytest.mark.parametrize("max_rounds", [2, 1 << 20])
def test_uf_sync_labels_and_rounds_match_jax(compress, max_rounds):
    jg = jgen.path(40)  # long chains: several rounds, and the cap binds at 2
    P0 = np.arange(jg.n + 1, dtype=np.int32)
    jP, jrounds = j_make_finish("uf_sync", compress=compress)(
        jnp.asarray(P0), jg.senders, jg.receivers, max_rounds=max_rounds)
    tP, trounds = make_finish("uf_sync", compress=compress)(
        _t(P0), _t(jg.senders), _t(jg.receivers), max_rounds=max_rounds)
    assert trounds == int(jrounds)
    np.testing.assert_array_equal(tP.numpy(), np.asarray(jP))


def test_make_finish_is_memoized_and_refuses_other_methods():
    assert make_finish("uf_sync", compress="full") is make_finish(
        "uf_sync", compress="full")
    assert make_finish("uf_sync") is make_finish("uf_sync", compress="naive")
    assert make_finish("liu_tarjan") is make_finish("liu_tarjan",
                                                    variant="CRFA")
    for method in ("shiloach_vishkin", "label_prop", "stergiou"):
        assert make_finish(method) is make_finish(method)
    assert make_finish("liu_tarjan", variant="PUS") is not make_finish(
        "liu_tarjan", variant="PUF")
    with pytest.raises(ValueError, match="unknown finish method"):
        make_finish("frobnicate")
    with pytest.raises(ValueError, match="Liu-Tarjan"):
        make_finish("liu_tarjan", variant="CUS")


def _pinned_start(jg) -> np.ndarray:
    """A sampled start as the driver hands it to a finish: the afforest
    k-out labeling, compressed, with L_max pinned to -1 (made by repro)."""
    P = jprim.full_compress(j_make_sampler("kout", k=2, variant="afforest")(
        jg, jax.random.PRNGKey(0)))
    lmax, _ = jprim.most_frequent(P)
    return np.asarray(jprim.relabel_lmax(P, lmax))


FINISH_GRAPHS = {"path": jgen.path(40), "rmat": GRAPHS["rmat"]}
FINISH_STARTS = {
    (name, start): (np.arange(jg.n + 1, dtype=np.int32) if start == "identity"
                    else _pinned_start(jg))
    for name, jg in FINISH_GRAPHS.items() for start in ("identity", "pinned")}


@functools.lru_cache(maxsize=None)
def _j_finish(finish: str, max_rounds: int):
    """repro's finish of one grid string, jitted once per shape."""
    fn = japi.VariantSpec.parse(finish).build_finish()
    return jax.jit(functools.partial(fn, max_rounds=max_rounds))


@pytest.mark.parametrize("max_rounds", [2, 1 << 20])
@pytest.mark.parametrize("finish", japi.default_finish_grid())
def test_finish_labels_and_rounds_match_jax(finish, max_rounds):
    """Each of the 22 finishes on a path and an RMAT graph, from the
    identity and from an L_max-pinned (-1) start: labels and rounds exactly
    equal to repro's, under a binding and a free round cap."""
    tfn = tapi.VariantSpec.parse(finish).build_finish()
    for (name, start), P0 in FINISH_STARTS.items():
        jg = FINISH_GRAPHS[name]
        jP, jrounds = _j_finish(finish, max_rounds)(
            jnp.asarray(P0), jg.senders, jg.receivers)
        tP, trounds = tfn(_t(P0), _t(jg.senders), _t(jg.receivers),
                          max_rounds=max_rounds)
        assert trounds == int(jrounds), (name, start)
        np.testing.assert_array_equal(tP.numpy(), np.asarray(jP),
                                      err_msg=f"{finish} {name} {start}")


def test_compress_helper_matches_jax():
    """``_compress`` (naive/halve/full) equals repro's exactly."""
    from repro.core.finish import _compress as j_compress
    P = _compressible(300)
    for how in ("naive", "halve", "full"):
        np.testing.assert_array_equal(
            _compress(_t(P), how).numpy(),
            np.asarray(j_compress(jnp.asarray(P), how)))
    with pytest.raises(ValueError):
        _compress(_t(P), "bogus")


def test_make_sampler_is_memoized_and_refuses_other_schemes():
    assert make_sampler("kout") is make_sampler("kout", k=2, variant="hybrid")
    assert make_sampler("bfs") is make_sampler("bfs", num_sources=3,
                                               threshold=0.1)
    assert make_sampler("ldd") is make_sampler("ldd", beta=0.2)
    assert make_sampler("ldd", beta=0.5) is not make_sampler("ldd")
    with pytest.raises(ValueError, match="unknown sampling scheme"):
        make_sampler("frobnicate")
    for scheme, kw in [("bfs", {"num_sources": 0}), ("bfs", {"threshold": 0}),
                       ("ldd", {"beta": 0.0}), ("kout", {"k": 0})]:
        with pytest.raises(ValueError):
            make_sampler(scheme, **kw)


@pytest.mark.parametrize("gname", ["random", "path", "star", "two_clique",
                                   "rmat"])
def test_bfs_traversal_matches_jax(gname):
    """The visited mask and the discovery parents from a given source equal
    repro's exactly."""
    jg = GRAPHS[gname]
    for src in (0, 3, jg.n - 1):
        want = j_bfs_from(jg, jnp.int32(src), jnp.bool_(True))
        got = _bfs_from(_port(jg), torch.tensor(src, dtype=torch.int32))
        for a, b in zip(got, want, strict=True):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_bfs_accepts_the_first_source_over_the_threshold():
    """Two 10-cliques: at threshold 0.1 the first source is accepted and
    labels its clique; at 1.0 none is, and the labeling stays the identity."""
    g = _port(GRAPHS["two_clique"])
    ids = torch.arange(g.n + 1, dtype=torch.int32)
    P = make_sampler("bfs", threshold=0.1)(g, torch.Generator().manual_seed(0))
    src = int(P[(P != ids)][0])
    clique = (torch.arange(g.n) < 10) == (src < 10)
    assert torch.equal(P[: g.n][clique], torch.full((10,), src,
                                                    dtype=torch.int32))
    assert torch.equal(P[: g.n][~clique], ids[: g.n][~clique])
    assert int(P[g.n]) == g.n
    P = make_sampler("bfs", threshold=1.0)(g, torch.Generator().manual_seed(0))
    assert torch.equal(P, ids)


@pytest.mark.parametrize("gname", ["random", "star", "two_clique", "rmat"])
def test_ldd_clusters_every_vertex_inside_its_component(gname):
    """Every vertex lands in a cluster whose center labels itself and lies
    in the same component (exact integer checks against scipy)."""
    g = _port(GRAPHS[gname])
    P = make_sampler("ldd")(g, torch.Generator().manual_seed(0))
    n = g.n
    assert int(P[n]) == n and bool((P[:n] >= 0).all() & (P[:n] < n).all())
    centers = P[:n].long()
    assert torch.equal(P[centers], P[:n])
    comp = components_oracle(g)
    np.testing.assert_array_equal(comp[centers.numpy()], comp)


@pytest.mark.parametrize("variant", ["afforest", "hybrid", "maxdeg", "pure"])
@pytest.mark.parametrize("gname", ["random", "star", "rmat"])
def test_kout_selection_matches_jax(variant, gname):
    jg = GRAPHS[gname]
    k = 3
    js, jr = j_select_kout(jg, jax.random.PRNGKey(0), k, variant)
    ts, tr = _select_kout_edges(_port(jg), torch.Generator().manual_seed(0), k,
                                variant)
    n = jg.n
    np.testing.assert_array_equal(ts.numpy() < n, np.asarray(js) < n)
    # deterministic columns match exactly; random columns must be real edges
    det = {"afforest": k, "hybrid": 1, "maxdeg": 1, "pure": 0}[variant]
    np.testing.assert_array_equal(tr.numpy()[: det * n],
                                  np.asarray(jr)[: det * n])
    edges = set(map(tuple, np.stack([np.asarray(jg.senders)[: jg.m],
                                     np.asarray(jg.receivers)[: jg.m]], 1)
                    .tolist()))
    for s, r in zip(ts.tolist(), tr.tolist()):
        assert (s, r) in edges or s == r == n


def _compressible(n: int) -> np.ndarray:
    P = np.minimum(RNG.integers(0, n, n + 1), np.arange(n + 1))
    P[n] = n
    return P.astype(np.int32)


@pytest.mark.parametrize("max_rounds", [1, 2, 64])
def test_full_compress_matches_jax(max_rounds):
    P = _compressible(500)
    for jumps in (1, 3):
        want = jprim.full_compress(jnp.asarray(P), max_rounds, jumps=jumps)
        got = tprim.full_compress(_t(P), max_rounds, jumps=jumps)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_iterate_to_fixpoint_counts_rounds_as_jax():
    P = _compressible(300)
    step_j = lambda p: jprim.jump_round(p, 1)  # noqa: E731
    step_t = lambda p: tprim.jump_round(p, 1)  # noqa: E731
    for cap in (1, 3, 1 << 20):
        _, jr = jprim.iterate_to_fixpoint(step_j, jnp.asarray(P), cap)
        _, tr = tprim.iterate_to_fixpoint(step_t, _t(P), cap)
        assert tr == int(jr)
    # a tuple state converges on any changed tensor
    _, rounds = tprim.iterate_to_fixpoint(
        lambda st: (tprim.jump_round(st[0]), st[1]), (_t(P), _t(P)))
    assert rounds == int(jr)


def test_label_primitives_match_jax():
    P = jprim.full_compress(jnp.asarray(_compressible(400)))
    tP = _t(P)
    jl, jc = jprim.most_frequent(P)
    tl, tc = tprim.most_frequent(tP)
    assert (int(tl), int(tc)) == (int(jl), int(jc))
    assert int(tprim.num_components(tP)) == int(jprim.num_components(P))
    np.testing.assert_array_equal(tprim.count_labels(tP).numpy(),
                                  np.asarray(jprim.count_labels(P)))
    np.testing.assert_array_equal(tprim.is_root(tP).numpy(),
                                  np.asarray(jprim.is_root(P)))
    jpin = jprim.relabel_lmax(P, jl)
    tpin = tprim.relabel_lmax(tP, tl)
    np.testing.assert_array_equal(tpin.numpy(), np.asarray(jpin))
    np.testing.assert_array_equal(tprim.restore_lmax(tpin).numpy(),
                                  np.asarray(jprim.restore_lmax(jpin)))
    np.testing.assert_array_equal(tprim.min_vertex_labels(tpin).numpy(),
                                  np.asarray(jprim.min_vertex_labels(jpin)))
    raw = _compressible(400)
    np.testing.assert_array_equal(
        tprim.canonical_labels(_t(raw)).numpy(),
        np.asarray(jprim.canonical_labels(jnp.asarray(raw))))
    x = _t(RNG.integers(-1, 401, 50).astype(np.int32))
    np.testing.assert_array_equal(
        tprim.parents_of(tP, x).numpy(),
        np.asarray(jprim.parents_of(P, jnp.asarray(x.numpy()))))


def test_most_frequent_ties_go_to_the_first_label():
    P = _t(np.array([3, 3, 1, 1, 0, 5, 6], np.int32))  # n = 6, dump last
    label, count = tprim.most_frequent(P)
    jl, jc = jprim.most_frequent(jnp.asarray(P.numpy()))
    assert (int(label), int(count)) == (int(jl), int(jc)) == (1, 2)


# ---------------------------------------------------------------------------
# The spec grammar: round-trips as repro.api prints, the rest refuses.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("text", [
    "none+uf_sync_naive", "uf_sync", "uf_sync_full", "none+uf_sync_halve",
    "kout_afforest_k2+uf_sync_full", "kout_k3_pure+uf_sync_naive",
    "kout_hybrid+uf_sync_full", "kout_maxdeg_k1+uf_sync", "kout+uf_sync_halve",
    "bfs_c3+uf_sync_full", "ldd_b0.2+uf_sync_full", "none+shiloach_vishkin",
    "none+label_prop", "stergiou", "kout_hybrid_k2+liu_tarjan_CRFA",
    "liu_tarjan", "bfs+liu_tarjan_PUS", "ldd_b1e+16+uf_sync_full",
    "bfs_c2_t0.30000000000000004+liu_tarjan_PRF", "bfs_c5_t0.1+label_prop",
    "ldd+stergiou",
])
def test_spec_strings_round_trip_as_jax(text):
    t = tapi.VariantSpec.parse(text)
    j = japi.VariantSpec.parse(text)
    assert str(t) == str(j)
    assert tapi.VariantSpec.parse(str(t)) == t
    assert str(t.sampling) == str(j.sampling)
    assert str(t.finish) == str(j.finish)
    assert t.finish_str == j.finish_str and t.lt_code == j.lt_code
    assert t.finish_kwargs() == j.finish_kwargs()
    assert t.sampling.factory_kwargs() == j.sampling.factory_kwargs()


def test_enumerate_variants_matches_jax():
    """The same 148 strings in the same order, each round-tripping, and the
    grid pieces equal to repro's."""
    got = [str(v) for v in tapi.enumerate_variants()]
    assert got == [str(v) for v in japi.enumerate_variants()]
    assert len(got) == 148
    for v in tapi.enumerate_variants():
        assert tapi.VariantSpec.parse(str(v)) == v
    assert tapi.default_finish_grid() == japi.default_finish_grid()
    assert ([str(s) for s in tapi.default_sampling_grid()]
            == [str(s) for s in japi.default_sampling_grid()])
    for code in tapi.LIU_TARJAN_VARIANTS:
        t = tapi.VariantSpec.liu_tarjan(code)
        assert str(t) == str(japi.VariantSpec.liu_tarjan(code))
        assert t.lt_code == code
    assert not tapi.is_compatible(tapi.SamplingSpec("bfs"), "stergiou")
    assert tapi.is_compatible(tapi.SamplingSpec(), "stergiou")


def test_invalid_liu_tarjan_rule_mixes_raise():
    """Rule mixes outside the 16 valid codes are not representable."""
    with pytest.raises(ValueError, match="not one of the paper's valid"):
        tapi.VariantSpec(finish=tapi.FinishSpec("liu_tarjan"),
                         connect="connect", rootup=True, shortcut="S",
                         alter=False)
    with pytest.raises(ValueError, match="unknown Liu-Tarjan code"):
        tapi.VariantSpec.parse("liu_tarjan_CUS")
    with pytest.raises(ValueError, match="connect rule"):
        tapi.VariantSpec(finish=tapi.FinishSpec("liu_tarjan"),
                         connect="bogus")


@pytest.fixture()
def tune_cache(tmp_path, monkeypatch):
    """An empty tuning cache of the port's, installed as its default."""
    from repro_torch import tune as ttune
    from repro_torch.kernels import ops as tops
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "tune.json"))
    ttune.reset_default_cache()
    tops.clear_tuned_blocks()
    yield ttune
    ttune.reset_default_cache()
    tops.clear_tuned_blocks()


@pytest.mark.parametrize("text,item", [
    ("auto", "Queue 1 item 14"),
])
def test_unported_specs_name_their_queue_item(text, item, tune_cache):
    """``item`` is ported: "auto" resolves through the tuning cache, to the
    paper's default on a cold one, and does not round-trip."""
    spec = tapi.VariantSpec.parse(text, device="cpu")
    assert str(spec) == tune_cache.PAPER_DEFAULT_VARIANT
    assert str(spec) == str(japi.VariantSpec.parse(spec.__str__()))


def test_unported_surfaces_name_their_queue_item(tune_cache):
    """Queue 1 item 14 is ported: the ``tune`` exec opt and ``"auto"``
    construct and run. A non-auto session with ``tune`` runs as without
    it; an auto one measures its variant on the first graph."""
    from repro_torch.launch import multihost
    jg = GRAPHS["rmat"]
    g = _port(jg)
    want = components_oracle(g)
    v = "kout_hybrid_k2+uf_sync_full"
    try:
        for exec_str in ("single:tune", "sharded(x):tune",
                         "single:dynamic,tune"):
            ci = tapi.ConnectIt(v, exec=exec_str, device="cpu")
            np.testing.assert_array_equal(ci.connectivity(g).numpy(), want)
            assert ci.stats.variant == v and ci.stats.exec == exec_str
        st = tapi.ConnectIt(v, exec="single:dynamic,tune",
                            device="cpu").stream(g.n, log=4096)
        none = torch.zeros(0, dtype=torch.int32)
        ans = st.process(none, none, g.senders[: g.m], g.receivers[: g.m],
                         torch.tensor([0, 1]), torch.tensor([1, 3]))
        np.testing.assert_array_equal(ans.numpy(),
                                      [want[0] == want[1],
                                       want[1] == want[3]])
        ci = tapi.ConnectIt("auto", device="cpu")
        np.testing.assert_array_equal(ci.connectivity(g).numpy(), want)
        assert ci.stats.variant == tune_cache.PAPER_DEFAULT_VARIANT
        ci = tapi.ConnectIt("auto", exec="single:tune", device="cpu")
        np.testing.assert_array_equal(ci.connectivity(g).numpy(), want)
        assert ci.stats.variant in \
            tune_cache.TuneSpec().variant_candidates()
    finally:
        multihost.shutdown()


def test_bad_specs_raise_value_errors():
    for text in ("kout_bogus_k2+uf_sync_full", "none+uf_sync_bogus",
                 "frobnicate+uf_sync", "none+nonsense", "bfs_x3+uf_sync",
                 "ldd_q0.2+uf_sync", "ldd_b0+uf_sync", "bfs_t1.5+uf_sync"):
        with pytest.raises(ValueError):
            tapi.VariantSpec.parse(text)


def test_session_refuses_a_graph_on_another_device():
    jg = GRAPHS["path"]
    g = _port(jg)
    ci = tapi.ConnectIt("uf_sync", device="cpu")
    ci.device = torch.device("meta")
    with pytest.raises(ValueError, match="graph lives on"):
        ci.connectivity(g)


def test_default_session_device_is_the_card():
    if torch.cuda.is_available():
        assert tapi.ConnectIt().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            tapi.ConnectIt()


# ---------------------------------------------------------------------------
# Import isolation.
# ---------------------------------------------------------------------------

def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_neither_jax_nor_repro():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "compare_kernels.py",
              REPO / "compare_paths.py"]
    assert len(files) > 15
    for path in files:
        bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"
