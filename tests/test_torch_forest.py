"""The port's spanning forest (paper §3.4 / Algorithm 2) against the JAX
package.

The same numpy inputs go through ``repro`` and ``repro_torch`` (on the CPU):
``hook_and_record``, ``uf_sync_forest`` under each compress mode and round
cap, and each sampler's ``want_forest`` output are bit-identical where no
random stream enters, or where the test hands both packages the same draws
(BFS sources, LDD shifts). ``ConnectIt.spanning_forest`` gives a valid
forest for all 28 forest-capable variants (the checks of
``test_spanning_forest.py``) and, on the deterministic samplings, the
reference's edges row for row. Every comparison is exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import connected_components

from conftest import partition_equiv, variant_grid_graphs
from repro import api as japi
from repro.core import finish as jfinish
from repro.core import primitives as jprim
from repro.core import sampling as jsampling
from repro.graphs import generators as jgen
from repro_torch import api as tapi
from repro_torch.core import finish as tfinish
from repro_torch.core import primitives as tprim
from repro_torch.core import sampling as tsampling
from repro_torch.graphs import graph_from_arrays
from test_spanning_forest import _check_forest

RNG = np.random.default_rng(7)


@pytest.fixture(autouse=True)
def _clear_jax_caches():
    """Shadow conftest's per-test cache clearing: the JAX programs here run
    at a few small shapes. Cleared once per module."""
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


def _assert_state(got, want, what) -> None:
    for a, b, leaf in zip(got, want, ("P", "fu", "fv")):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=f"{what}: {leaf}")


# ---------------------------------------------------------------------------
# Primitives and the forest finish.
# ---------------------------------------------------------------------------

_j_hook_and_record = jax.jit(jprim.hook_and_record)


@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_hook_and_record_matches_jax(gname):
    """Both passes on labels with chains, roots and -1 entries, masked and
    unmasked, into empty and partly filled forest slots."""
    jg = GRAPHS[gname]
    n, s, r = jg.n, np.asarray(jg.senders), np.asarray(jg.receivers)
    lab = np.minimum(RNG.integers(0, n + 1, n + 1), np.arange(n + 1))
    lab[RNG.random(n + 1) < 0.1] = -1
    lab[n] = n
    lab = lab.astype(np.int32)
    idx, vals = lab[s], lab[r]
    fu = np.where(RNG.random(n + 1) < 0.3, RNG.integers(0, n, n + 1), -1)
    fu = fu.astype(np.int32)
    fv = np.where(fu >= 0, RNG.integers(0, n, n + 1), -1).astype(np.int32)
    for mask in (None, RNG.random(s.shape[0]) < 0.7):
        for slots in ((-np.ones_like(fu), -np.ones_like(fv)), (fu, fv)):
            want = _j_hook_and_record(
                jnp.asarray(lab), jnp.asarray(idx), jnp.asarray(vals),
                None if mask is None else jnp.asarray(mask),
                jg.senders, jg.receivers, *map(jnp.asarray, slots))
            got = tprim.hook_and_record(
                _t(lab), _t(idx), _t(vals), None if mask is None else _t(mask),
                _t(s), _t(r), *map(_t, slots))
            _assert_state(got, want, gname)


@functools.lru_cache(maxsize=None)
def _j_forest(compress: str, max_rounds: int):
    return jax.jit(functools.partial(jfinish.uf_sync_forest,
                                     compress=compress, max_rounds=max_rounds))


@pytest.mark.parametrize("max_rounds", [2, 1 << 20])
@pytest.mark.parametrize("compress", ["naive", "halve", "full"])
def test_uf_sync_forest_matches_jax(compress, max_rounds):
    """Labels, forest slots and rounds, from the identity, exactly."""
    for name, jg in GRAPHS.items():
        P0 = np.arange(jg.n + 1, dtype=np.int32)
        jst, jrounds = _j_forest(compress, max_rounds)(
            jnp.asarray(P0), jg.senders, jg.receivers)
        tst, trounds = tfinish.uf_sync_forest(
            _t(P0), _t(jg.senders), _t(jg.receivers), compress=compress,
            max_rounds=max_rounds)
        assert trounds == int(jrounds), name
        _assert_state(tst, jst, f"{compress} {max_rounds} {name}")


def test_self_loops_are_never_recorded():
    n = 8
    s = torch.tensor([3, 3, 0, n, 3, 3, 1, n], dtype=torch.int32)
    r = torch.tensor([3, 3, 1, n, 3, 3, 0, n], dtype=torch.int32)
    st, _ = tfinish.uf_sync_forest(tprim.init_labels(n, device="cpu"), s, r)
    rec = [tuple(sorted((int(a), int(b))))
           for a, b in zip(st.fu, st.fv) if int(a) >= 0]
    assert rec == [(0, 1)]


def test_make_forest_finish_is_memoized_and_refuses_other_methods():
    make = tfinish.make_forest_finish
    assert make("uf_sync") is make("uf_sync", compress="full")
    assert make("uf_sync", compress="naive") is not make("uf_sync")
    assert make("shiloach_vishkin") is make("shiloach_vishkin")
    assert tfinish.forest_method_names() == jfinish.forest_method_names()
    assert tfinish.FOREST_METHODS == jfinish.FOREST_METHODS
    for method in ("label_prop", "stergiou", "liu_tarjan"):
        with pytest.raises(KeyError):
            make(method)
    with pytest.raises(ValueError, match="compress"):
        make("uf_sync", compress="bogus")
    # every forest step runs the same rounds as the reference's
    jg = GRAPHS["rmat"]
    P0 = np.arange(jg.n + 1, dtype=np.int32)
    fu0 = -np.ones_like(P0)
    for spec in ("none+uf_sync_halve", "none+shiloach_vishkin"):
        jst, jk = japi.VariantSpec.parse(spec).build_forest_finish()(
            jnp.asarray(P0), jg.senders, jg.receivers, jnp.asarray(fu0),
            jnp.asarray(fu0))
        tst, tk = tapi.VariantSpec.parse(spec).build_forest_finish()(
            _t(P0), _t(jg.senders), _t(jg.receivers), _t(fu0), _t(fu0))
        assert tk == int(jk)
        _assert_state(tst, jst, spec)


# ---------------------------------------------------------------------------
# Samplers' partial forests.
# ---------------------------------------------------------------------------

def _check_partial_forest(g, st) -> None:
    """A sampler's partial forest: real edges, acyclic, and its components
    are exactly the sampler's clusters (so its size is n - #clusters)."""
    n = g.n
    P = st.P[:n].numpy()
    sel = (st.fu[:n] >= 0).numpy()
    edges = np.stack([st.fu[:n].numpy()[sel], st.fv[:n].numpy()[sel]], 1)
    assert len(edges) == n - len(np.unique(P))
    keys = set(zip(g.senders[: g.m].tolist(), g.receivers[: g.m].tolist()))
    assert all((int(u), int(v)) in keys for u, v in edges)
    _, comp = connected_components(
        csr_matrix((np.ones(len(edges)), (edges[:, 0], edges[:, 1])),
                   shape=(n, n)), directed=False)
    assert partition_equiv(comp, P)


@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_kout_forest_matches_jax(gname):
    """k-out afforest is deterministic: equal to repro's; hybrid draws from
    the generator: a valid partial forest of its own clusters."""
    jg = GRAPHS[gname]
    g = _port(jg)
    want = jsampling.make_sampler("kout", variant="afforest")(
        jg, jax.random.PRNGKey(0), want_forest=True)
    got = tsampling.make_sampler("kout", variant="afforest")(
        g, None, want_forest=True)
    _assert_state(got, want, gname)
    np.testing.assert_array_equal(
        tsampling.make_sampler("kout", variant="afforest")(g, None).numpy(),
        got.P.numpy())
    hybrid = tsampling.make_sampler("kout")
    st = hybrid(g, torch.Generator().manual_seed(1), want_forest=True)
    _check_partial_forest(g, st)


def _jax_draws(name, n, **kw):
    """The random numbers repro's samplers draw from PRNGKey(0)."""
    key = jax.random.PRNGKey(0)
    if name == "bfs":
        out = []
        for _ in range(kw["num_sources"]):
            key, sub = jax.random.split(key)
            out.append(int(jax.random.randint(sub, (), 0, n,
                                              dtype=jnp.int32)))
        return torch.tensor(out, dtype=torch.int32)
    return torch.from_numpy(np.array(jax.random.exponential(key, (n,))))


@pytest.mark.parametrize("gname,threshold", [
    *((name, 0.1) for name in sorted(GRAPHS)), ("rmat", 0.9)])
def test_bfs_forest_matches_jax_given_its_sources(gname, threshold,
                                                  monkeypatch):
    """With repro's sources handed to the port, labels and parents are
    repro's; the port stops at the first accepted source."""
    jg, g = GRAPHS[gname], _port(GRAPHS[gname])
    want = jsampling.make_sampler("bfs", threshold=threshold)(
        jg, jax.random.PRNGKey(0), want_forest=True)
    sources = _jax_draws("bfs", jg.n, num_sources=3)
    monkeypatch.setattr(torch, "randint", lambda *a, **k: sources.clone())
    got = tsampling.make_sampler("bfs", threshold=threshold)(
        g, None, want_forest=True)
    _assert_state(got, want, gname)
    _check_partial_forest(g, got)


@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_ldd_forest_matches_jax_given_its_shifts(gname, monkeypatch):
    """With repro's exponential draws handed to the port, LDD's clusters
    and discovery edges are repro's."""
    jg, g = GRAPHS[gname], _port(GRAPHS[gname])
    want = jsampling.make_sampler("ldd")(jg, jax.random.PRNGKey(0),
                                         want_forest=True)
    draws = _jax_draws("ldd", jg.n)
    monkeypatch.setattr(torch.Tensor, "exponential_",
                        lambda self, generator=None: self.copy_(draws))
    got = tsampling.make_sampler("ldd")(g, None, want_forest=True)
    _assert_state(got, want, gname)
    _check_partial_forest(g, got)


def _bfs_scatter_reduce(g, src):
    """The BFS loop as it ran before its scatter went through
    ``ops.scatter_min``: ``scatter_reduce(..., "amin")`` → (visited,
    rounds)."""
    n, s, r = g.n, g.senders.long(), g.receivers.long()
    visited = torch.arange(n + 1) == src
    frontier, rounds = visited, 0
    while bool(frontier.any()):
        prop = torch.where(frontier[s] & ~visited[r], g.senders,
                           tprim.INT_MAX)
        buf = torch.full((n + 1,), tprim.INT_MAX, dtype=torch.int32
                         ).scatter_reduce(0, r, prop, "amin")
        frontier = (buf < tprim.INT_MAX) & ~visited
        visited = visited | frontier
        rounds += 1
    return visited, rounds


def _ldd_scatter_reduce(g, generator, beta=0.2):
    """The LDD loop as it ran before its scatter went through
    ``ops.scatter_min`` → (labels, rounds)."""
    n, s, r = g.n, g.senders.long(), g.receivers.long()
    big = tprim.INT_MAX
    shifts = torch.empty(n).exponential_(generator=generator) / beta
    shifts = shifts.clamp_max(float((1 << 20) - 2))
    wake = torch.floor(shifts.max() - shifts).to(torch.int32)
    wake = torch.cat([wake, wake.new_tensor([big])])
    P = torch.full((n + 1,), big, dtype=torch.int32)
    P[n] = n
    ids = torch.arange(n + 1, dtype=torch.int32)
    frontier = torch.zeros(n + 1, dtype=torch.bool)
    rounds = 0
    while bool((P[:n] == big).any()):
        start = (P == big) & (wake <= rounds) & (ids < n)
        P = torch.where(start, ids, P)
        frontier = frontier | start
        act = frontier[s]
        prop = torch.where(act & (P[r] == big), P[s], big)
        buf = torch.full((n + 1,), big, dtype=torch.int32).scatter_reduce(
            0, r, prop, "amin")
        frontier = (buf < big) & (P == big)
        P = torch.where(frontier, buf, P)
        rounds += 1
    return P, rounds


@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_sampler_scatters_through_scatter_min_change_nothing(gname,
                                                             monkeypatch):
    """Under a fixed generator, BFS and LDD give the labels, parents and
    round counts they gave with ``scatter_reduce`` (one ``write_min`` a
    round without the forest, two for LDD with it)."""
    g = _port(GRAPHS[gname])
    calls = []
    write_min = tsampling.write_min
    monkeypatch.setattr(tsampling, "write_min",
                        lambda *a: calls.append(1) or write_min(*a))
    for src in (0, g.n // 2):
        calls.clear()
        visited, parent = tsampling._bfs_from(g, torch.tensor(src))
        want, rounds = _bfs_scatter_reduce(g, src)
        assert torch.equal(visited, want) and len(calls) == rounds
        assert bool(((parent >= 0) == (visited & (torch.arange(g.n + 1)
                                                  != src))).all())
    ldd = tsampling.make_sampler("ldd")
    want, rounds = _ldd_scatter_reduce(g, torch.Generator().manual_seed(3))
    for forest in (False, True):
        calls.clear()
        got = ldd(g, torch.Generator().manual_seed(3), want_forest=forest)
        assert torch.equal(got.P if forest else got, want)
        assert len(calls) == rounds * (2 if forest else 1)


# ---------------------------------------------------------------------------
# The slice end to end.
# ---------------------------------------------------------------------------

FOREST_VARIANTS = [str(v) for v in tapi.enumerate_variants()
                   if v.forest_capable]
DETERMINISTIC = ("none", "kout_afforest_k2")


def test_forest_capable_variants_are_the_references():
    assert len(FOREST_VARIANTS) == 28
    assert FOREST_VARIANTS == [str(v) for v in japi.enumerate_variants()
                               if v.forest_capable]
    for text in FOREST_VARIANTS:
        t, j = tapi.VariantSpec.parse(text), japi.VariantSpec.parse(text)
        assert t.forest_compress == j.forest_compress


@pytest.mark.parametrize("variant", FOREST_VARIANTS)
def test_spanning_forest_is_valid(variant):
    """Every forest-capable variant gives a spanning forest of every graph:
    size n - #components, acyclic, spanning, real edges."""
    ci = tapi.ConnectIt(variant, device="cpu")
    for name, jg in GRAPHS.items():
        edges = ci.spanning_forest(_port(jg),
                                   generator=torch.Generator().manual_seed(1))
        assert edges.dtype == np.int32 and edges.shape[1] == 2
        _check_forest(jg, edges)
        assert ci.stats.variant == variant


@pytest.mark.parametrize("variant", [v for v in FOREST_VARIANTS
                                     if v.split("+")[0] in DETERMINISTIC])
def test_spanning_forest_matches_jax(variant):
    """On the deterministic samplings, repro's forest row for row."""
    jg = GRAPHS["rmat"]
    want = japi.ConnectIt(variant).spanning_forest(jg)
    got = tapi.ConnectIt(variant, device="cpu").spanning_forest(_port(jg))
    np.testing.assert_array_equal(got, want, err_msg=variant)


def test_spanning_forest_requires_a_root_based_finish():
    g = _port(GRAPHS["path"])
    for variant in ("kout_hybrid_k2+liu_tarjan_CRFA", "none+label_prop",
                    "none+stergiou"):
        with pytest.raises(ValueError, match="root-based finish"):
            tapi.ConnectIt(variant, device="cpu").spanning_forest(g)
        with pytest.raises(ValueError, match="root-based finish"):
            tapi.VariantSpec.parse(variant).build_forest_finish()
