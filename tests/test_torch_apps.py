"""The port's §5 apps (AMSF, exact MSF, SCAN GS*-Query) against the JAX
package.

The same numpy graph, weights and similarities go through ``repro`` and
``repro_torch`` (on the CPU). The AppSpec grammar is ``repro``'s;
``with_weights`` draws ``repro``'s weights; on these weights the bucket ids
are ``repro``'s, so every AMSF forest is ``repro``'s edge for edge, with
its buckets, histogram and rounds, and within (1 + eps) of Borůvka's
weight. Borůvka's forest and edge rank, ``build_index`` and every SCAN
label and core flag are ``repro``'s. Comparisons are exact; the one
difference by design (bucket ids at bucket boundaries, ROADMAP Queue 3) is
pinned below.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core.apps import amsf as jamsf
from repro.core.apps import scan as jscan
from repro.core.apps.spec import default_app_grid as j_default_app_grid
from repro.graphs import generators as jgen
from repro_torch import api as tapi
from repro_torch.core.apps import amsf as tamsf
from repro_torch.core.apps import scan as tscan
from repro_torch.core.apps.spec import AppSpec, default_app_grid
from repro_torch.graphs import components_oracle, graph_from_arrays
from repro_torch.graphs import generators as tgen
from test_apps import AMSF_VARIANTS, SCAN_VARIANTS

AMSF_SPECS = ("amsf", "amsf(skip=lmax)", "amsf(mode=coo)", "msf")
AMSF_STATS = ("variant", "exec", "placement", "devices", "app", "edges_total",
              "edges_finish", "edges_finish_padded", "edges_per_device",
              "dispatch_sizes", "buckets", "edges_per_bucket",
              "finish_rounds")
SCAN_STATS = ("variant", "exec", "placement", "devices", "app", "edges_total",
              "edges_finish", "edges_finish_padded", "edges_per_device",
              "dispatch_sizes", "finish_rounds")
CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def _clear_jax_caches():
    """Shadow conftest's per-test cache clearing: the JAX programs here run
    at two small graphs. Cleared once per module."""
    yield


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_once():
    yield
    jax.clear_caches()


def _port(jg):
    return graph_from_arrays(jg.senders, jg.receivers, jg.indptr, jg.indices,
                             jg.n, jg.m, **CPU)


@pytest.fixture(scope="module")
def weighted():
    jg = jgen.rmat(200, 900, seed=5)
    g = _port(jg)
    return jg, jgen.with_weights(jg, seed=1), g, tgen.with_weights(g, seed=1)


@pytest.fixture(scope="module")
def exact_weight(weighted):
    _, _, g, w = weighted
    edges, _ = tamsf.boruvka_msf(g, w)
    return tamsf.forest_weight(edges, g, w)


@pytest.fixture(scope="module")
def jax_amsf(weighted):
    """repro's ``(edges, stats)`` of one (variant, spec), run once a module:
    repro's coo mode takes seconds a run on the CPU."""
    jg, jw, _, _ = weighted
    memo = {}

    def run(variant, spec):
        if (variant, spec) not in memo:
            memo[variant, spec] = japi.ConnectIt(variant).amsf(
                jg, jw, spec, return_stats=True)
        return memo[variant, spec]

    return run


@pytest.fixture(scope="module")
def scan_graph():
    jg = jgen.planted_components(100, 3, 6.0, seed=2)
    g = _port(jg)
    return jg, jscan.build_index(jg), g, tscan.build_index(g)


# ---------------------------------------------------------------------------
# AppSpec grammar.
# ---------------------------------------------------------------------------

def test_app_grid_roundtrips_as_jax():
    grid = default_app_grid()
    assert [str(s) for s in grid] == [str(s) for s in j_default_app_grid()]
    for spec in grid:
        assert AppSpec.parse(str(spec)) == spec
        j = japi.AppSpec.parse(str(spec))
        assert dataclasses.asdict(spec) == dataclasses.asdict(j)
    assert AppSpec.parse("amsf(eps=0.25)") == AppSpec("amsf")
    assert str(AppSpec.parse("amsf(eps=0.25,skip=lmax)")) == "amsf(skip=lmax)"
    assert AppSpec.parse("scan(eps=0.6,mu=3)") == AppSpec("scan")
    assert tapi.AppSpec is AppSpec


def test_app_unused_knobs_are_pinned():
    assert AppSpec("msf") == AppSpec("msf", mu=9)
    assert AppSpec("amsf", mu=7) == AppSpec("amsf")
    assert AppSpec("scan", skip="lmax", mode="coo") == AppSpec("scan")
    assert AppSpec("amsf").eps == 0.25 and AppSpec("scan").eps == 0.6
    with pytest.raises(dataclasses.FrozenInstanceError):
        AppSpec("amsf").eps = 0.5


@pytest.mark.parametrize("bad", [
    "quantum", "amsf()", "amsf(eps=)", "amsf(skip=maybe)", "amsf(mode=csr)",
    "amsf(mu=3)", "scan(mode=coo)", "scan(eps=1.5)", "scan(mu=0)",
    "amsf(eps=-1.0)", "amsf(skip=lmax,mode=coo)", "msf(eps=0.25)",
])
def test_invalid_app_specs_rejected(bad):
    with pytest.raises(ValueError):
        japi.AppSpec.parse(bad)
    with pytest.raises(ValueError):
        AppSpec.parse(bad)


# ---------------------------------------------------------------------------
# Weights and buckets.
# ---------------------------------------------------------------------------

def test_with_weights_matches_jax(weighted):
    jg, jw, g, w = weighted
    assert w.dtype == torch.float32 and w.shape == (g.m_pad,)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    assert torch.isinf(w[g.m:]).all()
    for seed, mean in ((0, 1.0), (3, 2.5)):
        np.testing.assert_array_equal(
            tgen.with_weights(g, seed=seed, mean=mean).numpy(),
            np.asarray(jgen.with_weights(jg, seed=seed, mean=mean)))
    e = _port(jgen.empty_graph(5))
    np.testing.assert_array_equal(
        tgen.with_weights(e).numpy(),
        np.asarray(jgen.with_weights(jgen.empty_graph(5))))


@pytest.mark.parametrize("eps", [0.25, 0.1, 0.5])
def test_bucket_ids_match_jax_on_the_test_weights(weighted, eps):
    _, jw, _, w = weighted
    np.testing.assert_array_equal(tamsf.bucket_ids(w, eps).numpy(),
                                  np.asarray(jamsf.bucket_ids(jw, eps)))
    np.testing.assert_array_equal(
        tamsf.bucket_histogram(tamsf.bucket_ids(w, eps)).numpy(),
        np.asarray(jamsf.bucket_histogram(jamsf.bucket_ids(jw, eps))))


def _boundary_weights(eps: float, wmin: float) -> np.ndarray:
    """wmin·(1+eps)^k rounded to float32, and each one's two float32
    neighbours, plus an inf pad."""
    base = (np.float64(wmin) * (1 + eps) ** np.arange(200)).astype(np.float32)
    w = np.concatenate([[np.float32(wmin)], base,
                        np.nextafter(base, np.float32(np.inf)),
                        np.nextafter(base, np.float32(0))])
    return np.concatenate([w[np.isfinite(w)], [np.inf]]).astype(np.float32)


def _correctly_rounded_bucket_ids(w: np.ndarray, eps: float) -> np.ndarray:
    """bucket_ids with every float32 op correctly rounded (log taken in
    float64, then rounded to float32)."""
    finite = np.isfinite(w)
    q = np.maximum(w / w[finite].min(), np.float32(1.0))
    q[~finite] = 1.0  # their ids are INT_MAX whatever q is
    lg = np.log(q.astype(np.float64)).astype(np.float32)
    step = np.float32(np.log1p(np.float64(np.float32(eps))))
    return np.where(finite, np.floor(lg / step).astype(np.int64), 2**31 - 1)


@pytest.mark.parametrize("eps", [0.25, 0.1, 0.5, 0.01])
@pytest.mark.parametrize("wmin", [1.0, 3e-8, 0.37, 1e-3])
def test_bucket_ids_at_bucket_boundaries(eps, wmin):
    """At weights on and beside the bucket boundaries the port's ids are the
    correctly rounded ones, and equal repro's wherever repro's are too.
    repro's float32 log is not correctly rounded, so a few boundary weights
    land one bucket off there (ROADMAP Queue 3, by design)."""
    w = _boundary_weights(eps, wmin)
    got = tamsf.bucket_ids(torch.from_numpy(w), eps).numpy()
    want = _correctly_rounded_bucket_ids(w, eps)
    np.testing.assert_array_equal(got, want)
    jax_ids = np.asarray(jamsf.bucket_ids(jnp.asarray(w), eps))
    agree = jax_ids == want
    np.testing.assert_array_equal(got[agree], jax_ids[agree])


def test_bucket_ids_smallest_boundary_difference():
    """The smallest input that shows the difference: two weights whose
    quotient (2.3579473 / 0.99999994) lies 2e-7 above 1.1^9. Correctly
    rounded, log(q) / log1p(0.1) is 9.000000 in float32; repro's float32
    log gives 8.999998, bucket 8."""
    w = np.array([0.99999994, 2.3579473], np.float32)
    assert _correctly_rounded_bucket_ids(w, 0.1).tolist() == [0, 9]
    assert tamsf.bucket_ids(torch.from_numpy(w), 0.1).tolist() == [0, 9]
    assert np.asarray(jamsf.bucket_ids(jnp.asarray(w), 0.1)).tolist() == [0, 8]


def test_edge_rank_equals_the_references_unique(weighted):
    """The dense (w, lo, hi) rank from two stable sorts equals the inverse
    of repro's np.unique over those rows, padding rows included."""
    jg, jw, g, w = weighted
    s = np.asarray(jg.senders).astype(np.int64)
    r = np.asarray(jg.receivers).astype(np.int64)
    lo, hi = np.minimum(s, r), np.maximum(s, r)
    _, inverse = np.unique(
        np.stack([np.asarray(jw).astype(np.float64), lo.astype(np.float64),
                  hi.astype(np.float64)], 1), axis=0, return_inverse=True)
    got = tamsf.edge_rank(w, g.senders, g.receivers, g.n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), inverse.reshape(-1))
    # ties in weight between distinct edges: the rank still orders them
    tied = torch.ones_like(w)
    tied[g.m:] = float("inf")
    _, inverse = np.unique(
        np.stack([tied.numpy().astype(np.float64), lo.astype(np.float64),
                  hi.astype(np.float64)], 1), axis=0, return_inverse=True)
    np.testing.assert_array_equal(
        tamsf.edge_rank(tied, g.senders, g.receivers, g.n).numpy(),
        inverse.reshape(-1))


# ---------------------------------------------------------------------------
# AMSF and MSF.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", AMSF_SPECS)
@pytest.mark.parametrize("variant", AMSF_VARIANTS)
def test_amsf_matches_jax(weighted, exact_weight, jax_amsf, variant, spec):
    """repro's forest edge for edge, its stats, and the (1 + eps) bound."""
    jg, jw, g, w = weighted
    want, jstats = jax_amsf(variant, spec)
    got, stats = tapi.ConnectIt(variant, **CPU).amsf(g, w, spec,
                                                     return_stats=True)
    assert got.dtype == np.int32 and got.shape[1] == 2
    np.testing.assert_array_equal(got, want)
    for f in AMSF_STATS:
        assert getattr(stats, f) == getattr(jstats, f), f
    ncomp = len(np.unique(components_oracle(g)))
    assert len(got) == g.n - ncomp
    weight = tamsf.forest_weight(got, g, w)
    assert weight == jamsf.forest_weight(want, jg, jw)
    eps = AppSpec.parse(spec).eps
    assert exact_weight - 1e-5 <= weight <= (1 + eps) * exact_weight + 1e-5
    assert tapi.ConnectIt(variant, **CPU).stats is None


def test_boruvka_matches_jax(weighted):
    jg, jw, g, w = weighted
    want, jP = jamsf.boruvka_msf(jg, jw)
    got, P = tamsf.boruvka_msf(g, w)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(P.numpy(), np.asarray(jP))
    assert tamsf.forest_weight(got, g, w) == jamsf.forest_weight(want, jg, jw)
    for cap in (1, 2):  # a round cap stops where repro's does
        np.testing.assert_array_equal(
            tamsf.boruvka_msf(g, w, max_rounds=cap)[0],
            jamsf.boruvka_msf(jg, jw, max_rounds=cap)[0])


def test_amsf_device_and_coo_run_match_jax(weighted, jax_amsf):
    """The sweep's own outputs: labels, forest slots, buckets, rounds and
    the histogram; the coo run's forest, counts and dispatch sizes (against
    repro's session run)."""
    jg, jw, g, w = weighted
    # the forest step and kernel policy repro's session uses: its compiled
    # programs from the tests above are reused
    jci = japi.ConnectIt("none+uf_sync_full")
    kernels = jci._backend.kernels
    jfor = jci.spec.build_forest_finish(kernels=kernels)
    tfor = tapi.VariantSpec.parse("none+uf_sync_full").build_forest_finish()
    from repro.core.primitives import init_forest, init_labels
    from repro_torch.core import primitives as tprim
    for skip in (False, True):
        want = jamsf.amsf_device(
            init_labels(jg.n), *init_forest(jg.n), jg.senders, jg.receivers,
            jw, eps=0.25, skip=skip, forest_fn=jfor, kernels=kernels)
        got = tamsf.amsf_device(
            tprim.init_labels(g.n, **CPU), *tprim.init_forest(g.n, **CPU),
            g.senders, g.receivers, w, eps=0.25, skip=skip, forest_fn=tfor)
        for a, b in zip(got, want, strict=True):
            a = a.numpy() if isinstance(a, torch.Tensor) else a
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(skip))
    edges, jstats = jax_amsf("none+uf_sync_full", "amsf(mode=coo)")
    got = tamsf.amsf_coo_run(g, w, eps=0.25, forest_fn=tfor)
    np.testing.assert_array_equal(tamsf.forest_edges(got[1], got[2]), edges)
    assert (got[3], got[4], tuple(got[5]), tuple(got[6])) == (
        jstats.buckets, jstats.finish_rounds, jstats.edges_per_bucket,
        jstats.dispatch_sizes)


def test_amsf_with_no_finite_weight(weighted):
    """Every weight inf: no bucket, an empty forest, as in repro."""
    jg, _, g, w = weighted
    inf = torch.full_like(w, float("inf"))
    for spec in ("amsf", "amsf(mode=coo)", "msf"):
        got, stats = tapi.ConnectIt("none+uf_sync_full", **CPU).amsf(
            g, inf, spec, return_stats=True)
        want, jstats = japi.ConnectIt("none+uf_sync_full").amsf(
            jg, jnp.asarray(inf.numpy()), spec, return_stats=True)
        assert got.shape == want.shape == (0, 2), spec
        for f in AMSF_STATS:
            assert getattr(stats, f) == getattr(jstats, f), (spec, f)


def test_amsf_rejects_what_repro_rejects(weighted):
    _, _, g, w = weighted
    with pytest.raises(ValueError, match="root-based"):
        tapi.ConnectIt("none+label_prop", **CPU).amsf(g, w)
    with pytest.raises(ValueError, match="scan"):
        tapi.ConnectIt("none+uf_sync_full", **CPU).amsf(g, w, "scan")
    with pytest.raises(ValueError, match="scan spec"):
        tapi.ConnectIt("none+uf_sync_full", **CPU).scan(g, w, "amsf")
    with pytest.raises(ValueError, match="scan spec"):
        tapi.ConnectIt("none+uf_sync_full", **CPU).scan(g, w, "msf")
    with pytest.raises(KeyError, match="not present"):
        tamsf.forest_weight(np.array([[0, 0]]), g, w)


# ---------------------------------------------------------------------------
# SCAN.
# ---------------------------------------------------------------------------

def test_build_index_matches_jax(scan_graph):
    _, jsims, _, sims = scan_graph
    assert sims.dtype == np.float32
    np.testing.assert_array_equal(sims, jsims)


@pytest.mark.parametrize("eps,mu", [(0.3, 2), (0.1, 3), (0.5, 4), (1.0, 50)])
@pytest.mark.parametrize("variant", SCAN_VARIANTS)
def test_scan_matches_jax(scan_graph, variant, eps, mu):
    """labels and is_core equal repro's and the sequential GS*-Query's; the
    stats equal repro's. (1.0, 50) has no core."""
    jg, jsims, g, sims = scan_graph
    spec = f"scan(eps={eps},mu={mu})"
    jl, jc, jstats = japi.ConnectIt(variant).scan(jg, jsims, spec,
                                                  return_stats=True)
    tl, tc, stats = tapi.ConnectIt(variant, **CPU).scan(g, sims, spec,
                                                        return_stats=True)
    assert tl.dtype == torch.int32 and tc.dtype == torch.bool
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    labs, cores = tscan.gs_query_sequential(g, sims, eps, mu=mu)
    jlabs, jcores = jscan.gs_query_sequential(jg, jsims, eps, mu=mu)
    np.testing.assert_array_equal(labs, jlabs)
    np.testing.assert_array_equal(cores, jcores)
    np.testing.assert_array_equal(tl.numpy(), labs)
    np.testing.assert_array_equal(tc.numpy(), cores)
    for f in SCAN_STATS:
        assert getattr(stats, f) == getattr(jstats, f), f
    if mu == 50:
        assert not cores.any() and (labs == np.arange(g.n)).all()


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _on_card(g):
    return graph_from_arrays(g.senders, g.receivers, g.indptr, g.indices,
                             g.n, g.m, device="cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("variant", SCAN_VARIANTS)
def test_scan_on_card_matches_cpu(cuda, scan_graph, variant):
    _, _, g, sims = scan_graph
    gc = _on_card(g)
    for spec in ("scan(eps=0.3,mu=2)", "scan(eps=0.1,mu=3)"):
        want = tapi.ConnectIt(variant, **CPU).scan(g, sims, spec,
                                                   return_stats=True)
        got = tapi.ConnectIt(variant, device="cuda").scan(
            gc, torch.from_numpy(sims).cuda(), spec, return_stats=True)
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])
        for f in SCAN_STATS:
            assert getattr(got[2], f) == getattr(want[2], f), f


@pytest.mark.gpu
@pytest.mark.parametrize("spec", AMSF_SPECS)
def test_amsf_on_card_is_a_forest_within_the_bound(cuda, weighted,
                                                   exact_weight, spec):
    """The card's float32 log may put a boundary weight in another bucket,
    so the forest is held by size, validity and the weight bound."""
    _, _, g, w = weighted
    gc = _on_card(g)
    edges = tapi.ConnectIt("kout_hybrid_k2+uf_sync_full",
                           device="cuda").amsf(gc, w.cuda(), spec)
    ncomp = len(np.unique(components_oracle(g)))
    assert len(edges) == g.n - ncomp
    keys = set(zip(g.senders[: g.m].tolist(), g.receivers[: g.m].tolist()))
    assert all((int(u), int(v)) in keys for u, v in edges)
    parent = list(range(g.n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for u, v in edges:  # acyclic
        ru, rv = find(int(u)), find(int(v))
        assert ru != rv
        parent[ru] = rv
    weight = tamsf.forest_weight(edges, gc, w.cuda())
    eps = AppSpec.parse(spec).eps
    assert exact_weight - 1e-5 <= weight <= (1 + eps) * exact_weight + 1e-5
