"""The port's string-keyed legacy shims against the JAX package's.

Every shim of the seed-era surface warns with the reference's
``DeprecationWarning`` (its silent resolvers warn nothing) and gives
``repro``'s output on the same inputs:

  * ``get_finish`` / ``resolve_finish`` / ``finish_names`` and
    ``get_sampler`` / ``resolve_sampler`` / ``sampler_names``: equal key
    lists, every finish key's labels and rounds on ``variant_grid_graphs()``;
    the deterministic sampler keys bit for bit, the random ones a partial
    labeling of the graph's components (their draws are ``torch``'s);
  * the driver's ``connectivity`` (labels and every stats field: the random
    samplers replay ``repro``'s draws, as
    ``test_torch_execution.py::_replay_array`` does), ``connectivity_fused``,
    ``spanning_forest`` and ``connected_components``;
  * the streaming ``insert_batch`` / ``process_batch``; the apps'
    ``amsf_nf``, ``amsf_nf_s``, ``amsf_coo`` and ``gs_query_parallel``;
  * the legacy mesh factories at one in-process rank against ``repro``'s on
    its 1 x 1 smoke mesh: labels after the fixed rounds bit for bit, and
    ``make_streaming_ingest``'s answers.

Every comparison is exact; ``gpu``-marked: the shims on the card equal
the CPU path.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.core import distributed as jdist
from repro.core import driver as jdriver
from repro.core import finish as jfinish
from repro.core import sampling as jsampling
from repro.core import streaming as jstreaming
from repro.core.apps import amsf as jamsf
from repro.core.apps import scan as jscan
from repro.graphs import generators as jgen
from repro.launch.mesh import make_smoke_mesh as jsmoke_mesh

from repro_torch.core import distributed as tdist
from repro_torch.core import driver as tdriver
from repro_torch.core import finish as tfinish
from repro_torch.core import sampling as tsampling
from repro_torch.core import streaming as tstreaming
from repro_torch.core.apps import amsf as tamsf
from repro_torch.core.apps import scan as tscan
from repro_torch.graphs import graph_from_arrays
from repro_torch.graphs import generators as tgen
from repro_torch.launch import multihost
from repro_torch.launch.mesh import make_smoke_mesh as tsmoke_mesh

from conftest import scipy_canonical, variant_grid_graphs

GRID = variant_grid_graphs()
# the driver shims' graphs: a random one and two cliques (the samplers'
# L_max pinning and a second component)
PAIR = {k: GRID[k] for k in ("random", "two_clique")}
STATS = ("variant", "exec", "placement", "devices", "edges_total",
         "edges_finish", "edges_finish_padded", "edges_per_device",
         "dispatch_sizes", "lmax_count", "finish_rounds", "fused")
RANDOM_SAMPLERS = ("kout", "kout_pure", "kout_hybrid", "kout_maxdeg", "bfs",
                   "ldd")


@pytest.fixture(autouse=True)
def _clear_jax_caches():
    """Shadow conftest's per-test cache clearing: the reference's programs
    compile once per shape here. Cleared once per module."""
    yield


@pytest.fixture(scope="module", autouse=True)
def _module_scope():
    yield
    jax.clear_caches()
    multihost.shutdown()


def _port(jg, device="cpu"):
    return graph_from_arrays(jg.senders, jg.receivers, jg.indptr, jg.indices,
                             jg.n, jg.m, device=device)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.int32))


def _silent(fn, *a, **kw):
    """``fn`` with every warning raised as an error."""
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        return fn(*a, **kw)


def _stats(st) -> dict:
    return {k: getattr(st, k) for k in STATS}


# ---------------------------------------------------------------------------
# Finish and sampler keys.
# ---------------------------------------------------------------------------

def test_key_lists_match_repro():
    assert tfinish.finish_names() == jfinish.finish_names()
    assert tsampling.sampler_names() == jsampling.sampler_names()
    assert dict(tfinish._LEGACY_FINISH) == dict(jfinish._LEGACY_FINISH)
    assert dict(tsampling._LEGACY_SAMPLERS) == \
        dict(jsampling._LEGACY_SAMPLERS)
    with pytest.raises(KeyError, match="unknown finish method 'nope'"):
        tfinish.resolve_finish("nope")
    with pytest.raises(KeyError, match="unknown sampler 'nope'"):
        tsampling.resolve_sampler("nope")


@pytest.mark.parametrize("name", jfinish.finish_names())
def test_get_finish_matches_repro(name):
    with pytest.warns(DeprecationWarning, match="get_finish") as rec:
        fn = tfinish.get_finish(name)
    assert "repro_torch.api" in str(rec[0].message)
    with pytest.warns(DeprecationWarning, match="get_finish"):
        jfn = jfinish.get_finish(name)
    assert _silent(tfinish.resolve_finish, name) is fn
    jfn = jax.jit(jfn)  # one compile for the grid's one shape
    for jg in GRID.values():
        P0 = np.arange(jg.n + 1, dtype=np.int32)
        want, wr = jfn(jnp.asarray(P0), jg.senders, jg.receivers)
        got, r = fn(_t(P0), _t(jg.senders), _t(jg.receivers))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert int(r) == int(wr)


@pytest.mark.parametrize("name", jsampling.sampler_names())
def test_get_sampler_matches_repro(name):
    with pytest.warns(DeprecationWarning, match="get_sampler"):
        fn = tsampling.get_sampler(name)
    with pytest.warns(DeprecationWarning, match="get_sampler"):
        jfn = jsampling.get_sampler(name)
    assert fn.__name__ == jfn.__name__ == name
    _silent(tsampling.resolve_sampler, name)
    for jg in PAIR.values():
        g = _port(jg)
        got = fn(g, torch.Generator().manual_seed(0))
        want = np.asarray(jfn(jg, jax.random.PRNGKey(0)))
        if name not in RANDOM_SAMPLERS:
            np.testing.assert_array_equal(got.numpy(), want)
            continue
        # a partial labeling: every label class inside one component
        comp = scipy_canonical(jg)
        lab = got.numpy()[: jg.n]
        for c in np.unique(lab):
            assert np.unique(comp[lab == c]).size == 1
    kw = {"bfs": {"c": 2}, "ldd": {"beta": 0.5}}.get(name.split("_")[0])
    if kw:
        fn(_port(GRID["path"]), torch.Generator().manual_seed(0), **kw)
    with pytest.raises(TypeError, match="unexpected keyword"):
        fn(_port(GRID["path"]), None, nope=1)


# ---------------------------------------------------------------------------
# The driver's shims.
# ---------------------------------------------------------------------------

def _replayed(name: str, jg):
    """A sampler that hands back ``repro``'s draw for ``name`` on ``jg``."""
    want = np.asarray(jsampling.resolve_sampler(name)(jg,
                                                      jax.random.PRNGKey(0)))

    def sampler(g, generator=None, *, want_forest=False):
        return _t(want)
    return sampler


@pytest.mark.parametrize("sample", [None, "kout_afforest", "kout", "bfs",
                                    "ldd"])
@pytest.mark.parametrize("finish", ["uf_sync", "liu_tarjan_CRFA",
                                    "stergiou"])
def test_connectivity_matches_repro(monkeypatch, sample, finish):
    for key, jg in PAIR.items():
        with pytest.warns(DeprecationWarning, match="connectivity"):
            want, wst = jdriver.connectivity(jg, sample=sample,
                                             finish=finish,
                                             return_stats=True)
        if sample in RANDOM_SAMPLERS:
            monkeypatch.setattr(tdriver, "resolve_sampler",
                                lambda name, jg=jg: _replayed(name, jg))
        with pytest.warns(DeprecationWarning, match="repro_torch.api"):
            got, st = tdriver.connectivity(_port(jg), sample=sample,
                                           finish=finish, return_stats=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=key)
        assert _stats(st) == _stats(wst), key


@pytest.mark.parametrize("relabel", [False, True])
@pytest.mark.parametrize("finish", ["uf_sync_full", "liu_tarjan_PUFA"])
def test_connectivity_fused_matches_repro(relabel, finish):
    for jg in PAIR.values():
        P0 = np.asarray(jsampling.resolve_sampler("kout_afforest")(
            jg, jax.random.PRNGKey(0))) if relabel else \
            np.arange(jg.n + 1, dtype=np.int32)
        with pytest.warns(DeprecationWarning):
            want, wr = jdriver.connectivity_fused(
                jnp.asarray(P0), jg.senders, jg.receivers, finish, relabel)
        with pytest.warns(DeprecationWarning, match="connectivity_fused"):
            got, r = tdriver.connectivity_fused(
                _t(P0), _t(jg.senders), _t(jg.receivers), finish, relabel)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert int(r) == int(wr)


@pytest.mark.parametrize("sample", [None, "kout_afforest"])
def test_spanning_forest_matches_repro(sample):
    for jg in PAIR.values():
        with pytest.warns(DeprecationWarning):
            want = jdriver.spanning_forest(jg, sample=sample)
        with pytest.warns(DeprecationWarning, match="spanning_forest"):
            got = tdriver.spanning_forest(_port(jg), sample=sample)
        np.testing.assert_array_equal(got, want)


def test_connected_components_is_silent_numpy():
    for jg in GRID.values():
        got = _silent(tdriver.connected_components, _port(jg),
                      finish="uf_sync_full")
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(
            got, jdriver.connected_components(jg, finish="uf_sync_full"))
        np.testing.assert_array_equal(got, scipy_canonical(jg))


# ---------------------------------------------------------------------------
# Streams and apps.
# ---------------------------------------------------------------------------

def _batches(n: int, k: int = 4, size: int = 16):
    rng = np.random.default_rng(3)
    for _ in range(k):
        u = rng.integers(0, n + 1, size).astype(np.int32)  # n: padding
        v = rng.integers(0, n, size).astype(np.int32)
        qa = rng.integers(0, n, size).astype(np.int32)
        qb = rng.integers(0, n, size).astype(np.int32)
        yield u, v, qa, qb


@pytest.mark.parametrize("finish", ["uf_sync_full", "liu_tarjan_CRFA",
                                    "label_prop"])
def test_insert_and_process_batch_match_repro(finish):
    n = 40
    js, ts = jstreaming.init_stream(n), tstreaming.init_stream(n, device="cpu")
    for i, (u, v, qa, qb) in enumerate(_batches(n)):
        if i % 2:
            with pytest.warns(DeprecationWarning):
                js = jstreaming.insert_batch(js, u, v, finish)
            with pytest.warns(DeprecationWarning, match="insert_batch"):
                ts = tstreaming.insert_batch(ts, _t(u), _t(v), finish)
        else:
            with pytest.warns(DeprecationWarning):
                js, want = jstreaming.process_batch(js, u, v, qa, qb, finish)
            with pytest.warns(DeprecationWarning, match="process_batch"):
                ts, got = tstreaming.process_batch(ts, _t(u), _t(v), _t(qa),
                                                   _t(qb), finish)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(ts.P.numpy(), np.asarray(js.P))


@pytest.fixture(scope="module")
def weighted():
    jg = jgen.rmat(64, 256, seed=5)
    g = _port(jg)
    return jg, jgen.with_weights(jg, seed=1), g, tgen.with_weights(g, seed=1)


@pytest.mark.parametrize("shim", ["amsf_nf", "amsf_nf_s", "amsf_coo"])
def test_amsf_shims_match_repro(weighted, shim):
    jg, jw, g, w = weighted
    with pytest.warns(DeprecationWarning):
        want_e, want_P = getattr(jamsf, shim)(jg, jw, eps=0.25)
    with pytest.warns(DeprecationWarning, match=shim):
        got_e, got_P = getattr(tamsf, shim)(g, w, eps=0.25)
    np.testing.assert_array_equal(got_e, np.asarray(want_e))
    np.testing.assert_array_equal(got_P.numpy(), np.asarray(want_P))


@pytest.mark.parametrize("eps,mu", [(0.3, 2), (0.6, 3)])
def test_gs_query_parallel_matches_repro(weighted, eps, mu):
    jg, _, g, _ = weighted
    sims = jscan.build_index(jg)
    with pytest.warns(DeprecationWarning):
        want_l, want_c = jscan.gs_query_parallel(jg, sims, eps, mu=mu)
    with pytest.warns(DeprecationWarning, match="gs_query_parallel"):
        got_l, got_c = tscan.gs_query_parallel(g, sims, eps, mu=mu)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


# ---------------------------------------------------------------------------
# The legacy mesh factories at one rank.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def meshes():
    multihost.initialize()
    return jsmoke_mesh(), tsmoke_mesh("cpu")


def _mesh_inputs():
    rng = np.random.default_rng(11)
    n, m = 300, 512
    u = rng.integers(0, n, m // 2).astype(np.int32)
    v = rng.integers(0, n, m // 2).astype(np.int32)
    u[-10:] = v[-10:] = n
    return (np.arange(n + 1, dtype=np.int32), np.concatenate([u, v]),
            np.concatenate([v, u]))


MESH_FACTORIES = {
    "make_replicated_step": (("data", "model"), {"jumps": 3}),
    "make_replicated_connectivity": (("data", "model"), {"rounds": 3}),
    "make_sharded_step": (("data",), "model", {}),
    "make_sharded_connectivity": (("data",), "model", {"rounds": 3}),
    "make_sharded_connectivity[rs]": (("data",), "model",
                                      {"rounds": 2,
                                       "use_reduce_scatter": True}),
    "make_sharded_step_fused": (("data",), "model", {"jumps": 3}),
    "make_sharded_connectivity_fused": (("data",), "model",
                                        {"rounds": 3, "jumps": 1}),
}


@pytest.mark.parametrize("factory", list(MESH_FACTORIES))
def test_legacy_mesh_factories_match_repro(meshes, factory):
    jm, tm = meshes
    *args, kw = MESH_FACTORIES[factory]
    name = factory.split("[")[0]
    with pytest.warns(DeprecationWarning):
        jfn = getattr(jdist, name)(jm, *args, **kw)
    with pytest.warns(DeprecationWarning, match=name):
        tfn = getattr(tdist, name)(tm, *args, **kw)
    lab, s, r = _mesh_inputs()
    want = np.asarray(jax.jit(jfn)(*map(jnp.asarray, (lab, s, r))))
    got = tfn(_t(lab), _t(s), _t(r))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != lab).any()


def test_make_streaming_ingest_matches_repro(meshes):
    jm, tm = meshes
    with pytest.warns(DeprecationWarning):
        jfn = jdist.make_streaming_ingest(jm, ("data", "model"), rounds=2)
    with pytest.warns(DeprecationWarning, match="make_streaming_ingest"):
        tfn = tdist.make_streaming_ingest(tm, ("data", "model"), rounds=2)
    lab, s, r = _mesh_inputs()
    rng = np.random.default_rng(12)
    qa, qb = (rng.integers(0, 301, 64).astype(np.int32) for _ in range(2))
    qa[:32], qb[:32] = s[:32], r[:32]  # edge ends: connected pairs
    jl, ja = jfn(*map(jnp.asarray, (lab, s, r, qa, qb)))
    tl, ta = tfn(*map(_t, (lab, s, r, qa, qb)))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert ta.any() and not ta.all()


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_shims_on_card_match_cpu(cuda, meshes):
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    for jg in GRID.values():
        for finish in ("uf_sync", "liu_tarjan_CRFA"):
            want = _silent(tdriver.connected_components, _port(jg),
                           sample="kout_afforest", finish=finish)
            got = _silent(tdriver.connected_components, _port(jg, "cuda"),
                          sample="kout_afforest", finish=finish)
            np.testing.assert_array_equal(got, want)
    lab, s, r = _mesh_inputs()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        cpu = tdist.make_replicated_connectivity(meshes[1], ("data", "model"),
                                                 rounds=3)
        card = tdist.make_replicated_connectivity(
            tsmoke_mesh("cuda"), ("data", "model"), rounds=3)
    want = cpu(_t(lab), _t(s), _t(r))
    got = card(*(_t(x).cuda() for x in (lab, s, r)))
    assert torch.equal(got.cpu(), want)
    # uf_sync hooks; CRFA's puts scatter and its alter rewrites; the mesh
    # factory scatters and jumps
    counts = ops.launch_counts()
    assert all(counts[k] > 0 for k in ("hook_compress", "pointer_jump",
                                       "scatter_min", "edge_rewrite"))


def test_stats_fields_cover_the_reference():
    names = {f.name for f in dataclasses.fields(tdriver.ConnectivityStats)}
    assert set(STATS) <= names
