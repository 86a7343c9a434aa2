"""The port's AMSF and MSF on the replicated and sharded placements, at one
in-process rank, against the JAX package at one device.

  * ``amsf`` and ``amsf(skip=lmax)`` under ``replicated(x)``,
    ``sharded(x)`` and ``sharded(x):fused`` with the deterministic variants
    ``none+uf_sync_full`` and ``kout_afforest_k2+uf_sync_full``: the forest
    edge for edge and every stats field (buckets, edges per bucket, finish
    rounds, edges per device, dispatch sizes) equal ``repro``'s; the
    forest is spanning and within (1 + eps) of Borůvka's weight.
  * ``amsf(mode=coo)`` and ``msf`` run single-device under a placement, as
    in ``repro``: the same forest as the single placement.
  * ``gpu``-marked: the mesh sweep on the card (one rank over NCCL) gives
    the single path's forest, buckets and rounds on the card.

Every comparison is exact.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.graphs import generators as jgen
from repro_torch import api as tapi
from repro_torch.core.apps import amsf as tamsf
from repro_torch.graphs import components_oracle, graph_from_arrays
from repro_torch.graphs import generators as tgen
from repro_torch.launch import multihost

EXECS = ["replicated(x)", "sharded(x)", "sharded(x):fused"]
VARIANTS = ["none+uf_sync_full", "kout_afforest_k2+uf_sync_full"]
SPECS = ["amsf", "amsf(skip=lmax)"]
STATS = ("variant", "exec", "placement", "devices", "app", "edges_total",
         "edges_finish", "edges_finish_padded", "edges_per_device",
         "dispatch_sizes", "buckets", "edges_per_bucket", "finish_rounds")


@pytest.fixture(autouse=True)
def _clear_jax_caches():
    """Shadow conftest's per-test cache clearing: the JAX mesh sweep
    compiles once per (exec, spec). Cleared once per module."""
    yield


@pytest.fixture(scope="module", autouse=True)
def _module_scope():
    yield
    jax.clear_caches()
    multihost.shutdown()


@functools.lru_cache(maxsize=None)
def _graphs():
    jg = jgen.rmat(160, 700, seed=4)
    g = graph_from_arrays(jg.senders, jg.receivers, jg.indptr, jg.indices,
                          jg.n, jg.m, device="cpu")
    return jg, jgen.with_weights(jg, seed=2), g, tgen.with_weights(g, seed=2)


@functools.lru_cache(maxsize=None)
def _exact_weight() -> float:
    _, _, g, w = _graphs()
    edges, _ = tamsf.boruvka_msf(g, w)
    return tamsf.forest_weight(edges, g, w)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("exec_str", EXECS)
def test_mesh_amsf_matches_repro(exec_str, variant, spec):
    jg, jw, g, w = _graphs()
    want, jst = japi.ConnectIt(variant, exec=exec_str).amsf(
        jg, jw, spec, return_stats=True)
    got, st = tapi.ConnectIt(variant, exec=exec_str, device="cpu").amsf(
        g, w, spec, return_stats=True)
    np.testing.assert_array_equal(got, want)
    for f in STATS:
        assert getattr(st, f) == getattr(jst, f), f
    assert st.placement == exec_str.split("(")[0] and st.buckets > 0
    assert len(got) == g.n - len(np.unique(components_oracle(g)))
    weight = tamsf.forest_weight(got, g, w)
    assert _exact_weight() - 1e-5 <= weight <= 1.25 * _exact_weight() + 1e-5


@pytest.mark.parametrize("spec", ["amsf(mode=coo)", "msf"])
@pytest.mark.parametrize("exec_str", ["replicated(x)", "sharded(x)"])
def test_coo_and_msf_run_single_device_under_a_placement(exec_str, spec):
    """The host's bucket compaction and Borůvka are single-device programs
    under every placement: the single placement's forest and counters;
    ``msf`` reports the single placement, ``amsf(mode=coo)`` the
    session's, as ``repro`` does."""
    _, _, g, w = _graphs()
    v = "kout_afforest_k2+uf_sync_full"
    want, wst = tapi.ConnectIt(v, device="cpu").amsf(g, w, spec,
                                                    return_stats=True)
    got, st = tapi.ConnectIt(v, exec=exec_str, device="cpu").amsf(
        g, w, spec, return_stats=True)
    np.testing.assert_array_equal(got, want)
    same = ("exec", "placement", "devices")
    assert dataclasses.replace(st, **{f: getattr(wst, f) for f in same}) \
        == wst
    assert st.exec == ("single" if spec == "msf" else exec_str)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("exec_str", EXECS)
def test_mesh_amsf_on_card_matches_the_single_path(cuda, exec_str):
    """The merged forest rounds on the card: scatter_min's three passes
    (the stacked endpoint buffer of 2·(n + 1) + 1 slots among them) and
    pointer_jump give the single path's forest, buckets and rounds on the
    card (the global edge ids are the single path's edge positions). The
    card's bucket ids may differ from the CPU's at bucket boundaries
    (ROADMAP Queue 3), so the card is held against the card."""
    jg, _, g, w = _graphs()
    gc = graph_from_arrays(jg.senders, jg.receivers, jg.indptr, jg.indices,
                           jg.n, jg.m, device="cuda")
    for variant in VARIANTS:
        for spec in SPECS:
            want, wst = tapi.ConnectIt(variant, device="cuda").amsf(
                gc, w.cuda(), spec, return_stats=True)
            got, st = tapi.ConnectIt(variant, exec=exec_str,
                                     device="cuda").amsf(
                gc, w.cuda(), spec, return_stats=True)
            np.testing.assert_array_equal(got, want)
            for f in ("buckets", "edges_per_bucket", "finish_rounds",
                      "edges_finish"):
                assert getattr(st, f) == getattr(wst, f), f
