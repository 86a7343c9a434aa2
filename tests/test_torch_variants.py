"""The port's whole static variant grid, end to end on the CPU.

Cross-package: the 22 finishes × {none, kout_afforest_k2, bfs_c3, ldd_b0.2}
(85 variants, Stergiou only after ``none``), compacted and fused, on
``variant_grid_graphs()`` plus a small RMAT graph, through
``repro.api.ConnectIt`` and ``repro_torch.api.ConnectIt``. Labels must be
bit-identical; ``ConnectivityStats`` must be equal on the deterministic
variants (``none+…``, ``kout_afforest_k2+…``). BFS sources and LDD shifts
come from a ``torch.Generator``, not ``jax.random``, so their stats may
differ; their labels may not.

Port only: every one of the 148 variants of ``enumerate_variants()``,
compacted and fused, against ``conftest.scipy_canonical``.

Every comparison is exact integer equality.
"""

import jax
import numpy as np
import pytest
import torch

from conftest import scipy_canonical, variant_grid_graphs
from repro import api as japi
from repro.graphs import generators as jgen
from repro_torch import api as tapi
from repro_torch.graphs import graph_from_arrays

STATS_FIELDS = ("variant", "exec", "placement", "devices", "edges_total",
                "edges_finish", "edges_finish_padded", "edges_per_device",
                "dispatch_sizes", "lmax_count", "finish_rounds", "fused")
DETERMINISTIC_SAMPLINGS = ("none", "kout_afforest_k2")
CROSS = [str(v) for v in japi.enumerate_variants(
    samplings=[japi.SamplingSpec.parse(s) for s in
               (*DETERMINISTIC_SAMPLINGS, "bfs_c3", "ldd_b0.2")])]
GRID = [str(v) for v in tapi.enumerate_variants()]


@pytest.fixture(autouse=True)
def _clear_jax_caches():
    """Shadow conftest's per-test cache clearing: the JAX side compiles one
    program per variant at these few shapes. Cleared once per module."""
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
PORTED = {name: graph_from_arrays(jg.senders, jg.receivers, jg.indptr,
                                  jg.indices, jg.n, jg.m, device="cpu")
          for name, jg in GRAPHS.items()}
EXPECT = {name: scipy_canonical(jg) for name, jg in GRAPHS.items()}
_JAX_LABELS: dict = {}  # (variant, graph) -> repro's labels


def _jax_labels(variant: str, name: str) -> np.ndarray:
    """repro's labels of a random-stream variant, run once (fused) and shared
    by both of the port's paths: canonical labels do not depend on the path."""
    key = (variant, name)
    if key not in _JAX_LABELS:
        _JAX_LABELS[key] = np.asarray(
            japi.ConnectIt(variant).connectivity(GRAPHS[name], fused=True))
    return _JAX_LABELS[key]


@pytest.mark.parametrize("fused", [False, True], ids=["compacted", "fused"])
@pytest.mark.parametrize("variant", CROSS)
def test_variant_matches_jax(variant, fused):
    deterministic = variant.split("+")[0] in DETERMINISTIC_SAMPLINGS
    jci = japi.ConnectIt(variant)
    tci = tapi.ConnectIt(variant, device="cpu")
    for name, jg in GRAPHS.items():
        got, tstats = tci.connectivity(PORTED[name], fused=fused,
                                       return_stats=True)
        assert got.dtype == torch.int32
        if deterministic:
            want, jstats = jci.connectivity(jg, fused=fused,
                                            return_stats=True)
            fields = STATS_FIELDS
        else:
            want, jstats = _jax_labels(variant, name), None
            fields = ()
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"{variant} on {name}")
        for f in fields:
            assert getattr(tstats, f) == getattr(jstats, f), (f, name)
        assert tstats.variant == variant and tstats.fused == fused


@pytest.mark.parametrize("variant", GRID)
def test_every_enumerated_variant_matches_scipy(variant):
    ci = tapi.ConnectIt(variant, device="cpu")
    for name, g in PORTED.items():
        for fused in (False, True):
            got = ci.connectivity(g, fused=fused)
            np.testing.assert_array_equal(
                got.numpy(), EXPECT[name],
                err_msg=f"{variant} fused={fused} on {name}")
