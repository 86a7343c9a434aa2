"""The port's graph container and generators against the JAX package.

The same numpy edges, or the same generator seed, go through
``repro.graphs`` and ``repro_torch.graphs``; the COO and CSR arrays, ``n``
and ``m`` must be equal. Every comparison is exact integer equality.
"""

import numpy as np
import pytest
import torch

from repro.graphs import build_graph as j_build_graph
from repro.graphs import components_oracle as j_oracle
from repro.graphs import generators as jgen
from repro.graphs.containers import to_numpy_edges as j_to_numpy_edges
from repro_torch.graphs import (
    build_graph,
    components_oracle,
    graph_from_arrays,
    sort_dedup_edges,
    to_numpy_edges,
)
from repro_torch.graphs import generators as tgen

RNG = np.random.default_rng(5)
ARRAYS = ("senders", "receivers", "indptr", "indices")


def assert_same_graph(tg, jg):
    assert (tg.n, tg.m, tg.m_pad) == (jg.n, jg.m, jg.m_pad)
    for name in ARRAYS:
        got = getattr(tg, name)
        assert got.dtype == torch.int32, name
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      np.asarray(getattr(jg, name)),
                                      err_msg=name)


def _messy_edges(n: int, k: int) -> np.ndarray:
    """Random edges with self loops and duplicates in both directions."""
    e = RNG.integers(0, n, size=(k, 2))
    return np.concatenate([e, e[: k // 4, ::-1], np.stack([e[:5, 0]] * 2, 1)])


@pytest.mark.parametrize("case", [
    dict(n=50, k=120),
    dict(n=50, k=120, symmetrize=False),
    dict(n=50, k=120, dedup=False),
    dict(n=50, k=120, symmetrize=False, dedup=False),
    dict(n=300, k=40, pad_multiple=256),
    dict(n=7, k=30, pad_multiple=1),
    dict(n=10, k=0),
])
def test_build_graph_matches_jax(case):
    case = dict(case)
    n, k = case.pop("n"), case.pop("k")
    edges = _messy_edges(n, k) if k else np.zeros((0, 2), np.int64)
    assert_same_graph(build_graph(edges, n, device="cpu", **case),
                      j_build_graph(edges, n, **case))


def test_build_graph_takes_int32_and_wide_ids():
    n = 1 << 20
    edges = RNG.integers(0, n, size=(200, 2))
    for e in (edges.astype(np.int32), edges.astype(np.int64)):
        assert_same_graph(build_graph(e, n, device="cpu"), j_build_graph(e, n))


def test_sort_dedup_edges_matches_jax():
    from repro.graphs import sort_dedup_edges as j_sort_dedup
    edges = _messy_edges(40, 90)
    got = sort_dedup_edges(edges, 40, device="cpu")
    np.testing.assert_array_equal(got.numpy(), j_sort_dedup(edges, 40))


def test_int32_overflow_guards():
    with pytest.raises(ValueError, match="int32 vertex ids"):
        sort_dedup_edges(np.zeros((1, 2), np.int64), 2**31 - 1, device="cpu")
    with pytest.raises(ValueError, match="overflow int32"):
        sort_dedup_edges(np.array([[0, 2**31]], np.int64), 8, device="cpu")


@pytest.mark.parametrize("make", [
    lambda g: g.rmat(256, 2048, seed=3),
    lambda g: g.random_graph(100, 300, seed=1),
    lambda g: g.path(17),
    lambda g: g.star(9),
    lambda g: g.grid2d(4, 5),
    lambda g: g.planted_components(60, 3, 4.0, seed=2),
], ids=["rmat", "random", "path", "star", "grid2d", "planted"])
def test_generators_match_jax(make):
    import functools

    class OnCpu:  # the port's generators, on the CPU
        def __getattr__(self, name):
            return functools.partial(getattr(tgen, name), device="cpu")

    assert_same_graph(make(OnCpu()), make(jgen))


def test_graph_from_arrays_round_trips():
    jg = jgen.rmat(128, 600, seed=4)
    tg = graph_from_arrays(*(np.asarray(getattr(jg, a)) for a in ARRAYS),
                           jg.n, jg.m, device="cpu")
    assert_same_graph(tg, jg)
    np.testing.assert_array_equal(to_numpy_edges(tg), j_to_numpy_edges(jg))
    np.testing.assert_array_equal(tg.edge_mask.numpy(), np.asarray(jg.edge_mask))
    np.testing.assert_array_equal(tg.degrees().numpy(), np.asarray(jg.degrees()))
    # the arrays are copies: the source arrays may be reused freely
    src = np.asarray(jg.senders).copy()
    tg2 = graph_from_arrays(src, jg.receivers, jg.indptr, jg.indices, jg.n,
                            jg.m, device="cpu")
    src[:] = 0
    assert torch.equal(tg2.senders, tg.senders)


@pytest.mark.parametrize("make", [
    lambda g, d: g.planted_components(90, 4, 3.0, seed=6, **d),
    lambda g, d: g.rmat(200, 300, seed=8, **d),
    lambda g, d: g.random_graph(30, 0, seed=0, **d),
], ids=["planted", "rmat", "edgeless"])
def test_components_oracle_matches_jax(make):
    tg = make(tgen, dict(device="cpu"))
    jg = make(jgen, {})
    np.testing.assert_array_equal(components_oracle(tg), j_oracle(jg))


def test_default_device_is_the_card():
    """Entry points default to CUDA; without a card they raise and do not
    fall back to the CPU."""
    edges = np.array([[0, 1], [1, 2]])
    if torch.cuda.is_available():
        assert build_graph(edges, 3).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            build_graph(edges, 3)
        with pytest.raises(RuntimeError, match="cuda"):
            tgen.path(5)
