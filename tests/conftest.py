import os
import sys

# NOTE: do NOT set --xla_force_host_platform_device_count here — smoke tests
# and benches must see 1 device (dry-run sets it in its own process).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; the test skips itself without one")


@pytest.fixture(autouse=True)
def _clear_jax_caches():
    """Keep the jit-compilation cache from exhausting memory across the
    shape-heavy parametrized sweeps."""
    yield
    jax.clear_caches()


def scipy_canonical(g) -> np.ndarray:
    """scipy connected_components relabeled to min-vertex-id canonical form
    (the labeling convention every execution path must reproduce exactly)."""
    if g.m == 0:
        return np.arange(g.n, dtype=np.int64)
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components as scipy_cc
    s = np.asarray(g.senders)[: g.m]
    r = np.asarray(g.receivers)[: g.m]
    mat = csr_matrix((np.ones(len(s), dtype=np.int8), (s, r)),
                     shape=(g.n, g.n))
    _, lab = scipy_cc(mat, directed=False)
    reps = np.full(lab.max() + 1, g.n, dtype=np.int64)
    np.minimum.at(reps, lab, np.arange(g.n))
    return reps[lab]


def variant_grid_graphs(n: int = 20, pad: int = 256) -> dict:
    """The variant-API sweep's graph grid: one (n, m_pad) shape shared by
    all graphs so jit caches are reused across the sweep. Used by
    test_variant_api.py and the cross-placement tests in test_execution.py."""
    from repro.graphs import build_graph
    rng = np.random.default_rng(0)
    half = n // 2
    clique = [(i, j) for i in range(half) for j in range(i + 1, half)]
    clique += [(half + i, half + j) for i in range(half)
               for j in range(i + 1, half)]
    return {
        "random": build_graph(rng.integers(0, n, size=(30, 2)), n,
                              pad_multiple=pad),
        "path": build_graph(
            np.stack([np.arange(n - 1), np.arange(1, n)], 1), n,
            pad_multiple=pad),
        "star": build_graph(
            np.stack([np.zeros(n - 1, np.int64), np.arange(1, n)], 1), n,
            pad_multiple=pad),
        "two_clique": build_graph(np.array(clique, dtype=np.int64), n,
                                  pad_multiple=pad),
    }


def partition_equiv(a, b) -> bool:
    """True iff two labelings induce the same partition."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return False
    ra, rb = {}, {}
    for x, y in zip(a.tolist(), b.tolist()):
        if x in ra and ra[x] != y:
            return False
        if y in rb and rb[y] != x:
            return False
        ra[x] = y
        rb[y] = x
    return True
