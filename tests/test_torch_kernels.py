"""The port's kernels against the JAX package.

Each plain PyTorch version (``repro_torch.kernels.*.ref``) is held against
the JAX Pallas kernel run with ``interpret=True`` and against the JAX
``*_ref``; the dispatch layer (``repro_torch.kernels.ops``) against
``repro.kernels.ops`` under the ``ref`` policy. Inputs are made with numpy
from a seed and handed to both packages. Every comparison is exact integer
equality: all values are int32 (or int16) labels and indices, except
embedding_bag's float rows, held at the reference test's tolerances (rtol
and atol 1e-6 in float32, 3e-2 in bfloat16: sums in another order, and
bfloat16 rounded at other places).

Tests marked ``gpu`` hold the CUDA kernels against the plain versions on
the card, exactly; they skip without one.
"""

import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.edge_relabel.kernel import edge_relabel as j_edge_relabel
from repro.kernels.edge_relabel.kernel import edge_rewrite as j_edge_rewrite
from repro.kernels.edge_relabel.ref import edge_relabel_ref as j_relabel_ref
from repro.kernels.edge_relabel.ref import edge_rewrite_ref as j_rewrite_ref
from repro.kernels.hook_compress.kernel import hook_compress as j_hook_compress
from repro.kernels.hook_compress.ref import hook_compress_ref as j_hook_ref
from repro.kernels.legacy.embedding_bag.kernel import (
    embedding_bag as j_embedding_bag,
)
from repro.kernels.legacy.embedding_bag.ref import (
    embedding_bag_ref as j_bag_ref,
)
from repro.kernels.pointer_jump.kernel import pointer_jump as j_pointer_jump
from repro.kernels.pointer_jump.ref import pointer_jump_ref as j_jump_ref
from repro.kernels.scatter_min.kernel import scatter_min as j_scatter_min
from repro.kernels.scatter_min.ref import scatter_min_ref as j_scatter_ref
from repro_torch.kernels import _build, ops
from repro_torch.kernels.edge_relabel.ref import (
    edge_relabel_ref,
    edge_rewrite_ref,
)
from repro_torch.kernels.hook_compress.ref import hook_compress_ref
from repro_torch.kernels.index import take
from repro_torch.kernels.legacy import embedding_bag
from repro_torch.kernels.legacy.embedding_bag.ref import embedding_bag_ref
from repro_torch.kernels.pointer_jump.ref import pointer_jump_ref
from repro_torch.kernels.scatter_min.ref import scatter_min_ref

RNG = np.random.default_rng(11)
REPO = Path(__file__).resolve().parents[1]


def _labels_with_virtual_min(n_pad: int, dtype=np.int32, rng=RNG) -> np.ndarray:
    """A labeling with chains, roots, and sprinkled -1 virtual minimums."""
    lab = np.minimum(rng.integers(0, n_pad, n_pad), np.arange(n_pad))
    lab[rng.random(n_pad) < 0.1] = -1
    return lab.astype(dtype)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _assert_same(got: torch.Tensor, *want) -> None:
    for w in want:
        w = np.asarray(w)
        assert got.numpy().dtype == w.dtype
        np.testing.assert_array_equal(got.numpy(), w)


# ---------------------------------------------------------------------------
# Plain versions vs the Pallas kernels (interpret) and the jnp refs, over the
# shapes of tests/test_kernels.py.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_pad,m_pad,block_m", [
    (128, 256, 64), (1024, 4096, 1024), (512, 512, 512), (64, 64, 64),
])
@pytest.mark.parametrize("dtype", [np.int32, np.int16])
def test_scatter_min_plain_matches_jax(n_pad, m_pad, block_m, dtype):
    P = RNG.permutation(n_pad).astype(dtype)
    idx = RNG.integers(0, n_pad, m_pad).astype(np.int32)
    vals = RNG.integers(-1, n_pad, m_pad).astype(dtype)
    pallas = j_scatter_min(jnp.asarray(P), jnp.asarray(idx),
                           jnp.asarray(vals), block_m=block_m, interpret=True)
    ref = j_scatter_ref(jnp.asarray(P), jnp.asarray(idx), jnp.asarray(vals))
    _assert_same(scatter_min_ref(_t(P), _t(idx), _t(vals)), pallas, ref)


@pytest.mark.parametrize("n_pad,block,k", [
    (128, 64, 1), (1024, 256, 2), (512, 512, 3), (2048, 128, 4),
])
def test_pointer_jump_plain_matches_jax(n_pad, block, k):
    P = _labels_with_virtual_min(n_pad)
    pallas = j_pointer_jump(jnp.asarray(P), k=k, block=block, interpret=True)
    ref = j_jump_ref(jnp.asarray(P), k=k)
    _assert_same(pointer_jump_ref(_t(P), k=k), pallas, ref)


@pytest.mark.parametrize("n_pad,m_pad,block_m", [
    (128, 256, 64), (1024, 4096, 1024), (256, 512, 512), (64, 64, 64),
])
@pytest.mark.parametrize("k", [0, 1, 3])
def test_hook_compress_plain_matches_jax(n_pad, m_pad, block_m, k):
    P = _labels_with_virtual_min(n_pad)
    s = RNG.integers(0, n_pad, m_pad).astype(np.int32)
    r = RNG.integers(0, n_pad, m_pad).astype(np.int32)
    pallas = j_hook_compress(jnp.asarray(P), jnp.asarray(s), jnp.asarray(r),
                             k=k, block_m=block_m, interpret=True)
    ref = j_hook_ref(jnp.asarray(P), jnp.asarray(s), jnp.asarray(r), k=k)
    _assert_same(hook_compress_ref(_t(P), _t(s), _t(r), k=k), pallas, ref)


@pytest.mark.parametrize("chunk", [1, 7, 64, 4096])
@pytest.mark.parametrize("m_pad", [0, 100, 1000])
@pytest.mark.parametrize("k", [0, 2])
def test_hook_compress_plain_in_edge_slices_matches_jax(monkeypatch, chunk,
                                                        m_pad, k):
    """The plain hook proposes EDGE_CHUNK edges a pass: any slice size gives
    the JAX package's one-pass round, and the result never aliases the
    input labels (k = 0, no edges)."""
    from repro_torch.kernels.hook_compress import ref as hook_ref
    monkeypatch.setattr(hook_ref, "EDGE_CHUNK", chunk)
    P = _labels_with_virtual_min(256)
    s = RNG.integers(-300, 300, m_pad).astype(np.int32)
    r = RNG.integers(0, 256, m_pad).astype(np.int32)
    want = j_hook_ref(jnp.asarray(P), jnp.asarray(s), jnp.asarray(r), k=k)
    labels = _t(P)
    got = hook_compress_ref(labels, _t(s), _t(r), k=k)
    _assert_same(got, want)
    assert got.data_ptr() != labels.data_ptr()


def _endpoints(n_pad: int, m_pad: int, negative: bool) -> np.ndarray:
    """Edge endpoints in [0, n_pad), or in {-1} ∪ [0, n_pad) with ~10% -1
    as Liu–Tarjan altered edges carry."""
    e = RNG.integers(0, n_pad, m_pad)
    if negative:
        e[RNG.random(m_pad) < 0.1] = -1
    return e.astype(np.int32)


@pytest.mark.parametrize("n_pad,m_pad,block_m", [
    (128, 256, 64), (1024, 4096, 1024), (512, 512, 512), (256, 1024, 128),
    (64, 64, 64),
])
@pytest.mark.parametrize("negative", [False, True], ids=["real", "neg"])
def test_edge_relabel_plain_matches_jax(n_pad, m_pad, block_m, negative):
    """Exact int32 equality with the Pallas kernel (interpret) and jnp ref,
    on permutation labels (real endpoints) or -1-sprinkled labels and
    endpoints."""
    P = (_labels_with_virtual_min(n_pad) if negative
         else RNG.permutation(n_pad).astype(np.int32))
    s = _endpoints(n_pad, m_pad, negative)
    r = _endpoints(n_pad, m_pad, negative)
    pallas = j_edge_relabel(jnp.asarray(P), jnp.asarray(s), jnp.asarray(r),
                            block_m=block_m, interpret=True)
    ref = j_relabel_ref(jnp.asarray(P), jnp.asarray(s), jnp.asarray(r))
    _assert_same(edge_relabel_ref(_t(P), _t(s), _t(r)), pallas, ref)


@pytest.mark.parametrize("n_pad,m_pad,block_m", [
    (128, 256, 64), (512, 2048, 512), (64, 64, 64),
])
def test_edge_rewrite_plain_matches_jax(n_pad, m_pad, block_m):
    """Exact int32 equality of both outputs, with -1 labels and endpoints."""
    P = _labels_with_virtual_min(n_pad)
    s = _endpoints(n_pad, m_pad, True)
    r = _endpoints(n_pad, m_pad, True)
    ps, pr = j_edge_rewrite(jnp.asarray(P), jnp.asarray(s), jnp.asarray(r),
                            block_m=block_m, interpret=True)
    es, er = j_rewrite_ref(jnp.asarray(P), jnp.asarray(s), jnp.asarray(r))
    got_s, got_r = edge_rewrite_ref(_t(P), _t(s), _t(r))
    _assert_same(got_s, ps, es)
    _assert_same(got_r, pr, er)


def test_edge_relabel_negative_endpoints_propose_but_never_receive():
    """-1 endpoints propose the virtual minimum; they are never targets
    (exact equality with the JAX ref)."""
    P = np.arange(8, dtype=np.int32)
    s = np.array([-1, 3], np.int32)
    r = np.array([5, -1], np.int32)
    out = edge_relabel_ref(_t(P), _t(s), _t(r))
    assert out[5] == -1 and out[3] == -1   # proposals from -1 endpoints
    assert (out >= -1).all()               # nothing scattered off-array
    _assert_same(out, j_relabel_ref(jnp.asarray(P), jnp.asarray(s),
                                    jnp.asarray(r)))


def _ends_out_of_range(L: int, m: int, rng) -> np.ndarray:
    """Endpoints over every int32 region: -1, other negatives (below -L
    too), real slots, L and past it, and the int32 extremes."""
    i32 = np.iinfo(np.int32)
    pool = np.array([-1, -2, -L, -L - 3, L, L + 5, i32.min, i32.max])
    e = rng.integers(0, L, m)
    pick = rng.random(m) < 0.5
    e[pick] = rng.choice(pool, int(pick.sum()))
    return e.astype(np.int32)


@pytest.mark.parametrize("L", [1, 9, 257])
def test_edge_plain_versions_on_ends_out_of_range_match_jax(L):
    """An end at or past L gathers the last slot and is never a target, as
    repro's refs do it (their gather clamps, their scatter drops); a
    negative end is kept (rewrite) or proposes itself (relabel)."""
    rng = np.random.default_rng(41)
    P = _labels_with_virtual_min(L, rng=rng)
    s, r = (_ends_out_of_range(L, 600, rng) for _ in range(2))
    js, jr = j_rewrite_ref(*map(jnp.asarray, (P, s, r)))
    got_s, got_r = edge_rewrite_ref(_t(P), _t(s), _t(r))
    _assert_same(got_s, js)
    _assert_same(got_r, jr)
    _assert_same(edge_relabel_ref(_t(P), _t(s), _t(r)),
                 j_relabel_ref(*map(jnp.asarray, (P, s, r))))
    _assert_same(ops.edge_rewrite(_t(P), _t(s), _t(r))[0],
                 jops.edge_rewrite(*map(jnp.asarray, (P, s, r)),
                                   policy="ref")[0])


@pytest.mark.parametrize("k", [0, 3])
def test_hook_compress_plain_on_ends_out_of_range_matches_jax(k):
    """repro's hook gathers P[s] and P[r] with jnp indexing: a negative end
    counts from the end once, and what is still outside [0, L) clamps."""
    rng = np.random.default_rng(42)
    L = 65
    P = _labels_with_virtual_min(L, rng=rng)
    s, r = (_ends_out_of_range(L, 700, rng) for _ in range(2))
    _assert_same(hook_compress_ref(_t(P), _t(s), _t(r), k=k),
                 j_hook_ref(*map(jnp.asarray, (P, s, r)), k=k))


def test_take_indexes_as_jnp():
    rng = np.random.default_rng(43)
    for L in (1, 2, 17):
        x = rng.integers(-5, 99, L).astype(np.int32)
        idx = _ends_out_of_range(L, 300, rng)
        _assert_same(take(_t(x), _t(idx)), jnp.asarray(x)[jnp.asarray(idx)])


# ---------------------------------------------------------------------------
# Hub shapes: most proposals converge on one slot, as on RMAT graphs. The
# same builders make the card's inputs below, at 2^20 slots and more.
# ---------------------------------------------------------------------------

INT32_MAX = np.iinfo(np.int32).max
SCATTER_HUBS = ("one_slot", "min_vertex_labels", "neg_mix")
HOOK_HUBS = ("star", "hub_root", "csr_runs", "neg_mix")


def _hub_components(n: int, rng) -> np.ndarray:
    """Compressed labels (n + 1,) of a graph whose one component holds ~96%
    of the vertices; ~2% are -1 (a pinned L_max); dump row n."""
    comp = np.where(rng.random(n) < 0.96, int(rng.integers(0, n)),
                    rng.integers(0, n, n))
    comp[rng.random(n) < 0.02] = -1
    return np.append(comp, n).astype(np.int32)


def _hub_scatter_inputs(shape: str, n: int, rng) -> tuple:
    """(labels (n + 1,), idx, vals), idx sanitized into [0, n] with the dump
    row n carrying the int32 max, as ops.scatter_min hands them over."""
    L = n + 1
    if shape == "min_vertex_labels":
        # min_vertex_labels' own call: base all n, every real vertex's id to
        # its component's slot
        P = _hub_components(n, rng)
        ids = np.arange(L, dtype=np.int32)
        real = (P >= 0) & (ids < n)
        return (np.full(L, n, np.int32), np.where(real, P, n).astype(np.int32),
                np.where(real, ids, INT32_MAX).astype(np.int32))
    m = 3 * n + 5
    P = _labels_with_dump(n, rng)
    if shape == "one_slot":
        idx = np.full(m, int(rng.integers(0, n)), np.int32)
        vals = rng.integers(-1, n, m).astype(np.int32)
    else:  # neg_mix: -1 labels and values, ~70% of the targets on one slot
        P[rng.random(L) < 0.3] = -1
        P[n] = n
        idx = np.where(rng.random(m) < 0.7, int(rng.integers(0, n)),
                       rng.integers(0, L, m)).astype(np.int32)
        vals = np.where(rng.random(m) < 0.3, -1,
                        rng.integers(0, n, m)).astype(np.int32)
    dumped = (rng.random(m) < 0.05) | (idx == n)
    return (P, np.where(dumped, n, idx).astype(np.int32),
            np.where(dumped, INT32_MAX, vals).astype(np.int32))


def _hub_hook_inputs(shape: str, n: int, rng) -> tuple:
    """(labels (n + 1,), senders, receivers) whose hooks converge on one
    root; edges in CSR order (sorted by sender) unless said otherwise."""
    L = n + 1
    ids = np.arange(L, dtype=np.int32)
    if shape == "star":
        # identity labels, hub n - 1 joined to every other vertex both ways:
        # each hub -> leaf edge hooks the leaf into the hub's root
        leaves = np.arange(n - 1, dtype=np.int32)
        hub = np.full(n - 1, n - 1, np.int32)
        return ids, np.concatenate([leaves, hub]), np.concatenate([hub, leaves])
    m = 4 * n + 3
    if shape == "csr_runs":
        # chains and -1s; each sender's edges form one run
        P = _labels_with_virtual_min(L, rng=rng)
        s = np.repeat(ids[:n], rng.geometric(0.1, n))[:m]
        return P, s.astype(np.int32), rng.integers(0, L, s.shape[0]).astype(np.int32)
    # hub_root: ~96% of the vertices hang off root n - 2, the rest on small
    # roots below it, so their edges propose smaller labels to the hub;
    # neg_mix: the same with ~40% of the labels -1
    P = np.minimum(rng.integers(0, n, L), ids)
    P[rng.random(L) < 0.96] = n - 2
    P[n - 2] = n - 2
    if shape == "neg_mix":
        P[rng.random(L) < 0.4] = -1
    P[n] = n
    s = np.sort(rng.integers(0, L, m))
    return P.astype(np.int32), s.astype(np.int32), rng.integers(0, L, m).astype(np.int32)


def _pad_to(block: int, fill: int, *arrays) -> list:
    """Each array padded with ``fill`` to a multiple of ``block`` (the
    Pallas kernels take whole blocks)."""
    m = arrays[0].shape[0]
    pad = -m % block
    return [np.concatenate([a, np.full(pad, f, a.dtype)])
            for a, f in zip(arrays, fill)]


@pytest.mark.parametrize("shape", SCATTER_HUBS)
def test_scatter_min_plain_matches_jax_on_hubs(shape):
    P, idx, vals = _hub_scatter_inputs(shape, 1000, np.random.default_rng(21))
    n = P.shape[0] - 1
    idx, vals = _pad_to(256, (n, INT32_MAX), idx, vals)
    pallas = j_scatter_min(jnp.asarray(P), jnp.asarray(idx), jnp.asarray(vals),
                           block_m=256, interpret=True)
    ref = j_scatter_ref(jnp.asarray(P), jnp.asarray(idx), jnp.asarray(vals))
    got = scatter_min_ref(_t(P), _t(idx), _t(vals))
    _assert_same(got, pallas, ref)
    hit = np.bincount(idx[vals != INT32_MAX], minlength=n + 1).max()
    assert hit > 0.6 * (vals != INT32_MAX).sum()  # one slot takes most


def test_min_vertex_labels_matches_jax_on_a_hub():
    """The canonicalization itself, one component over 95% of the vertices."""
    from repro.core.primitives import min_vertex_labels as j_min_vertex_labels

    from repro_torch.core.primitives import min_vertex_labels

    P = _hub_components(1000, np.random.default_rng(22))
    _assert_same(min_vertex_labels(_t(P)), j_min_vertex_labels(jnp.asarray(P)))


@pytest.mark.parametrize("shape", HOOK_HUBS)
@pytest.mark.parametrize("k", [0, 1, 3])
def test_hook_compress_plain_matches_jax_on_hubs(shape, k):
    P, s, r = _hub_hook_inputs(shape, 1000, np.random.default_rng(23))
    n = P.shape[0] - 1
    s, r = _pad_to(256, (n, n), s, r)
    jP, js, jr = jnp.asarray(P), jnp.asarray(s), jnp.asarray(r)
    pallas = j_hook_compress(jP, js, jr, k=k, block_m=256, interpret=True)
    ref = j_hook_ref(jP, js, jr, k=k)
    got = hook_compress_ref(_t(P), _t(s), _t(r), k=k)
    _assert_same(got, pallas, ref)
    if shape == "star":  # every leaf hooked into the hub's root
        hooked = hook_compress_ref(_t(P), _t(s), _t(r), k=0)
        assert int(hooked[n - 1]) == 0 and torch.equal(hooked[:n - 1],
                                                       _t(P)[:n - 1])


RELABEL_HUBS = ("csr_hub", "stergiou", "pufa", "self_loops")


def _hub_relabel_inputs(shape: str, n: int, rng) -> tuple:
    """(labels (n + 1,), senders, receivers) as the edge_relabel paths hand
    them over; senders in CSR order (sorted) unless said otherwise."""
    L = n + 1
    m = 4 * n + 3
    s = np.sort(rng.integers(0, L, m)).astype(np.int32)
    r = rng.integers(0, L, m).astype(np.int32)
    if shape == "stergiou":
        # a round's rewritten endpoints prev[s], prev[r]: runs of equal
        # values, ~96% of them one hub label, ~2% -1
        prev = _hub_components(n, rng)
        return prev, prev[s], prev[r]
    P = _labels_with_dump(n, rng)
    if shape == "csr_hub":
        # half the receivers are one root whose label is the largest, so
        # nearly every edge onto it proposes
        hub = n - 1
        P[hub] = hub
        return P, s, np.where(rng.random(m) < 0.5, hub, r).astype(np.int32)
    if shape == "pufa":
        # Liu-Tarjan's altered edges once L_max is pinned: ~90% of the
        # endpoints -1, most edges -1 at both ends
        P[rng.random(L) < 0.3] = -1
        P[n] = n
        return (P, np.where(rng.random(m) < 0.9, -1, s).astype(np.int32),
                np.where(rng.random(m) < 0.9, -1, r).astype(np.int32))
    # self_loops: half the edges have s == r, which proposes nothing
    return P, s, np.where(rng.random(m) < 0.5, s, r).astype(np.int32)


@pytest.mark.parametrize("shape", RELABEL_HUBS)
def test_edge_relabel_plain_matches_jax_on_hubs(shape):
    P, s, r = _hub_relabel_inputs(shape, 1000, np.random.default_rng(24))
    n = P.shape[0] - 1
    s, r = _pad_to(256, (n, n), s, r)
    jP, js, jr = jnp.asarray(P), jnp.asarray(s), jnp.asarray(r)
    pallas = j_edge_relabel(jP, js, jr, block_m=256, interpret=True)
    ref = j_relabel_ref(jP, js, jr)
    got = edge_relabel_ref(_t(P), _t(s), _t(r))
    _assert_same(got, pallas, ref)
    if shape == "self_loops":  # an edge onto itself changes nothing
        loops = s == r
        assert torch.equal(edge_relabel_ref(_t(P), _t(s[loops]),
                                            _t(r[loops])), _t(P))


def _jump_labels(L: int, rng) -> np.ndarray:
    """(L,) labels with chains, ~20% self-loops (roots), ~10% -1 and ~40%
    of the slots on one hub root."""
    ids = np.arange(L)
    P = np.minimum(rng.integers(0, L, L), ids)
    hub = int(rng.integers(0, L))
    P[rng.random(L) < 0.4] = hub
    P[hub] = hub
    roots = rng.random(L) < 0.2
    P[roots] = ids[roots]
    P[rng.random(L) < 0.1] = -1
    return P.astype(np.int32)


@pytest.mark.parametrize("L", [1, 5, 4097])
@pytest.mark.parametrize("k", [1, 3])
def test_pointer_jump_plain_matches_jax_on_hubs(k, L):
    P = _jump_labels(L, np.random.default_rng(25))
    pallas = jops.pointer_jump(jnp.asarray(P), k=k, policy="interpret",
                               block=1024)
    ref = j_jump_ref(jnp.asarray(P), k=k)
    got = pointer_jump_ref(_t(P), k=k)
    _assert_same(got, pallas, ref)
    if k == 3:
        assert torch.equal(got, pointer_jump_ref(pointer_jump_ref(_t(P))))


def test_pointer_jump_three_hops_is_two_rounds():
    P = _t(_labels_with_virtual_min(256))
    two = pointer_jump_ref(pointer_jump_ref(P, k=1), k=1)
    assert torch.equal(pointer_jump_ref(P, k=3), two)
    assert torch.equal(pointer_jump_ref(P, k=3)[P == -1], P[P == -1])


# ---------------------------------------------------------------------------
# The dispatch layer vs repro.kernels.ops under the ref policy: dump-slot
# sanitization, masks, -1 fixed points, arbitrary (n + 1,) lengths.
# ---------------------------------------------------------------------------

def _labels_with_dump(n: int, rng=RNG) -> np.ndarray:
    P = np.minimum(rng.integers(-1, n, n + 1), np.arange(n + 1))
    P[n] = n
    return P.astype(np.int32)


@pytest.mark.parametrize("masked", [False, True])
def test_scatter_min_sanitization_matches_jax(masked):
    n = 150
    P = _labels_with_dump(n)
    idx = RNG.integers(-9, n + 9, 400).astype(np.int32)
    vals = RNG.integers(-1, n, 400).astype(np.int32)
    mask = RNG.random(400) < 0.5 if masked else None
    want = jops.scatter_min(
        jnp.asarray(P), jnp.asarray(idx), jnp.asarray(vals),
        None if mask is None else jnp.asarray(mask), policy="ref")
    got = ops.scatter_min(_t(P), _t(idx), _t(vals),
                          None if mask is None else _t(mask))
    _assert_same(got, want)


def test_scatter_min_all_false_mask_is_identity():
    n = 64
    P = _labels_with_dump(n)
    idx = RNG.integers(-3, n + 3, 100).astype(np.int32)
    vals = RNG.integers(-1, n, 100).astype(np.int32)
    got = ops.scatter_min(_t(P), _t(idx), _t(vals), torch.zeros(100, dtype=bool))
    assert torch.equal(got, _t(P))


@pytest.mark.parametrize("n", [5, 127, 128, 300])
def test_ops_match_jax_on_arbitrary_label_shapes(n):
    P = _labels_with_dump(n)
    s = RNG.integers(0, n + 1, 77).astype(np.int32)
    r = RNG.integers(0, n + 1, 77).astype(np.int32)
    mask = RNG.random(77) < 0.7
    jP, js, jr = jnp.asarray(P), jnp.asarray(s), jnp.asarray(r)
    for k in (1, 3):
        _assert_same(ops.pointer_jump(_t(P), k=k),
                     jops.pointer_jump(jP, k=k, policy="ref"))
        _assert_same(ops.hook_compress(_t(P), _t(s), _t(r), k=k),
                     jops.hook_compress(jP, js, jr, k=k, policy="ref"))
        _assert_same(
            ops.hook_compress(_t(P), _t(s), _t(r), k=k, mask=_t(mask)),
            jops.hook_compress(jP, js, jr, k=k, mask=jnp.asarray(mask),
                               policy="ref"))


@pytest.mark.parametrize("n", [5, 127, 300])
def test_edge_ops_match_jax(n):
    """The dispatch layer's edge_relabel/edge_rewrite equal repro's under
    the ref policy exactly, with -1 labels and -1 endpoints."""
    P = _labels_with_dump(n)
    s = _endpoints(n + 1, 91, True)
    r = _endpoints(n + 1, 91, True)
    jP, js, jr = jnp.asarray(P), jnp.asarray(s), jnp.asarray(r)
    _assert_same(ops.edge_relabel(_t(P), _t(s), _t(r)),
                 jops.edge_relabel(jP, js, jr, policy="ref"))
    got = ops.edge_rewrite(_t(P), _t(s), _t(r))
    want = jops.edge_rewrite(jP, js, jr, policy="ref")
    _assert_same(got[0], want[0])
    _assert_same(got[1], want[1])


# embedding_bag: the plain version against the Pallas kernel (interpret) and
# the jnp ref over tests/test_kernels.py's sweep, then the id contract.
_BAG_TOL = {"float32": 1e-6, "bfloat16": 3e-2}


def _bag_inputs(V: int, D: int, B: int, L: int) -> tuple:
    """A (V + 1, D) normal table with a zero dump row V, and ids in [0, V]."""
    tab = np.zeros((V + 1, D), np.float32)
    tab[:V] = RNG.normal(size=(V, D))
    return tab, RNG.integers(0, V + 1, (B, L)).astype(np.int32)


def _assert_bag_close(got: torch.Tensor, want, dtype: str) -> None:
    assert str(got.dtype) == f"torch.{dtype}"
    if isinstance(want, torch.Tensor):
        want = want.float().cpu().numpy()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               np.asarray(want, np.float32),
                               rtol=_BAG_TOL[dtype], atol=_BAG_TOL[dtype])


@pytest.mark.parametrize("V,D,B,L,bb,mode", [
    (100, 16, 64, 4, 32, "sum"), (50, 64, 128, 8, 64, "mean"),
    (200, 32, 32, 3, 32, "max"), (33, 8, 16, 1, 16, "sum"),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_bag_plain_matches_jax(V, D, B, L, bb, mode, dtype):
    tab, idx = _bag_inputs(V, D, B, L)
    jtab = jnp.asarray(tab, dtype)
    pallas = j_embedding_bag(jtab, jnp.asarray(idx), mode=mode, block_b=bb,
                             interpret=True)
    ref = j_bag_ref(jtab, jnp.asarray(idx), mode=mode)
    got = embedding_bag_ref(_t(tab).to(getattr(torch, dtype)), _t(idx),
                            mode=mode)
    _assert_bag_close(got, pallas, dtype)
    _assert_bag_close(got, ref, dtype)


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_bag_wraps_and_clamps_as_jax(mode, dtype):
    """-1 reads the dump row and counts as valid; rows + 3 reads the dump
    row and does not; -rows - 2 wraps to -2 and clamps to row 0."""
    V, D = 9, 8
    rows = V + 1
    tab, _ = _bag_inputs(V, D, 1, 1)
    idx = np.array([[-1, 3], [-rows - 2, 3], [rows + 3, 3], [3, 5],
                    [-1, -1], [rows + 3, rows + 3], [V, -rows - 2]],
                   np.int32)
    jtab = jnp.asarray(tab, dtype)
    got = embedding_bag_ref(_t(tab).to(getattr(torch, dtype)), _t(idx),
                            mode=mode)
    _assert_bag_close(got, j_bag_ref(jtab, jnp.asarray(idx), mode=mode),
                      dtype)
    _assert_bag_close(got, j_embedding_bag(jtab, jnp.asarray(idx), mode=mode,
                                           block_b=7, interpret=True), dtype)
    # the same through the dispatcher, on the CPU
    _assert_bag_close(embedding_bag(_t(tab).to(getattr(torch, dtype)),
                                    _t(idx), mode=mode), got, dtype)


def test_embedding_bag_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="mode"):
        embedding_bag(torch.ones(4, 2), torch.zeros(1, 1, dtype=torch.int32),
                      mode="min")


def test_ops_embedding_bag_shim_warns_and_dispatches():
    table = torch.ones(8, 4)
    idx = torch.zeros(2, 3, dtype=torch.int32)
    before = ops.launch_counts()
    with pytest.warns(DeprecationWarning, match="legacy"):
        out = ops.embedding_bag(table, idx)
    assert torch.equal(out, embedding_bag_ref(table, idx))
    assert ops.launch_counts() == before


def test_cpu_tensors_take_the_plain_path():
    before = ops.launch_counts()
    P = _t(_labels_with_dump(40))
    s = _t(RNG.integers(0, 41, 50).astype(np.int32))
    ops.scatter_min(P, s, s)
    ops.pointer_jump(P, k=3)
    ops.hook_compress(P, s, s, k=1)
    ops.edge_relabel(P, s, s)
    ops.edge_rewrite(P, s, s)
    embedding_bag(torch.ones(8, 4), s.reshape(5, 10), mode="mean")
    ops.segment_sum(torch.ones(50, 3), s, torch.arange(6, dtype=torch.int32))
    assert ops.launch_counts() == before
    assert set(before) == {"hook_compress", "pointer_jump", "scatter_min",
                           "edge_relabel", "edge_rewrite", "embedding_bag",
                           "embedding_bag_backward", "threefry_bits",
                           "threefry_randint", "segment_sum", "gather_sum"}


def test_reset_launch_counts_zeroes_every_counter():
    for fn in ops.KERNELS.values():
        fn.launches += 3
    ops.reset_launch_counts()
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)


def test_unsupported_device_raises():
    P = torch.empty(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.pointer_jump(P)


# ---------------------------------------------------------------------------
# The CUDA wrappers: what they refuse is checked before any CUDA call, so it
# is testable here; the sources and the build are checked statically.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(set(ops.KERNELS) - {
    "embedding_bag", "embedding_bag_backward", "threefry_bits",
    "threefry_randint", "segment_sum", "gather_sum"}))
def test_kernel_wrappers_reject_what_they_cannot_take(name):
    fn = ops.KERNELS[name]
    before = fn.launches
    lab = torch.arange(9, dtype=torch.int32)
    edges = torch.zeros(6, dtype=torch.int32)

    def call(P, e=edges, e2=edges):
        if name == "pointer_jump":
            return fn(P)
        if name in ("scatter_min", "edge_relabel", "edge_rewrite"):
            return fn(P, e, e2)
        return fn(P, e, e2, k=1)

    with pytest.raises(TypeError, match="int32"):
        call(lab.to(torch.int16))
    with pytest.raises(ValueError, match="CUDA device"):
        call(lab)                      # int32, but on the CPU
    with pytest.raises(ValueError, match="contiguous"):
        call(torch.arange(18, dtype=torch.int32)[::2])
    if name != "pointer_jump":
        with pytest.raises(ValueError):
            call(lab, edges, edges[:5])
    assert fn.launches == before  # a refused call launches nothing


def test_embedding_bag_wrapper_rejects_what_it_cannot_take():
    fn = ops.KERNELS["embedding_bag"]
    before = fn.launches
    table = torch.zeros(10, 4)
    idx = torch.zeros(3, 2, dtype=torch.int32)
    with pytest.raises(TypeError, match="table"):
        fn(table.to(torch.float16), idx)
    with pytest.raises(TypeError, match="int32"):
        fn(table, idx.long())
    with pytest.raises(ValueError, match="2-D"):
        fn(table, idx.reshape(-1))
    with pytest.raises(ValueError, match="contiguous"):
        fn(torch.zeros(4, 10).t(), idx)
    with pytest.raises(ValueError, match="no rows"):
        fn(torch.zeros(0, 4), idx)
    with pytest.raises(ValueError, match="CUDA device"):
        fn(table, idx)                 # right types, but on the CPU
    assert fn.launches == before


def test_each_c_entry_point_is_defined_in_its_source():
    for name, fns in _build.SIGNATURES.items():
        src = (_build.CSRC / f"{name}.cu").read_text()
        for fn, argtypes in fns.items():
            m = re.search(rf'extern "C" int {fn}\(([^)]*)\)', src)
            assert m, f"{fn} not found in {name}.cu"
            assert len(m.group(1).split(",")) == len(argtypes), fn
        assert "sm_90a" in " ".join(_build.NVCC_FLAGS)


def test_build_directory_is_ignored_and_inside_the_checkout():
    assert _build.BUILD_DIR.is_relative_to(REPO)
    ignored = (REPO / ".gitignore").read_text().split()
    assert "build/" in ignored


def test_library_name_follows_the_sources():
    names = {_build._library_path(n).name for n in _build.SIGNATURES}
    assert len(names) == len(_build.SIGNATURES)
    assert all(re.fullmatch(r"[a-z_]+-[0-9a-f]{16}\.so", x) for x in names)


def test_another_source_tree_builds_apart(tmp_path, monkeypatch):
    """A second csrc tree (a parent commit's, say) is named by its own
    sources and kept in its own directory; what is built there already is
    reported, ptxas lines included, without nvcc and without touching what
    ``load`` uses."""
    import shutil

    csrc, out = tmp_path / "csrc", tmp_path / "out"
    shutil.copytree(_build.CSRC, csrc)
    names = ("scatter_min", "hook_compress")
    same = {n: _build._library_path(n, csrc, out) for n in names}
    assert all(same[n].name == _build._library_path(n).name for n in names)
    assert all(path.parent == out for path in same.values())
    with open(csrc / "warp_min.cuh", "a") as f:
        f.write("// edited\n")
    edited = {n: _build._library_path(n, csrc, out) for n in names}
    assert all(edited[n] != same[n] for n in names)
    out.mkdir()
    for n, path in edited.items():
        path.write_bytes(b"")
        path.with_suffix(".ptxas.txt").write_text(f"ptxas info {n}")
    monkeypatch.setattr(_build, "_nvcc", lambda: pytest.fail("nvcc called"))
    records_before = dict(_build._RECORDS)
    recs = _build.build_all(csrc, out, names=names)
    assert {n: (r.path, r.seconds, r.ptxas) for n, r in recs.items()} == {
        n: (edited[n], 0.0, (f"ptxas info {n}",)) for n in names}
    assert _build._RECORDS == records_before


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version, exactly.
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("k", [0, 1, 3])
def test_hook_compress_kernel_matches_plain_on_card(cuda, k):
    P = _t(_labels_with_virtual_min(4097)).to(cuda)
    s = _t(RNG.integers(0, 4097, 50_000).astype(np.int32)).to(cuda)
    r = _t(RNG.integers(0, 4097, 50_000).astype(np.int32)).to(cuda)
    got = ops.KERNELS["hook_compress"](P, s, r, k=k)
    assert torch.equal(got, hook_compress_ref(P, s, r, k=k))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 3])
def test_pointer_jump_kernel_matches_plain_on_card(cuda, k):
    P = _t(_labels_with_virtual_min(100_003)).to(cuda)
    assert torch.equal(ops.KERNELS["pointer_jump"](P, k=k),
                       pointer_jump_ref(P, k=k))


@pytest.mark.gpu
def test_scatter_min_kernel_matches_plain_on_card(cuda):
    n = 30_000
    P = _t(_labels_with_dump(n)).to(cuda)
    idx = _t(RNG.integers(-5, n + 5, 200_000).astype(np.int32)).to(cuda)
    vals = _t(RNG.integers(-1, n, 200_000).astype(np.int32)).to(cuda)
    mask = _t(RNG.random(200_000) < 0.8).to(cuda)
    want = ops.scatter_min(P.cpu(), idx.cpu(), vals.cpu(), mask.cpu())
    assert torch.equal(ops.scatter_min(P, idx, vals, mask).cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("negative", [False, True], ids=["real", "neg"])
def test_edge_relabel_kernel_matches_plain_on_card(cuda, negative):
    n_pad = 100_003
    P = _t(_labels_with_virtual_min(n_pad)).to(cuda)
    s = _t(_endpoints(n_pad, 400_000, negative)).to(cuda)
    r = _t(_endpoints(n_pad, 400_000, negative)).to(cuda)
    assert torch.equal(ops.KERNELS["edge_relabel"](P, s, r),
                       edge_relabel_ref(P, s, r))


@pytest.mark.gpu
@pytest.mark.parametrize("negative", [False, True], ids=["real", "neg"])
def test_edge_rewrite_kernel_matches_plain_on_card(cuda, negative):
    n_pad = 100_003
    P = _t(_labels_with_virtual_min(n_pad)).to(cuda)
    s = _t(_endpoints(n_pad, 400_000, negative)).to(cuda)
    r = _t(_endpoints(n_pad, 400_000, negative)).to(cuda)
    got = ops.KERNELS["edge_rewrite"](P, s, r)
    want = edge_rewrite_ref(P, s, r)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("D", [8, 13, 16, 32, 64, 200])
@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_bag_kernel_matches_plain_on_card(cuda, D, mode, dtype):
    """Any D (13: no vector loads; 200: more than one column chunk), ids
    on the dump row and wrapped and clamped ids among them."""
    V, B, L = 5_000, 3_001, 5
    tab, idx = _bag_inputs(V, D, B, L)
    idx[RNG.random((B, L)) < 0.02] = -1
    idx[RNG.random((B, L)) < 0.02] = V + 7
    idx[RNG.random((B, L)) < 0.02] = -V - 9
    table = _t(tab).to(getattr(torch, dtype)).to(cuda)
    ids = _t(idx).to(cuda)
    before = ops.KERNELS["embedding_bag"].launches
    got = embedding_bag(table, ids, mode=mode)
    assert ops.KERNELS["embedding_bag"].launches == before + 1
    _assert_bag_close(got, embedding_bag_ref(table, ids, mode=mode), dtype)


# Card inputs of the hub shapes, made once per shape: (2^20 + 1,) labels.
@functools.lru_cache(maxsize=None)
def _card_scatter_inputs(shape: str) -> tuple:
    return _hub_scatter_inputs(shape, 1 << 20, np.random.default_rng(31))


@functools.lru_cache(maxsize=None)
def _card_hook_inputs(shape: str) -> tuple:
    return _hub_hook_inputs(shape, 1 << 20, np.random.default_rng(32))


LAYOUTS = ("aligned", "ragged", "offset", "mixed", "empty")


def _edge_layout(cuda, layout: str, a, b) -> tuple:
    """Two edge-indexed arrays on the card: as allocated; cut to a length
    m with m % 8 == 5; both 4 bytes past a 16-byte boundary; only the
    first so; or empty."""
    a, b = _t(a).to(cuda), _t(b).to(cuda)
    assert a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    if layout == "ragged":
        m = a.shape[0] - (a.shape[0] - 5) % 8
        return a[:m], b[:m]
    if layout == "empty":
        return a[:0], b[:0]

    def offset(x):
        buf = torch.empty(x.shape[0] + 1, dtype=x.dtype, device=cuda)
        buf[1:] = x
        assert buf[1:].data_ptr() % 16 == 4
        return buf[1:]

    if layout == "offset":
        return offset(a), offset(b)
    if layout == "mixed":
        return offset(a), b
    return a, b


@pytest.mark.gpu
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shape", SCATTER_HUBS)
def test_scatter_min_kernel_matches_plain_on_hubs(cuda, shape, layout):
    P, idx, vals = _card_scatter_inputs(shape)
    P = _t(P).to(cuda)
    idx, vals = _edge_layout(cuda, layout, idx, vals)
    fn = ops.KERNELS["scatter_min"]
    before = fn.launches
    got = fn(P, idx, vals)
    assert fn.launches == before + 1
    assert torch.equal(got, scatter_min_ref(P, idx, vals))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [0, 1, 3])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shape", HOOK_HUBS)
def test_hook_compress_kernel_matches_plain_on_hubs(cuda, shape, layout, k):
    P, s, r = _card_hook_inputs(shape)
    P = _t(P).to(cuda)
    s, r = _edge_layout(cuda, layout, s, r)
    fn = ops.KERNELS["hook_compress"]
    before = fn.launches
    got = fn(P, s, r, k=k)
    assert fn.launches == before + 1
    assert torch.equal(got, hook_compress_ref(P, s, r, k=k))


@functools.lru_cache(maxsize=None)
def _card_relabel_inputs(shape: str) -> tuple:
    return _hub_relabel_inputs(shape, 1 << 20, np.random.default_rng(33))


@pytest.mark.gpu
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shape", RELABEL_HUBS)
def test_edge_relabel_kernel_matches_plain_on_hubs(cuda, shape, layout):
    P, s, r = _card_relabel_inputs(shape)
    P = _t(P).to(cuda)
    s, r = _edge_layout(cuda, layout, s, r)
    fn = ops.KERNELS["edge_relabel"]
    before = fn.launches
    got = fn(P, s, r)
    assert fn.launches == before + 1
    assert torch.equal(got, edge_relabel_ref(P, s, r))


JUMP_LAYOUTS = ("aligned", "ragged", "offset", "one")


def _label_layout(cuda, layout: str, P) -> torch.Tensor:
    """Labels on the card: (2^20 + 1,) as allocated (L % 4 == 1); cut to
    L % 4 == 3; a view 4 bytes past a 16-byte boundary; or one slot."""
    P = _t(P).to(cuda)
    if layout == "ragged":
        return P[:P.shape[0] - 2].clamp_max(P.shape[0] - 3)
    if layout == "one":
        return P[:1].clamp_max(0)
    if layout == "offset":
        buf = torch.empty(P.shape[0] + 1, dtype=P.dtype, device=cuda)
        buf[1:] = P
        assert buf[1:].data_ptr() % 16 == 4
        return buf[1:]
    return P


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("layout", JUMP_LAYOUTS)
def test_pointer_jump_kernel_matches_plain_on_hubs(cuda, layout, k):
    P = _label_layout(cuda, layout,
                      _jump_labels((1 << 20) + 1, np.random.default_rng(34)))
    fn = ops.KERNELS["pointer_jump"]
    before = fn.launches
    got = fn(P, k=k)
    assert fn.launches == before + 1
    assert torch.equal(got, pointer_jump_ref(P, k=k))


@pytest.mark.gpu
@pytest.mark.parametrize("L", [1, 2, 7])
def test_hook_compress_kernel_hops_short_labels(cuda, L):
    """The hop pass after the hook on label arrays shorter than a vector."""
    rng = np.random.default_rng(35)
    P = _t(_jump_labels(L, rng)).to(cuda)
    s = _t(rng.integers(0, L, 37).astype(np.int32)).to(cuda)
    r = _t(rng.integers(0, L, 37).astype(np.int32)).to(cuda)
    got = ops.KERNELS["hook_compress"](P, s, r, k=3)
    assert torch.equal(got, hook_compress_ref(P, s, r, k=3))


# Calls the forest and stream paths make: scatter_min into an edge-id
# buffer (hook_and_record's second pass), edge_rewrite of a pow2-padded
# stream batch, hook_compress on fully compressed labels with no -1.
EDGE_ID_TARGETS = ("hub_root", "distinct_roots", "dump_slot")


@functools.lru_cache(maxsize=None)
def _edge_id_inputs(targets: str) -> tuple:
    """An INT_MAX-filled (n + 1,) buffer, ascending edge ids ~5% live (the
    rest dumped with the sentinel, as ops hands them), live targets on one
    hub root, on distinct roots, or on the dump slot itself."""
    n = 1 << 20
    rng = np.random.default_rng(36)
    m = n - 3
    live = rng.random(m) < 0.05
    idx = {"hub_root": np.full(m, n // 3),
           "distinct_roots": rng.permutation(n)[:m],
           "dump_slot": np.full(m, n)}[targets]
    idx = np.where(live, idx, n).astype(np.int32)
    vals = np.where(live, np.arange(m), INT32_MAX).astype(np.int32)
    return np.full(n + 1, INT32_MAX, np.int32), idx, vals


@pytest.mark.gpu
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("targets", EDGE_ID_TARGETS)
def test_scatter_min_kernel_on_an_edge_id_buffer(cuda, targets, layout):
    buf, idx, vals = _edge_id_inputs(targets)
    buf = _t(buf).to(cuda)
    idx, vals = _edge_layout(cuda, layout, idx, vals)
    fn = ops.KERNELS["scatter_min"]
    before = fn.launches
    got = fn(buf, idx, vals)
    assert fn.launches == before + 1
    assert torch.equal(got, scatter_min_ref(buf, idx, vals))


def _compressed_labels(n: int, rng) -> np.ndarray:
    """(n + 1,) fully compressed labels, no -1: ~20% roots labeling
    themselves, every other slot on a root; the dump row n on itself."""
    roots = np.flatnonzero(rng.random(n) < 0.2)
    P = roots[rng.integers(0, len(roots), n)]
    P[roots] = roots
    return np.append(P, n).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _stream_batch(size: int = 1 << 17, real: int = (1 << 17) - 12_345):
    """Compressed labels and one symmetrized stream batch of ``size``
    entries whose tail past ``real`` is dump-padded (id n)."""
    n = 1 << 20
    rng = np.random.default_rng(37)
    P = _compressed_labels(n, rng)
    u = np.full(size, n, np.int32)
    v = np.full(size, n, np.int32)
    u[:real], v[:real] = rng.integers(0, n, (2, real))
    return P, np.concatenate([u, v]), np.concatenate([v, u])


@pytest.mark.gpu
@pytest.mark.parametrize("layout", LAYOUTS)
def test_edge_rewrite_kernel_on_a_padded_stream_batch(cuda, layout):
    P, u, v = _stream_batch()
    P = _t(P).to(cuda)
    u, v = _edge_layout(cuda, layout, u[: 1 << 17], v[: 1 << 17])
    fn = ops.KERNELS["edge_rewrite"]
    before = fn.launches
    got = fn(P, u, v)
    assert fn.launches == before + 1
    want = edge_rewrite_ref(P, u, v)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# edge_rewrite's calls: all ends -1 (a converged alter step), ~99.99% -1
# (fused Liu-Tarjan PUFA's later rounds), a dump-padded stream batch, and
# ends at or past L and below -1 (clamped, or kept); each at its inputs'
# 16-byte phase (as the wrapper allocates) and out of it.
REWRITE_ENDS = ("all_neg", "pufa", "stream", "past_L")
REWRITE_LENGTHS = (0, 1, 31, 33, (1 << 17) + 3)


@functools.lru_cache(maxsize=None)
def _rewrite_inputs(ends: str, m: int) -> tuple:
    n = 1 << 20
    rng = np.random.default_rng(38)
    if ends == "stream":
        P, u, v = _stream_batch()
        return P, u[:m], v[:m]
    P = _labels_with_virtual_min(n + 1, rng=rng)
    if ends == "past_L":
        return P, *(_ends_out_of_range(n + 1, m, rng) for _ in range(2))
    s, r = rng.integers(0, n + 1, (2, m)).astype(np.int32)
    keep = 0.0 if ends == "all_neg" else 1e-4
    s[rng.random(m) >= keep] = -1
    r[rng.random(m) >= keep] = -1
    return P, s, r


def _out_of_phase(monkeypatch):
    """Make edge_rewrite's wrapper allocate each output one element past its
    input's 16-byte phase (the scalar path), with guard elements around
    it that must stay untouched."""
    from repro_torch.kernels.edge_relabel import kernel as kmod
    guarded = []

    def shifted(x):
        k = x.numel()
        phase = (x.data_ptr() % 16 // 4 + 1) % 4
        buf = torch.full((k + 8,), -7, dtype=x.dtype, device=x.device)
        guarded.append((buf, phase + 4, k))
        return buf[phase + 4: phase + 4 + k]

    monkeypatch.setattr(kmod, "_at_phase_of", shifted)
    return guarded


def _check_rewrite(P, s, r, guarded=()) -> None:
    fn = ops.KERNELS["edge_rewrite"]
    before = fn.launches
    got = fn(P, s, r)
    assert fn.launches == before + 1
    want = edge_rewrite_ref(P, s, r)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for out, x in zip(got, (s, r)):
        assert out.shape == x.shape and out.dtype == torch.int32
        if not guarded:  # the wrapper's own outputs share their input's phase
            assert out.data_ptr() % 16 == x.data_ptr() % 16
    for buf, lo, k in guarded:
        rest = torch.cat([buf[:lo], buf[lo + k:]])
        assert bool((rest == -7).all())


@pytest.mark.gpu
@pytest.mark.parametrize("phase", ["input", "shifted"])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("ends", REWRITE_ENDS)
def test_edge_rewrite_kernel_on_its_calls(cuda, monkeypatch, ends, layout,
                                         phase):
    P, s, r = _rewrite_inputs(ends, REWRITE_LENGTHS[-1])
    guarded = _out_of_phase(monkeypatch) if phase == "shifted" else ()
    _check_rewrite(_t(P).to(cuda), *_edge_layout(cuda, layout, s, r), guarded)


@pytest.mark.gpu
@pytest.mark.parametrize("phase", ["input", "shifted"])
@pytest.mark.parametrize("m", REWRITE_LENGTHS)
@pytest.mark.parametrize("ends", REWRITE_ENDS)
def test_edge_rewrite_kernel_on_short_and_ragged_calls(cuda, monkeypatch,
                                                       ends, m, phase):
    P, s, r = _rewrite_inputs(ends, m)
    guarded = _out_of_phase(monkeypatch) if phase == "shifted" else ()
    _check_rewrite(_t(P).to(cuda), _t(s).to(cuda), _t(r).to(cuda), guarded)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [0, 3])
def test_hook_compress_kernel_on_ends_out_of_range(cuda, k):
    """The kernel reads an end outside [0, L) where the plain version (and
    repro's jnp gather) does: a negative end from the end once, then
    clamped."""
    rng = np.random.default_rng(39)
    L = 4097
    P = _t(_labels_with_virtual_min(L, rng=rng)).to(cuda)
    s, r = (_t(_ends_out_of_range(L, 50_003, rng)).to(cuda)
            for _ in range(2))
    got = ops.KERNELS["hook_compress"](P, s, r, k=k)
    assert torch.equal(got, hook_compress_ref(P, s, r, k=k))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 3])
def test_hook_compress_kernel_on_compressed_labels(cuda, k):
    """The stream's finish: rewritten batch endpoints (roots) on labels
    with no -1."""
    P, u, v = _stream_batch()
    P = _t(P).to(cuda)
    s, r = edge_rewrite_ref(P, _t(u).to(cuda), _t(v).to(cuda))
    got = ops.KERNELS["hook_compress"](P, s, r, k=k)
    assert torch.equal(got, hook_compress_ref(P, s, r, k=k))
