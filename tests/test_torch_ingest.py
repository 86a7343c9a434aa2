"""The port's out-of-core chunked ingest and compressed containers against
the JAX package.

The same numpy edges go through ``repro`` and ``repro_torch`` (on the CPU).
``from_chunks`` gives ``repro``'s labels, and the port's ``.connectivity``
ones, for every family, chunk size and variant. On the deterministic
variants every counter of the run (chunks, streamed, survivors, spills,
finish rounds, lmax_count) and the survivor buffers after every chunk are
``repro``'s. ``compress_edges``' arrays are byte for byte ``repro``'s, and
each block decodes to ``repro``'s. The streamed generators draw
``repro``'s chunks. Every comparison is exact.
"""

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.graphs import ArrayEdgeSource as JArraySource
from repro.graphs import build_graph as j_build_graph
from repro.graphs import compress_edges as j_compress_edges
from repro.graphs import generators as jgen
from repro.graphs import ingest as jingest
from repro_torch import api as tapi
from repro_torch.core.driver import bucket_size
from repro_torch.graphs import (
    ArrayEdgeSource,
    ChunkedEdgeSource,
    CompressedEdgeBlocks,
    build_graph,
    compress_edges,
    compress_graph,
    open_edge_file,
    sort_dedup_edges,
    write_edge_file,
)
from repro_torch.graphs import generators as tgen
from repro_torch.graphs import ingest as tingest
from test_ingest import FAMILIES, N, _family_edges

# the reference's two variants (deterministic: no random draw) and the
# main variant (its k-out columns come from the generator: labels only)
DETERMINISTIC = ("kout_afforest_k2+uf_sync_full", "none+shiloach_vishkin")
VARIANTS = DETERMINISTIC + ("kout_hybrid_k2+uf_sync_full",)
STATS_FIELDS = ("variant", "exec", "placement", "devices", "edges_total",
                "edges_finish", "edges_finish_padded", "edges_per_device",
                "dispatch_sizes", "lmax_count", "finish_rounds", "chunks",
                "spills", "survivor_ratio")
CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def _clear_jax_caches():
    """Shadow conftest's per-test cache clearing: the JAX programs here run
    at a few small shapes. Cleared once per module."""
    yield


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_once():
    yield
    jax.clear_caches()


def _record_steps(monkeypatch, module, pick):
    """Wrap ``module._chunk_step`` so every call's outputs are kept:
    ``pick(out)`` → (bu, bv, count) as numpy."""
    seen = []
    step = module._chunk_step

    def recording(*a, **kw):
        out = step(*a, **kw)
        seen.append(pick(out))
        return out

    monkeypatch.setattr(module, "_chunk_step", recording)
    return seen


def _run_both(monkeypatch, variant, edges, n, chunk, **kw):
    """Both packages' from_chunks on one source → (labels, stats) of each and
    the survivor buffers after every chunk."""
    jseen = _record_steps(monkeypatch, jingest, lambda o: (
        np.asarray(o[1]), np.asarray(o[2]), int(o[3])))
    tseen = _record_steps(monkeypatch, tingest, lambda o: (
        o[1].numpy().copy(), o[2].numpy().copy(), o[3]))
    jl, js = japi.ConnectIt(variant).from_chunks(
        JArraySource(edges, n, chunk=chunk), return_stats=True, **kw)
    tl, ts = tapi.ConnectIt(variant, **CPU).from_chunks(
        ArrayEdgeSource(edges, n, chunk=chunk), return_stats=True, **kw)
    return (np.asarray(jl), js, jseen), (tl.numpy(), ts, tseen)


def _assert_same_run(want, got, what):
    (jl, js, jseen), (tl, ts, tseen) = want, got
    np.testing.assert_array_equal(tl, jl, err_msg=what)
    for f in STATS_FIELDS:
        assert getattr(ts, f) == getattr(js, f), (what, f)
    assert len(tseen) == len(jseen) == js.chunks, what
    for i, (a, b) in enumerate(zip(tseen, jseen)):
        np.testing.assert_array_equal(a[0], b[0], err_msg=f"{what} bu {i}")
        np.testing.assert_array_equal(a[1], b[1], err_msg=f"{what} bv {i}")
        assert a[2] == b[2], (what, "count", i)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("chunk", [5, 64])
def test_chunked_matches_jax(monkeypatch, variant, family, chunk):
    """Labels equal repro's, the one-shot path's and scipy's; on the
    deterministic variants the stats and the buffers after every chunk."""
    edges = _family_edges(family)
    want, got = _run_both(monkeypatch, variant, edges, N, chunk)
    one = tapi.ConnectIt(variant, **CPU).connectivity(
        build_graph(edges, N, **CPU))
    np.testing.assert_array_equal(got[0], one.numpy())
    np.testing.assert_array_equal(got[0], want[0])
    if variant in DETERMINISTIC:
        _assert_same_run(want, got, f"{variant} {family} {chunk}")
    else:
        assert got[1].chunks == want[1].chunks
        assert got[1].edges_total == want[1].edges_total


@pytest.mark.parametrize("variant", DETERMINISTIC)
def test_spills_forced_by_a_tiny_cap_match_jax(monkeypatch, variant):
    """survivor_cap of one chunk's bucket: the flushes happen at repro's
    chunks, before the append, and the buffers stay repro's."""
    edges = _family_edges("random")
    cap = bucket_size(16, pad="pow2")
    want, got = _run_both(monkeypatch, variant, edges, N, 16,
                          survivor_cap=cap)
    assert got[1].spills > 0
    _assert_same_run(want, got, variant)


def test_cap_below_chunk_bucket_raises():
    edges = _family_edges("random")
    ci = tapi.ConnectIt("none+uf_sync_full", **CPU)
    with pytest.raises(ValueError, match="survivor_cap"):
        ci.from_chunks(ArrayEdgeSource(edges, N, chunk=64), survivor_cap=8)


@pytest.mark.parametrize("edges,n,want", [
    (np.zeros((0, 2), np.int32), 9, np.arange(9)),
    (np.array([[3, 7]]), 9, [0, 1, 2, 3, 4, 5, 6, 3, 8]),
], ids=["empty", "one_edge"])
def test_empty_and_single_edge_sources(monkeypatch, edges, n, want):
    """An empty source yields one empty chunk; one edge joins its ends;
    both as repro runs them."""
    jax_run, run = _run_both(monkeypatch, DETERMINISTIC[0], edges, n, 4)
    np.testing.assert_array_equal(run[0], want)
    _assert_same_run(jax_run, run, "tiny")


def test_one_edge_final_chunk_and_stats(monkeypatch):
    edges = _family_edges("two_halves")
    m = edges.shape[0]
    src = ArrayEdgeSource(edges, N, chunk=m - 1)
    assert src.num_chunks == 2 and isinstance(src, ChunkedEdgeSource)
    want, got = _run_both(monkeypatch, DETERMINISTIC[0], edges, N, m - 1)
    _assert_same_run(want, got, "two chunks")
    ts = got[1]
    assert ts.exec == "single" and ts.chunks == 2
    assert ts.edges_finish == ts.edges_per_device[0]


def test_ingest_chunks_result_matches_jax():
    """IngestResult field for field, sample_chunks > 1 included."""
    edges = _family_edges("random")
    for sample_chunks in (1, 3):
        j = jingest.ingest_chunks(
            JArraySource(edges, N, chunk=24),
            japi.SamplingSpec.parse("kout_afforest_k2").build(),
            japi.VariantSpec.parse("uf_sync_full").build_finish(),
            sample_chunks=sample_chunks)
        t = tingest.ingest_chunks(
            ArrayEdgeSource(edges, N, chunk=24),
            tapi.SamplingSpec.parse("kout_afforest_k2").build(),
            tapi.VariantSpec.parse("uf_sync_full").build_finish(),
            sample_chunks=sample_chunks, **CPU)
        np.testing.assert_array_equal(t.labels.numpy(), np.asarray(j.labels))
        for f in ("n", "chunks", "streamed", "survivors", "spills",
                  "finish_rounds", "lmax_count", "survivor_cap",
                  "survivor_ratio"):
            assert getattr(t, f) == getattr(j, f), (sample_chunks, f)


def test_streamed_generators_match_jax():
    n, m, chunk = 1 << 10, 1 << 12, 300
    ci = tapi.ConnectIt(DETERMINISTIC[0], **CPU)
    for name in ("rmat_chunks", "powerlaw_chunks"):
        tsrc = getattr(tgen, name)(n, m, chunk=chunk, seed=5)
        jsrc = getattr(jgen, name)(n, m, chunk=chunk, seed=5)
        assert isinstance(tsrc, ChunkedEdgeSource)
        assert tsrc.num_chunks == jsrc.num_chunks
        got = list(tsrc.chunks())
        for a, b in zip(got, jsrc.chunks(), strict=True):
            assert a.dtype == np.int32
            np.testing.assert_array_equal(a, np.asarray(b))
        for a, b in zip(got, tsrc.chunks(), strict=True):
            np.testing.assert_array_equal(a, b)  # seekable: the same again
        one = ci.connectivity(build_graph(np.concatenate(got), n, **CPU))
        np.testing.assert_array_equal(ci.from_chunks(tsrc).numpy(),
                                      one.numpy())
    empty = tgen.rmat_chunks(8, 0, chunk=4)
    assert [c.shape for c in empty.chunks()] == [(0, 2)]
    with pytest.raises(ValueError, match="chunk"):
        tgen.powerlaw_chunks(8, 8, chunk=0)


def test_edge_file_roundtrip(tmp_path):
    """The port's file is byte for byte repro's, and reads back the same
    chunks through either package."""
    n, m = 1 << 9, 1 << 11
    src = tgen.rmat_chunks(n, m, chunk=177, seed=2)
    path = str(tmp_path / "edges.bin")
    jpath = str(tmp_path / "edges_jax.bin")
    assert write_edge_file(path, src) == m
    from repro.graphs import write_edge_file as j_write_edge_file
    assert j_write_edge_file(jpath, jgen.rmat_chunks(n, m, chunk=177,
                                                     seed=2)) == m
    assert open(path, "rb").read() == open(jpath, "rb").read()
    back = open_edge_file(path, n, chunk=333)
    ref = np.concatenate(list(src.chunks()))
    np.testing.assert_array_equal(np.concatenate(list(back.chunks())), ref)
    ci = tapi.ConnectIt("none+uf_sync_full", **CPU)
    one = ci.connectivity(build_graph(ref, n, **CPU))
    np.testing.assert_array_equal(ci.from_chunks(back).numpy(), one.numpy())
    odd = tmp_path / "odd.bin"
    odd.write_bytes(np.arange(3, dtype=np.int32).tobytes())
    with pytest.raises(ValueError, match="odd"):
        open_edge_file(str(odd), 4)


# ---------------------------------------------------------------------------
# Compressed edge blocks.
# ---------------------------------------------------------------------------

_FIELDS = ("ds", "dr", "first_s", "first_r", "block_len", "exc_s_pos",
           "exc_s_val", "exc_s_start", "exc_r_pos", "exc_r_val",
           "exc_r_start")


def _exception_edges():
    # receiver deltas past int16 and sender deltas past uint8 in one graph
    n = 1 << 20
    return n, np.array([[0, 5], [0, n - 2], [0, 7], [512, 3], [512, n - 1],
                        [n - 3, 1]], dtype=np.int64)


def _shapes():
    rng = np.random.default_rng(100 + 400)
    yield "small_blocks", 100, rng.integers(0, 100, size=(400, 2)), 16, {}
    rng = np.random.default_rng(70000 + 12)
    yield "past_int16", 70000, rng.integers(0, 70000, size=(12, 2)), 8, {}
    n, e = _exception_edges()
    yield "exceptions", n, e, 8, {}
    rng = np.random.default_rng(5)
    yield ("symmetrized", 300, rng.integers(0, 300, size=(900, 2)), 64,
           dict(symmetrize=True))
    yield "empty", 7, np.zeros((0, 2), np.int64), 8, {}


SHAPES = {name: rest for name, *rest in _shapes()}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_compress_edges_matches_jax(name):
    """Every array byte for byte repro's; every block decodes to repro's
    decode; chunks are the sorted, deduped edges."""
    n, edges, block, kw = SHAPES[name]
    j = j_compress_edges(edges, n, block_size=block, **kw)
    t = compress_edges(edges, n, block_size=block, **kw, **CPU)
    assert (t.n, t.m, t.block_size, t.num_blocks, t.nbytes) == (
        j.n, j.m, j.block_size, j.num_blocks, j.nbytes)
    assert t.ratio == j.ratio
    for f in _FIELDS:
        a, b = getattr(t, f), getattr(j, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    for i in range(t.num_blocks):
        for a, b in zip(t.decode_block(i), j.decode_block(i), strict=True):
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ref = sort_dedup_edges(edges, n, symmetrize=kw.get("symmetrize", False),
                           **CPU).numpy()
    dec = np.concatenate([c.numpy() for c in t.chunks()])
    np.testing.assert_array_equal(dec, ref)
    if name == "exceptions":
        assert len(t.exc_r_val) > 0 and len(t.exc_s_val) > 0


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_blocks_from_jax_fields_decode_as_jax(name):
    """The port's CompressedEdgeBlocks built from repro's numpy fields
    decodes every block as repro does."""
    n, edges, block, kw = SHAPES[name]
    j = j_compress_edges(edges, n, block_size=block, **kw)
    t = CompressedEdgeBlocks(n=j.n, m=j.m, block_size=j.block_size,
                             **{f: getattr(j, f) for f in _FIELDS}, **CPU)
    for a, b in zip(t.chunks(), j.chunks(), strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_compressed_graph_and_blocks_as_ingest_source(monkeypatch):
    n, m = 600, 2400
    rng = np.random.default_rng(0)
    edges = rng.integers(0, n, size=(m, 2), dtype=np.int64)
    g = build_graph(edges, n, **CPU)
    cg = compress_graph(g, block_size=1 << 10)
    jg = j_build_graph(edges, n)
    from repro.graphs import compress_graph as j_compress_graph
    jc = j_compress_graph(jg, block_size=1 << 10)
    for f in _FIELDS:
        assert getattr(cg, f).tobytes() == getattr(jc, f).tobytes(), f
    c = compress_edges(edges, n, block_size=256, **CPU)
    ci = tapi.ConnectIt("none+uf_sync_full", **CPU)
    one = ci.connectivity(g).numpy()
    np.testing.assert_array_equal(ci.from_chunks(c).numpy(), one)
    want = japi.ConnectIt("none+uf_sync_full").from_chunks(
        j_compress_edges(edges, n, block_size=256), return_stats=True)
    _, ts = ci.from_chunks(c, return_stats=True)
    for f in STATS_FIELDS:
        assert getattr(ts, f) == getattr(want[1], f), f


def test_compress_rejects_tiny_blocks():
    with pytest.raises(ValueError, match="block_size"):
        compress_edges(np.zeros((1, 2)), 4, block_size=1, **CPU)


def test_sort_dedup_takes_a_tensor_as_numpy():
    rng = np.random.default_rng(9)
    e = rng.integers(0, 50, size=(300, 2))
    for kw in (dict(), dict(symmetrize=False), dict(dedup=False)):
        np.testing.assert_array_equal(
            sort_dedup_edges(torch.from_numpy(e), 50, **kw, **CPU).numpy(),
            sort_dedup_edges(e, 50, **kw, **CPU).numpy())
    with pytest.raises(ValueError, match="int32"):
        sort_dedup_edges(torch.tensor([[0, 1 << 33]]), 8, **CPU)


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("variant", DETERMINISTIC)
def test_ingest_on_card_matches_cpu(cuda, variant):
    """Labels and every counter of the card's run equal the CPU path's,
    from a numpy source and from compressed blocks decoded on the card."""
    edges = np.random.default_rng(4).integers(0, 3000, size=(20000, 2))
    for cap in (None, 1 << 12):
        want = tapi.ConnectIt(variant, **CPU).from_chunks(
            ArrayEdgeSource(edges, 3000, chunk=1000), survivor_cap=cap,
            return_stats=True)
        got = tapi.ConnectIt(variant, device="cuda").from_chunks(
            ArrayEdgeSource(edges, 3000, chunk=1000), survivor_cap=cap,
            return_stats=True)
        assert got[0].device.type == "cuda"
        assert torch.equal(got[0].cpu(), want[0])
        for f in STATS_FIELDS:
            assert getattr(got[1], f) == getattr(want[1], f), (cap, f)
    blocks = compress_edges(edges, 3000, block_size=1 << 10, device="cuda")
    assert all(c.device.type == "cuda" for c in blocks.chunks())
    got = tapi.ConnectIt(variant, device="cuda").from_chunks(blocks)
    want = tapi.ConnectIt(variant, **CPU).from_chunks(
        compress_edges(edges, 3000, block_size=1 << 10, **CPU))
    assert torch.equal(got.cpu(), want)
