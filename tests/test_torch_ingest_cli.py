"""The port's ingest CLI (``repro_torch.launch.ingest``), its edge stream
and its checkpoints against the JAX package's.

  * ``run_ingest`` (n = 2^12, 2^14 edges, batches of 2^12, as
    ``tests/test_system.py`` runs the reference) and ``run_chunked`` end in
    ``repro``'s final labels; the query pairs are drawn differently
    (``torch.Generator`` per step, ROADMAP Queue 3) and change no label;
  * a checkpointed run stopped after a few batches and resumed from its
    latest checkpoint ends in the uninterrupted run's labels;
  * checkpoints cross between the packages in both directions (the
    reference's on-disk layout), retention keeps the newest ``keep``;
  * ``EdgeStream.batch_at`` equals ``repro``'s, padding included;
  * the CLI (``main``) exits 0 and writes the labels it ran to;
  * ``gpu``-marked: ``run_ingest`` and ``run_chunked`` on the card equal
    the CPU run.
"""

import os
from typing import NamedTuple

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import streaming as jstreaming
from repro.launch import ingest as jingest
from repro.legacy import checkpoint as jckpt
from repro.legacy.data import EdgeStream as JEdgeStream

from repro_torch.core import streaming as tstreaming
from repro_torch.launch import ingest as tingest
from repro_torch.legacy import checkpoint as tckpt
from repro_torch.legacy.data import EdgeStream

N, EDGES, BATCH = 1 << 12, 1 << 14, 1 << 12
CPU = dict(device="cpu", verbose=False)


@pytest.fixture(scope="module")
def uninterrupted() -> np.ndarray:
    """The port's labels of the checkpoint cases' stream (2^10 batches)."""
    _, st = tingest.run_ingest(N, EDGES, 1 << 10, **CPU)
    return st.P.numpy()


@pytest.mark.parametrize("finish,graph", [
    ("uf_sync_full", "rmat"), ("liu_tarjan_CRFA", "rmat"),
    ("uf_sync", "ba"), ("label_prop", "rmat")])
def test_run_ingest_matches_repro(finish, graph):
    _, want = jingest.run_ingest(N, EDGES, BATCH, finish, graph,
                                 verbose=False)
    _, got = tingest.run_ingest(N, EDGES, BATCH, finish, graph,
                                query_frac=0.25, **CPU)
    np.testing.assert_array_equal(got.P.numpy(), np.asarray(want.P))


@pytest.mark.parametrize("graph", ["rmat", "powerlaw"])
def test_run_chunked_matches_repro(graph):
    _, want = jingest.run_chunked(N, EDGES, BATCH, graph=graph, seed=3,
                                  verbose=False)
    _, got = tingest.run_chunked(N, EDGES, BATCH, graph=graph, seed=3, **CPU)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_stopped_and_resumed_run_equals_uninterrupted(tmp_path,
                                                       uninterrupted):
    d = str(tmp_path / "ckpt")
    # 13 batches: checkpoints at steps 8 only (every 8); the rest is lost
    _, st = tingest.run_ingest(N, EDGES, 1 << 10, ckpt_dir=d, max_steps=13,
                               **CPU)
    assert tckpt.latest_step(d) == 8
    assert not np.array_equal(st.P.numpy(), uninterrupted)
    _, st = tingest.run_ingest(N, EDGES, 1 << 10, ckpt_dir=d, **CPU)
    np.testing.assert_array_equal(st.P.numpy(), uninterrupted)
    # the resumed run saved every 8th step; the last three are kept
    last = tckpt.latest_step(d)
    assert last > 8 and last % 8 == 0
    assert sorted(f for f in os.listdir(d) if f.endswith(".npz")) == [
        f"ckpt_{s:010d}.npz" for s in range(max(8, last - 16), last + 1, 8)]


def test_resume_from_a_repro_checkpoint(tmp_path, uninterrupted):
    """The reference's run stopped at step 16 (its labels saved with its
    own ``save``) resumes in the port to the same labels."""
    g = jingest.gen.rmat(N, EDGES, seed=0)
    s, r = np.asarray(g.senders)[: g.m], np.asarray(g.receivers)[: g.m]
    perm = np.random.default_rng(0).permutation(g.m)
    stream = JEdgeStream(s[perm], r[perm], 1 << 10, g.n)
    state = jstreaming.init_stream(g.n)
    fn = jingest.resolve_finish("uf_sync_full")
    q = jnp.zeros((1,), jnp.int32)
    for step in range(16):
        b = stream.batch_at(step)
        state, _ = jstreaming.process_batch_fn(state, b["u"], b["v"], q, q,
                                               fn)
    d = str(tmp_path / "ckpt")
    jckpt.save(d, (state,), step=16)
    _, st = tingest.run_ingest(N, EDGES, 1 << 10, ckpt_dir=d, **CPU)
    np.testing.assert_array_equal(st.P.numpy(), uninterrupted)


class _State(NamedTuple):
    P: torch.Tensor
    n: torch.Tensor


def test_checkpoints_cross_both_ways(tmp_path):
    tree = {"b": (np.arange(5, dtype=np.int32), np.float32([1.5, 2.5])),
            "a": np.int64([7])}
    jckpt.save(str(tmp_path / "j"), {k: (tuple(map(jnp.asarray, v))
                                         if isinstance(v, tuple)
                                         else jnp.asarray(v))
                                     for k, v in tree.items()}, step=3)
    like = {"a": torch.zeros(1, dtype=torch.int64),
            "b": (torch.zeros(5, dtype=torch.int32), torch.zeros(2))}
    got, step = tckpt.restore(str(tmp_path / "j"), like)
    assert step == 3 and isinstance(got["b"], tuple)
    np.testing.assert_array_equal(got["a"].numpy(), tree["a"])
    np.testing.assert_array_equal(got["b"][0].numpy(), tree["b"][0])
    np.testing.assert_array_equal(got["b"][1].numpy(), tree["b"][1])
    # the port's file restores in the reference; a NamedTuple keeps its type
    st = _State(torch.arange(4, dtype=torch.int32), torch.tensor([9]))
    tckpt.save(str(tmp_path / "t"), [st], step=5)
    back, _ = tckpt.restore(str(tmp_path / "t"), [st], device="cpu")
    assert isinstance(back[0], _State) and torch.equal(back[0].P, st.P)
    jback, jstep = jckpt.restore(str(tmp_path / "t"), [(jnp.zeros(4),
                                                       jnp.zeros(1))])
    assert jstep == 5
    np.testing.assert_array_equal(np.asarray(jback[0][0]), st.P.numpy())
    with pytest.raises(ValueError, match="leaves"):
        tckpt.restore(str(tmp_path / "t"), [st.P])


def test_manager_saves_every_n_and_keeps_k(tmp_path):
    m = tckpt.CheckpointManager(str(tmp_path), every=2, keep=2)
    x = (torch.zeros(3),)
    assert m.resume_or(x) == (x, 0)
    saved = [m.maybe_save((torch.full((3,), float(s)),), s)
             for s in range(1, 8)]
    assert [p is not None for p in saved] == [False, True, False, True,
                                              False, True, False]
    assert tckpt.latest_step(str(tmp_path)) == 6
    (y,), step = m.resume_or(x)
    assert step == 6 and torch.equal(y, torch.full((3,), 6.0))
    assert len([f for f in os.listdir(tmp_path) if f.endswith(".npz")]) == 2
    assert m.maybe_save(x, 7, force=True) is not None


@pytest.mark.parametrize("step", [0, 1, 4])
def test_edge_stream_matches_repro(step):
    rng = np.random.default_rng(step)
    s = rng.integers(0, 50, 37).astype(np.int32)
    r = rng.integers(0, 50, 37).astype(np.int32)
    want = JEdgeStream(s, r, 8, 50, seed=1).batch_at(step)
    stream = EdgeStream(s, r, 8, 50, seed=1, device="cpu")
    got = stream.batch_at(step)
    assert stream.num_batches() == 5
    for k in ("u", "v"):
        assert got[k].dtype == torch.int32 and got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_cli_runs_and_resumes(tmp_path, uninterrupted):
    base = ["--device", "cpu", "--n", str(N), "--edges", str(EDGES),
            "--batch", str(1 << 10)]
    d = str(tmp_path / "ckpt")
    assert tingest.main(base + ["--ckpt-dir", d, "--max-steps", "20"]) == 0
    assert tckpt.latest_step(d) == 16
    out = tmp_path / "labels.npy"
    assert tingest.main(base + ["--ckpt-dir", d, "--out", str(out)]) == 0
    np.testing.assert_array_equal(np.load(out), uninterrupted[:N])
    out = tmp_path / "chunked.npy"
    assert tingest.main(["--device", "cpu", "--chunked", "--n", str(N),
                         "--edges", str(EDGES), "--batch", str(BATCH),
                         "--out", str(out)]) == 0
    _, want = jingest.run_chunked(N, EDGES, BATCH, verbose=False)
    np.testing.assert_array_equal(np.load(out), np.asarray(want))
    with pytest.raises(SystemExit):
        tingest.main(["--chunked", "--graph", "ba"])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_ingest_on_card_matches_cpu(cuda):
    _, want = tingest.run_ingest(N, EDGES, BATCH, **CPU)
    _, got = tingest.run_ingest(N, EDGES, BATCH, device="cuda", verbose=False)
    assert torch.equal(got.P.cpu(), want.P)
    _, want = tingest.run_chunked(N, EDGES, BATCH, **CPU)
    _, got = tingest.run_chunked(N, EDGES, BATCH, device="cuda",
                                 verbose=False)
    assert torch.equal(got, want)
