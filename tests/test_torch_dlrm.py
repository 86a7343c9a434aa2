"""The port's DLRM serving path against the JAX package.

The reference's ``init_dlrm`` weights are carried into the port by
``dlrm_from_jax``; inputs are made with numpy from a seed and handed to
both packages. Logits, probabilities and the loss are held within rtol and
atol 1e-5 (float32 matrix products summed in another order), retrieval's
top-k indices exactly and its scores within 1e-5.

Tests marked ``gpu`` hold the kernel path against the plain path on the
card; they skip without one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RECSYS_SHAPES as J_RECSYS_SHAPES
from repro.configs.legacy.dlrm_rm2 import MODEL as J_RM2
from repro.legacy.models import dlrm as jdlrm
from repro_torch.configs import all_archs, get_arch
from repro_torch.kernels import ops
from repro_torch.kernels.legacy.embedding_bag.ref import embedding_bag_ref
from repro_torch.launch.steps import build_cell, retrieve, serve_step, \
    train_step
from repro_torch.legacy.data import RecsysStream
from repro_torch.legacy.models import dlrm as tdlrm

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = get_arch("dlrm-rm2")
# the registry's smoke config, and tests/test_models.py's multi-hot one
CONFIGS = {
    "rm2_smoke": dataclasses.replace(ARCH.model, **ARCH.smoke),
    "multi_hot2": tdlrm.DLRMConfig(
        name="dlrm", vocab_sizes=(500,) * 26, multi_hot=2,
        bot_mlp=(32, 16, 8), embed_dim=8, top_mlp=(32, 16, 1)),
}


def _jax_cfg(cfg: tdlrm.DLRMConfig) -> jdlrm.DLRMConfig:
    return jdlrm.DLRMConfig(**dataclasses.asdict(cfg))


# jitted once per config: the reference run op by op takes seconds
_j_init = jax.jit(jdlrm.init_dlrm, static_argnums=1)
_j_forward = jax.jit(jdlrm.dlrm_forward, static_argnums=3)
_j_loss = jax.jit(jdlrm.dlrm_loss, static_argnums=4)
_j_retrieval = jax.jit(jdlrm.retrieval_score, static_argnums=4,
                       static_argnames="top_k")


def test_registry_matches_jax():
    # the LM and GNN archs are ported too (tests/test_torch_lm_cells.py and
    # tests/test_torch_gnn_cells.py hold their configs against the
    # reference's): every arch id of the reference, in its order
    assert all_archs() == ["h2o-danube-3-4b", "qwen3-4b", "stablelm-3b",
                           "deepseek-moe-16b", "granite-moe-3b-a800m",
                           "pna", "egnn", "gin-tu", "nequip",
                           "dlrm-rm2", "connectit"]
    assert ARCH.family == "recsys"
    assert dataclasses.asdict(ARCH.model) == dataclasses.asdict(J_RM2)
    assert ARCH.shapes == J_RECSYS_SHAPES
    assert ARCH.smoke == dict(vocab_sizes=(1000,) * 26, bot_mlp=(32, 16, 8),
                              embed_dim=8, top_mlp=(32, 16, 1))
    assert get_arch("qwen3-4b").family == "lm"
    assert get_arch("gin-tu").family == "gnn"
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("gin")


def test_interaction_order_is_jnp_tril_indices():
    iu, ju = np.tril_indices(27, k=-1)
    t = torch.tril_indices(27, 27, offset=-1)
    np.testing.assert_array_equal(t[0].numpy(), iu)
    np.testing.assert_array_equal(t[1].numpy(), ju)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_dlrm_matches_jax(name):
    cfg = CONFIGS[name]
    jcfg = _jax_cfg(cfg)
    params = _j_init(jax.random.PRNGKey(9), jcfg)
    model = tdlrm.dlrm_from_jax(jax.tree.map(np.asarray, params), cfg,
                                device="cpu")
    rng = np.random.default_rng(10)
    B, V = 16, cfg.vocab_sizes[0]
    dense = rng.normal(size=(B, cfg.n_dense)).astype(np.float32)
    sparse = rng.integers(0, V, (B, cfg.n_sparse, cfg.multi_hot)
                          ).astype(np.int32)
    y = (rng.random(B) < 0.3).astype(np.int32)
    cand = rng.normal(size=(1000, cfg.embed_dim)).astype(np.float32)
    jd, js = jnp.asarray(dense), jnp.asarray(sparse)
    td, ts = torch.from_numpy(dense), torch.from_numpy(sparse)

    before = ops.launch_counts()
    logits = model(td, ts)
    want = np.asarray(_j_forward(params, jd, js, jcfg))
    assert logits.shape == (B,) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), want, **TOL)
    np.testing.assert_allclose(serve_step(model, td, ts).numpy(),
                               np.asarray(jax.nn.sigmoid(want)), **TOL)
    np.testing.assert_allclose(
        float(model.loss(td, ts, torch.from_numpy(y))),
        float(_j_loss(params, jd, js, jnp.asarray(y), jcfg)), **TOL)
    vals, idx = retrieve(model, td[:1], ts[:1], torch.from_numpy(cand),
                         top_k=7)
    jvals, jidx = _j_retrieval(params, jd[:1], js[:1], jnp.asarray(cand),
                               jcfg, top_k=7)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), **TOL)
    # CPU tensors take the plain version: no kernel launched
    assert ops.launch_counts() == before


def test_id_past_the_table_is_nan_in_repro_and_clamped_in_the_port():
    """By design (ROADMAP Queue 3): one id equal to ``table_rows(v)`` in
    one table turns ``repro``'s logits to NaN (its bags are ``jnp.take``,
    whose default mode fills out-of-range rows with NaN); the port follows
    the Pallas kernel's clamp contract
    (``src/repro/kernels/legacy/embedding_bag/kernel.py:47``) and reads
    the table's last row, as the id ``table_rows(v) - 1`` does."""
    cfg = CONFIGS["rm2_smoke"]
    jcfg = _jax_cfg(cfg)
    params = _j_init(jax.random.PRNGKey(9), jcfg)
    model = tdlrm.dlrm_from_jax(jax.tree.map(np.asarray, params), cfg,
                                device="cpu")
    rng = np.random.default_rng(11)
    dense = rng.normal(size=(1, cfg.n_dense)).astype(np.float32)
    sparse = rng.integers(0, cfg.vocab_sizes[0],
                          (1, cfg.n_sparse, cfg.multi_hot)).astype(np.int32)
    rows = tdlrm.table_rows(cfg.vocab_sizes[3])
    past, last = sparse.copy(), sparse.copy()
    past[0, 3, 0], last[0, 3, 0] = rows, rows - 1
    want = np.asarray(_j_forward(params, jnp.asarray(dense),
                                 jnp.asarray(past), jcfg))
    assert np.isnan(want).all()
    assert np.isfinite(np.asarray(_j_forward(
        params, jnp.asarray(dense), jnp.asarray(last), jcfg))).all()
    with torch.no_grad():
        got = model(torch.from_numpy(dense), torch.from_numpy(past))
        clamped = model(torch.from_numpy(dense), torch.from_numpy(last))
    assert torch.isfinite(got).all()
    assert torch.equal(got, clamped)


def test_init_dlrm_pads_tables_with_zero_rows():
    assert tdlrm.table_rows(1_000_000) == 1_000_448
    assert [tdlrm.table_rows(v) for v in (511, 512, 1000)] == [512, 1024,
                                                                 1024]
    cfg = dataclasses.replace(CONFIGS["rm2_smoke"],
                              vocab_sizes=(511, 512) * 13)
    models = [tdlrm.init_dlrm(cfg, device="cpu",
                              generator=torch.Generator().manual_seed(3))
              for _ in range(2)]
    for t, v in zip(models[0].tables, cfg.vocab_sizes):
        assert t.shape == (tdlrm.table_rows(v), cfg.embed_dim)
        assert not t[v:].any() and t[:v].abs().min() > 0
    # the same seed gives the same weights, and every one takes a gradient
    for a, b in zip(models[0].parameters(), models[1].parameters()):
        assert torch.equal(a, b) and a.requires_grad
    with pytest.raises(ValueError, match="table of shape"):
        tdlrm.DLRM(cfg, [t[:-1] for t in models[0].tables], models[0].bot,
                   models[0].top)


@pytest.mark.parametrize("shape", ["serve_p99", "serve_bulk",
                                   "retrieval_cand"])
def test_cell_shapes_and_flops_match_jax(shape):
    """The reference's ``_dlrm_cell`` meta (repro/launch/steps.py),
    computed here by hand from the JAX config, with no mesh."""
    spec = J_RECSYS_SHAPES[shape]
    B = spec["batch"]
    if spec["kind"] == "serve":
        mlp = sum(a * b for a, b in zip((J_RM2.n_dense,) + J_RM2.bot_mlp[:-1],
                                        J_RM2.bot_mlp))
        mlp += sum(a * b for a, b in zip(
            (J_RM2.n_interactions + J_RM2.embed_dim,) + J_RM2.top_mlp[:-1],
            J_RM2.top_mlp))
        want_meta = dict(model_flops=2 * B * mlp, batch=B)
        want_shapes = [(B, 13), (B, 26, 1)]
        want_fn = serve_step
    else:
        want_meta = dict(model_flops=2 * spec["n_candidates"] * 64, batch=1)
        want_shapes = [(1, 13), (1, 26, 1), (spec["n_candidates"], 64)]
        want_fn = retrieve
    cell = build_cell(ARCH, shape)
    assert (cell.arch, cell.shape, cell.fn) == ("dlrm-rm2", shape, want_fn)
    assert cell.meta == want_meta
    assert [tuple(a.shape) for a in cell.args] == want_shapes
    assert all(a.device.type == "meta" for a in cell.args)
    assert [a.dtype for a in cell.args][:2] == [torch.float32, torch.int32]


def test_train_cell_is_not_ported_yet():
    """The train cell is built: the reference's ``_dlrm_cell`` meta and
    input shapes for ``train_batch``, the model and optimizer state donated
    (updated in place); an unknown shape still raises."""
    spec = J_RECSYS_SHAPES["train_batch"]
    B = spec["batch"]
    serve = build_cell(ARCH, "serve_bulk")
    cell = build_cell(ARCH, "train_batch")
    assert (cell.arch, cell.shape, cell.fn) == ("dlrm-rm2", "train_batch",
                                                train_step)
    assert cell.donate == (0, 1)
    assert cell.meta == dict(model_flops=serve.meta["model_flops"] * B
                             // serve.meta["batch"], batch=B)
    assert [tuple(a.shape) for a in cell.args] == [(B, 13), (B, 26, 1), (B,)]
    assert [a.dtype for a in cell.args] == [torch.float32, torch.int32,
                                            torch.int32]
    assert all(a.device.type == "meta" for a in cell.args)
    with pytest.raises(KeyError, match="no shape"):
        build_cell(ARCH, "decode_32k")


def test_recsys_stream_follows_the_recipe():
    stream = RecsysStream(batch=4096, n_dense=13, n_sparse=26, vocab=1000,
                          multi_hot=2, seed=5)
    b0 = stream.batch_at(0, device="cpu")
    assert b0["dense"].shape == (4096, 13) and b0["dense"].dtype == torch.float32
    assert b0["sparse"].shape == (4096, 26, 2)
    assert b0["sparse"].dtype == torch.int32
    assert b0["labels"].shape == (4096,) and b0["labels"].dtype == torch.int32
    ids = b0["sparse"]
    assert int(ids.min()) >= 0 and int(ids.max()) <= 999
    # zipfian: the smallest ids are the most frequent
    counts = torch.bincount(ids.flatten().long(), minlength=1000)
    assert counts[:10].sum() > counts[-500:].sum()
    assert set(b0["labels"].unique().tolist()) == {0, 1}
    again = stream.batch_at(0, device="cpu")
    assert all(torch.equal(b0[k], again[k]) for k in b0)
    assert not torch.equal(b0["dense"], stream.batch_at(1, device="cpu")
                           ["dense"])


# ---------------------------------------------------------------------------
# On the card: the kernel path against the plain path, same weights.
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("multi_hot", [1, 3])
def test_dlrm_kernel_path_matches_plain_on_card(cuda, multi_hot, monkeypatch):
    cfg = dataclasses.replace(CONFIGS["rm2_smoke"], multi_hot=multi_hot)
    model = tdlrm.init_dlrm(cfg, device=cuda,
                            generator=torch.Generator(cuda).manual_seed(0))
    batch = RecsysStream(batch=1000, n_dense=13, n_sparse=26, vocab=1000,
                         multi_hot=multi_hot).batch_at(0, device=cuda)
    before = ops.KERNELS["embedding_bag"].launches
    got = serve_step(model, batch["dense"], batch["sparse"])
    # one launch for the 26 tables
    assert ops.KERNELS["embedding_bag"].launches == before + 1
    monkeypatch.setattr(tdlrm, "embedding_bags",
                        lambda tables, idx, mode="sum": [
                            embedding_bag_ref(t, i, mode)
                            for t, i in zip(tables, idx)])
    want = serve_step(model, batch["dense"], batch["sparse"])
    if multi_hot == 1:  # a one-row bag is a copy: equal to the bit
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
