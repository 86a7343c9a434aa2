"""The port's DLRM training slice against the JAX package.

  * ``embedding_bag_backward_ref`` (the plain backward, the CPU route of
    the bag's autograd function) against ``jax.grad`` of ``repro``'s
    ``embedding_bag_ref`` for ``sum``, ``mean`` and ``max``, with ties, a
    hub row, the dump row and wrapped negative ids: equal bit for bit. Ids
    at or past ``rows`` (and below ``-rows``) pass their share to the row
    the forward reads (the clamp contract); ``jax.grad`` drops it;
  * every ``legacy.optim`` function against ``repro.legacy.optim``, within
    OPT_TOL (float32 sums of another order);
  * one ``train_step`` of the smoke DLRM from ``dlrm_from_jax`` weights:
    the loss, ``grad_norm``, ``lr`` and every parameter and moment after the
    step within STEP_TOL of ``repro``'s step;
  * ``launch.train``: 20 steps from ``PRNGKey(0)`` (the reference's weights
    and batches, drawn by ``repro_torch.random``) with losses within
    LOSS_TOL of ``repro``'s; a simulated failure resumed bit-exact against
    an uninterrupted run (two processes); a checkpoint ``repro`` wrote,
    resumed by the port and run on to ``repro``'s end;
  * ``gpu``-marked: the CUDA backward against the plain version, the same
    bits on two runs, and one train step through the kernels (one grouped
    backward call for the 26 tables, ``tests/test_torch_bags.py``) against
    the plain versions.
"""

import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.kernels.legacy.embedding_bag.ref import embedding_bag_ref as j_bag
from repro.launch import train as jtrain
from repro.legacy import checkpoint as jckpt
from repro.legacy import optim as joptim
from repro.legacy.models import dlrm as jdlrm
from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.kernels.legacy import embedding_bag, embedding_bag_backward
from repro_torch.kernels.legacy.embedding_bag.ref import (
    embedding_bag_backward_ref,
    embedding_bag_ref,
)
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.legacy import checkpoint as tckpt
from repro_torch.legacy import optim as toptim
from repro_torch.legacy.models import dlrm as tdlrm

REPO = Path(__file__).resolve().parents[1]
OPT_TOL = dict(rtol=1e-6, atol=1e-6)
# one step: the gradients are float32 sums in another order (matmul
# reductions, the bag's index_add_), and AdamW's first step divides each by
# its own magnitude
STEP_TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
RNG = np.random.default_rng(11)
ARCH = get_arch("dlrm-rm2")
SMOKE = dataclasses.replace(ARCH.model, **ARCH.smoke)
J_SMOKE = jdlrm.DLRMConfig(**dataclasses.asdict(SMOKE))


@pytest.fixture(autouse=True)
def _clear_jax_caches():
    """Shadow conftest's per-test cache clearing: the reference's training
    program is compiled once for the module."""
    yield


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_once():
    yield
    jax.clear_caches()


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _leaves(tree) -> list:
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


# ---------------------------------------------------------------------------
# The bag's backward.
# ---------------------------------------------------------------------------

def _bag_case(rows, D, B, L, *, hub=0.0, ties=False, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(rows, D)).astype(np.float32)
    if ties:  # rows that tie with each other on every column, and rounding
        table[3] = table[5]
        table = np.round(table, 1)
    idx = rng.integers(-rows, rows, size=(B, L)).astype(np.int32)
    idx[rng.random(B) < hub, 0] = 0
    idx[0, :] = rows - 1           # a bag of dump rows only
    idx[1, 0], idx[1, -1] = 5, 5   # a row twice in one bag
    grad_out = rng.normal(size=(B, D)).astype(np.float32)
    return table, idx, grad_out


BAG_CASES = {
    "multi_hot": dict(rows=17, D=8, B=40, L=3, ties=True),
    "one_hot_hub": dict(rows=64, D=16, B=200, L=1, hub=0.3),
    "long_bags": dict(rows=9, D=4, B=30, L=6, ties=True, hub=0.5),
}


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("case", sorted(BAG_CASES))
def test_plain_backward_is_jax_grad(case, mode):
    table, idx, grad_out = _bag_case(**BAG_CASES[case])
    want = jax.grad(lambda t: jnp.vdot(
        j_bag(t, jnp.asarray(idx), mode), jnp.asarray(grad_out)))(
        jnp.asarray(table))
    got = embedding_bag_backward_ref(_t(table), _t(idx), _t(grad_out), mode)
    assert got.shape == table.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the bag's autograd function takes it on the CPU
    t = _t(table).requires_grad_(True)
    before = ops.launch_counts()
    out = embedding_bag(t, _t(idx), mode=mode)
    out.backward(_t(grad_out))
    assert torch.equal(t.grad, got)
    assert ops.launch_counts() == before
    assert torch.equal(embedding_bag_backward(_t(table), _t(idx),
                                              _t(grad_out), mode=mode), got)


def test_ids_past_the_table_follow_the_clamp_contract():
    """The smallest input where the two differ: rows = 2, one bag of one id
    2 (past the table). The forward reads the clamped row 1 in both
    packages; the port's backward passes the share to row 1, the gradient
    of what its forward computed, where ``jax.grad``'s scatter drops it."""
    table = np.float32([[1.0], [2.0]])
    idx = np.int32([[2]])
    g = np.float32([[1.0]])
    got = embedding_bag_backward_ref(_t(table), _t(idx), _t(g), "sum")
    np.testing.assert_array_equal(got.numpy(), [[0.0], [1.0]])
    want = jax.grad(lambda t: jnp.vdot(j_bag(t, jnp.asarray(idx), "sum"),
                                       jnp.asarray(g)))(jnp.asarray(table))
    np.testing.assert_array_equal(np.asarray(want), [[0.0], [0.0]])
    # below -rows: the forward clamps to row 0, and so does the backward
    got = embedding_bag_backward_ref(_t(table), _t(np.int32([[-3]])), _t(g),
                                     "sum")
    np.testing.assert_array_equal(got.numpy(), [[1.0], [0.0]])


def test_backward_wrapper_refuses_what_it_cannot_take():
    fn = ops.KERNELS["embedding_bag_backward"]
    before = fn.launches
    table = torch.zeros(10, 4)
    idx = torch.zeros(3, 2, dtype=torch.int32)
    g = torch.zeros(3, 4)
    with pytest.raises(TypeError, match="table"):
        fn(table.to(torch.bfloat16), idx, g)
    with pytest.raises(ValueError, match="CUDA device"):
        fn(table, idx, g)              # right types, but on the CPU
    with pytest.raises(ValueError, match="unknown embedding_bag mode"):
        embedding_bag_backward(table, idx, g, mode="min")
    assert fn.launches == before


# ---------------------------------------------------------------------------
# The optimizer.
# ---------------------------------------------------------------------------

def _tree(seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"tables": [rng.normal(size=(6, 4)).astype(np.float32) * scale
                       for _ in range(2)],
            "bot": {"w0": rng.normal(size=(3, 4)).astype(np.float32) * scale,
                    "b0": rng.normal(size=(4,)).astype(np.float32) * scale}}


def _jtree(t):
    return jax.tree.map(jnp.asarray, t)


def _ttree(t):
    return toptim.tree_map(lambda x: torch.from_numpy(np.array(x)), t)


def _close_trees(got, want, **tol):
    g, w = toptim.tree_leaves(got), _leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a.detach().numpy(), b, **tol)


CONFIGS = {
    "default": joptim.OptimizerConfig(),
    "linear": joptim.OptimizerConfig(schedule="linear", warmup_steps=3,
                                     total_steps=20),
    "constant_sgd": joptim.OptimizerConfig(name="sgd", schedule="constant",
                                           lr=0.1, grad_clip=0.5),
}


def _tcfg(cfg):
    return toptim.OptimizerConfig(**dataclasses.asdict(cfg))


def test_optimizer_config_defaults_match_repro():
    assert dataclasses.asdict(toptim.OptimizerConfig()) == \
        dataclasses.asdict(joptim.OptimizerConfig())
    assert dataclasses.asdict(tsteps.OPT) == \
        dataclasses.asdict(joptim.OptimizerConfig())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_schedule_lr_matches_repro(name):
    cfg = CONFIGS[name]
    for step in (0, 1, 2, 5, 50, 99, 100, 101, 500, 9999, 10_000, 20_000):
        want = float(joptim.schedule_lr(cfg, jnp.int32(step)))
        got = toptim.schedule_lr(_tcfg(cfg), torch.tensor(step,
                                                          dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, **OPT_TOL)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_repro(max_norm):
    grads = _tree(1, scale=3.0)
    want, wn = joptim.clip_by_global_norm(_jtree(grads), max_norm)
    got, gn = toptim.clip_by_global_norm(_ttree(grads), max_norm)
    np.testing.assert_allclose(float(gn), float(wn), **OPT_TOL)
    _close_trees(got, want, **OPT_TOL)


def test_init_adam_matches_repro():
    params = _tree(2)
    want = joptim.init_adam(_jtree(params))
    got = toptim.init_adam(_ttree(params))
    assert got.step.dtype == torch.int32 and got.step.shape == ()
    assert int(got.step) == int(want.step) == 0
    _close_trees(got.mu, want.mu, rtol=0, atol=0)
    _close_trees(got.nu, want.nu, rtol=0, atol=0)
    # the checkpoint's leaf order is the reference's
    assert [x.shape for x in toptim.tree_leaves((_ttree(params), got))] == \
        [x.shape for x in _leaves((_jtree(params), want))]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_update_matches_repro_over_steps(name):
    cfg = CONFIGS[name]
    jp, tp = _jtree(_tree(3)), _ttree(_tree(3))
    js, ts = joptim.init_adam(jp), toptim.init_adam(tp)
    for step in range(4):
        grads = _tree(10 + step, scale=0.7)
        jp, js, jinfo = joptim.update(cfg, jp, _jtree(grads), js)
        tp2, ts, tinfo = toptim.update(_tcfg(cfg), tp, _ttree(grads), ts)
        assert tp2 is tp  # in place
        assert int(ts.step) == int(js.step) == step + 1
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tinfo[k]), float(jinfo[k]),
                                       **OPT_TOL)
        _close_trees(tp, jp, **OPT_TOL)
        _close_trees(ts.mu, js.mu, **OPT_TOL)
        _close_trees(ts.nu, js.nu, **OPT_TOL)
    with pytest.raises(ValueError):
        toptim.update(toptim.OptimizerConfig(name="lion"), tp,
                      _ttree(_tree(4)), ts)


def test_int8_compression_matches_repro():
    grads, errors = _tree(5, scale=2.0), _tree(6, scale=0.01)
    for g in (grads["bot"]["w0"], grads["tables"][0]):
        jq, js = joptim.compress_int8(jnp.asarray(g))
        tq, ts = toptim.compress_int8(_t(g))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_allclose(float(ts), float(js), rtol=1e-6)
        np.testing.assert_allclose(
            toptim.decompress_int8(tq, ts).numpy(),
            np.asarray(joptim.decompress_int8(jq, js)), **OPT_TOL)
    jqs, jerr = joptim.compressed_grads_with_feedback(_jtree(grads),
                                                      _jtree(errors))
    tqs, terr = toptim.compressed_grads_with_feedback(_ttree(grads),
                                                      _ttree(errors))
    _close_trees(terr, jerr, **OPT_TOL)
    assert len(_pairs(tqs)) == len(_pairs(jqs)) == 4
    for (tq, ts), (jq, js) in zip(_pairs(tqs), _pairs(jqs)):
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_allclose(float(ts), float(js), rtol=1e-6)


def _pairs(tree) -> list:
    """The ``(q, scale)`` pairs of a compressed pytree, in leaf order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _pairs(tree[k])]
    if isinstance(tree, list):
        return [p for t in tree for p in _pairs(t)]
    return [tree]


# ---------------------------------------------------------------------------
# One train step, the cell and the driver.
# ---------------------------------------------------------------------------

def _smoke_batch(B=48, seed=12):
    rng = np.random.default_rng(seed)
    V = SMOKE.vocab_sizes[0]
    return (rng.normal(size=(B, SMOKE.n_dense)).astype(np.float32),
            rng.integers(0, V, (B, SMOKE.n_sparse, SMOKE.multi_hot)
                         ).astype(np.int32),
            (rng.random(B) < 0.4).astype(np.int32))


def test_train_step_matches_repro():
    params = jax.jit(jdlrm.init_dlrm, static_argnums=1)(
        jax.random.PRNGKey(4), J_SMOKE)
    model = tdlrm.dlrm_from_jax(jax.tree.map(np.asarray, params), SMOKE,
                                device="cpu")
    dense, sparse, labels = _smoke_batch()

    @jax.jit
    def jstep(p, d, s, y):
        loss, grads = jax.value_and_grad(
            lambda q: jdlrm.dlrm_loss(q, d, s, y, J_SMOKE))(p)
        return (loss, *joptim.update(joptim.OptimizerConfig(), p, grads,
                                     joptim.init_adam(p)))

    loss, jp, js, jinfo = jstep(params, jnp.asarray(dense),
                                jnp.asarray(sparse), jnp.asarray(labels))

    cell = tsteps.build_cell(ARCH, "train_batch")
    tstate = toptim.init_adam(model.params())
    out_model, ts, info = cell.fn(model, tstate, _t(dense), _t(sparse),
                                  _t(labels))
    assert out_model is model and cell.donate == (0, 1)
    np.testing.assert_allclose(float(info["loss"]), float(loss), **STEP_TOL)
    for k in ("lr", "grad_norm"):
        np.testing.assert_allclose(float(info[k]), float(jinfo[k]),
                                   **STEP_TOL)
    assert int(ts.step) == 1
    _close_trees(model.params(), jp, **STEP_TOL)
    _close_trees(ts.mu, js.mu, **STEP_TOL)
    _close_trees(ts.nu, js.nu, **STEP_TOL)


def test_init_dlrm_from_a_key_is_the_references():
    cfg = dataclasses.replace(SMOKE, vocab_sizes=(300, 700) * 13)
    want = jax.jit(jdlrm.init_dlrm, static_argnums=1)(
        jax.random.PRNGKey(8), jdlrm.DLRMConfig(**dataclasses.asdict(cfg)))
    from repro_torch import random as trandom
    model = tdlrm.init_dlrm(cfg, key=trandom.PRNGKey(8, device="cpu"))
    got = toptim.tree_leaves(model.params())
    assert [tuple(x.shape) for x in got] == [x.shape for x in _leaves(want)]
    for a, b in zip(got, _leaves(want)):
        # normal's draws within their ulps (tests/test_torch_random.py)
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=1e-6,
                                   atol=1e-7)
    with pytest.raises(ValueError, match="one of key= and generator="):
        tdlrm.init_dlrm(cfg, device="cpu")


@pytest.fixture(scope="module")
def repro_run(tmp_path_factory):
    """The reference's 20 smoke steps from seed 0, checkpointed every 4
    (kept: steps 12, 16 and 20)."""
    d = tmp_path_factory.mktemp("repro_run")
    _, losses = jtrain.train("dlrm-rm2", 20, ckpt_dir=str(d), ckpt_every=4,
                             log_every=100)
    return d, np.array(losses)


def test_train_losses_match_repro(repro_run, tmp_path):
    _, want = repro_run
    model, got = ttrain.train("dlrm-rm2", 20, ckpt_dir=str(tmp_path),
                              ckpt_every=4, log_every=100, device="cpu")
    assert len(got) == 20 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    # the final checkpoints hold the same leaves, within the same rounding
    assert tckpt.latest_step(str(tmp_path)) == 20 == \
        jckpt.latest_step(str(repro_run[0]))
    assert len(toptim.tree_leaves(model.params())) == 26 + 6 + 6
    with np.load(repro_run[0] / "ckpt_0000000020.npz") as data:
        ours = np.load(tmp_path / "ckpt_0000000020.npz")
        assert sorted(data.files) == sorted(ours.files)
        for k in data.files:
            np.testing.assert_allclose(ours[k], data[k], rtol=1e-4,
                                       atol=1e-6, err_msg=k)


def test_repro_checkpoint_resumes_in_the_port(repro_run, tmp_path):
    src, want = repro_run
    d = tmp_path / "run"
    shutil.copytree(src, d)
    for step in (16, 20):  # keep the checkpoint of step 12 only
        os.unlink(d / f"ckpt_{step:010d}.npz")
        os.unlink(d / f"ckpt_{step:010d}.npz.json")
    _, got = ttrain.train("dlrm-rm2", 20, ckpt_dir=str(d), ckpt_every=4,
                          log_every=100, device="cpu")
    assert len(got) == 8
    np.testing.assert_allclose(got, want[12:], **LOSS_TOL)


def _cli(ckpt_dir, *extra) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "dlrm-rm2", "--steps", "12", "--ckpt-every", "4", "--ckpt-dir",
         str(ckpt_dir), "--device", "cpu", *extra],
        env=env, capture_output=True, text=True, timeout=300)


def test_simulated_failure_resumes_bit_exact(tmp_path):
    crash = _cli(tmp_path / "a", "--simulate-failure", "6")
    assert crash.returncode == 42, crash.stderr
    assert "SIMULATED FAILURE at step 6" in crash.stdout
    assert tckpt.latest_step(str(tmp_path / "a")) == 4
    again = _cli(tmp_path / "a")
    assert again.returncode == 0, again.stderr
    assert "resumed from step 4" in again.stdout
    ttrain.train("dlrm-rm2", 12, ckpt_dir=str(tmp_path / "b"), ckpt_every=4,
                 log_every=100, device="cpu")
    a = np.load(tmp_path / "a" / "ckpt_0000000012.npz")
    b = np.load(tmp_path / "b" / "ckpt_0000000012.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_unported_families_raise_in_build_trainable():
    # the reference's registry loads its configs only while it is empty: a
    # file that imported one config module first leaves it holding just
    # that one (tests/test_torch_dlrm.py imports dlrm_rm2)
    from repro.configs import base as jbase
    jbase.load_all()
    for name in ("qwen3-4b", "gin-tu"):
        arch = jget_arch(name)
        with pytest.raises(KeyError, match="unknown arch"):
            ttrain.build_trainable(name, device="cpu")
        assert arch.family in ("lm", "gnn")
    fake = dataclasses.replace(ARCH, name="x-lm", family="lm")
    from repro_torch.configs import base
    base.register(fake)
    try:
        with pytest.raises(NotImplementedError, match="Queue 1 item 16"):
            ttrain.build_trainable("x-lm", device="cpu")
    finally:
        base._REGISTRY.pop("x-lm")


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_tol(got, want, table, idx, grad_out, mode):
    """|kernel - plain| per element within the worst case of two float32
    sums of the same k terms in different orders: 2 (k - 1) 2^-24 sum|t|."""
    mag = embedding_bag_backward_ref(table, idx, grad_out.abs(), mode)
    from repro_torch.kernels.legacy.embedding_bag.ref import wrap_and_clamp
    k = torch.bincount(wrap_and_clamp(idx, table.shape[0]).flatten(),
                       minlength=table.shape[0]).to(torch.float32)
    bound = 2 * (k[:, None] - 1).clamp(min=0) * 2.0 ** -24 * mag
    assert bool(((got - want).abs() <= bound).all())


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("shape", [(70_000, 64, 65_536, 1, 0.05),
                                   (5_000, 13, 4_000, 8, 0.5),
                                   (257, 200, 3_000, 3, 0.9)])
def test_backward_kernel_matches_plain_on_card(cuda, mode, shape):
    rows, D, B, L, hub = shape
    table, idx, grad_out = (_t(x).to(cuda) for x in _bag_case(
        rows, D, B, L, hub=hub, ties=True, seed=rows))
    fn = ops.KERNELS["embedding_bag_backward"]
    before = fn.launches
    got = fn(table, idx, grad_out, mode=mode)
    again = fn(table, idx, grad_out, mode=mode)
    assert fn.launches == before + 2
    assert torch.equal(got, again)  # the same bits from run to run
    want = embedding_bag_backward_ref(table, idx, grad_out, mode)
    _card_tol(got, want, table, idx, grad_out, mode)
    # the autograd route on the card takes the kernel
    t = table.clone().requires_grad_(True)
    embedding_bag(t, idx, mode=mode).backward(grad_out)
    assert torch.equal(t.grad, got)
    assert fn.launches == before + 3


@pytest.mark.gpu
def test_train_step_on_card_matches_the_plain_step(cuda, monkeypatch):
    from repro_torch import random as trandom
    from repro_torch.legacy.data import RecsysStream

    class PlainBag(torch.autograd.Function):
        @staticmethod
        def forward(ctx, table, idx, mode):
            ctx.save_for_backward(table, idx)
            ctx.mode = mode
            return embedding_bag_ref(table, idx, mode)

        @staticmethod
        def backward(ctx, g):
            table, idx = ctx.saved_tensors
            return embedding_bag_backward_ref(table, idx, g, ctx.mode), \
                None, None

    def run(plain: bool):
        model = tdlrm.init_dlrm(SMOKE, key=trandom.PRNGKey(0, device=cuda))
        state = toptim.init_adam(model.params())
        batch = RecsysStream(batch=512, n_dense=13, n_sparse=26, vocab=1000,
                             seed=0).batch_at(0, device=cuda)
        with monkeypatch.context() as m:
            if plain:  # the model's grouped bags, each through PlainBag
                m.setattr(tdlrm, "embedding_bags",
                          lambda tables, idx, mode="sum": [
                              PlainBag.apply(t, i, mode)
                              for t, i in zip(tables, idx)])
            _, state, info = tsteps.train_step(
                model, state, batch["dense"], batch["sparse"],
                batch["labels"])
        return model, state, info

    before = ops.launch_counts()
    km, ks, kinfo = run(False)
    after = ops.launch_counts()
    assert after["embedding_bag"] - before["embedding_bag"] == 26
    # one grouped backward call for the 26 tables
    assert after["embedding_bag_backward"] - \
        before["embedding_bag_backward"] == 1
    pm, ps, pinfo = run(True)
    assert float(kinfo["loss"]) == float(pinfo["loss"])
    for a, b in zip(toptim.tree_leaves((km.params(), ks)),
                    toptim.tree_leaves((pm.params(), ps))):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
