"""The LM family's registry, data, cells, training and CLIs against the
JAX package:

  * the registry: ``all_archs()`` order, each LM config, ``LM_SHAPES``,
    deepseek's ``train_4k_int8a2a``, the smoke dicts and the
    ``long_500k`` gating (``tests/test_smoke_archs.py``);
  * ``TokenStream.batch_at``: equal bit for bit over seeds and steps,
    ``2**31`` among them;
  * ``build_cell`` for every LM arch × supported shape on the ``meta``
    device: ``meta`` equal to the reference's 1 x 1 cell's; the smoke
    cells' ``fn`` (train, prefill, decode) against the reference's;
  * every LM cell built on the production meshes, and the dry run's
    per-rank plan of two cells, by hand;
  * ``launch.train.build_trainable`` for an LM arch: two steps, each
    step's gradients within GRAD_TOL, every moment within STEP_TOL and
    every parameter within STEP_TOL plus its AdamW magnification of the
    measured gradient difference (``test_two_train_steps_match_repro``) of
    ``repro.launch.train``'s, and a checkpointed run resumed equal to an
    uninterrupted one;
  * ``launch.legacy.serve``: the reference's generated ids.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import get_arch as jget_arch
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.launch.legacy import serve as jserve
from repro.legacy.data import TokenStream as JTokenStream
from repro.legacy.models import transformer as jtfm
from repro_torch.configs import all_archs, get_arch
from repro_torch.configs import base as tbase
from repro_torch.launch import dryrun
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.launch.legacy import serve as tserve
from repro_torch.legacy import optim as toptim
from repro_torch.legacy.data import TokenStream
from repro_torch.legacy.models import transformer as ttfm
from repro_torch.legacy.tree import leaves

# the reference's registry loads its configs only while it is empty: a
# module that imported one config first (tests/test_torch_dlrm.py) leaves
# it holding just that one
jbase.load_all()
LM_ARCHS = ["h2o-danube-3-4b", "qwen3-4b", "stablelm-3b", "deepseek-moe-16b",
            "granite-moe-3b-a800m"]
# two AdamW steps: the gradients are float32 sums in another order, and the
# first step divides each by its own magnitude (tests/test_torch_train.py)
STEP_TOL = dict(rtol=1e-5, atol=1e-6)
LM_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _clear_jax_caches():
    """Shadow conftest's per-test cache clearing; cleared once a module."""
    yield


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_once():
    yield
    jax.clear_caches()


def _cells():
    """Every LM arch × shape it supports (long_500k only on a window)."""
    return [(a, s) for a in LM_ARCHS for s in get_arch(a).shape_names()
            if get_arch(a).supports(s)]


def test_registry_matches_jax():
    assert tbase.LM_SHAPES == jbase.LM_SHAPES
    assert list(tbase.LM_SHAPES) == list(jbase.LM_SHAPES)
    assert [a for a in all_archs() if get_arch(a).family == "lm"] == LM_ARCHS
    for name in LM_ARCHS:
        ta, ja = get_arch(name), jget_arch(name)
        assert (ta.name, ta.family, ta.smoke) == (ja.name, ja.family,
                                                  ja.smoke)
        assert dataclasses.asdict(ta.model) == dataclasses.asdict(ja.model)
        assert ta.shapes == ja.shapes and ta.shape_names() == ja.shape_names()
        for s in ta.shape_names():
            assert ta.supports(s) == ja.supports(s), (name, s)
    assert get_arch("deepseek-moe-16b").shapes["train_4k_int8a2a"] == dict(
        kind="train", seq=4096, batch=256, moe_a2a_int8=True)


def test_long_500k_gating():
    """long_500k runs only for sub-quadratic (SWA) archs."""
    assert get_arch("h2o-danube-3-4b").supports("long_500k")
    for full_attn in LM_ARCHS[1:]:
        assert not get_arch(full_attn).supports("long_500k"), full_attn


@pytest.mark.parametrize("seed", [0, 3, 2**31, -5])
@pytest.mark.parametrize("step", [0, 1, 17, 2**32 - 1])
def test_token_stream_is_the_references(seed, step):
    kw = dict(vocab=512, batch=3, seq_len=21, seed=seed)
    want = JTokenStream(**kw).batch_at(step)
    got = TokenStream(**kw).batch_at(step, device="cpu")
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("name,shape", _cells())
def test_cell_meta_matches_repro(name, shape):
    arch = get_arch(name)
    jc = jsteps.build_cell(jget_arch(name), shape, jmesh.make_smoke_mesh())
    tc = tsteps.build_cell(arch, shape, device="meta")
    assert tc.meta == jc.meta
    assert tc.donate == jc.donate
    assert all(x.device.type == "meta" for a in tc.args for x in leaves(a))
    spec = arch.shapes[shape]
    if spec["kind"] == "decode":
        cache = tc.args[0]
        assert tuple(cache.k.shape) == jc.args[1].k.shape


def _smoke_arch(name: str):
    """``name`` at its smoke overrides with small train/prefill/decode
    shapes, in both packages."""
    shapes = {"t": dict(kind="train", seq=16, batch=2),
              "p": dict(kind="prefill", seq=16, batch=2),
              "d": dict(kind="decode", seq=16, batch=2)}
    ja, ta = jget_arch(name), get_arch(name)
    return (dataclasses.replace(ja, model=dataclasses.replace(
                ja.model, **ja.smoke), shapes=shapes),
            dataclasses.replace(ta, model=dataclasses.replace(
                ta.model, **ta.smoke), shapes=shapes))


@pytest.mark.parametrize("name", ["qwen3-4b", "granite-moe-3b-a800m"])
def test_smoke_cells_run_as_repro(name):
    ja, ta = _smoke_arch(name)
    mesh = jmesh.make_smoke_mesh()
    jp = jtfm.init_params(jax.random.PRNGKey(0), ja.model)
    model = ttfm.Transformer.from_params(jax.tree.map(np.asarray, jp),
                                         ta.model, device="cpu")
    b = TokenStream(ta.model.vocab, 2, 16).batch_at(0, device="cpu")
    toks, labels = (b[k].numpy() for k in ("tokens", "labels"))
    with mesh:
        # prefill, then one decode step from its cache
        jl, jcache = jax.jit(jsteps.build_cell(ja, "p", mesh).fn)(
            jp, jnp.asarray(toks))
        tl, tcache = tsteps.build_cell(ta, "p").fn(model,
                                                   torch.from_numpy(toks))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LM_TOL)
        jd, _ = jax.jit(jsteps.build_cell(ja, "d", mesh).fn)(
            jp, jcache, jnp.asarray(toks[:, 0]))
        td, tcache = tsteps.build_cell(ta, "d").fn(
            model, tcache, torch.from_numpy(toks[:, 0]))
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), **LM_TOL)
        assert int(tcache.pos) == 17
        # one train step
        jcell = jsteps.build_cell(ja, "t", mesh)
        jp2, jo2, jinfo = jax.jit(jcell.fn)(
            jp, jax.tree.map(jnp.asarray, jtrain.optim.init_adam(jp)),
            {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    _, state, info = tsteps.build_cell(ta, "t").fn(
        model, toptim.init_adam(model.params()), torch.from_numpy(toks),
        torch.from_numpy(labels))
    np.testing.assert_allclose(float(info["loss"]), float(jinfo["loss"]),
                               **LM_TOL)
    for a, b in zip(jax.tree.leaves((jp2, jo2)),
                    leaves((model.params(), state))):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   **STEP_TOL)


def test_lm_cell_on_a_mesh_names_item_16_part_b():
    """Item 16's second part (b) is done: every LM cell builds on the
    production meshes, planned per rank on the meta device, its model and
    AdamW state laid out by the reference's specs."""
    for multi in (False, True):
        mesh = dryrun.make_production_mesh(multi_pod=multi)
        for name, shape in _cells():
            cell = tsteps.build_cell(get_arch(name), shape, mesh,
                                     device="meta")
            assert all(x.device.type == "meta" for a in cell.args
                       for x in leaves(a))
            assert len(cell.state) == (2 if shape.startswith("train")
                                       else 1)
            assert 0 < tsteps.state_bytes(cell, mesh) < \
                tsteps.state_bytes(tsteps.build_cell(
                    get_arch(name), shape, device="meta"), mesh)


def test_dryrun_plans_an_lm_cell_by_hand():
    """Per rank, on the production meshes. qwen3-4b × decode_32k on 16 x
    16 (no FSDP): embed's rows and lm_head's columns over the 16 model
    ranks (151,936 / 16 = 9,496), wq's columns (4,096 / 16 = 256), wk's and
    wv's (1,024 / 16 = 64: half a head), wo's rows, the FFN's 9,728 / 16 =
    608 columns and rows; the norms whole; the bf16 KV cache of 128 x
    32,768 tokens split 8 sequences a data rank and 2,048 slots a model
    rank; its position; 8 tokens a rank."""
    L, D, V, dh = 36, 2560, 151936, 128
    params = 4 * (2 * 9496 * D + D + 2 * L * D + 2 * L * dh
                  + L * D * (256 + 2 * 64) + L * 256 * D + 3 * L * D * 608)
    kv = 2 * 2 * L * 8 * 2048 * 8 * dh
    rec = dryrun.run_cell("qwen3-4b", "decode_32k", "single", verbose=False)
    assert (rec["status"], rec["devices"]) == ("ok", 256)
    assert rec["arg_bytes"] == params + kv + 4 + 8 * 4
    assert rec["fits"] and kv == 2415919104
    # stablelm-3b × train_4k on 2 x 16 x 16: FSDP over the 32 data ranks
    # on d_model (the largest free dimension) for every leaf over 2^16
    # elements (final_norm's 2,560 stay whole); 8 sequences a data rank
    L, D, F, M = 32, 2560, 6912, 16
    per = (2 * (50304 // M) * (D // 32) + D + 2 * L * (D // 32)
           + 4 * L * (D // 32) * (D // M) + 3 * L * (D // 32) * (F // M))
    rec = dryrun.run_cell("stablelm-3b", "train_4k", "multi", verbose=False)
    assert rec["devices"] == 512
    assert rec["arg_bytes"] == 3 * 4 * per + 4 + 2 * 8 * 4096 * 4
    assert rec["fits"]


# each step's gradient leaf within GRAD_TOL of the reference's largest
# magnitude there (tests/test_torch_lm.py's bound)
GRAD_TOL = 1e-5


def _adam_moves(grads_by_step, ocfg, lrs):
    """Each leaf's summed AdamW step ``lr_t m_t / (sqrt(v_t) + eps)`` (bias
    corrected, after global-norm clipping) over the given steps' gradients,
    in float64; weight decay left out."""
    b1, b2, eps = ocfg.beta1, ocfg.beta2, ocfg.eps
    m = v = tot = [0.0] * len(grads_by_step[0])
    for t, (gs, lr) in enumerate(zip(grads_by_step, lrs), 1):
        c = min(1.0, ocfg.grad_clip / np.sqrt(sum((g * g).sum() for g in gs)))
        m = [b1 * a + (1 - b1) * c * g for a, g in zip(m, gs)]
        v = [b2 * a + (1 - b2) * (c * g) ** 2 for a, g in zip(v, gs)]
        tot = [u + lr * (a / (1 - b1 ** t)) / (np.sqrt(w / (1 - b2 ** t)) + eps)
               for u, a, w in zip(tot, m, v)]
    return tot


@pytest.mark.parametrize("name", ["h2o-danube-3-4b", "deepseek-moe-16b"])
def test_two_train_steps_match_repro(name):
    """Two steps of ``build_trainable`` against ``repro.launch.train``'s.
    Each step's gradients are held to GRAD_TOL; the moments to STEP_TOL.
    AdamW's step ``m / (sqrt(v) + eps)`` changes by ``lr eps dg / (|g| +
    eps)^2`` for a gradient change ``dg``: at ``|g|`` within a few eps a
    float32 reassociation of ``g`` moves it by a sizeable share of ``lr``.
    So each parameter is held to STEP_TOL plus how far the two gradients
    (the port's and the reference's, both measured here) move its two-step
    update apart through AdamW's formula in float64; that term is below
    STEP_TOL's atol for all but a few elements (PERF.md, PR 26)."""
    jparams, jopt, jstep, jdata = jtrain.build_trainable(name, seed=0)
    model, state, step_fn, data_fn = ttrain.build_trainable(
        name, seed=0, device="cpu")
    for a, b in zip(jax.tree.leaves(jparams), leaves(model.params())):
        ulps = np.abs(np.asarray(a).view(np.int32).astype(np.int64)
                      - b.detach().numpy().view(np.int32).astype(np.int64))
        assert int(ulps.max()) <= 4
    model = ttfm.Transformer.from_params(jax.tree.map(np.asarray, jparams),
                                         model.cfg, device="cpu")
    state = toptim.init_adam(model.params())
    ocfg = toptim.OptimizerConfig(lr=1e-3, warmup_steps=10,
                                  total_steps=1000)
    mcfg = jtrain.smoke_model(jget_arch(name))
    jgrad = jax.jit(jax.grad(
        lambda p, t, lab: jtfm.lm_loss(p, t, lab, mcfg)[0]))
    gj, gt, lrs = [], [], []
    for step in range(2):
        batch = data_fn(step)
        jb = jdata(step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(batch[k].numpy(),
                                          np.asarray(jb[k]))
        gj.append([np.asarray(g, np.float64) for g in jax.tree.leaves(
            jgrad(jparams, jb["tokens"], jb["labels"]))])
        params = model.params()
        loss, _ = ttfm.lm_loss(params, batch["tokens"], batch["labels"],
                               model.cfg)
        gt.append([g.double().numpy() for g in torch.autograd.grad(
            loss, leaves(params))])
        for a, b in zip(gt[-1], gj[-1]):
            assert np.abs(a - b).max() <= GRAD_TOL * np.abs(b).max()
        jparams, jopt, jloss = jstep(jparams, jopt, jb)
        model, state, loss = step_fn(model, state, batch)
        np.testing.assert_allclose(float(loss), float(jloss), **LM_TOL)
        lrs.append(float(toptim.schedule_lr(ocfg, torch.tensor(step + 1))))
    assert int(state.step) == int(jopt.step) == 2
    for a, b in zip(jax.tree.leaves((jopt.mu, jopt.nu)),
                    leaves((state.mu, state.nu))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **STEP_TOL)
    apart = [np.abs(a - b) for a, b in zip(_adam_moves(gt, ocfg, lrs),
                                           _adam_moves(gj, ocfg, lrs))]
    n_wide = 0
    for a, b, d in zip(jax.tree.leaves(jparams), leaves(model.params()),
                       apart):
        a, b = np.asarray(a), b.detach().numpy()
        tol = STEP_TOL["atol"] + STEP_TOL["rtol"] * np.abs(a) + d
        assert np.all(np.abs(b - a) <= tol)
        n_wide += int((d > STEP_TOL["atol"]).sum())
    assert n_wide <= 1e-4 * sum(a.size for a in apart)


def test_train_resume_is_bit_exact(tmp_path):
    """launch.train on an LM arch: 4 steps with a checkpoint every 2, then
    the same command to 6 resumes from step 4 and ends equal, bit for bit,
    to an uninterrupted 6-step run."""
    kw = dict(ckpt_every=2, seed=0, log_every=100, device="cpu")
    ttrain.train("stablelm-3b", 4, str(tmp_path / "a"), **kw)
    resumed, losses = ttrain.train("stablelm-3b", 6, str(tmp_path / "a"),
                                   **kw)
    whole, all_losses = ttrain.train("stablelm-3b", 6, str(tmp_path / "b"),
                                     **kw)
    assert len(losses) == 2 and losses == all_losses[4:]
    assert all(torch.equal(a, b) for a, b in zip(
        leaves(resumed.params()), leaves(whole.params())))


@pytest.mark.parametrize("name", ["qwen3-4b", "h2o-danube-3-4b"])
def test_serve_generates_the_references_ids(name):
    kw = dict(batch=2, prompt_len=16, gen_tokens=20, seed=3, verbose=False)
    want = np.asarray(jserve.serve(name, **kw))
    got = tserve.serve(name, device="cpu", **kw)
    assert got.dtype == torch.int32 and got.shape == (2, 20)
    np.testing.assert_array_equal(got.numpy(), want)


def test_serve_cli_runs(capsys):
    assert tserve.main(["--arch", "stablelm-3b", "--batch", "1", "--prompt",
                        "8", "--tokens", "4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[serve] stablelm-3b: batch=1 prompt=8 generated=4" in out
    with pytest.raises(ValueError, match="LM arch"):
        tserve.serve("dlrm-rm2", device="cpu")
