"""``embedding_bags``: T bags at once, in one forward launch on the card,
whose T table gradients one backward call computes (one launch pair and
one sort for all of them).

  * on the CPU, the grouped forward's plain path against ``repro``'s Pallas
    kernel in interpret mode, table by table (T = 1, 3 and 26 tables of
    unequal rows, each mode, float32 and bfloat16, wrapped and too-large
    ids); the grouped function's bags and gradients against ``repro``'s bag
    and ``jax.grad`` of it, table by table, and against the plain
    per-table backward, bit for bit: ``sum``, ``mean``, ``max``, tables of
    unequal rows, bags of several ids, wrapped, clamped and dump-row ids,
    one table alone; ``DLRM.loss``'s gradients through it equal the
    per-table route's bit for bit;
  * what the grouped CUDA wrappers (forward and backward) refuse, checked
    before any CUDA call;
  * ``gpu``-marked: the grouped forward against the plain version table by
    table (26 tables at RM2's D = 64 and L = 8 among the shapes), its T = 1
    case the one-table wrapper's bits, its output views taken by the
    backward as they are; the grouped backward against the plain version
    within the reordering bound of two float32 sums, the same bits on a
    second call, a hub row, widths that take 8- and 4-byte vectors,
    ``grad_out`` rows at a stride, gradients past 2^31 flat rows (int64
    keys), and the launch counts of a call and of a train step; row
    windows (a rank's block of a row-sharded table): each shard's forward
    the windowed plain version's bits (float32 adds in l order at L > 1)
    and the shards' bags summing to the whole table's, each shard's
    gradient the chunked restatement of the kernel's order bit for bit and
    within the reordering bound of the windowed plain backward, on windows
    that cut the tables mid-range and on the shard holding the clamped last
    row; a whole-table window the call without one, bits and launches.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.legacy.embedding_bag.kernel import (
    embedding_bag as j_pallas_bag,
)
from repro.kernels.legacy.embedding_bag.ref import embedding_bag_ref as j_bag
from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.kernels.legacy import (
    embedding_bag,
    embedding_bags,
    embedding_bags_backward,
)
from repro_torch.kernels.legacy.embedding_bag import kernel as bag_kernel
from repro_torch.kernels.legacy.embedding_bag.ref import (
    embedding_bag_backward_ref,
    embedding_bag_ref,
    embedding_bags_backward_chunked_ref,
    wrap_and_clamp,
)
from repro_torch.legacy.models import dlrm as tdlrm

MODES = ("sum", "mean", "max")
ARCH = get_arch("dlrm-rm2")
SMOKE = dataclasses.replace(ARCH.model, **ARCH.smoke)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _tables_case(rows, D, B, L, *, hub=0.0, past=False, seed=0):
    """T = len(rows) float32 tables (ties on rounded values, a row copied
    onto another), (T, B, L) ids with wrapped negatives, a bag of dump rows
    only and a row twice in one bag; ``past`` adds ids at or past the
    table and below -rows (the clamp contract); ``hub`` sends that share
    of the bags' first ids to row 0. Returns numpy arrays."""
    rng = np.random.default_rng(seed)
    tables, idx = [], []
    for r in rows:
        t = np.round(rng.normal(size=(r, D)), 1).astype(np.float32)
        t[min(3, r - 1)] = t[min(5, r - 1)]
        tables.append(t)
        i = rng.integers(-r, r, size=(B, L)).astype(np.int32)
        i[rng.random(B) < hub, 0] = 0
        i[0, :] = r - 1
        i[1, 0] = i[1, -1] = min(5, r - 1)
        if past:
            i[2, 0], i[3, 0], i[4, 0] = r, r + 3, -r - 2
        idx.append(i)
    grad_out = rng.normal(size=(len(rows), B, D)).astype(np.float32)
    return tables, np.stack(idx), grad_out


def _grouped_grads(tables, idx, grad_out, mode):
    """The tables' gradients through ``embedding_bags``' autograd route."""
    ts = [x.clone().requires_grad_(True) for x in tables]
    outs = embedding_bags(ts, idx, mode=mode)
    torch.autograd.backward(outs, list(grad_out))
    return outs, [x.grad for x in ts]


CASES = {
    "unequal_rows_multi_hot": dict(rows=(17, 9, 40), D=8, B=30, L=3),
    "one_hot_hub": dict(rows=(64, 33), D=16, B=200, L=1, hub=0.3),
    "one_table": dict(rows=(12,), D=4, B=25, L=6, hub=0.5),
}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_grouped_plain_path_is_jax_and_per_table(case, mode):
    tables, idx, grad_out = _tables_case(**CASES[case], seed=len(case))
    before = ops.launch_counts()
    outs, grads = _grouped_grads([_t(x) for x in tables], _t(idx),
                                 _t(grad_out), mode)
    assert ops.launch_counts() == before  # the CPU takes the plain versions
    assert len(outs) == len(grads) == len(tables)
    direct = embedding_bags_backward([_t(x) for x in tables], _t(idx),
                                     list(_t(grad_out)), mode=mode)
    for t, (table, out, grad) in enumerate(zip(tables, outs, grads)):
        jt, ji = jnp.asarray(table), jnp.asarray(idx[t])
        np.testing.assert_array_equal(out.detach().numpy(),
                                      np.asarray(j_bag(jt, ji, mode)))
        want = jax.grad(lambda x: jnp.vdot(
            j_bag(x, ji, mode), jnp.asarray(grad_out[t])))(jt)
        assert grad.shape == table.shape and grad.dtype == torch.float32
        np.testing.assert_array_equal(grad.numpy(), np.asarray(want))
        ref = embedding_bag_backward_ref(_t(table), _t(idx[t]),
                                         _t(grad_out[t]), mode)
        assert torch.equal(grad, ref) and torch.equal(direct[t], ref)


@pytest.mark.parametrize("mode", MODES)
def test_grouped_plain_path_follows_the_clamp_contract(mode):
    """Ids at or past a table, and below -rows, pass their share to the row
    the forward read, table by table (``jax.grad`` drops them; see
    tests/test_torch_train.py)."""
    tables, idx, grad_out = _tables_case((11, 7), 4, 12, 2, past=True)
    _, grads = _grouped_grads([_t(x) for x in tables], _t(idx),
                              _t(grad_out), mode)
    for t, table in enumerate(tables):
        assert torch.equal(grads[t], embedding_bag_backward_ref(
            _t(table), _t(idx[t]), _t(grad_out[t]), mode))
    if mode == "sum":  # id r + 3 of bag 3 reads, and takes a share to, r - 1
        rows = wrap_and_clamp(_t(idx[0]), 11)
        assert int(rows[3, 0]) == 10 and int(rows[4, 0]) == 0


def test_grouped_bags_take_only_the_tables_that_need_a_gradient():
    tables, idx, grad_out = _tables_case((10, 6), 4, 8, 2)
    a = _t(tables[0]).requires_grad_(True)
    b = _t(tables[1])
    outs = embedding_bags([a, b], _t(idx))
    torch.autograd.backward(outs[0], _t(grad_out[0]))
    assert torch.equal(a.grad, embedding_bag_backward_ref(
        _t(tables[0]), _t(idx[0]), _t(grad_out[0])))
    assert b.grad is None


def test_grouped_bags_refuse_a_table_count_the_ids_do_not_have():
    tables, idx, _ = _tables_case((10, 6), 4, 8, 2)
    with pytest.raises(ValueError, match="2 tables"):
        embedding_bags([_t(x) for x in tables], _t(idx[:1]))


def _smoke_batch(B=40, seed=5):
    rng = np.random.default_rng(seed)
    return (_t(rng.normal(size=(B, SMOKE.n_dense)).astype(np.float32)),
            _t(rng.integers(-3, SMOKE.vocab_sizes[0] + 600,
                            (B, SMOKE.n_sparse, 2)).astype(np.int32)),
            _t((rng.random(B) < 0.4).astype(np.int32)))


def test_dlrm_loss_gradients_equal_the_per_table_route(monkeypatch):
    """The model's bags through one grouped call give the same bits as 26
    ``embedding_bag`` calls, on every parameter: multi-hot bags with ids
    past the vocab and wrapped negatives, tables of two sizes."""
    from repro_torch import random as trandom
    from repro_torch.legacy import optim
    cfg = dataclasses.replace(SMOKE, multi_hot=2,
                              vocab_sizes=(1000, 300) * 13)
    model = tdlrm.init_dlrm(cfg, key=trandom.PRNGKey(3, device="cpu"))
    dense, sparse, labels = _smoke_batch()
    leaves = optim.tree_leaves(model.params())

    def grads():
        loss = model.loss(dense, sparse, labels)
        return loss, torch.autograd.grad(loss, leaves)

    loss, grouped = grads()
    with monkeypatch.context() as m:
        m.setattr(tdlrm, "embedding_bags", lambda tables, idx, mode="sum": [
            embedding_bag(t, i, mode=mode) for t, i in zip(tables, idx)])
        loss2, per_table = grads()
    assert torch.equal(loss, loss2)
    assert len(grouped) == len(per_table) == len(leaves)
    for a, b in zip(grouped, per_table):
        assert torch.equal(a, b)


# The grouped forward's plain path against the Pallas kernel in interpret
# mode, table by table, at test_torch_kernels.py's tolerances: rtol = atol =
# 1e-6 (float32; a one-row bag is a copy, so exact), 3e-2 (bfloat16).
_BAG_TOL = {"float32": 1e-6, "bfloat16": 3e-2}
_ROWS = (17, 9, 40, 23)  # cycled over the tables: 4 Pallas compiles a case


def _forward_case(T: int, L: int, seed: int):
    """T float32 tables of unequal rows (the last row zero, DLRM's dump
    row) and (T, 12, L) ids in [-rows - 3, rows + 4): wrapped negatives,
    ids past the table and the dump row among them."""
    rng = np.random.default_rng(seed)
    tables, idx = [], []
    for t in range(T):
        r = _ROWS[t % len(_ROWS)]
        x = rng.normal(size=(r, 8)).astype(np.float32)
        x[-1] = 0.0
        tables.append(x)
        idx.append(rng.integers(-r - 3, r + 4, (12, L)).astype(np.int32))
    return tables, np.stack(idx)


@pytest.mark.parametrize("L", [1, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("T", [1, 3, 26])
def test_grouped_forward_plain_path_is_the_pallas_kernel(T, mode, dtype, L):
    tables, idx = _forward_case(T, L, seed=T * 10 + L)
    before = ops.launch_counts()
    outs = embedding_bags([_t(x).to(getattr(torch, dtype)) for x in tables],
                          _t(idx), mode=mode)
    assert ops.launch_counts() == before  # the CPU takes the plain version
    assert len(outs) == T
    for t, (table, out) in enumerate(zip(tables, outs)):
        want = np.asarray(j_pallas_bag(
            jnp.asarray(table, dtype), jnp.asarray(idx[t]), mode=mode,
            block_b=idx.shape[1], interpret=True), np.float32)
        assert str(out.dtype) == f"torch.{dtype}"
        got = out.float().numpy()
        if dtype == "float32" and L == 1:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=_BAG_TOL[dtype],
                                       atol=_BAG_TOL[dtype])


def test_grouped_forward_wrapper_refuses_what_it_cannot_take():
    fn = bag_kernel.embedding_bags
    before = ops.launch_counts()
    tables = [torch.zeros(10, 4), torch.zeros(7, 4)]
    idx = torch.zeros(2, 3, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown embedding_bag mode"):
        fn(tables, idx, mode="min")
    with pytest.raises(ValueError, match="1 to 64 tables"):
        fn([], idx[:0])
    with pytest.raises(ValueError, match="1 to 64 tables"):
        fn([torch.zeros(2, 4)] * 65, torch.zeros(65, 1, 1, dtype=torch.int32))
    with pytest.raises(ValueError, match="like the first"):
        fn([tables[0], torch.zeros(7, 6)], idx)    # mixed D
    with pytest.raises(ValueError, match="like the first"):
        fn([tables[0], tables[1].to(torch.bfloat16)], idx)  # mixed dtype
    with pytest.raises(ValueError, match="like the first"):
        fn([tables[0], torch.zeros(4, 7).t()], idx)  # a strided table
    with pytest.raises(ValueError, match=r"\(T, B, L\)"):
        fn(tables, idx[0])                         # 2-D ids
    with pytest.raises(ValueError, match=r"\(T, B, L\)"):
        fn(tables, torch.zeros(2, 2, 6, dtype=torch.int32)[:, :, ::2])
    with pytest.raises(ValueError, match=r"\(T, B, L\)"):
        fn(tables, idx[:1])                        # one table's ids for two
    with pytest.raises(TypeError, match="int32"):
        fn(tables, idx.long())
    with pytest.raises(TypeError, match="table"):
        fn([x.half() for x in tables], idx)
    with pytest.raises(ValueError, match="CUDA device"):
        fn(tables, idx)                            # right types, on the CPU
    assert ops.launch_counts() == before


def test_grouped_wrapper_refuses_what_it_cannot_take():
    fn = bag_kernel.embedding_bags_backward
    before = ops.launch_counts()
    tables = [torch.zeros(10, 4), torch.zeros(7, 4)]
    idx = torch.zeros(2, 3, 2, dtype=torch.int32)
    g = [torch.zeros(3, 4), torch.zeros(3, 4)]
    with pytest.raises(ValueError, match="unknown embedding_bag mode"):
        fn(tables, idx, g, mode="min")
    with pytest.raises(ValueError, match="1 to 64 tables"):
        fn([], idx[:0], [])
    with pytest.raises(ValueError, match="1 to 64 tables"):
        fn([torch.zeros(2, 4)] * 65, torch.zeros(65, 1, 1, dtype=torch.int32),
           [torch.zeros(1, 4)] * 65)
    with pytest.raises(ValueError, match=r"\(T, B, L\)"):
        fn(tables, idx[0], g)                      # 2-D ids
    with pytest.raises(ValueError, match=r"\(T, B, L\)"):
        fn(tables, idx[:1], g)                     # one table's ids for two
    with pytest.raises(ValueError, match=r"\(T, B, L\)"):
        fn(tables, torch.zeros(3, 2, 2, dtype=torch.int32)[::2], g)
    with pytest.raises(TypeError, match="table"):
        fn([x.to(torch.bfloat16) for x in tables], idx, g)
    with pytest.raises(TypeError, match="int32"):
        fn(tables, idx.long(), g)
    with pytest.raises(ValueError, match="CUDA device"):
        fn(tables, idx, g)                         # right types, on the CPU
    assert ops.launch_counts() == before


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _within_reordering(got, table, idx, grad_out, mode):
    """|kernel - plain| per element within the worst case of two float32
    sums of the same k terms in different orders: 2 (k - 1) 2^-24 sum|t|,
    k the positions that read the row."""
    want = embedding_bag_backward_ref(table, idx, grad_out, mode)
    mag = embedding_bag_backward_ref(table, idx, grad_out.abs(), mode)
    k = torch.bincount(wrap_and_clamp(idx, table.shape[0]).flatten(),
                       minlength=table.shape[0]).to(torch.float32)
    bound = 2 * (k[:, None] - 1).clamp(min=0) * 2.0 ** -24 * mag
    assert got.shape == want.shape
    assert bool(((got - want).abs() <= bound).all())


def _dirty(cuda, n: int) -> None:
    """Leave n NaN floats in the caching allocator's next block, so that a
    gradient the kernel does not write whole fails the check."""
    x = torch.full((n,), float("nan"), device=cuda)
    del x


def _card_case(cuda, rows, D, B, L, hub, seed):
    tables, idx, grad_out = _tables_case(rows, D, B, L, hub=hub, past=True,
                                         seed=seed)
    return ([_t(x).to(cuda) for x in tables], _t(idx).to(cuda),
            _t(grad_out).to(cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", [
    ((70_000, 30_000, 5_000), 64, 65_536, 1, 0.05),  # RM2-like, 16-byte rows
    ((70_000,), 64, 65_536, 1, 0.5),                 # a hub: ~32,768 on row 0
    ((5_000, 3_000), 13, 4_000, 8, 0.5),             # 4-byte columns, L = 8
    ((257, 1_100, 40), 200, 3_000, 3, 0.9),          # 800-byte rows, hubs
    ((4_099, 2_000), 6, 9_000, 2, 0.2),             # 4-byte sums, 8-byte zeros
])
def test_grouped_kernel_matches_plain_on_card(cuda, mode, shape):
    rows, D, B, L, hub = shape
    tables, idx, grad_out = _card_case(cuda, rows, D, B, L, hub, seed=B + D)
    counter = ops.KERNELS["embedding_bag_backward"]
    before = counter.launches
    _dirty(cuda, sum(rows) * D)
    got = embedding_bags_backward(tables, idx, list(grad_out), mode=mode)
    again = embedding_bags_backward(tables, idx, list(grad_out), mode=mode)
    torch.cuda.synchronize()
    assert counter.launches == before + 2  # one a call, whatever T is
    for t, (a, b) in enumerate(zip(got, again)):
        assert torch.equal(a, b)  # the same bits from run to run
        _within_reordering(a, tables[t], idx[t], grad_out[t], mode)
    # the autograd route on the card takes the kernel, the same bits
    outs, grads = _grouped_grads(tables, idx, grad_out, mode)
    assert counter.launches == before + 3
    assert all(torch.equal(a, b) for a, b in zip(grads, got))
    for t, out in enumerate(outs):
        assert torch.equal(out, embedding_bag(tables[t], idx[t], mode=mode))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
def test_grouped_kernel_reads_grad_out_rows_at_a_stride(cuda, mode):
    """grad_out as DLRM's backward hands it over: the slices of one
    (B, T + 1, D) tensor, rows (T + 1) * D apart; then rows 4 bytes off a
    16-byte boundary, which take the kernel's scalar columns."""
    tables, idx, _ = _card_case(cuda, (3_000, 1_000, 2_000), 64, 4_096, 2,
                                0.3, seed=7)
    stacked = torch.randn(4_096, 4, 64, device=cuda)
    views = [stacked[:, t + 1] for t in range(3)]
    got = embedding_bags_backward(tables, idx, views, mode=mode)
    dense = embedding_bags_backward(tables, idx,
                                    [v.contiguous() for v in views], mode=mode)
    assert all(torch.equal(a, b) for a, b in zip(got, dense))
    off = stacked.flatten()[1:1 + 4_096 * 64].view(4_096, 64)
    assert off.data_ptr() % 16 == 4
    for views in (views, [off] * 3):
        got = embedding_bags_backward(tables, idx, views, mode=mode)
        for t, a in enumerate(got):
            _within_reordering(a, tables[t], idx[t], views[t], mode)


@pytest.mark.gpu
def test_single_table_wrapper_is_the_grouped_kernel(cuda):
    tables, idx, grad_out = _card_case(cuda, (9_000,), 64, 20_000, 2, 0.2,
                                       seed=3)
    counter = ops.KERNELS["embedding_bag_backward"]
    before = counter.launches
    one = counter(tables[0], idx[0], grad_out[0], mode="mean")
    assert counter.launches == before + 1
    assert torch.equal(one, embedding_bags_backward(
        tables, idx, list(grad_out), mode="mean")[0])


@pytest.mark.gpu
def test_grouped_kernel_past_int32_flat_rows(cuda):
    """Two tables whose rows add up past 2^31 take int64 keys; one-column
    rows keep it to ~20 GB on the card."""
    rows = (2**30 + 7, 2**30 + 5)
    rng = np.random.default_rng(9)
    tables = [torch.zeros(r, 1, device=cuda) for r in rows]
    _dirty(cuda, sum(rows))
    idx = torch.stack([_t(rng.integers(-r, r, (4_096, 2)).astype(np.int32))
                       for r in rows]).to(cuda)
    idx[1, :8, 0] = rows[1] - 2  # the last row a position can read
    grad_out = torch.randn(2, 4_096, 1, device=cuda)
    got = embedding_bags_backward(tables, idx, list(grad_out))
    for t in range(2):
        # the touched rows against index_add_ over them alone; every other
        # row zero
        read = wrap_and_clamp(idx[t], rows[t]).flatten()
        touched, slot = torch.unique(read, return_inverse=True)
        share = grad_out[t].repeat_interleave(2, dim=0)
        want = torch.zeros(len(touched), 1, device=cuda).index_add_(
            0, slot, share)
        mag = torch.zeros_like(want).index_add_(0, slot, share.abs())
        k = torch.bincount(slot).to(torch.float32)[:, None]
        bound = 2 * (k - 1) * 2.0 ** -24 * mag
        assert bool(((got[t][touched] - want).abs() <= bound).all())
        assert int(torch.count_nonzero(got[t])) == \
            int(torch.count_nonzero(got[t][touched]))


@pytest.mark.gpu
def test_train_step_launches_one_backward(cuda):
    from repro_torch import random as trandom
    from repro_torch.launch.steps import train_step
    from repro_torch.legacy import optim
    from repro_torch.legacy.data import RecsysStream

    model = tdlrm.init_dlrm(SMOKE, key=trandom.PRNGKey(0, device=cuda))
    state = optim.init_adam(model.params())
    batch = RecsysStream(batch=512, n_dense=13, n_sparse=26, vocab=1000,
                         seed=0).batch_at(0, device=cuda)
    before = ops.launch_counts()
    train_step(model, state, batch["dense"], batch["sparse"], batch["labels"])
    after = ops.launch_counts()
    # one forward launch and one backward call for the 26 tables
    assert after["embedding_bag"] - before["embedding_bag"] == 1
    assert after["embedding_bag_backward"] - \
        before["embedding_bag_backward"] == 1


@pytest.mark.gpu
def test_grouped_wrapper_refuses_on_card(cuda):
    tables, idx, grad_out = _card_case(cuda, (50, 40), 8, 20, 2, 0.0, seed=1)
    fn = bag_kernel.embedding_bags_backward
    counter = ops.KERNELS["embedding_bag_backward"]
    before = counter.launches
    with pytest.raises(ValueError, match="like the first"):
        fn([tables[0], tables[1][:, :4].contiguous()], idx, list(grad_out))
    with pytest.raises(ValueError, match="grad_out"):
        fn(tables, idx, [g[:, :4] for g in grad_out])
    with pytest.raises(ValueError, match="adjacent columns"):
        fn(tables, idx, [g.t().contiguous().t() for g in grad_out])
    with pytest.raises(ValueError, match="grad_out"):
        fn(tables, idx, list(grad_out[:1]))
    assert counter.launches == before


def _forward_card_case(cuda, rows, D, B, L, dtype, seed):
    tables, idx, _ = _tables_case(rows, D, B, L, hub=0.1, past=True,
                                  seed=seed)
    return ([_t(x).to(cuda, getattr(torch, dtype)) for x in tables],
            _t(idx).to(cuda))


def _in_l_order(table, idx, mode):
    """The bags as the kernel computes them, so its bits: float32 adds (or
    maxes over the valid ids) position by position in l order from 0 (or
    the dtype's lowest value), mean's one float32 divide, one rounding to
    the table's dtype."""
    g = table[wrap_and_clamp(idx, table.shape[0])].float()  # (B, L, D)
    valid = (idx < table.shape[0] - 1)[..., None]
    if mode == "max":
        acc = torch.full_like(g[:, 0], torch.finfo(table.dtype).min)
        for l in range(idx.shape[1]):
            acc = torch.where(valid[:, l], torch.maximum(acc, g[:, l]), acc)
    else:
        acc = torch.zeros_like(g[:, 0])
        for l in range(idx.shape[1]):
            acc = acc + g[:, l]
        if mode == "mean":
            acc = acc / valid.sum(dim=1).clamp(min=1).float()
    return acc.to(table.dtype)


def _reordering(table, idx, mode):
    """|kernel - plain| per element allowed for a float32 bag: two sums of
    the same L terms in other orders differ by at most 2 (L - 1) 2^-24
    sum|term|, mean's divides each round once more; max is exact."""
    g = table[wrap_and_clamp(idx, table.shape[0])].float()
    if mode == "max":
        return torch.zeros_like(g[:, 0])
    bound = 2 * (idx.shape[1] - 1) * 2.0 ** -24 * g.abs().sum(dim=1)
    if mode == "mean":
        cnt = (idx < table.shape[0] - 1).sum(dim=1).clamp(min=1).float()
        bound = (bound + 2.0 ** -23 * g.abs().sum(dim=1)) / cnt[:, None]
    return bound


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", [
    ((70_000, 30_000, 5_000), 64, 65_536, 1),  # RM2-like, 4 bags a tile
    ((5_000, 3_000), 13, 4_000, 8),            # 4-byte columns, passes of 2
    ((257, 1_100, 40), 200, 3_000, 3),         # 800-byte rows, two chunks
    ((4_099, 2_000), 6, 9_000, 2),             # short vectors, 2 bags of 2
    ((2_000,) * 26, 64, 2_048, 8),             # RM2's 26 tables, D, L = 8
])
def test_grouped_forward_matches_plain_on_card(cuda, shape, mode, dtype):
    rows, D, B, L = shape
    tables, idx = _forward_card_case(cuda, rows, D, B, L, dtype, seed=B + D)
    counter = ops.KERNELS["embedding_bag"]
    before = counter.launches
    out = bag_kernel.embedding_bags(tables, idx, mode=mode)
    torch.cuda.synchronize()
    assert counter.launches == before + 1  # one launch, whatever T is
    assert out.shape == (len(rows), B, D) and out.dtype == tables[0].dtype
    for t in range(len(rows)):
        assert torch.equal(out[t], _in_l_order(tables[t], idx[t], mode))
        want = embedding_bag_ref(tables[t], idx[t], mode)
        if dtype == "float32":
            err = (out[t] - want).abs()
            assert bool((err <= _reordering(tables[t], idx[t], mode)).all())
        else:
            torch.testing.assert_close(out[t].float(), want.float(),
                                       rtol=_BAG_TOL[dtype],
                                       atol=_BAG_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", MODES)
def test_grouped_forward_is_the_one_table_wrapper_table_by_table(
        cuda, mode, dtype):
    """Each table of a grouped call (and a call of one table, T = 1) gives
    the one-table wrapper's bits."""
    tables, idx = _forward_card_case(cuda, (9_000, 500, 3_000), 64, 20_000,
                                     1, dtype, seed=3)
    grouped = bag_kernel.embedding_bags(tables, idx, mode=mode)
    for t in range(3):
        alone = bag_kernel.embedding_bags(tables[t:t + 1], idx[t:t + 1],
                                          mode=mode)
        one = ops.KERNELS["embedding_bag"](tables[t], idx[t], mode=mode)
        assert torch.equal(grouped[t], one) and torch.equal(alone[0], one)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
def test_backward_takes_the_forward_views(cuda, mode):
    """The dispatcher's bags on the card are views of one (T, B, D) tensor;
    the backward takes them as grad_out as they are."""
    tables, idx, _ = _card_case(cuda, (3_000, 1_000, 2_000), 64, 4_096, 2,
                                0.3, seed=5)
    outs = embedding_bags(tables, idx, mode=mode)
    base = outs[0].data_ptr()
    assert [o.data_ptr() - base for o in outs] == \
        [t * 4_096 * 64 * 4 for t in range(3)]
    assert all(o.stride() == (64, 1) for o in outs)
    got = embedding_bags_backward(tables, idx, outs, mode=mode)
    dense = embedding_bags_backward(tables, idx, [o.clone() for o in outs],
                                    mode=mode)
    assert all(torch.equal(a, b) for a, b in zip(got, dense))


@pytest.mark.gpu
def test_grouped_forward_refuses_on_card(cuda):
    tables, idx = _forward_card_case(cuda, (50, 40), 8, 20, 2, "float32",
                                     seed=1)
    fn = bag_kernel.embedding_bags
    counter = ops.KERNELS["embedding_bag"]
    before = counter.launches
    with pytest.raises(ValueError, match="like the first"):
        fn([tables[0], tables[1].to(torch.bfloat16)], idx)
    with pytest.raises(ValueError, match="like the first"):
        fn([tables[0], tables[1][:, :4].contiguous()], idx)
    with pytest.raises(ValueError, match="like the first"):
        fn([tables[0], tables[1].cpu()], idx)
    with pytest.raises(ValueError, match="CUDA device"):
        fn(tables, idx.cpu())
    assert counter.launches == before


# ---------------------------------------------------------------------------
# Row windows on the card (a rank's block of a row-sharded table).
# ---------------------------------------------------------------------------

def _bag_case(rows: int, D: int, B: int, L: int, seed: int) -> tuple:
    """A float32 table with tied rows, ids with wrapped negatives, the dump
    row, ids at and past the table and below -rows (the clamp), and the
    (B, D) cotangent."""
    rng = np.random.default_rng(seed)
    table = np.round(rng.normal(size=(rows, D)), 1).astype(np.float32)
    table[3] = table[rows - 7]
    idx = rng.integers(-rows, rows, size=(B, L)).astype(np.int32)
    idx[0, 0], idx[1, 0], idx[2, 0] = rows - 1, rows, rows + 9
    idx[3, 0], idx[4, 0] = -rows - 5, -1
    g = rng.normal(size=(B, D)).astype(np.float32)
    return (torch.from_numpy(table), torch.from_numpy(idx),
            torch.from_numpy(g))


def _card_windows(cuda, rows, D, B, L, cuts, seed):
    """T tables of ``rows`` rows each cut at ``cuts`` (one window a table
    per shard), their (T, B, L) ids (wrapped, clamped, past the table) and
    cotangents, on the card."""
    cases = [_bag_case(r, D, B, L, seed + t) for t, r in enumerate(rows)]
    tables = [c[0].to(cuda) for c in cases]
    idx = torch.stack([c[1] for c in cases]).to(cuda)
    g = [c[2].to(cuda) for c in cases]
    shards = []
    for k in range(len(cuts) - 1):
        lo = [int(c * r) for c, r in zip([cuts[k]] * len(rows), rows)]
        hi = [int(cuts[k + 1] * r) for r in rows]
        shards.append(([t[a:b].contiguous() for t, a, b in zip(tables, lo,
                                                               hi)],
                       [(a, r) for a, r in zip(lo, rows)]))
    return tables, idx, g, shards


@pytest.mark.gpu
@pytest.mark.parametrize("L", [1, 3])
@pytest.mark.parametrize("cuts", [(0, 0.37, 1.0), (0, 0.25, 0.5, 0.75, 1.0)])
def test_windowed_kernel_is_the_windowed_plain_version(cuda, cuts, L):
    """Each shard's kernel bags are the windowed plain version's bits at
    L = 1 (float32 adds in l order at L > 1), and sum over the shards to
    the whole table's kernel bags; each shard's gradient is the chunked
    restatement's bits and within the reordering bound of the windowed
    plain backward, the same bits twice. The last shard holds the clamped
    last row."""
    rows = (70_001, 30_000, 5_003)
    tables, idx, g, shards = _card_windows(cuda, rows, 64, 20_000, L, cuts,
                                           seed=L)
    whole = bag_kernel.embedding_bags(tables, idx)
    total = torch.zeros_like(whole)
    for blocks, wins in shards:
        out = bag_kernel.embedding_bags(blocks, idx, windows=wins)
        total += out
        for t, (blk, (lo, wh)) in enumerate(zip(blocks, wins)):
            want = embedding_bag_ref(blk, idx[t], row_lo=lo, rows_global=wh)
            if L == 1:
                assert torch.equal(out[t], want)
            else:
                read = wrap_and_clamp(idx[t], wh) - lo
                inside = ((read >= 0) & (read < blk.shape[0]))[..., None]
                rows_ = torch.where(inside, blk[read.clamp(0, blk.shape[0]
                                                           - 1)], 0.0)
                acc = torch.zeros_like(out[t])
                for l in range(L):
                    acc = acc + rows_[:, l]
                assert torch.equal(out[t], acc)
        grads = bag_kernel.embedding_bags_backward(blocks, idx, g,
                                                   windows=wins)
        again = bag_kernel.embedding_bags_backward(blocks, idx, g,
                                                   windows=wins)
        chunked = embedding_bags_backward_chunked_ref(blocks, idx, g, wins)
        for t, (blk, (lo, wh)) in enumerate(zip(blocks, wins)):
            assert torch.equal(grads[t], again[t])
            assert torch.equal(grads[t], chunked[t])
            want = embedding_bag_backward_ref(blk, idx[t], g[t], row_lo=lo,
                                              rows_global=wh)
            mag = embedding_bag_backward_ref(blk, idx[t], g[t].abs(),
                                             row_lo=lo, rows_global=wh)
            read = wrap_and_clamp(idx[t], wh) - lo
            n = blk.shape[0]
            read = torch.where((read >= 0) & (read < n), read, n)
            k = torch.bincount(read.flatten(), minlength=n + 1)[:-1].float()
            bound = 2 * (k[:, None] - 1).clamp(min=0) * 2.0 ** -24 * mag
            assert bool(((grads[t] - want).abs() <= bound).all())
    if L == 1:
        assert torch.equal(total, whole)
    # the clamped last row (ids rows and rows + 9) is in the last shard
    last_blocks, last_wins = shards[-1]
    assert last_wins[0][0] + last_blocks[0].shape[0] == rows[0]


@pytest.mark.gpu
def test_whole_window_is_the_one_rank_call_on_card(cuda):
    """A window of the whole table gives the call without windows, bits and
    launches alike."""
    tables, idx, g, _ = _card_windows(cuda, (9_000, 500), 64, 4_096, 2,
                                      (0, 1.0), seed=9)
    wins = [(0, t.shape[0]) for t in tables]
    counts = ops.launch_counts()
    a = bag_kernel.embedding_bags(tables, idx)
    b = bag_kernel.embedding_bags(tables, idx, windows=wins)
    ga = bag_kernel.embedding_bags_backward(tables, idx, g)
    gb = bag_kernel.embedding_bags_backward(tables, idx, g, windows=wins)
    after = ops.launch_counts()
    assert torch.equal(a, b)
    assert all(torch.equal(x, y) for x, y in zip(ga, gb))
    assert after["embedding_bag"] - counts["embedding_bag"] == 2
    assert after["embedding_bag_backward"] - \
        counts["embedding_bag_backward"] == 2
