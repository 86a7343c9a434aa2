"""The fused gather and segment sum (``repro_torch.kernels.segments``'s
``gather_sum`` over ``ops.gather_sum``) against the reference's GIN
aggregation,

    jax.ops.segment_sum(jnp.where(valid[:, None], h[senders], 0),
                        receivers, n1)

and its ``jax.grad`` in ``h`` (``src/repro/legacy/models/gnn.py``), on
inputs made from numpy seeds: padded edges on the dump row, a hub, empty
rows, receivers out of range; the plain version and the autograd function,
in float32 and bfloat16. The permuted-id cache, the wrapper's refusals, and
on the card (``gpu``, skipped here) the kernel against its plain version in
float64 within the float32 reordering bound, the same bits twice, the same
bits as the three-op path (index_select, where, segment_sum) forward and
backward, and a small call in one launch where no row spans chunks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.segment import kernel as seg_kernel
from repro_torch.kernels.segment.ref import gather_sum_ref, segment_sum_ref
from repro_torch.kernels.segments import (
    Segments,
    gather,
    gather_sum,
    segment_sum,
)

WIDTHS = [1, 3, 16, 64, 100]
# float32: the CPU's plain version adds each row in the reference's order
# (index_add_ and XLA's scatter both walk the edges in order), so the two
# agree to float32 rounding; 1e-5 of the largest magnitude covers a
# reordered add of the hub's 150 entries
F32_TOL = 1e-5


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _graph(seed: int, n_real: int = 60, m_real: int = 600, pad: int = 100):
    """``n_real`` nodes and a dump row (n1 = n_real + 1): ``m_real`` edges
    whose receivers skip every fifth node (empty rows), 150 of them into
    node 7 (a hub), 10 into ids outside ``[0, n1)`` (dropped), then ``pad``
    padded edges on the dump row."""
    rng = np.random.default_rng(seed)
    n1 = n_real + 1
    s = rng.integers(0, n_real, m_real)
    targets = np.array([v for v in range(n_real) if v % 5 != 0])
    r = rng.choice(targets, m_real)
    r[rng.choice(m_real, 150, replace=False)] = 7
    r[rng.choice(m_real, 10, replace=False)] = rng.choice(
        [-3, -1, n1, n1 + 4], 10)
    senders = np.concatenate([s, np.full(pad, n1 - 1)]).astype(np.int32)
    receivers = np.concatenate([r, np.full(pad, n1 - 1)]).astype(np.int32)
    return senders, receivers, n1


def _jax_agg(h, senders, receivers, n1):
    valid = senders < n1 - 1
    return jax.ops.segment_sum(
        jnp.where(valid[:, None], h[senders], jnp.zeros((), h.dtype)),
        receivers, n1)


def _bf16_bound(h64, senders, receivers, n1):
    """A bfloat16 sum of c entries, rounded at each add: c 2^-8 sum|x| a
    row (float64)."""
    valid = (senders < n1 - 1)[:, None]
    a = np.where(valid, np.abs(h64[senders]), 0.0)
    ok = (receivers >= 0) & (receivers < n1)
    absum = np.zeros((n1, h64.shape[1]))
    np.add.at(absum, receivers[ok], a[ok])
    count = np.bincount(receivers[ok], minlength=n1)[:, None]
    return count * 2.0 ** -8 * absum


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", WIDTHS)
def test_gather_sum_matches_jax(width, dtype):
    senders, receivers, n1 = _graph(width)
    rng = np.random.default_rng(100 + width)
    h = rng.normal(size=(n1, width)).astype(np.float32)
    w = rng.normal(size=(n1, width)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    hj = jnp.asarray(h).astype(jdt)
    want = np.asarray(_jax_agg(hj, senders, receivers, n1), np.float64)
    jgrad = np.asarray(jax.grad(lambda x: jnp.sum(
        _jax_agg(x, senders, receivers, n1).astype(jnp.float32) * w))(hj),
        np.float64)

    s, r = _t(senders), _t(receivers)
    recv = Segments.of(r, n1)
    ht = _t(h).to(tdt).requires_grad_(True)
    got = gather_sum(ht, s, recv, n1 - 1)
    fwd = recv.gathered(s, id_limit=n1 - 1, row_limit=n1)
    plain = ops.gather_sum(ht.detach(), fwd.ids, recv.offsets)
    ref = gather_sum_ref(ht.detach(), fwd.ids, recv.offsets)
    (g,) = torch.autograd.grad((got.float() * _t(w)).sum(), ht)
    assert got.dtype == tdt and got.shape == (n1, width)
    assert torch.equal(plain, got.detach()) and torch.equal(ref, plain)
    # the empty rows (every fifth node) and the dump row are zero
    assert bool((got[0::5] == 0).all()) and bool((got[n1 - 1] == 0).all())
    assert bool((g[n1 - 1] == 0).all())  # the dump row's messages are masked
    got64, g64 = got.detach().double().numpy(), g.double().numpy()
    if dtype == "float32":
        for a, b in ((got64, want), (g64, jgrad)):
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=F32_TOL * np.abs(b).max())
        return
    # bfloat16: both add in bfloat16; each within the bf16 bound of the
    # float64 sum of the same bfloat16 inputs
    h64 = np.asarray(hj.astype(jnp.float32), np.float64)
    exact = np.zeros((n1, width))
    ok = (receivers >= 0) & (receivers < n1)
    valid = (senders < n1 - 1)[:, None]
    np.add.at(exact, receivers[ok], np.where(valid, h64[senders], 0.0)[ok])
    bound = _bf16_bound(h64, senders, receivers, n1) + 1e-30
    assert np.all(np.abs(got64 - exact) <= bound)
    assert np.all(np.abs(want - exact) <= bound)
    # the gradient: each h row's bf16 sum of the cotangents of its edges
    gw = np.asarray(jnp.asarray(w).astype(jnp.bfloat16).astype(jnp.float32),
                    np.float64)
    exact_g = np.zeros((n1, width))
    live = (senders < n1 - 1) & ok
    np.add.at(exact_g, senders[live], gw[receivers[live]])
    absum_g = np.zeros((n1, width))
    np.add.at(absum_g, senders[live], np.abs(gw[receivers[live]]))
    count_g = np.bincount(senders[live], minlength=n1)[:, None]
    bound_g = count_g * 2.0 ** -8 * absum_g + 2.0 ** -8 * np.abs(exact_g)
    assert np.all(np.abs(g64 - exact_g) <= bound_g + 1e-30)
    assert np.all(np.abs(jgrad - exact_g) <= bound_g + 1e-30)


@pytest.mark.parametrize("width", [1, 16, 100])
def test_gather_sum_is_the_three_op_path_bit_for_bit(width):
    """On the CPU the fused function and ``segment_sum(where(valid,
    gather(h, send), 0), recv)`` give the same bits, forward and
    backward."""
    senders, receivers, n1 = _graph(7 * width)
    rng = np.random.default_rng(width)
    h = _t(rng.normal(size=(n1, width)).astype(np.float32))
    w = _t(rng.normal(size=(n1, width)).astype(np.float32))
    s, r = _t(senders), _t(receivers)
    send, recv = Segments.of(s, n1), Segments.of(r, n1)
    a = h.clone().requires_grad_(True)
    b = h.clone().requires_grad_(True)
    fused = gather_sum(a, s, recv, n1 - 1)
    v = (s < n1 - 1)[:, None]
    three = segment_sum(torch.where(v, gather(b, send), 0.0), recv)
    assert torch.equal(fused, three)
    (ga,) = torch.autograd.grad((fused * w).sum(), a)
    (gb,) = torch.autograd.grad((three * w).sum(), b)
    assert torch.equal(ga, gb)


def test_gather_sum_without_a_limit_takes_every_position():
    rng = np.random.default_rng(5)
    x = _t(rng.normal(size=(9, 4)).astype(np.float32))
    idx = _t(rng.integers(0, 9, 40).astype(np.int32))
    ids = _t(rng.integers(0, 6, 40).astype(np.int32))
    got = gather_sum(x, idx, Segments.of(ids, 6))
    want = segment_sum(x[idx.long()], Segments.of(ids, 6))
    assert torch.equal(got, want)
    # trailing dimensions are flattened and restored
    x3 = x.reshape(9, 2, 2)
    assert torch.equal(gather_sum(x3, idx, Segments.of(ids, 6)),
                       want.reshape(6, 2, 2))


def test_permuted_ids_are_made_once_and_anew_after_a_write():
    s = torch.tensor([4, 0, 2, 1, 3, 4], dtype=torch.int32)
    r = torch.tensor([1, 0, 1, 2, -1, 4], dtype=torch.int32)
    recv = Segments.of(r, 5)
    a = recv.gathered(s, id_limit=4, row_limit=5)
    assert recv.gathered(s, id_limit=4, row_limit=5) is a       # cached
    assert recv.gathered(s, id_limit=5, row_limit=5) is not a   # another mask
    # order: row 0 (entry 1), row 1 (entries 0, 2), row 2 (3), row 4 (5),
    # then the dropped entry 4; ids >= 4 and the dropped row masked
    assert recv.order.tolist() == [1, 0, 2, 3, 5, 4]
    assert a.ids.tolist() == [0, -1, 2, 1, -1, -1]
    assert a.id_limit == 4 and a.plan is recv.plan   # the layout's plan
    rows = recv.gathered(r, id_limit=5, row_limit=2)  # a limit on rows
    assert rows.ids.tolist() == [0, 1, 1, -1, -1, -1]
    s[1] = 3                                  # an in-place write
    b = recv.gathered(s, id_limit=4, row_limit=5)
    assert b is not a and b.ids.tolist() == [3, -1, 2, 1, -1, -1]
    with pytest.raises(ValueError, match="gathered ids"):
        recv.gathered(s[:4], id_limit=4, row_limit=5)


def test_gather_sum_refuses_ids_out_of_range():
    x = torch.zeros(5, 3)
    ids = torch.tensor([0, 1, 2], dtype=torch.int32)
    for bad in (5, -1):
        idx = torch.tensor([0, bad, 2], dtype=torch.int32)
        with pytest.raises(ValueError, match="gather_sum"):
            gather_sum(x, idx, Segments.of(ids, 3))


def test_gather_sum_wrapper_rejects_what_it_cannot_take():
    fn = ops.KERNELS["gather_sum"]
    before = fn.launches
    x = torch.zeros(6, 4)
    ids = torch.tensor([0, 5, -1, 2, 3, 1], dtype=torch.int32)
    offsets = torch.tensor([0, 3, 6], dtype=torch.int32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fn(x.double(), ids, offsets)
    with pytest.raises(ValueError, match="contiguous"):
        fn(torch.zeros(4, 6).t(), ids, offsets)
    with pytest.raises(ValueError, match="CUDA device"):
        fn(x, ids, offsets)               # right types, but on the CPU
    with pytest.raises(TypeError, match="int32"):
        fn(x, ids.long(), offsets)
    with pytest.raises(ValueError, match="outside"):
        fn(x[:5], ids, offsets)           # id 5 of 5 rows
    plan = seg_kernel.SegmentPlan(offsets, ids.shape[0])
    with pytest.raises(ValueError, match="other offsets"):
        fn(x, ids, offsets.clone(), plan=plan)
    with pytest.raises(ValueError, match="another count"):
        fn(x, ids[:5], offsets, plan=plan)
    with pytest.raises(ValueError, match="outside"):   # a bound past x
        fn(x, ids, offsets, plan=plan, id_max=6)
    assert fn.launches == before


def test_plans_are_kept_with_the_layout():
    s = torch.tensor([3, 0, 2, 1, 0], dtype=torch.int32)
    r = torch.tensor([1, 0, 1, 2, 9], dtype=torch.int32)
    recv = Segments.of(r, 4)
    assert recv.total == 4 and not recv.all_valid
    plan = recv.plan
    assert plan is recv.plan and plan.offsets is recv.offsets
    assert (plan.total, plan.m, plan.chunk, plan.n_chunks) == (4, 5, 32, 1)
    # the counts came with the sort's one host sync: rows 0, 1, 2 filled
    assert recv.counts == [4, 3, 0] and (plan.n_nz, plan.n_span) == (3, 0)
    fwd = recv.gathered(s, id_limit=3, row_limit=4)
    assert fwd.plan is plan and fwd.id_limit == 3
    # chunks of 32 to 256 positions, each chunk's first row
    assert [seg_kernel.chunk_of(m) for m in (10, 1 << 18, 1 << 20, 1 << 26)
            ] == [32, 64, 256, 256]
    offsets = torch.tensor([0, 0, 40, 40, 50, 100, 100], dtype=torch.int32)
    p = seg_kernel.SegmentPlan(offsets, 100)
    assert (p.n_nz, p.n_span, p.total, p.n_chunks) == (3, 2, 100, 4)
    address = p.prepare(3)
    # the non-empty rows 1, 3, 4 start at 0, 40, 50; chunks of 32
    # positions start in the non-empty rows 0, 0, 2, 2 of them; rows 1
    # (positions 0-39) and 4 (50-99) span chunks, row 3 (40-49) does not
    assert p.nz.tolist() == [1, 3, 4] and p.empty.tolist() == [0, 2, 5]
    assert p.coff.tolist() == [0, 40, 50, 100]
    assert p.first.tolist() == [0, 0, 2, 2] and p.spans.tolist() == [1, 4]
    assert p.scratch.shape == (2, 4, 3)
    scratch = p.scratch
    assert p.prepare(2) == address and p.scratch is scratch
    assert p.prepare(5) == address and p.scratch.shape == (2, 4, 5)
    assert (p._layout.d_max, p._layout.n_empty, p._layout.n_span) == (5, 3,
                                                                      2)
    # a layout whose ids are all dropped: one chunk, no non-empty row
    q = seg_kernel.SegmentPlan(torch.zeros(4, dtype=torch.int32), 7)
    q.prepare(1)
    assert (q.total, q.n_chunks, q.n_span, q.first.tolist(),
            q.empty.tolist()) == (0, 1, 0, [0], [0, 1, 2])


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_graph(gen, n1: int, m: int, hub: int):
    """``m`` edge slots over ``n1`` rows on the card: a hub of ``hub``
    receivers, some receivers out of range, the last tenth padded onto the
    dump row."""
    s = torch.randint(0, n1 - 1, (m,), generator=gen, device="cuda",
                      dtype=torch.int32)
    r = torch.randint(-4, n1 + 4, (m,), generator=gen, device="cuda",
                      dtype=torch.int32)
    r[:hub] = 17
    s[-(m // 10):] = n1 - 1
    r[-(m // 10):] = n1 - 1
    return s, r


def _within_reorder_bound(got, x, fwd, offsets):
    """``got`` against the plain version in float64: count 2^-24 sum|x| a
    row, and one rounding to bfloat16."""
    want = gather_sum_ref(x.double(), fwd.ids, offsets)
    absum = gather_sum_ref(x.double().abs(), fwd.ids, offsets)
    live = (fwd.ids >= 0).double()
    counts = segment_sum_ref(live[:, None], torch.arange(
        live.shape[0], device=live.device), offsets)
    bound = counts * 2.0 ** -24 * absum
    if x.dtype == torch.bfloat16:
        bound = bound + 2.0 ** -8 * want.abs()
    return bool(((got.double() - want).abs() <= bound + 1e-30).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [1, 3, 16, 64, 100, 160])
def test_gather_sum_kernel_matches_plain_on_card(cuda, dtype, width):
    """Rows of 0 to ~3,000 positions (a hub, the dump row's padding masked),
    1.2 M positions (chunks of 256, rows spanning many): within the float32
    reordering bound, the same bits on a second call, the wrapper counted
    once a call."""
    gen = torch.Generator(device="cuda").manual_seed(width)
    n1, m = 50_001, 1_200_000
    s, r = _card_graph(gen, n1, m, 3000)
    x = torch.randn(n1, width, generator=gen, device=cuda).to(dtype)
    recv = Segments(r, n1)
    fwd = recv.gathered(s, id_limit=n1 - 1, row_limit=n1)
    before = ops.KERNELS["gather_sum"].launches
    got = fwd.sum(x)
    again = fwd.sum(x)
    torch.cuda.synchronize()
    assert ops.KERNELS["gather_sum"].launches == before + 2
    assert got.dtype == dtype and torch.equal(got, again)
    assert _within_reorder_bound(got, x, fwd, recv.offsets)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [1, 64, 100])
def test_gather_sum_is_the_three_op_path_on_card(cuda, dtype, width):
    """GIN's aggregation and its gradient through the kernel, bit for bit
    the three-op path (index_select, where, segment_sum) on the same
    layouts."""
    gen = torch.Generator(device="cuda").manual_seed(1 + width)
    n1, m = 20_001, 600_000
    s, r = _card_graph(gen, n1, m, 2000)
    r = r.clamp(0, n1 - 1)  # GIN's receivers are all in range
    h = torch.randn(n1, width, generator=gen, device=cuda).to(dtype)
    w = torch.randn(n1, width, generator=gen, device=cuda).to(dtype)
    send, recv = Segments.of(s, n1), Segments.of(r, n1)
    a = h.clone().requires_grad_(True)
    b = h.clone().requires_grad_(True)
    before = ops.launch_counts()
    fused = gather_sum(a, s, recv, n1 - 1)
    (ga,) = torch.autograd.grad((fused * w).sum(), a)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["gather_sum"] == before["gather_sum"] + 2
    assert after["segment_sum"] == before["segment_sum"]
    zero = torch.zeros((), dtype=dtype, device=cuda)
    three = segment_sum(torch.where((s < n1 - 1)[:, None], gather(b, send),
                                    zero), recv)
    (gb,) = torch.autograd.grad((three * w).sum(), b)
    assert torch.equal(fused, three) and torch.equal(ga, gb)


def _launches(torch_fn) -> int:
    """The kernels ``torch_fn`` launches on the card (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch_fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if "segment_sum" in e.name or "gather_sum" in e.name)


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ["segment_sum", "gather_sum"])
def test_small_calls_are_one_launch_on_card(cuda, entry):
    """A few hundred positions with empty rows at the start, inside and at
    the end: where no row spans chunks, one launch a call, else two (the
    pieces added by the second); against the plain version, no scratch
    made after the first call; a layout whose ids are all dropped writes
    zeros."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    n1, m = 300, 704
    idx = torch.randint(0, n1, (m,), generator=gen, device=cuda,
                        dtype=torch.int32)
    x = torch.randn(n1 if entry == "gather_sum" else m, 24, generator=gen,
                    device=cuda)
    spanning = torch.randint(40, 260, (m,), generator=gen, device=cuda,
                             dtype=torch.int32)
    spanning[:90] = 100                      # a row across three chunks
    # rows of 8 positions from row 40, every other row: none spans a chunk
    inside = 40 + 2 * (torch.arange(m, device=cuda, dtype=torch.int32) // 8)
    fn = ops.KERNELS[entry]
    for ids, spans in ((spanning, True), (inside, False)):
        segs = Segments(ids, n1)
        if entry == "gather_sum":
            fwd = segs.gathered(idx, id_limit=n1 - 7, row_limit=n1)
            call, plan = (lambda: fwd.sum(x)), fwd.plan
            want = gather_sum_ref(x.double(), fwd.ids, segs.offsets)
        else:
            call, plan = (lambda: segs.sum(x)), segs.plan
            want = segment_sum_ref(x.double(), segs.order, segs.offsets)
        assert (plan.n_span > 0) == spans
        got = call()
        scratch = plan.scratch
        before = fn.launches
        for _ in range(5):
            assert torch.equal(call(), got)
        torch.cuda.synchronize()
        assert fn.launches == before + 5
        assert _launches(call) == (2 if spans else 1)
        assert plan.scratch is scratch
        assert float((got.double() - want).abs().max()) <= 1e-4
        assert bool((got[:40] == 0).all()) and bool((got[260:] == 0).all())
    dropped = Segments(torch.full((m,), -1, dtype=torch.int32, device=cuda),
                       n1)
    assert dropped.total == 0
    out = dropped.sum(torch.ones(m, 5, device=cuda))
    assert out.shape == (n1, 5) and bool((out == 0).all())
