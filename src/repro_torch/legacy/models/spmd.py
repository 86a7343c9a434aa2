"""The LM's mesh path: specs, collectives with gradients, and the
``shard`` object the model functions take on a mesh.

Every rank runs the same program on its blocks of the parameters, the
batch and the cache (``launch/shardings.py`` chooses the specs). The
gradients follow Megatron's conventions, with data parallelism:

  * **model axis.** Activations between sublayers are whole on every
    model rank and the same there (*invariant*); a rank's gradient of an
    invariant tensor is the whole gradient. Where an invariant tensor
    feeds this rank's heads or columns it passes ``enter`` (identity; its
    backward sums over the axis: Megatron's *f*), and where the ranks'
    partial products meet it passes ``reduce_sum`` (a sum; its backward
    is the identity: Megatron's *g*). A weight gathered over ``model`` is
    used whole, so its gather's backward keeps this rank's block.
  * **data axes.** Each rank holds its part of the batch. The loss is the
    same value on every rank, its sums taken by ``reduce_sum``, so each
    rank's backward differentiates its own tokens' part: a parameter's
    gradient is summed over the data axes, by the FSDP gather's backward
    (a reduce-scatter) for a leaf split over them, and after the backward
    (``MeshShard.sync_grads``) for a leaf whole over them. Where the batch
    is whole on every rank (B = 1), nothing is summed.

``MeshShard`` takes the place of ``layers.no_shard`` on a mesh: it moves
nothing by itself; ``layout`` says where the reference's constraint
would split an activation, and the model functions compute accordingly.
"""

from __future__ import annotations

import contextlib
import time
from typing import Sequence

import torch

from ...core import collectives as coll
from .layers import div

__all__ = ["extent", "spec_axes", "local_shape", "local_block",
           "tree_paths", "tree_rebuild", "spec_leaves", "spec_map",
           "comm_timer", "enter", "reduce_sum", "gather", "gather_rows",
           "rs_chain", "all_to_all", "a2a_int8", "scale_grad", "MeshShard"]


# ---------------------------------------------------------------------------
# Specs: per-dimension tuples of None, an axis name, or a tuple of names.
# ---------------------------------------------------------------------------

def spec_axes(entry) -> tuple:
    """The mesh axes of one spec entry, as a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def extent(mesh, axes) -> int:
    """The number of ranks along ``axes`` (``None``, a name or names)."""
    return coll.mesh_size(mesh, spec_axes(axes))


def local_shape(shape: tuple, spec: tuple, mesh) -> tuple:
    """A rank's block shape of an array of ``shape`` laid out by ``spec``
    on ``mesh`` (a real or a shape-only mesh)."""
    shape = tuple(shape)
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than {shape}")
    out = list(shape)
    for i, e in enumerate(spec):
        k = extent(mesh, e)
        if shape[i] % k:
            raise ValueError(f"dimension {i} of {shape} does not split "
                             f"over {e} ({k} ranks)")
        out[i] = shape[i] // k
    return tuple(out)


def local_block(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of a global array (a view)."""
    per = local_shape(tuple(x.shape), spec, mesh)
    for i, e in enumerate(spec):
        if per[i] != x.shape[i]:
            at = coll.shard_index(mesh, spec_axes(e)) * per[i]
            x = x.narrow(i, at, per[i])
    return x


def _is_leaf(x) -> bool:
    """A tensor, a shape or a spec: a tuple of ints, names, ``None`` or
    tuples of names (not a ``NamedTuple``)."""
    if isinstance(x, torch.Tensor):
        return True
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        e is None or isinstance(e, (int, str)) or (
            isinstance(e, tuple) and all(isinstance(n, str) for n in e))
        for e in x)


def tree_paths(tree, prefix: str = "") -> list:
    """``[(path, leaf)]`` of a pytree of tensors, shapes or specs in the
    reference's leaf order: dict keys sorted and joined by ``/``, list
    positions as numbers, a ``NamedTuple``'s fields by name."""
    join = (lambda k: f"{prefix}/{k}") if prefix else str
    if _is_leaf(tree):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in tree_paths(tree[k],
                                                              join(k))]
    if hasattr(tree, "_fields"):
        return [pl for k in tree._fields
                for pl in tree_paths(getattr(tree, k), join(k))]
    return [pl for i, x in enumerate(tree) for pl in tree_paths(x, join(i))]


def tree_rebuild(tree, leaves: list):
    """``leaves`` (``tree_paths`` order) in ``tree``'s structure."""
    it = iter(leaves)

    def walk(t):
        if _is_leaf(t):
            return next(it)
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if hasattr(t, "_fields"):
            return type(t)(*(walk(getattr(t, k)) for k in t._fields))
        return type(t)(walk(x) for x in t)
    return walk(tree)


def spec_leaves(tree) -> list:
    return [s for _, s in tree_paths(tree)]


def spec_map(fn, tree):
    """``fn`` over every spec of a spec pytree, in its structure."""
    return tree_rebuild(tree, [fn(s) for s in spec_leaves(tree)])


# ---------------------------------------------------------------------------
# Collectives (torch.distributed, one process group an axis).
# ---------------------------------------------------------------------------

def _live(mesh, axes) -> list:
    return [a for a in axes if extent(mesh, a) > 1]


_TIMER: list = []  # the open ``comm_timer`` records, innermost last


@contextlib.contextmanager
def comm_timer():
    """Within it, every collective of this module waits for the card
    before and after it and adds its seconds and a count to the yielded
    record (``{"s", "calls"}``): an instrumented run, whose own wall is not
    the untimed one's."""
    rec = {"s": 0.0, "calls": 0}
    _TIMER.append(rec)
    try:
        yield rec
    finally:
        _TIMER.remove(rec)


def _timed(fn):
    def run(x, *args):
        if not _TIMER:
            return fn(x, *args)
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        out = fn(x, *args)
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        for rec in _TIMER:
            rec["s"] += time.perf_counter() - t0
            rec["calls"] += 1
        return out
    return run


@_timed
def _psum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    return coll.psum(x.contiguous(), mesh, _live(mesh, axes))


@_timed
def _pmax(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    return coll.pmax(x.contiguous(), mesh, _live(mesh, axes))


@_timed
def _gather(x: torch.Tensor, mesh, dim: int, axes) -> torch.Tensor:
    """Tiled gather along ``dim``: the blocks in row-major order of
    ``axes`` (the inverse of ``local_block``; ``coll.all_gather`` puts
    the last axis it is given slowest)."""
    live = _live(mesh, axes)
    if not live:
        return x
    y = coll.all_gather(x.movedim(dim, 0), mesh, tuple(reversed(live)))
    return y.movedim(0, dim)


def _block(x: torch.Tensor, mesh, dim: int, axes) -> torch.Tensor:
    k = extent(mesh, axes)
    if k == 1:
        return x
    per = x.shape[dim] // k
    return x.narrow(dim, coll.shard_index(mesh, axes) * per, per).contiguous()


@_timed
def _a2a(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``lax.all_to_all(split_axis=0, concat_axis=0, tiled=False)``."""
    if extent(mesh, axis) == 1:
        return x
    return coll.all_to_all(x, mesh, axis)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _psum(g, ctx.mesh, ctx.axes), None, None


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _psum(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, axes, summed):
        ctx.mesh, ctx.dim, ctx.axes, ctx.summed = mesh, dim, axes, summed
        return _gather(x, mesh, dim, axes)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:  # a reduce-scatter, in the gradient's dtype
            g = _psum(g, ctx.mesh, ctx.axes)
        return _block(g, ctx.mesh, ctx.dim, ctx.axes), None, None, None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _gather(x, mesh, 0, axes)

    @staticmethod
    def backward(ctx, g):
        with torch.no_grad():
            return rs_chain(g, ctx.mesh, ctx.axes, "sum"), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _a2a(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        # the exchange is its own transpose
        return _a2a(g, ctx.mesh, ctx.axis), None, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, c):
        ctx.c = c
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.c, None


def enter(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Identity; the backward sums the gradient over ``axes``."""
    if not _live(mesh, axes) or not x.requires_grad:
        return x
    return _Enter.apply(x, mesh, tuple(axes))


def reduce_sum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum over ``axes``; the backward is the identity."""
    if not _live(mesh, axes):
        return x
    if not x.requires_grad:
        return _psum(x, mesh, axes)
    return _ReduceSum.apply(x, mesh, tuple(axes))


def pmax(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The elementwise maximum over ``axes`` (no gradient)."""
    return _pmax(x.detach(), mesh, axes)


def gather(x: torch.Tensor, mesh, dim: int, axes, *,
           summed: bool) -> torch.Tensor:
    """All-gather along ``dim`` over ``axes``. The backward keeps this
    rank's block of the gradient, summed over ``axes`` first where
    ``summed`` (the gathered tensor was used per rank: FSDP)."""
    if not _live(mesh, axes):
        return x
    if not x.requires_grad:
        return _gather(x, mesh, dim, tuple(axes))
    return _Gather.apply(x, mesh, dim, tuple(axes), summed)


def gather_rows(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The tiled all-gather of row blocks over ``axes`` (blocks in the
    row-major order of ``axes``, ``local_block``'s); the backward is the
    reduce-scatter ``rs_chain(g, "sum")``: this rank's block of the
    gradient summed over ``axes`` (each rank used the gathered rows on a
    part of its own: the GNN's edge blocks)."""
    axes = tuple(_live(mesh, axes))
    if not axes:
        return x
    if not x.requires_grad:
        return _gather(x, mesh, 0, axes)
    return _GatherRows.apply(x, mesh, axes)


def rs_chain(x: torch.Tensor, mesh, axes, combine: str) -> torch.Tensor:
    """Reduce-scatter of rows over ``axes`` by all_to_all, an axis at a
    time (the reference's ``_rs_chain``): ``x`` (R, ...) becomes this
    rank's block of R / extent rows (``gather_rows``' order) of the sum
    (``combine="sum"``) or the maximum (``"max"``) over the ranks.
    Differentiable through ``all_to_all`` (a sum's gradient is the
    all-gather; a maximum's splits a tie evenly, as ``amax``'s)."""
    for ax in _live(mesh, axes):
        k = extent(mesh, ax)
        xs = all_to_all(x.reshape((k, x.shape[0] // k) + tuple(x.shape[1:])),
                        mesh, ax)
        x = xs.sum(0) if combine == "sum" else torch.amax(xs, 0)
    return x


def all_to_all(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``x`` is ``(k, ...)`` with ``k`` the axis size: row ``j`` goes to
    the rank at coordinate ``j``, and row ``j`` of the result came from
    it. Differentiable (the backward is the same exchange)."""
    if x.shape[0] != extent(mesh, axis):
        raise ValueError(f"all_to_all over {axis!r} takes "
                         f"{extent(mesh, axis)} chunks, got {x.shape[0]}")
    if not x.requires_grad:
        return _a2a(x, mesh, axis)
    return _AllToAll.apply(x, mesh, axis)


def scale_grad(x: torch.Tensor, c: float) -> torch.Tensor:
    """Identity; the backward multiplies the gradient by ``c``."""
    if c == 1.0 or not x.requires_grad:
        return x
    return _ScaleGrad.apply(x, c)


# --- the int8 all_to_all (the reference's ``a2a_int8``) ---------------------

def quant_i8(x: torch.Tensor) -> tuple:
    """Per-row (last dimension) symmetric int8: ``(q, scale)`` with
    ``scale = max(max|x|, 1e-8) / 127`` in float32 and ``q`` rounded to
    nearest even, clipped to ±127."""
    scale = torch.amax(torch.abs(x), dim=-1, keepdim=True).float()
    scale = div(torch.clamp(scale, min=1e-8), 127.0)
    q = torch.clamp(torch.round(x.float() / scale), -127, 127)
    return q.to(torch.int8), scale


def dequant_i8(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def _a2a_i8(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    q, s = quant_i8(x)
    return dequant_i8(_a2a(q, mesh, axis), _a2a(s, mesh, axis), x.dtype)


class _A2AInt8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _a2a_i8(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        # the cotangent goes through the same quantized exchange
        return _a2a_i8(g, ctx.mesh, ctx.axis), None, None


def a2a_int8(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``all_to_all`` with an int8 payload (and a float32 scale a row) on
    the wire, in both directions: the reference's ``a2a_int8``."""
    if x.shape[0] != extent(mesh, axis):
        raise ValueError(f"all_to_all over {axis!r} takes "
                         f"{extent(mesh, axis)} chunks, got {x.shape[0]}")
    return _A2AInt8.apply(x, mesh, axis)


# ---------------------------------------------------------------------------
# The shard object.
# ---------------------------------------------------------------------------

class MeshShard:
    """What the LM's functions take as ``shard`` on a mesh of several
    ranks (``launch.shardings.make_shard_fn``).

    ``specs`` is the model's parameter spec tree (global, with the layer
    leaves' leading ``L``); ``batch_split`` whether the cell's batch is
    split over the data axes. ``bax`` are the axes the batch is split over
    (the data axes, or none); ``M`` and ``m`` the model axis' size and this
    rank's coordinate on it."""

    def __init__(self, mesh, specs=None, *, batch_split: bool):
        self.mesh = mesh
        self.specs = specs
        names = tuple(mesh.mesh_dim_names)
        self.dax = tuple(a for a in names if a in ("pod", "data"))
        self.batch_split = batch_split
        self.bax = self.dax if batch_split else ()
        self.M = extent(mesh, "model") if "model" in names else 1
        self.m = int(mesh.get_local_rank("model")) if self.M > 1 else 0

    def layout(self, shape: tuple, logical_axes) -> tuple:
        """The reference's ``make_shard_fn`` decision for an activation of
        global ``shape``: per dimension the mesh axes it would be split
        over (``"data"`` → the data axes, ``"model"``/``"expert"``/
        ``"seq"`` → ``model``), ``None`` where the constraint is dropped
        because the axes do not divide it."""
        table = {"data": self.dax, "model": ("model",),
                 "expert": ("model",), "seq": ("model",)}
        out = []
        for dim, a in zip(shape, logical_axes):
            axes = table.get(a)
            if not axes or dim % extent(self.mesh, axes):
                out.append(None)
            else:
                out.append(axes[0] if len(axes) == 1 else tuple(axes))
        return tuple(out)

    def splits(self, n: int) -> bool:
        """Whether a ``"model"`` constraint holds on a dimension of ``n``."""
        return self.layout((n,), ("model",))[0] is not None

    # -- collectives named by role ------------------------------------------
    def enter(self, x):
        return enter(x, self.mesh, ("model",))

    def reduce_model(self, x):
        return reduce_sum(x, self.mesh, ("model",))

    def reduce_batch(self, x):
        return reduce_sum(x, self.mesh, self.bax)

    def pmax_model(self, x):
        return pmax(x, self.mesh, ("model",))

    def gather_model(self, x, dim: int):
        """An invariant tensor from this rank's block along ``dim``."""
        return gather(x, self.mesh, dim, ("model",), summed=False)

    # -- weights --------------------------------------------------------------
    def unfsdp(self, w: torch.Tensor, spec: tuple, dtype=None) -> tuple:
        """``w`` (cast to ``dtype`` first where given) gathered along every
        dimension split over the data axes → ``(w, spec)`` with those
        entries cleared. The backward reduce-scatters the gradient (in the
        gathered dtype) where the batch is split over the data axes."""
        if dtype is not None:
            w = w.to(dtype)
        spec = list(spec)
        for i, e in enumerate(spec):
            axes = spec_axes(e)
            if axes and all(a in self.dax for a in axes):
                w = gather(w, self.mesh, i, axes, summed=self.batch_split)
                spec[i] = None
        return w, tuple(spec)

    def whole(self, w: torch.Tensor, spec: tuple, dtype=None) -> torch.Tensor:
        """The whole weight: ``unfsdp``, then gathered over ``model``."""
        w, spec = self.unfsdp(w, spec, dtype)
        for i, e in enumerate(spec):
            if e is not None:
                w = gather(w, self.mesh, i, spec_axes(e), summed=False)
        return w

    def sync_grads(self, grads: Sequence[torch.Tensor],
                   specs: Sequence[tuple]) -> None:
        """Sum, in place, the gradient of every leaf whole over the data
        axes across them (a leaf split over them was summed in its
        gather's backward)."""
        if not _live(self.mesh, self.bax):
            return
        for g, spec in zip(grads, specs):
            if not any(a in self.dax for e in spec for a in spec_axes(e)):
                g.copy_(_psum(g, self.mesh, self.bax))

    def norm_sq(self, sq: Sequence[torch.Tensor],
                specs: Sequence[tuple]) -> torch.Tensor:
        """The global sum of squares from each leaf's local one: a leaf
        split over some axes is summed over them, and counted once where
        the other axes hold copies of it."""
        by_axes = {}
        for s, spec in zip(sq, specs):
            axes = tuple(a for a in self.mesh.mesh_dim_names
                         if any(a in spec_axes(e) for e in spec))
            by_axes[axes] = s if axes not in by_axes else by_axes[axes] + s
        total = None
        for axes, s in by_axes.items():
            if _live(self.mesh, axes):
                s = _psum(s, self.mesh, axes)
            total = s if total is None else total + s
        return total

    def check_layout(self, specs) -> None:
        """Raise unless ``specs`` (a model's) are this cell's: the port
        never redistributes a model silently."""
        if specs != self.specs:
            raise ValueError("the model's parameters are laid out for "
                             "another cell or mesh; rebuild it with this "
                             "cell's specs (Cell.state_shardings[0])")

