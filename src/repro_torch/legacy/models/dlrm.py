"""DLRM (arXiv:1906.00091), RM2 configuration (mirrors
``repro.legacy.models.dlrm``).

13 dense features → bottom MLP; 26 sparse multi-hot fields → one embedding
bag per table, through the dispatching ``embedding_bags`` (on the card one
launch of the hand-written CUDA kernel for the 26 tables, on the CPU its
plain version); dot-product feature interaction (strict lower triangle);
top MLP → CTR logit.

``retrieval_score`` is the retrieval_cand cell: one user vector against
10⁶ candidate embeddings as one GEMV and a top-k in ``jax.lax.top_k``'s
order (value descending, ties to the lower index).

Trainable: the bags are one ``torch.autograd.Function`` whose backward is
one call of the hand-written CUDA backward for all 26 tables on the card. ``params()`` is
the reference's parameter pytree (``{"tables": [...], "bot": {...}, "top":
{...}}``) of the module's own tensors, which ``legacy.optim`` updates in
place and ``legacy.checkpoint`` saves in the reference's leaf order.
Serving runs under ``inference_mode`` (``launch/steps.py``).

On a mesh (``mesh=``, ``specs=``: a ``DeviceMesh`` of several ranks and the
reference's ``param_specs(..., "recsys", mesh)``) each table is this rank's
block of rows (``DLRM_RULES``: ``("model", None)``) and the MLPs are whole
on every rank; the batch is split over the data axes where the cell's
batch divides them (``spmd.MeshShard.bax``). The bags of a rank's batch
block are one windowed ``embedding_bags`` call (each table's rows are a
window of the whole table: an id's row is found in the whole table, and a
row outside the window adds nothing), summed over ``model``. Their
backward gathers the bags' cotangents and the ids over the data axes, in
the batch's block order, and runs one windowed backward over the whole
batch: each rank gets its rows' whole gradient, summed in the one-rank
call's position order. The loss is a rank's sum over the global batch,
summed over the data axes (the reference's mean); the MLPs' gradients are
summed over the data axes (``mesh_grads``). ``retrieval_score`` splits the
candidates over ``model``: a top-k a rank, gathered in rank order, merged
by a stable descending sort.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ... import random as trandom
from ...core import collectives as coll
from ...kernels.legacy import embedding_bags, embedding_bags_backward
from . import spmd
from ..tree import leaves as tree_leaves
from .layers import MLP, mlp_init, mlp_shapes, normal
from .layers import top_k as lax_top_k

ROW_PAD = 512  # tables are padded to a multiple of this many rows


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 64
    vocab_sizes: tuple = (1_000_000,) * 26
    multi_hot: int = 1            # bag length per field
    bot_mlp: tuple = (512, 256, 64)
    top_mlp: tuple = (512, 512, 256, 1)

    @property
    def n_interactions(self) -> int:
        f = self.n_sparse + 1
        return f * (f - 1) // 2


def table_rows(vocab: int) -> int:
    """Rows of a table: ``vocab`` ids, then zero rows up to a multiple of
    ``ROW_PAD`` (at least one: the last row is the bag's dump row)."""
    return -(-(vocab + 1) // ROW_PAD) * ROW_PAD


def param_shapes(cfg: DLRMConfig) -> dict:
    """The leaf shapes of the reference's ``init_dlrm`` pytree."""
    return {"tables": [(table_rows(v), cfg.embed_dim)
                       for v in cfg.vocab_sizes],
            "bot": mlp_shapes([cfg.n_dense, *cfg.bot_mlp]),
            "top": mlp_shapes([cfg.n_interactions + cfg.embed_dim,
                               *cfg.top_mlp])}


def _windows(cfg: DLRMConfig, specs, mesh) -> Optional[tuple]:
    """Each table's ``(row_lo, rows_global)`` on this rank of ``mesh``
    under ``specs`` (None off a mesh). A table is split by rows only."""
    if mesh is None:
        return None
    out = []
    for v, sp in zip(cfg.vocab_sizes, specs["tables"]):
        rows = table_rows(v)
        if any(e is not None for e in sp[1:]):
            raise ValueError(f"{cfg.name}: a table splits by rows only, got "
                             f"the spec {sp}")
        axes = spmd.spec_axes(sp[0]) if sp else ()
        per = rows // spmd.extent(mesh, axes)
        out.append((coll.shard_index(mesh, axes) * per if axes else 0, rows))
    return tuple(out)


def _mesh_bag_parts(tables, idx, windows, mesh) -> torch.Tensor:
    """The whole tables' bags of ``idx`` (T, B, L): this rank's windows'
    bags, summed over ``model``, as one (T, B, D) tensor."""
    part = torch.stack(embedding_bags(list(tables), idx, windows=windows))
    return spmd.reduce_sum(part, mesh, ("model",))


class _MeshBags(torch.autograd.Function):
    """The bags of a rank's batch block on a mesh; the backward gathers
    the cotangents and ids over ``bax`` (the batch's block order) and runs
    one windowed backward over the whole batch."""

    @staticmethod
    def forward(ctx, idx, windows, mesh, bax, *tables):
        ctx.save_for_backward(idx, *tables)
        ctx.windows, ctx.mesh, ctx.bax = windows, mesh, bax
        return _mesh_bag_parts(tables, idx, windows, mesh).unbind(0)

    @staticmethod
    def backward(ctx, *grad_outs):
        idx, *tables = ctx.saved_tensors
        g = torch.stack([tables[0].new_zeros((idx.shape[1], tables[0].shape[1]))
                         if x is None else x for x in grad_outs])
        g = spmd.gather(g, ctx.mesh, 1, ctx.bax, summed=False)
        ids = spmd.gather(idx, ctx.mesh, 1, ctx.bax,
                          summed=False).contiguous()
        grads = embedding_bags_backward(tables, ids, list(g),
                                        windows=ctx.windows)
        return (None, None, None, None, *grads)


class DLRM(nn.Module):
    """The model; ``forward`` gives ``(B,)`` logits. On a ``mesh`` of
    several ranks its tables are this rank's blocks of rows under
    ``specs`` (a cell's ``state_shardings[0]``)."""

    def __init__(self, cfg: DLRMConfig, tables: Sequence[torch.Tensor],
                 bot: MLP, top: MLP, *, mesh=None, specs=None):
        super().__init__()
        if len(tables) != cfg.n_sparse:
            raise ValueError(f"{cfg.name}: {len(tables)} tables for "
                             f"{cfg.n_sparse} sparse fields")
        if (mesh is None) != (specs is None):
            raise ValueError(f"{cfg.name}: pass both of mesh= and specs=, "
                             f"or neither")
        for i, (t, v) in enumerate(zip(tables, cfg.vocab_sizes)):
            want = (table_rows(v), cfg.embed_dim)
            if mesh is not None:
                want = spmd.local_shape(want, specs["tables"][i], mesh)
            if tuple(t.shape) != want:
                raise ValueError(f"{cfg.name}: a table of shape "
                                 f"{tuple(t.shape)} for vocab {v}, want "
                                 f"{want}")
        self.cfg = cfg
        self.mesh = mesh
        self.specs = specs
        self.windows = _windows(cfg, specs, mesh)
        self.tables = nn.ParameterList(tables)
        self.bot = bot
        self.top = top
        f = cfg.n_sparse + 1
        # jnp.tril_indices(f, k=-1) order, which the top MLP's weights follow
        self.register_buffer("tril", torch.tril_indices(
            f, f, offset=-1, device=tables[0].device), persistent=False)

    def params(self) -> dict:
        """The reference's pytree of this module's parameters (the tensors
        themselves, not copies)."""
        return {"tables": list(self.tables), "bot": self.bot.params(),
                "top": self.top.params()}

    def bags(self, sparse_idx: torch.Tensor, shard=None) -> list:
        """The ``n_sparse`` sum-bags ``(B, D)`` of ``sparse_idx`` (B, n_sparse,
        L): one ``embedding_bags`` call for all the tables. On a mesh, the
        whole tables' bags of this rank's batch block; ``shard`` (a
        ``spmd.MeshShard``) names the axes the batch is split over."""
        per_field = sparse_idx.to(torch.int32).transpose(0, 1).contiguous()
        if self.mesh is None:
            return embedding_bags(list(self.tables), per_field)
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in self.tables):
            bax = shard.bax if shard is not None else ()
            return list(_MeshBags.apply(per_field, self.windows, self.mesh,
                                        tuple(bax), *self.tables))
        return list(_mesh_bag_parts(self.tables, per_field, self.windows,
                                    self.mesh).unbind(0))

    def forward(self, dense: torch.Tensor, sparse_idx: torch.Tensor,
                shard=None) -> torch.Tensor:
        """dense: (B, n_dense) float; sparse_idx: (B, n_sparse, L) int →
        (B,) logits."""
        x = self.bot(dense)                                   # (B, D)
        z = torch.stack([x, *self.bags(sparse_idx, shard)], dim=1)
        inter = torch.bmm(z, z.transpose(1, 2))               # (B, 27, 27)
        flat = inter[:, self.tril[0], self.tril[1]]           # (B, 351)
        return self.top(torch.cat([x, flat], dim=-1))[..., 0]

    def loss(self, dense: torch.Tensor, sparse_idx: torch.Tensor,
             labels: torch.Tensor, shard=None) -> torch.Tensor:
        """Mean binary cross-entropy of the logits. On a mesh (``shard`` a
        ``spmd.MeshShard``), this rank's sum over the global batch, summed
        over the axes the batch is split over."""
        logit = self.forward(dense, sparse_idx, shard).float()
        y = labels.float()
        per = (torch.clamp(logit, min=0) - logit * y
               + torch.log1p(torch.exp(-logit.abs())))
        if self.mesh is None:
            return torch.mean(per)
        bax = shard.bax if shard is not None else ()
        total = per.sum() / (per.shape[0] * spmd.extent(self.mesh, bax))
        return spmd.reduce_sum(total, self.mesh, bax)

    def mesh_grads(self, grads: Sequence[torch.Tensor], shard) -> None:
        """On a mesh, sum in place over the data axes the gradients of the
        MLPs' leaves (``grads`` in ``params()``'s leaf order); the tables'
        are whole already, their backward having gathered the batch."""
        if self.mesh is None or shard is None:
            return
        tables = {id(t) for t in self.tables}
        mlp = [g for p, g in zip(tree_leaves(self.params()), grads)
               if id(p) not in tables]
        # one collective for all of them
        flat = spmd.reduce_sum(torch.cat([g.flatten() for g in mlp]),
                               self.mesh, shard.bax)
        for g, x in zip(mlp, flat.split([g.numel() for g in mlp])):
            g.copy_(x.view_as(g))

    def retrieval_score(self, dense: torch.Tensor, sparse_idx: torch.Tensor,
                        cand: torch.Tensor, top_k: int = 100):
        """Score one query (dense (1, n_dense), sparse (1, n_sparse, L))
        against ``cand`` (N_cand, D): ``(values, indices)`` of the top
        ``top_k`` float32 scores, largest first, ties to the lower index.
        On a mesh ``cand`` is this rank's block of rows over ``model``,
        and the result is the whole candidates' top-k on every rank."""
        q = self.bot(dense)                                   # (1, D)
        q = q + sum(self.bags(sparse_idx))                    # fused user vec
        scores = (cand @ q[0]).float()                        # (N_cand,)
        if self.mesh is None:
            return lax_top_k(scores, top_k)
        n = scores.shape[0]
        vals, idx = lax_top_k(scores, min(top_k, n))
        idx = idx + coll.shard_index(self.mesh, ("model",)) * n
        # rank m's candidates precede rank m + 1's: in the rank-ordered
        # gather a stable sort keeps ties in index order
        vals = spmd.gather(vals, self.mesh, 0, ("model",), summed=False)
        idx = spmd.gather(idx, self.mesh, 0, ("model",), summed=False)
        vals, at = lax_top_k(vals, top_k)
        return vals, idx[at]


def init_dlrm(cfg: DLRMConfig, *, key=None, generator=None, device=None,
              dtype=torch.float32, mesh=None, specs=None) -> DLRM:
    """Random weights: tables normal / sqrt(D) with the rows from ``V`` on
    zero, MLPs as ``mlp_init``. From a threefry ``key`` (on ``device``, the
    key's own when None) they are the reference's ``init_dlrm(key, cfg)``:
    table ``i`` draws from ``split(key, n_sparse + 2)[i]``, the bottom MLP
    from the one before last, the top MLP from the last. From a
    ``generator`` (which must live on ``device``) they are torch's numbers.
    Each table is drawn where it lives, so the 6.66 GB of RM2's tables
    never pass through the host. On a ``mesh`` each rank keeps its block of
    rows of each table under ``specs``: from a ``key`` it draws only those
    rows of the table's draw, from a ``generator`` the whole table, cut."""
    if (key is None) == (generator is None):
        raise ValueError("init_dlrm: pass one of key= and generator=")
    if key is not None:
        key = key.to(device) if device is not None else key
        device = key.device
        ks = trandom.split(key, cfg.n_sparse + 2)
        draw = [dict(key=ks[i]) for i in range(cfg.n_sparse)]
        bot_kw, top_kw = dict(key=ks[-2]), dict(key=ks[-1])
    else:
        draw = [dict(generator=generator)] * cfg.n_sparse
        bot_kw = top_kw = dict(generator=generator, device=device)
    windows = _windows(cfg, specs, mesh) or [
        (0, table_rows(v)) for v in cfg.vocab_sizes]
    root_d = torch.tensor(math.sqrt(cfg.embed_dim), device=device)
    D = cfg.embed_dim
    tables = []
    for i, (v, kw) in enumerate(zip(cfg.vocab_sizes, draw)):
        rows = table_rows(v)
        lo = windows[i][0]
        n = rows if mesh is None else spmd.local_shape(
            (rows, D), specs["tables"][i], mesh)[0]
        if "key" in kw:
            t = trandom.normal(kw["key"], (n, D), start=lo * D)
        else:
            t = normal((rows, D), device=device, **kw)
            if n != rows:
                t = t[lo: lo + n].clone()
        t.div_(root_d)  # a float32 divide, as the reference's
        t[max(v - lo, 0):] = 0.0
        tables.append(t.to(dtype))
    bot = mlp_init([cfg.n_dense, *cfg.bot_mlp], dtype=dtype, final_relu=True,
                   **bot_kw)
    top = mlp_init([cfg.n_interactions + cfg.embed_dim, *cfg.top_mlp],
                   dtype=dtype, **top_kw)
    return DLRM(cfg, tables, bot, top, mesh=mesh, specs=specs)


def dlrm_from_jax(params: Mapping, cfg: DLRMConfig, *, device, mesh=None,
                  specs=None) -> DLRM:
    """The reference's ``init_dlrm`` pytree (``{"tables": [...], "bot":
    {"w0", "b0", ...}, "top": {...}}``, leaves as arrays) as the port's
    module. Weights keep their ``(d_in, d_out)`` layout. On a ``mesh``
    each rank keeps its block of each table under ``specs``."""
    tables = [torch.tensor(np.asarray(t), device=device)
              for t in params["tables"]]
    if mesh is not None:
        tables = [spmd.local_block(t, sp, mesh).clone()
                  for t, sp in zip(tables, specs["tables"])]
    return DLRM(cfg, tables,
                MLP.from_params(params["bot"], final_relu=True, device=device),
                MLP.from_params(params["top"], final_relu=False,
                                device=device), mesh=mesh, specs=specs)
