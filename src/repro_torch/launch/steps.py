"""Cell builders: (architecture × input shape × mesh) → a runnable step
(mirrors ``repro.launch.steps``: the ``lm``, ``recsys`` and ``connectit``
parts).

A cell is a step function, the global shapes of its inputs as ``meta``
tensors (allocated nowhere, like the reference's ``ShapeDtypeStruct``s),
how each input is split over the mesh (``in_shardings``) and its ``meta``
counts. A sharding is a per-dimension spec (``launch/shardings.py``): ``()``
for an input whole on every rank, ``("model",)`` for a label window,
``(("data", "model"),)`` for edges split over both axes. Every rank calls
``fn`` on its own block of each input (``local_block``; ``local_shape``
plans it without data), as a ``shard_map`` body takes its blocks. A cell
whose step updates a model (and an optimizer state) holds their global
shapes in ``state`` and their specs in ``state_shardings``.

  * ``connectit``: the paper's production cells. The shape dict's
    ``labels``/``variant`` keys choose the placement, the finish comes from
    the arch's config (``ConnectItConfig.finish``); the step is the
    placement's finish program (``kind="static"``) or its stream process
    (``kind="ingest"``) from ``core/execution.py::make_backend``. Labels are
    ``(n + 1,)`` (dump row ``n``), padded with self-rooted ids to divide the
    label axis under the sharded placement. Built on a real mesh the cell
    runs; built on a ``launch.mesh.ShapeMesh`` with ``device="meta"`` it
    only plans (``launch/dryrun.py``).
  * ``recsys``: DLRM training, serving and retrieval;
    ``fn(model, *inputs)``, and for training ``fn(model, opt_state,
    *inputs)``, which updates the model and the optimizer state in place
    (the reference donates both). On a mesh of several ranks each rank
    passes its blocks: the model laid out by ``state_shardings[0]``
    (``init_dlrm`` / ``dlrm_from_jax`` with ``mesh=`` and ``specs=``: each
    table's rows over ``model``, the MLPs whole), AdamW's moments by
    ``state_shardings[1]``, the batch over the data axes, retrieval's
    candidates over ``model`` (its query whole); serving returns this
    rank's block of the probabilities, retrieval the whole top-k on every
    rank (``legacy/models/dlrm.py``).
  * ``lm``: the transformer's ``train`` / ``prefill`` / ``decode`` cells,
    the same calling convention: ``fn(model, opt_state, tokens, labels)``,
    ``fn(model, tokens)`` and ``fn(model, cache, tok)`` (the cache is
    updated in place; the reference donates it). On a mesh of several
    ranks each rank passes its blocks: the model laid out by
    ``state_shardings[0]`` (``Transformer.from_params`` /
    ``init_transformer`` with ``mesh=`` and ``specs=``), the AdamW moments
    by ``state_shardings[1]``, the batch over the data axes, the decode
    cache over the data axes (batch) and ``model`` (sequence); prefill
    returns the cache so split and the logits whole over the vocabulary.
    The specs are the reference's (FSDP for train cells, the experts out
    of it unless ``moe_fsdp``); the step is Megatron TP, EP with one
    all_to_all each way, FSDP (``legacy/models/spmd.py``).
  * ``gnn``: GIN, PNA, EGNN and NequIP train cells,
    ``fn(model, opt_state, *inputs)`` updating both in place: full-graph
    and molecule shapes ``fn(model, opt_state, feats, senders, receivers,
    targets[, graph_ids])`` (``feats`` a dict: ``{"feats"[, "coords"]}``,
    NequIP's ``{"species", "coords"}``), ``minibatch_lg`` ``fn(model,
    opt_state, feats, indptr, indices, seeds, labels, key)`` (the
    reference's neighbour sampling inside the step), and
    ``ogb_products_spmd`` the reference's calling convention ``fn(model,
    opt_state, node_feats, coords, senders, receivers, targets)`` with
    ``n + 1`` target rows, the loss over the ``n_real`` real rows
    (``legacy/models/gnn_spmd.py``). The segment sums of the step go
    through the hand-written ``segment_sum`` over each edge array's sorted
    layout, sorted at the first step on a graph (``kernels/segments.py``).
    On a mesh of several ranks each rank passes its blocks: node features
    split over the data axes, edges over every axis, minibatch seeds over
    the data axes (each rank samples its block's edges), the rest whole;
    node state is gathered once a layer for the edges and every
    aggregation reduce-scattered back (``gnn_spmd.GraphShard``), and the
    parameters' gradients are summed over the data axes.
"""

from __future__ import annotations

import dataclasses
from math import prod
from typing import Callable

import torch

from ..configs.base import Arch
from ..core import collectives as coll
from ..core.execution import ExecutionSpec, make_backend
from ..core.finish import make_finish
from ..graphs.containers import round_up
from ..legacy import optim
from ..graphs.sampler import sample_subgraph
from ..legacy.models import gnn as gnn_mod
from ..legacy.models import nequip as nequip_mod
from ..legacy.models import transformer as tfm
from ..legacy.models.dlrm import DLRM, DLRMConfig
from ..legacy.models.dlrm import param_shapes as dlrm_param_shapes
from ..legacy.models import spmd
from ..legacy.models.spmd import spec_leaves
from ..legacy.tree import leaves as tree_leaves
from . import shardings as shd
from .mesh import ShapeMesh, all_axes, data_axes, make_smoke_mesh


OPT = optim.OptimizerConfig()


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    fn: Callable        # fn(*blocks); recsys: fn(model, [opt_state,] *inputs)
    args: tuple         # the inputs' global shapes, as meta tensors
    in_shardings: tuple = ()  # per input: its per-dimension spec
    donate: tuple = ()  # the arguments of fn the reference donates: the
    # connectivity programs write out of place, the train step in place
    meta: dict = dataclasses.field(default_factory=dict)
    state: tuple = ()   # lm: the model's (and AdamW's) global shapes
    state_shardings: tuple = ()  # their spec pytrees


def local_shape(arg: torch.Tensor, sharding: tuple, mesh) -> tuple:
    """A rank's block shape of an input laid out by ``sharding`` (a
    per-dimension spec) on ``mesh`` (a real or a shape-only mesh)."""
    return shd.local_shape(tuple(arg.shape), sharding, mesh)


def _tree_bytes(tree, specs, mesh) -> int:
    return sum(prod(local_shape(x, sp, mesh)) * x.element_size()
               for x, sp in zip(tree_leaves(tree), spec_leaves(specs)))


def local_bytes(cell: Cell, mesh) -> int:
    """The bytes of one rank's blocks of every input (an input may be a
    pytree, as a ``KVCache``, whose specs are a pytree alike)."""
    total = 0
    for a, sh in zip(cell.args, cell.in_shardings):
        if isinstance(a, torch.Tensor):
            total += prod(local_shape(a, sh, mesh)) * a.element_size()
        else:
            total += _tree_bytes(a, sh, mesh)
    return total


def state_bytes(cell: Cell, mesh) -> int:
    """The bytes of one rank's blocks of the cell's model (and optimizer
    state)."""
    return sum(_tree_bytes(t, sp, mesh)
               for t, sp in zip(cell.state, cell.state_shardings))


def local_block(x: torch.Tensor, sharding: tuple, mesh) -> torch.Tensor:
    """This rank's block of a global input (a view)."""
    return shd.local_block(x, sharding, mesh)


def _meta(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _dlrm_model_flops(cfg: DLRMConfig, batch: int) -> int:
    """Matmul FLOPs of the two MLPs (the reference's count; the
    embedding-bag bytes, 26 gathers of B × D rows, dominate all the same)."""
    bot = sum(a * b for a, b in zip((cfg.n_dense,) + cfg.bot_mlp[:-1],
                                    cfg.bot_mlp))
    top = sum(a * b for a, b in zip(
        (cfg.n_interactions + cfg.embed_dim,) + cfg.top_mlp[:-1],
        cfg.top_mlp))
    return 2 * batch * (bot + top)


def serve_step(model: DLRM, dense: torch.Tensor,
               sparse: torch.Tensor) -> torch.Tensor:
    """Click probabilities ``sigmoid(forward)``, (B,)."""
    with torch.inference_mode():
        return torch.sigmoid(model(dense, sparse))


def train_step(model: DLRM, opt_state: optim.AdamState, dense: torch.Tensor,
               sparse: torch.Tensor, labels: torch.Tensor,
               ocfg: optim.OptimizerConfig = OPT, shard=None):
    """One step of the reference's DLRM ``train_step``: the loss, its
    gradient with respect to every parameter, and ``optim.update``, in place
    on ``model``'s parameters and ``opt_state``'s moments → ``(model,
    opt_state, {"loss", "lr", "grad_norm"})``. On a mesh (``shard`` a
    ``MeshShard``) each rank steps its blocks: the MLPs' gradients are
    summed over the data axes, and the clip's norm counts each table row
    once (over ``model``)."""
    params = model.params()
    with torch.enable_grad():
        if shard is None:
            loss = model.loss(dense, sparse, labels)
        else:
            loss = model.loss(dense, sparse, labels, shard)
        grads = torch.autograd.grad(loss, optim.tree_leaves(params))
    norm_sq = None
    if shard is not None:
        model.mesh_grads(grads, shard)
        specs = spec_leaves(shard.specs)
        norm_sq = lambda sq: shard.norm_sq(sq, specs)  # noqa: E731
    _, opt_state, info = optim.update(
        ocfg, params, optim.tree_unflatten(params, grads), opt_state,
        norm_sq=norm_sq)
    return model, opt_state, {"loss": loss.detach(), **info}


def retrieve(model: DLRM, dense: torch.Tensor, sparse: torch.Tensor,
             cand: torch.Tensor, top_k: int = 100):
    """``(values, indices)`` of the top ``top_k`` candidates for one query."""
    with torch.inference_mode():
        return model.retrieval_score(dense, sparse, cand, top_k=top_k)


def _dlrm_cell(arch: Arch, shape_name: str, mesh=None) -> Cell:
    """A DLRM cell: at one rank, whole inputs; on a mesh of several ranks
    the reference's ``in_shardings`` (the batch over the data axes where
    they divide it, retrieval's query whole and its candidates over
    ``model``) and state (the tables' rows over ``model``, the MLPs whole;
    AdamW's moments as the parameters)."""
    cfg: DLRMConfig = arch.model
    spec = arch.shapes[shape_name]
    kind = spec["kind"]
    B = spec["batch"]
    dense = _meta((B, cfg.n_dense), torch.float32)
    sparse = _meta((B, cfg.n_sparse, cfg.multi_hot), torch.int32)
    meta = dict(model_flops=_dlrm_model_flops(cfg, B), batch=B)
    if kind == "retrieval":
        n_cand = spec["n_candidates"]
        cand = _meta((n_cand, cfg.embed_dim), torch.float32)
        meta = dict(model_flops=2 * n_cand * cfg.embed_dim, batch=1)
    elif kind == "train":
        labels = _meta((B,), torch.int32)
    elif kind != "serve":
        raise ValueError(f"{arch.name}: unknown shape kind {kind!r}")
    if mesh is None or mesh.size() <= 1:
        if kind == "serve":
            return Cell(arch.name, shape_name, serve_step, (dense, sparse),
                        ((), ()), meta=meta)
        if kind == "retrieval":
            return Cell(arch.name, shape_name, retrieve,
                        (dense, sparse, cand), ((), (), ()), meta=meta)
        return Cell(arch.name, shape_name, train_step,
                    (dense, sparse, labels), ((), (), ()), donate=(0, 1),
                    meta=meta)

    pshapes = _meta_tree(dlrm_param_shapes(cfg))
    pspecs = shd.param_specs(pshapes, "recsys", mesh)
    shard = _LazyShard(mesh, pspecs, B)
    if kind == "serve":
        def serve(model, dense, sparse):
            shard(model)
            return serve_step(model, dense, sparse)

        return Cell(arch.name, shape_name, serve, (dense, sparse),
                    tuple(shd.batch_spec(tuple(x.shape), mesh)
                          for x in (dense, sparse)), meta=meta,
                    state=(pshapes,), state_shardings=(pspecs,))
    if kind == "retrieval":
        def retrieval(model, dense, sparse, cand, top_k: int = 100):
            shard(model)
            return retrieve(model, dense, sparse, cand, top_k)

        return Cell(arch.name, shape_name, retrieval, (dense, sparse, cand),
                    ((), (), ("model", None)), meta=meta, state=(pshapes,),
                    state_shardings=(pspecs,))

    def train(model, opt_state, dense, sparse, labels):
        return train_step(model, opt_state, dense, sparse, labels,
                          shard=shard(model))

    ostate = optim.AdamState(_meta((), torch.int32), pshapes, pshapes)
    ospecs = optim.AdamState((), pspecs, pspecs)
    return Cell(arch.name, shape_name, train, (dense, sparse, labels),
                tuple(shd.batch_spec(tuple(x.shape), mesh)
                      for x in (dense, sparse, labels)), donate=(0, 1),
                meta=meta, state=(pshapes, ostate),
                state_shardings=(pspecs, ospecs))


# ---------------------------------------------------------------------------
# LM cells (one rank).
# ---------------------------------------------------------------------------

def lm_active_params(cfg: tfm.TransformerConfig) -> int:
    """Active parameters per token (MoE counts top_k + shared experts)."""
    D, dh = cfg.d_model, cfg.head_dim
    att = D * dh * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)
    if cfg.is_moe:
        F = cfg.d_expert or cfg.d_ff
        ffn = (cfg.top_k + cfg.n_shared_experts) * 3 * D * F + D * cfg.n_experts
    else:
        ffn = 3 * D * cfg.d_ff
    return cfg.n_layers * (att + ffn) + 2 * cfg.vocab * D


def lm_grads(model: tfm.Transformer, tokens: torch.Tensor,
             labels: torch.Tensor, cfg: tfm.TransformerConfig,
             shard=None) -> tuple:
    """``(loss, gradients)`` of ``lm_loss`` with respect to every parameter
    leaf (``optim.tree_leaves`` order). On a mesh (``shard`` a
    ``MeshShard``) each is this rank's block of the global gradient: the
    leaves whole over the data axes are summed over them."""
    params = model.params()
    leaves = optim.tree_leaves(params)
    with torch.enable_grad():
        if shard is None:
            loss, _ = tfm.lm_loss(params, tokens, labels, cfg)
        else:
            loss, _ = tfm.lm_loss(params, tokens, labels, cfg, shard)
        grads = torch.autograd.grad(loss, leaves)
    if shard is not None:
        shard.sync_grads(grads, spec_leaves(shard.specs))
    return loss.detach(), grads


def lm_train_step(model: tfm.Transformer, opt_state: optim.AdamState,
                  tokens: torch.Tensor, labels: torch.Tensor,
                  cfg: tfm.TransformerConfig,
                  ocfg: optim.OptimizerConfig = OPT, shard=None):
    """One step of the reference's LM ``train_step``: ``lm_loss``, its
    gradient with respect to every parameter, and ``optim.update``, in
    place on ``model``'s parameters and ``opt_state``'s moments →
    ``(model, opt_state, {"loss", "lr", "grad_norm"})``. On a mesh
    (``shard`` a ``MeshShard``) every rank steps its blocks, and the clip's
    norm counts each element once."""
    params = model.params()
    loss, grads = lm_grads(model, tokens, labels, cfg, shard)
    norm_sq = None
    if shard is not None:
        specs = spec_leaves(shard.specs)
        norm_sq = lambda sq: shard.norm_sq(sq, specs)  # noqa: E731
    _, opt_state, info = optim.update(
        ocfg, params, optim.tree_unflatten(params, grads), opt_state,
        norm_sq=norm_sq)
    return model, opt_state, {"loss": loss, **info}


def _whole_specs(tree):
    """A spec tree of ``()`` (every leaf whole) in ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: _whole_specs(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_whole_specs(v) for v in tree]
    return ()


def _meta_tree(shapes, dtype=torch.float32):
    if isinstance(shapes, dict):
        return {k: _meta_tree(v, dtype) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_meta_tree(v, dtype) for v in shapes]
    return _meta(tuple(shapes), dtype)


class _LazyShard:
    """The cell's ``MeshShard``, made at the first call (a cell planned on
    a ``ShapeMesh`` is never called)."""

    def __init__(self, mesh, specs, batch: int):
        self.args, self.shard = (mesh, specs, batch), None

    def __call__(self, model):
        if self.shard is None:
            mesh, specs, batch = self.args
            self.shard = shd.make_shard_fn(mesh, specs, batch=batch)
        self.shard.check_layout(model.specs)
        return self.shard


def lm_cell_config(arch: Arch, shape_name: str,
                   mesh=None) -> tfm.TransformerConfig:
    """The model config an LM cell runs: the reference's ``_lm_cell``'s
    MoE settings — one dispatch group a data shard (one where the batch is
    a single sequence, or at one rank), ``moe_fsdp`` (train cells unless
    the shape says otherwise) and the int8 exchange from the shape."""
    spec = arch.shapes[shape_name]
    kind, B = spec["kind"], spec["batch"]
    n_groups = 1
    if mesh is not None and mesh.size() > 1 and B > 1:
        n_groups = shd.extent(mesh, data_axes(mesh))
        if B % n_groups:
            raise ValueError(f"{arch.name} × {shape_name}: a batch of {B} "
                             f"does not split over {n_groups} data shards")
    return dataclasses.replace(
        arch.model, moe_groups=n_groups if arch.model.is_moe else 1,
        moe_fsdp=spec.get("moe_fsdp", kind == "train"),
        moe_a2a_int8=spec.get("moe_a2a_int8", False))


def _lm_cell(arch: Arch, shape_name: str, mesh) -> Cell:
    spec = arch.shapes[shape_name]
    kind = spec["kind"]
    B, S = spec["batch"], spec["seq"]
    on_mesh = mesh is not None and mesh.size() > 1
    cfg = lm_cell_config(arch, shape_name, mesh)
    moe_fsdp = cfg.moe_fsdp
    pshapes = _meta_tree(tfm.param_shapes(cfg))
    if on_mesh:
        no_moe_fsdp = r"moe/(w_gate|w_up|w_down)$" if not moe_fsdp else None
        pspecs = shd.param_specs(pshapes, "lm", mesh, fsdp=(kind == "train"),
                                 fsdp_exclude=no_moe_fsdp)
        bspec = shd.batch_spec((B, S), mesh)
        shard = _LazyShard(mesh, pspecs, B)
    else:
        pspecs, bspec, shard = _whole_specs(pshapes), (), None
    tokens = _meta((B, S), torch.int32)

    def kw(model):
        return {} if shard is None else {"shard": shard(model)}

    if kind == "train":
        ostate = optim.AdamState(_meta((), torch.int32), pshapes, pshapes)
        ospecs = optim.AdamState((), pspecs, pspecs)

        def train_step(model, opt_state, tokens, labels):
            return lm_train_step(model, opt_state, tokens, labels, cfg,
                                 **kw(model))

        n_tok = B * S
        return Cell(arch.name, shape_name, train_step, (tokens, tokens),
                    (bspec, bspec), donate=(0, 1),
                    meta=dict(model_flops=6 * lm_active_params(cfg) * n_tok,
                              tokens=n_tok, loop_trips=cfg.n_layers,
                              flops_multiplier=8 / 6 if cfg.remat else 1.0),
                    state=(pshapes, ostate), state_shardings=(pspecs, ospecs))
    if kind == "prefill":
        def prefill_step(model, tokens):
            with torch.no_grad():
                return tfm.prefill(model.params(), tokens, cfg, S,
                                   **kw(model))

        return Cell(arch.name, shape_name, prefill_step, (tokens,), (bspec,),
                    meta=dict(model_flops=2 * lm_active_params(cfg) * B * S,
                              tokens=B * S, loop_trips=cfg.n_layers),
                    state=(pshapes,), state_shardings=(pspecs,))
    if kind == "decode":
        cache = tfm.cache_spec(cfg, B, S)
        cspec, tspec = (), ()
        if on_mesh:
            # batch over the data axes, the sequence over "model": GQA's kv
            # heads do not divide the model axis, the sequence does
            dax = data_axes(mesh) if B > 1 else ()
            cspec = (None, dax[0] if len(dax) == 1 else (dax or None),
                     "model", None, None)
            tspec = shd.batch_spec((B,), mesh)

        def decode(model, cache, tok):
            with torch.no_grad():
                return tfm.decode_step(model.params(), cache, tok, cfg,
                                       **kw(model))

        return Cell(arch.name, shape_name, decode,
                    (cache, _meta((B,), torch.int32)),
                    (tfm.KVCache(cspec, cspec, ()), tspec), donate=(1,),
                    meta=dict(model_flops=2 * lm_active_params(cfg) * B,
                              tokens=B, loop_trips=cfg.n_layers,
                              kv_bytes=cache.k.numel() * 2 * 2),
                    state=(pshapes,), state_shardings=(pspecs,))
    raise ValueError(f"{arch.name}: unknown shape kind {kind!r}")


# ---------------------------------------------------------------------------
# GNN cells.
# ---------------------------------------------------------------------------

def gnn_train_step(model, opt_state: optim.AdamState, loss_fn: Callable,
                   ocfg: optim.OptimizerConfig = OPT, mesh_shard=None):
    """One step of the reference's GNN ``train_step``: ``loss_fn(params)``,
    its gradient with respect to every parameter (zero for a leaf the loss
    does not reach, as ``jax.grad`` gives: EGNN's last coordinate MLP), and
    ``optim.update`` in place → ``(model, opt_state, {"loss", "lr",
    "grad_norm"})``. On a mesh (``mesh_shard`` a ``MeshShard``) every
    parameter is whole on every rank: its gradient is summed over the data
    axes after the backward, so the clip's norm is the global one on every
    rank."""
    params = model.params()
    leaves = optim.tree_leaves(params)
    with torch.enable_grad():
        loss = loss_fn(params)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    if mesh_shard is not None:
        mesh_shard.sync_grads(grads, [()] * len(grads))
    _, opt_state, info = optim.update(
        ocfg, params, optim.tree_unflatten(params, grads), opt_state)
    return model, opt_state, {"loss": loss.detach(), **info}


def gnn_cell_dims(spec: dict) -> dict:
    """The reference's sizes of a GNN shape: ``n_real`` nodes, ``n`` the
    node rows but the dump (``round_up(n_real + 1, 512) - 1``: rows in
    ``[n_real, n)`` are inert), ``m_pad`` edge slots (a multiple of 8,192)
    and ``n_graphs``."""
    kind = spec["kind"]
    if kind == "molecule":
        n_real = spec["nodes"] * spec["batch"]
        m_pad = round_up(spec["edges"] * 2 * spec["batch"], 8192)
        n_graphs = spec["batch"]
    elif kind == "minibatch":
        n_real = spec["n"]
        f = spec["fanout"]
        m_pad = round_up(spec["batch"] * (f[0] + f[0] * f[1]), 8192)
        n_graphs = 1
    else:
        n_real = spec["n"]
        m_pad = round_up(spec["m"], 8192)
        n_graphs = 1
    return dict(n_real=n_real, n=round_up(n_real + 1, 512) - 1,
                m_pad=m_pad, n_graphs=n_graphs)


def gnn_cell_config(arch: Arch, shape_name: str):
    """The model config a GNN cell runs (the reference's ``_gnn_cell``):
    NequIP with ``remat`` past 10^6 nodes; the others at the shape's
    feature and class counts, in bfloat16 past 10^6 nodes, with a graph
    readout on the molecule batch."""
    spec = arch.shapes[shape_name]
    big = gnn_cell_dims(spec)["n_real"] > 1_000_000
    if arch.name == "nequip":
        return dataclasses.replace(arch.model, remat=big)
    return dataclasses.replace(
        arch.model, d_in=spec["d_feat"], n_classes=spec["n_classes"],
        dtype="bfloat16" if big else "float32",
        readout="graph" if spec["kind"] == "molecule" else "node")


def _entry(axes: tuple):
    return None if not axes else axes[0] if len(axes) == 1 else tuple(axes)


def _minibatch_edges(s, r, graph, fill: int) -> tuple:
    """This model rank's block of a data rank's sampled edges, padded with
    inert dump edges to split over ``model``."""
    if not graph.model:
        return s, r
    M = shd.extent(graph.mesh, graph.model)
    pad = (-s.shape[0]) % M
    s, r = (torch.cat([e, e.new_full((pad,), fill)]) for e in (s, r))
    per = s.shape[0] // M
    m = coll.axis_index(graph.mesh, "model")
    return s[m * per: (m + 1) * per], r[m * per: (m + 1) * per]


def _gnn_cell(arch: Arch, shape_name: str, mesh=None) -> Cell:
    """A GNN train cell. On a mesh of several ranks (the reference's
    ``in_shardings``): node features split over the data axes, edges over
    every axis, NequIP's species and every coordinate array whole,
    minibatch seeds over the data axes, the parameters and AdamW's state
    whole; each rank passes its blocks."""
    spec = arch.shapes[shape_name]
    kind = spec["kind"]
    is_nequip = arch.name == "nequip"
    dims = gnn_cell_dims(spec)
    n_real, n, m_pad, n_graphs = (dims[k] for k in
                                  ("n_real", "n", "m_pad", "n_graphs"))
    d_feat = spec["d_feat"]
    mcfg = gnn_cell_config(arch, shape_name)
    mod = nequip_mod if is_nequip else gnn_mod
    pshapes = _meta_tree(mod.param_shapes(mcfg))
    pspecs = _whole_specs(pshapes)
    state = (pshapes, optim.AdamState(_meta((), torch.int32), pshapes,
                                      pshapes))
    state_specs = (pspecs, optim.AdamState((), pspecs, pspecs))
    meta = dict(model_flops=2 * 3 * m_pad * getattr(mcfg, "d_hidden", 32)
                * getattr(mcfg, "n_layers", 5), edges=m_pad)
    on_mesh = mesh is not None and mesh.size() > 1
    dax = data_axes(mesh) if on_mesh else ()
    nspec = (_entry(dax), None) if on_mesh else ()
    espec = (_entry(all_axes(mesh)),) if on_mesh else ()
    # this rank's node rows and the gradients' sum over the data axes (a
    # ShapeMesh only plans the cell, which is never called)
    graph = mshard = None
    if on_mesh and not isinstance(mesh, ShapeMesh):
        from ..legacy.models.gnn_spmd import GraphShard
        graph = GraphShard(mesh, n + 1)
        mshard = spmd.MeshShard(mesh, batch_split=True)

    if is_nequip:
        feats = {"species": _meta((n + 1,), torch.int32),
                 "coords": _meta((n + 1, 3), torch.float32)}
        targets = _meta((n_graphs,), torch.float32)
    else:
        feats = {"feats": _meta((n + 1, d_feat), torch.float32)}
        if mcfg.kind == "egnn":
            feats["coords"] = _meta((n + 1, 3), torch.float32)
        targets = _meta((n_graphs if kind == "molecule" else n,),
                        torch.int32)
    fspecs = {k: nspec if k == "feats" else () for k in feats}

    def node_mask(like):
        return (torch.arange(n, device=like.device) < n_real).float()

    def cell(fn, args, shardings):
        return Cell(arch.name, shape_name, fn, args, shardings,
                    donate=(0, 1), meta=meta, state=state,
                    state_shardings=state_specs)

    if kind == "minibatch":
        indptr = _meta((n + 2,), torch.int32)
        indices = _meta((round_up(spec["m"], 8192),), torch.int32)
        seeds = _meta((spec["batch"],), torch.int32)
        labels = _meta((n,), torch.int32)
        key = _meta((2,), torch.int64)

        def train_step(model, opt_state, feats, indptr, indices, seeds,
                       labels, key):
            start = 0 if graph is None else (
                coll.shard_index(graph.mesh, graph.dax) * seeds.shape[0])
            s, r = sample_subgraph(indptr, indices, seeds, key,
                                   spec["fanout"], start=start)
            if graph is not None:
                s, r = _minibatch_edges(s, r, graph, n)
                seeds = spmd.gather(seeds, graph.mesh, 0, graph.dax,
                                    summed=False)
            mask = torch.zeros((n,), dtype=torch.float32, device=s.device)
            mask[seeds.long()] = 1.0

            def loss_fn(p):
                if is_nequip:
                    return nequip_mod.nequip_loss(
                        p, mcfg, feats["species"], feats["coords"], s, r,
                        torch.zeros((1,), device=s.device), graph=graph)
                return gnn_mod.gnn_loss(
                    p, mcfg, feats["feats"], s, r, labels,
                    coords=feats.get("coords"), label_mask=mask, graph=graph)

            return gnn_train_step(model, opt_state, loss_fn,
                                  mesh_shard=mshard)

        return cell(train_step, (feats, indptr, indices, seeds, labels, key),
                    (fspecs, (), (), (_entry(dax),) if on_mesh else (), (),
                     ()))

    edges = _meta((m_pad,), torch.int32)
    if spec.get("spmd"):
        # the reference's convention: every node input of n + 1 rows (the
        # features split over the data axes), int targets of n + 1 rows for
        # the classifiers
        from ..legacy.models.gnn_spmd import make_spmd_gnn_loss
        a2 = feats["species"] if is_nequip \
            else _meta((n + 1, d_feat), torch.float32)
        targets2 = targets if is_nequip else _meta((n + 1,), torch.int32)
        loss_fn, _ = make_spmd_gnn_loss(
            None if graph is None else mesh, mcfg, n1=n + 1, n_real=n_real,
            dax=dax, n_graphs=n_graphs)

        def train_step(model, opt_state, a2, coords, s, r, targets):
            return gnn_train_step(
                model, opt_state,
                lambda p: loss_fn(p, a2, coords, s, r, targets),
                mesh_shard=mshard)

        args = (a2, _meta((n + 1, 3), torch.float32), edges, edges, targets2)
        return cell(train_step, args,
                    (() if is_nequip else nspec, (), espec, espec, ()))

    def train_step(model, opt_state, feats, s, r, targets, graph_ids=None):

        def loss_fn(p):
            if is_nequip:
                return nequip_mod.nequip_loss(
                    p, mcfg, feats["species"], feats["coords"], s, r,
                    targets, graph_ids=graph_ids, n_graphs=n_graphs,
                    graph=graph)
            mask = node_mask(s) if mcfg.readout == "node" else None
            return gnn_mod.gnn_loss(
                p, mcfg, feats["feats"], s, r, targets,
                coords=feats.get("coords"), graph_ids=graph_ids,
                n_graphs=n_graphs, label_mask=mask, graph=graph)

        return gnn_train_step(model, opt_state, loss_fn, mesh_shard=mshard)

    args = (feats, edges, edges, targets)
    shardings = (fspecs, espec, espec, ())
    if kind == "molecule":
        args += (_meta((n + 1,), torch.int32),)
        shardings += ((),)
    return cell(train_step, args, shardings)


# ---------------------------------------------------------------------------
# ConnectIt production cells (the paper's own workload on a mesh).
# ---------------------------------------------------------------------------

def _connectit_exec_spec(spec: dict, mesh) -> ExecutionSpec:
    rounds = spec.get("rounds", 8)
    if spec.get("labels", "replicated") == "replicated" or \
            spec["kind"] == "ingest":
        return ExecutionSpec("replicated", axes=all_axes(mesh), rounds=rounds)
    return ExecutionSpec(
        "sharded", axes=data_axes(mesh), label_axis="model", rounds=rounds,
        fused=(spec.get("variant") == "fused"
               or spec.get("use_reduce_scatter", False)))


def _connectit_finish(arch: Arch):
    return make_finish(getattr(arch.model, "finish", "uf_sync"))


def _connectit_cell(arch: Arch, shape_name: str, mesh, device) -> Cell:
    spec = arch.shapes[shape_name]
    n, rounds = spec["n"], spec.get("rounds", 8)
    exec_spec = _connectit_exec_spec(spec, mesh)
    backend = make_backend(exec_spec, mesh, device=device)
    finish_fn = _connectit_finish(arch)
    kind = spec["kind"]

    if exec_spec.placement == "sharded":
        n1 = round_up(n + 1, coll.axis_size(mesh, "model"))
        lshard = ("model",)
    else:
        n1 = n + 1
        lshard = ()
    labels = _meta((n1,), torch.int32)
    axes = tuple(exec_spec.axes)
    eshard = (axes[0] if len(axes) == 1 else axes,)

    if kind == "static":
        m = round_up(spec["m"], backend.edge_shards)
        edges = _meta((m,), torch.int32)
        return Cell(arch.name, shape_name, backend.finish_program(finish_fn),
                    (labels, edges, edges), (lshard, eshard, eshard),
                    donate=(0,),
                    meta=dict(edges=m, model_flops=0, loop_trips=rounds,
                              bytes_touched=rounds * (m * 8 + n * 8)))

    if kind == "ingest":
        bsz = round_up(spec["batch"], backend.edge_shards)
        q = round_up(spec["queries"], backend.edge_shards)
        fn = backend.stream_programs(finish_fn).process
        args = (labels, _meta((bsz,), torch.int32),
                _meta((bsz,), torch.int32), _meta((q,), torch.int32),
                _meta((q,), torch.int32))
        return Cell(arch.name, shape_name, fn, args, (lshard,) + (eshard,) * 4,
                    donate=(0,),
                    meta=dict(edges=bsz, model_flops=0, loop_trips=rounds,
                              bytes_touched=rounds * (bsz * 8 + n * 8)))
    raise ValueError(f"{arch.name}: unknown shape kind {kind!r}")


def build_cell(arch: Arch, shape_name: str, mesh=None, *,
               device="cuda") -> Cell:
    """The cell of ``arch`` at ``shape_name``. A ``connectit`` cell runs on
    ``mesh`` (default: the ``(data, model)`` mesh over every rank of the
    world, ``launch.mesh.make_smoke_mesh``) and ``device``; on a
    ``ShapeMesh``, pass ``device="meta"``. An ``lm`` cell runs on one rank
    (``mesh`` None or of one rank) or on ``mesh`` (a ``DeviceMesh``; a
    ``ShapeMesh`` plans it), and takes its inputs' devices; so does a
    ``gnn`` train cell and a ``recsys`` cell."""
    if shape_name not in arch.shapes:
        raise KeyError(f"{arch.name} has no shape {shape_name!r}; have "
                       f"{sorted(arch.shapes)}")
    if arch.family == "recsys":
        return _dlrm_cell(arch, shape_name, mesh)
    if arch.family == "lm":
        return _lm_cell(arch, shape_name, mesh)
    if arch.family == "gnn":
        return _gnn_cell(arch, shape_name, mesh)
    if arch.family == "connectit":
        device = torch.device(device)
        if mesh is None:
            mesh = make_smoke_mesh(device.type)
        return _connectit_cell(arch, shape_name, mesh, device)
    raise ValueError(f"{arch.name}: unknown family {arch.family!r}")
