"""Full-graph GNN message passing on a mesh, with explicit collectives
(mirrors ``repro.legacy.models.gnn_spmd``).

Node state lives split over the data axes (``P(dax, None)``), the edges
over every axis (``P(ALL)``, global ids), the parameters whole on every
rank. Each layer all-gathers the node state once for the edge-local
gathers (``gather_nodes``), and every aggregation goes back to the rows'
owners through the all_to_all reduce-scatter chain over the data axes
(``spmd.rs_chain``, the reference's ``_rs_chain``: pod-major, the order of
the all-gather and of ``my_offset``), then a sum over ``model``.

``GraphShard`` is the mesh's ``gnn.LocalGraph``: the GIN / PNA / EGNN
layers of ``gnn.gnn_forward`` and NequIP's of ``nequip.nequip_forward``
run on it unchanged. They are the reference's ``layer_plain`` (GIN's
aggregation one ``gather_sum`` a layer), ``layer_egnn`` and
``layer_nequip`` (one reduce-scatter a layer for each output l): on a mesh
the port's GSPMD-constrained cells and this module's SPMD loss compute
alike. ``make_spmd_gnn_loss`` keeps the reference's loss bodies: ``valid =
senders < n1 - 1``, PNA's mean degree over the ``n1`` rows, the losses over
the rows below ``n_real``, NequIP's energy summed over the real rows.

Gradients follow ``spmd``'s Megatron convention. A rank's gradient of a
node block is its whole gradient; the edge side's contributions are summed
over the edge blocks where they leave the gather (``gather_nodes``: over
``model``, then the reduce-scatter over the data axes), parameters used on
the edge side pass ``enter`` over ``model``, and the cell sums every
parameter's gradient over the data axes after the backward
(``MeshShard.sync_grads``).

PNA's max and min over the mesh (``scatter_max``) give the one-rank
gradient: an even split over every edge that reaches the maximum, on any
rank (``segment_max``'s, and ``jax.grad`` of ``jax.ops.segment_max``'s).
The reference's ``pmax_grad`` gives the whole cotangent to each model
shard that reaches it and never sums it over ``model``, so its SPMD PNA
gradient reaches the layers before the last divided by the size of
``model`` (ROADMAP Queue 3); the port does not copy that.
"""

from __future__ import annotations

import torch

from ...core import collectives as coll
from ...kernels.segments import Segments
from ...kernels.segments import segment_sum as _segment_sum
from . import spmd
from .gnn import GNNConfig, LocalGraph, gnn_loss, segment_max, segment_sum
from .nequip import NequIPConfig, nequip_loss

__all__ = ["GraphShard", "scatter_max", "make_spmd_gnn_loss"]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


class GraphShard(LocalGraph):
    """This rank's part of a graph on ``mesh`` (a ``DeviceMesh``): node rows
    ``[off, off + rows)`` of ``n1``, split over ``dax`` (default: the
    mesh's data axes) pod-major, and a block of the edges."""

    def __init__(self, mesh, n1: int, dax=None):
        names = tuple(mesh.mesh_dim_names)
        self.mesh = mesh
        self.dax = tuple(dax) if dax is not None else tuple(
            a for a in names if a in ("pod", "data"))
        self.axes = names
        self.model = ("model",) if "model" in names else ()
        Gd = spmd.extent(mesh, self.dax)
        if n1 % Gd:
            raise ValueError(f"{n1} node rows do not split over {self.dax} "
                             f"({Gd} ranks)")
        self.n1, self.rows = int(n1), int(n1) // Gd
        self.off = coll.shard_index(mesh, self.dax) * self.rows

    def block(self, x):
        return x.narrow(0, self.off, self.rows)

    def gather_nodes(self, h):
        # the backward: summed over model (each model rank read the rows
        # for its own edges), then reduce-scattered over the data axes
        return spmd.gather_rows(spmd.enter(h, self.mesh, self.model),
                                self.mesh, self.dax)

    def gather_whole(self, x):
        return spmd.gather(x, self.mesh, 0, self.dax, summed=False)

    def edge_use(self, x):
        return _tree_map(lambda t: spmd.enter(t, self.mesh, self.axes), x)

    def edge_params(self, tree):
        return _tree_map(lambda t: spmd.enter(t, self.mesh, self.model),
                         tree)

    def pooled_params(self, tree):
        c = 1.0 / spmd.extent(self.mesh, self.dax)
        return _tree_map(lambda t: spmd.scale_grad(t, c), tree)

    def scatter_sum(self, full):
        return spmd.reduce_sum(spmd.rs_chain(full, self.mesh, self.dax,
                                             "sum"), self.mesh, self.model)

    def scatter_max(self, vals, idx, fill):
        return scatter_max(vals, idx, self, fill)

    def mean_rows(self, x):
        return spmd.reduce_sum(x.sum(), self.mesh, self.dax) / self.n1

    def _real(self, x):
        # this rank's rows below the dump row (the last row of the last block)
        return x[: max(min(self.rows, self.n1 - 1 - self.off), 0)]

    def pool(self, x, graph_ids, n_graphs):
        xs = self._real(x)
        if graph_ids is None:
            part = torch.sum(xs)[None]
        else:
            part = segment_sum(xs, self._real(self.block(graph_ids)),
                               n_graphs)
        return spmd.reduce_sum(part, self.mesh, self.dax)

    def masked_mean(self, vals, mask):
        num = spmd.reduce_sum(torch.sum(vals * mask), self.mesh, self.dax)
        den = spmd.reduce_sum(mask.detach().sum(), self.mesh, self.dax)
        return num / torch.clamp(den, min=1)


class _ScatterMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vals, idx, graph, fill):
        full = segment_max(vals, idx, graph.n1, fill)
        loc = spmd.rs_chain(full, graph.mesh, graph.dax, "max")
        y = spmd.pmax(loc, graph.mesh, graph.model)
        ctx.graph = graph
        ctx.save_for_backward(vals, idx, y)
        return y

    @staticmethod
    def backward(ctx, g):
        vals, idx, y = ctx.saved_tensors
        graph = ctx.graph
        rows = idx.long()
        # the entries that reach their row's maximum, and how many do over
        # the whole mesh: each takes an even share of the row's cotangent
        hit = vals == graph.gather_whole(y).index_select(0, rows)
        cnt = graph.scatter_sum(_segment_sum(
            hit.to(g.dtype), Segments.of(idx, graph.n1)))
        share = graph.gather_whole(g / torch.clamp(cnt, min=1))
        zero = torch.zeros((), dtype=g.dtype, device=g.device)
        return (torch.where(hit, share.index_select(0, rows), zero),
                None, None, None)


def scatter_max(vals: torch.Tensor, idx: torch.Tensor, graph: GraphShard,
                fill: float) -> torch.Tensor:
    """This rank's rows of the maximum of ``vals`` (m, d) by segment
    ``idx`` (m,) over every rank's edges: a local ``segment_max`` into
    ``n1`` rows (``fill`` where none reaches), the max chain over the data
    axes, then the max over ``model``. The gradient splits each row's
    cotangent evenly over every entry on the mesh equal to its maximum, as
    one rank's ``segment_max`` does."""
    return _ScatterMax.apply(vals, idx, graph, fill)


def make_spmd_gnn_loss(mesh, mcfg, *, n1: int, n_real: int, dax: tuple,
                       n_graphs: int = 1):
    """``(loss_fn, kind)``: the reference's explicit-SPMD loss. Each rank
    calls ``loss_fn(params, feats_shard, coords, senders, receivers,
    labels)`` (NequIP: ``(params, species, coords, senders, receivers,
    targets)``) on its blocks: ``params``, ``coords``, NequIP's
    ``species`` and the targets whole, the node features split over
    ``dax``, the edges over every axis. ``mesh`` None (or of one rank)
    computes the same loss on one rank, whole inputs."""
    if mesh is None or mesh.size() == 1:
        graph = LocalGraph(n1)
    else:
        graph = GraphShard(mesh, n1, dax)

    if isinstance(mcfg, NequIPConfig):
        def loss_fn(params, species, coords, senders, receivers, targets):
            # the energy of the real rows only: the padded rows take an id
            # past the one graph, which the sum leaves out
            real = torch.arange(n1, device=senders.device) >= n_real
            return nequip_loss(params, mcfg, species, coords, senders,
                               receivers, targets, graph_ids=real.to(
                                   torch.int32), n_graphs=1, graph=graph)

        return loss_fn, "nequip"

    assert isinstance(mcfg, GNNConfig)

    def loss_fn(params, feats_shard, coords, senders, receivers, labels):
        mask = (torch.arange(n1 - 1, device=senders.device)
                < n_real).float()
        return gnn_loss(params, mcfg, feats_shard, senders, receivers,
                        labels[: n1 - 1],
                        coords=coords if mcfg.kind == "egnn" else None,
                        label_mask=mask, graph=graph)

    return loss_fn, mcfg.kind
