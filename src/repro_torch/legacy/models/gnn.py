"""GNN architectures: GIN, PNA, EGNN, message passing through segment sums
(mirrors ``repro.legacy.models.gnn``).

Conventions, the reference's: node arrays carry a dump row (index n = n1 -
1) absorbing padded edges, whose sender is the dump row (``valid = senders
< n1 - 1``); graphs arrive as COO ``(senders, receivers)`` int32 arrays;
``graph_ids`` (from ConnectIt labels, compacted) drive the graph-level
readout of the batched molecule shape.

Every aggregation is a segment sum and every gather ``h[senders]`` has a
segment sum for its gradient: both go through ``kernels/segments.py``
(the hand-written CUDA ``segment_sum`` on the card, ``index_add_`` on the
CPU) over the graph's sorted layout, built once per edge array
(``Segments.of``), so a train step on the card adds in a fixed order and
gives the same bits every run. GIN's aggregation is one ``gather_sum``
each way (the CUDA ``gather_sum``), which reads ``h``'s rows where they
lie and never writes the (m, d) messages. PNA's max and min are
``scatter_reduce`` ("amax", order-free in value) over the reference's
``-1e30`` fill.

On a mesh the same functions run each rank's block of the node rows and
of the edges (``LocalGraph``'s methods: ``gnn_spmd.GraphShard``).

The parameters are the reference's pytree (``GNN.params()``; ``init_gnn``
draws the reference's weights from a threefry key, ``GNN.from_params``
takes the reference's arrays). Arithmetic follows ``jnp``'s dtype
promotion: under ``dtype="bfloat16"`` PNA's first projection and EGNN's
edge MLP take float32 weights against bfloat16 activations and so run in
float32, as the reference's do. ``remat`` checkpoints each layer
(``torch.utils.checkpoint``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ... import random as trandom
from ...kernels.segments import Segments, gather, gather_sum
from ...kernels.segments import segment_sum as _segment_sum
from .layers import (
    ParamTree,
    matmul,
    mlp_apply,
    mlp_params,
    mlp_shapes,
)


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    kind: str                 # gin | pna | egnn
    n_layers: int
    d_hidden: int
    d_in: int
    n_classes: int
    readout: str = "node"     # node | graph
    remat: bool = False       # checkpoint each layer (full-graph scale)
    dtype: str = "float32"    # activation/message dtype (bf16 at scale)
    # pna
    aggregators: tuple = ("mean", "max", "min", "std")
    scalers: tuple = ("identity", "amplification", "attenuation")
    # gin
    learn_eps: bool = True


def segment_sum(x: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.ops.segment_sum(x, idx, n)``, its gradient in a fixed order."""
    return _segment_sum(x, Segments.of(idx, n))


def segment_mean(x: torch.Tensor, idx: torch.Tensor, n: int,
                 mask: Optional[torch.Tensor],
                 graph: "LocalGraph") -> tuple:
    """``(sum / max(count, 1), count)`` over the segments of ``idx``, the
    entries where ``mask`` is False left out: ``graph``'s rows of the sums
    over every rank's entries."""
    if mask is None:
        ones = torch.ones(x.shape[:1], dtype=x.dtype, device=x.device)
    else:
        ones = mask.to(x.dtype)
        x = x * mask[:, None].to(x.dtype)
    tot = graph.scatter_sum(segment_sum(x, idx, n))
    cnt = graph.scatter_sum(segment_sum(ones, idx, n))
    return tot / torch.clamp(cnt, min=1.0)[:, None], cnt


def segment_max(x: torch.Tensor, idx: torch.Tensor, n: int,
                fill: float) -> torch.Tensor:
    """The max over each segment of ``idx`` (``fill`` where a segment is
    empty): ``scatter_reduce("amax", include_self=False)``, whose gradient
    splits a tie evenly, as ``jax.grad`` of ``segment_max`` does. The index
    is broadcast along the columns, never materialised."""
    index = idx.long()[:, None].expand(x.shape)
    base = torch.full((n,) + tuple(x.shape[1:]), float(fill), dtype=x.dtype,
                      device=x.device)
    return base.scatter_reduce(0, index, x, "amax", include_self=False)


class LocalGraph:
    """Where a graph's node rows live and how edge work reaches them, on
    one rank: every node row here, every collective the identity. On a
    mesh ``gnn_spmd.GraphShard`` takes its place (this rank's block of
    node rows over the data axes, its block of the edges), with the same
    methods; the models call them where the reference places a sharding
    constraint or a collective.

    ``n1`` the global node rows (the dump row ``n1 - 1`` included),
    ``rows`` and ``off`` this rank's block of them."""

    def __init__(self, n1: int):
        self.n1 = self.rows = int(n1)
        self.off = 0

    def block(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole node array."""
        return x

    def gather_nodes(self, h: torch.Tensor) -> torch.Tensor:
        """Every node row of ``h`` for this rank's edges to read."""
        return h

    def gather_whole(self, x: torch.Tensor) -> torch.Tensor:
        """Every node row of ``x``, a tensor then kept whole."""
        return x

    def edge_use(self, x):
        """A tensor (or a pytree of them) that is whole on every rank, as
        this rank's edges read it."""
        return x

    def edge_params(self, tree):
        """Parameters as this rank's edges use them."""
        return tree

    def pooled_params(self, tree):
        """Parameters used after ``pool``: every data rank computes the
        same there, so the gradients summed over the data axes count it
        once."""
        return tree

    def scatter_sum(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's rows of the sum of every rank's ``full`` (n1, ...)."""
        return full

    def scatter_max(self, vals: torch.Tensor, idx: torch.Tensor,
                    fill: float) -> torch.Tensor:
        """This rank's rows of the max of ``vals`` by segment ``idx`` over
        every rank's edges (``fill`` where none reaches a row)."""
        return segment_max(vals, idx, self.n1, fill)

    def mean_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of ``x`` (one value a row) over every node row."""
        return x.mean()

    def pool(self, x: torch.Tensor, graph_ids: Optional[torch.Tensor],
             n_graphs: int) -> torch.Tensor:
        """The sum of ``x``'s rows but the dump row, by graph (``graph_ids``
        (n1,), an id at or past ``n_graphs`` left out), or of all of them
        as one graph (``None``; ``x`` one value a row)."""
        if graph_ids is None:
            return torch.sum(x[: self.n1 - 1])[None]
        return segment_sum(x[: self.n1 - 1], graph_ids[: self.n1 - 1],
                           n_graphs)

    def masked_mean(self, vals: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
        """``sum(vals * mask) / max(sum(mask), 1)`` over every node row but
        the dump row, ``vals`` this rank's rows, ``mask`` (n1 - 1,)."""
        return torch.sum(vals * mask) / torch.clamp(mask.sum(), min=1)


def graph_of(graph: Optional[LocalGraph], n1: int) -> LocalGraph:
    """The graph a model runs on: ``graph`` (a mesh's ``GraphShard``), or
    where it is None one rank's of ``n1`` node rows."""
    return LocalGraph(n1) if graph is None else graph


def _layer_sizes(cfg: GNNConfig, i: int) -> dict:
    """Layer ``i``'s MLP sizes by name; ``"eps"`` for GIN's scalar."""
    d = cfg.d_hidden
    # EGNN's residual feature update requires d_in == d: an input embedding
    # maps raw features into the hidden width first
    d_in = d if cfg.kind == "egnn" else (cfg.d_in if i == 0 else d)
    if cfg.kind == "gin":
        return {"mlp": [d_in, d, d], "eps": None}
    if cfg.kind == "pna":
        n_feat = len(cfg.aggregators) * len(cfg.scalers) * d_in + d_in
        return {"post": [n_feat, d, d]}
    if cfg.kind == "egnn":
        return {"phi_e": [2 * d + 1, d, d], "phi_x": [d, d, 1],
                "phi_h": [d + d, d, d]}
    raise ValueError(cfg.kind)


def param_shapes(cfg: GNNConfig) -> dict:
    """Every leaf's shape of ``init_params``' pytree."""
    layers = [{k: () if sizes is None else mlp_shapes(sizes)
               for k, sizes in _layer_sizes(cfg, i).items()}
              for i in range(cfg.n_layers)]
    out = {"layers": layers,
           "head": mlp_shapes([cfg.d_hidden, cfg.d_hidden, cfg.n_classes])}
    if cfg.kind == "egnn":
        out["embed"] = mlp_shapes([cfg.d_in, cfg.d_hidden])
    return out


def init_params(cfg: GNNConfig, *, key: torch.Tensor,
                dtype=torch.float32) -> dict:
    """The reference's ``init_gnn(key, cfg, dtype)`` pytree, on the key's
    device: per-kind layer MLPs from ``split(key, n_layers + 2)``, the
    head from the last key, EGNN's input embedding from the one before."""
    ks = trandom.split(key, cfg.n_layers + 2)
    d = cfg.d_hidden
    layers = []
    for i in range(cfg.n_layers):
        lk = trandom.split(ks[i], 4)
        # the MLPs draw from lk[0], lk[1], ... in the reference's order
        layers.append({
            name: (torch.zeros((), dtype=dtype, device=key.device)
                   if sizes is None else
                   mlp_params(sizes, key=lk[j], dtype=dtype))
            for j, (name, sizes) in enumerate(_layer_sizes(cfg, i).items())})
    params = {"layers": layers,
              "head": mlp_params([d, d, cfg.n_classes], key=ks[-1],
                                 dtype=dtype)}
    if cfg.kind == "egnn":
        params["embed"] = mlp_params([cfg.d_in, d], key=ks[-2], dtype=dtype)
    return params


def _pna_parts(msgs, recv, n, deg, cfg: GNNConfig, valid,
               graph: Optional[LocalGraph] = None):
    """4 aggregators × 3 degree scalers (PNA, arXiv:2004.05718), yielded one
    (n, d) part at a time: the caller projects each part at once, so the
    (n, 12·d) concatenation is never built. ``deg`` and the parts are the
    rows of ``graph`` (``graph_of``)."""
    graph = graph_of(graph, n)
    mean, cnt = segment_mean(msgs, recv, n, valid, graph)
    big = torch.tensor(1e30, dtype=msgs.dtype, device=msgs.device)
    v = valid[:, None]
    mx = graph.scatter_max(torch.where(v, msgs, -big), recv, -1e30)
    mn = -graph.scatter_max(torch.where(v, -msgs, -big), recv, -1e30)
    zero = torch.zeros((), dtype=msgs.dtype, device=msgs.device)
    mx = torch.where(cnt[:, None] > 0, mx, zero)
    mn = torch.where(cnt[:, None] > 0, mn, zero)
    sq, _ = segment_mean(msgs * msgs, recv, n, valid, graph)
    std = torch.sqrt(torch.clamp(sq - mean * mean, min=0.0)
                     + torch.tensor(1e-5, dtype=sq.dtype, device=sq.device))
    agg_map = {"mean": mean, "max": mx, "min": mn, "std": std}
    delta = torch.log(graph.mean_rows(deg) + 1.0).to(msgs.dtype)
    logd = torch.log(deg + 1.0)[:, None].to(msgs.dtype)
    for a in cfg.aggregators:
        base = agg_map[a]
        for s in cfg.scalers:
            if s == "identity":
                yield base
            elif s == "amplification":
                yield base * (logd / delta)
            elif s == "attenuation":
                yield base * (delta / torch.clamp(logd, min=1e-5))


def gnn_forward(params: dict, cfg: GNNConfig, feats: torch.Tensor,
                senders: torch.Tensor, receivers: torch.Tensor, *,
                coords: Optional[torch.Tensor] = None,
                graph_ids: Optional[torch.Tensor] = None,
                n_graphs: int = 1,
                graph: Optional[LocalGraph] = None) -> tuple:
    """feats: (n+1, d_in) node features (dump row n). Returns ``(logits,
    coords)``: per-node logits, or per-graph logits (readout="graph"),
    float32, and EGNN's final coordinates (``coords`` for the others).

    On a mesh (``graph`` a ``gnn_spmd.GraphShard``) ``feats`` and the
    per-node logits are this rank's block of node rows, ``senders`` and
    ``receivers`` its block of the edges (global ids), ``coords`` and
    ``graph_ids`` whole: each layer gathers the node state once for the
    edges, and every aggregation comes back reduce-scattered to the rows'
    owners, where the reference constrains its node state to the data
    axes."""
    graph = graph_of(graph, feats.shape[0])
    if feats.shape[0] != graph.rows:
        raise ValueError(f"{feats.shape[0]} node rows for a block of "
                         f"{graph.rows}")
    n1 = graph.n1
    valid = senders < n1 - 1
    send, recv = Segments.of(senders, n1), Segments.of(receivers, n1)
    h = feats.to(getattr(torch, cfg.dtype))
    if cfg.kind == "egnn":
        h = mlp_apply(params["embed"], h, act=F.silu)
    x = coords
    deg = graph.scatter_sum(_segment_sum(valid.float(), recv))
    v = valid[:, None]

    def layer_fn(lp, h, x):
        hg = graph.gather_nodes(h)  # every row, for this rank's edges
        if cfg.kind == "gin":
            # segment_sum(where(valid, hg[senders], 0), receivers)
            agg = graph.scatter_sum(gather_sum(hg, senders, recv, n1 - 1))
            h = mlp_apply(lp["mlp"], (1.0 + lp["eps"]).to(h.dtype) * h + agg,
                          act=torch.relu)
            h = torch.relu(h)
        elif cfg.kind == "pna":
            msgs = gather(hg, send)
            d_part = h.shape[-1]
            w0, b0 = lp["post"]["w0"], lp["post"]["b0"]
            acc = matmul(h, w0[:d_part]) + b0  # concat slot 0 is h itself
            off = d_part
            for part in _pna_parts(msgs, receivers, n1, deg, cfg, valid,
                                   graph):
                acc = acc + matmul(part, w0[off: off + d_part])
                off += d_part
            h = matmul(torch.relu(acc), lp["post"]["w1"]) + lp["post"]["b1"]
        elif cfg.kind == "egnn":
            xe = graph.edge_use(x)
            phi_e, phi_x = graph.edge_params((lp["phi_e"], lp["phi_x"]))
            rel = gather(xe, recv) - gather(xe, send)
            d2 = torch.sum(rel * rel, -1, keepdim=True)
            m = mlp_apply(phi_e,
                          torch.cat([gather(hg, recv), gather(hg, send), d2],
                                    -1),
                          act=F.silu, final_act=F.silu)
            m = torch.where(v, m, torch.zeros((), dtype=m.dtype,
                                              device=m.device))
            w = mlp_apply(phi_x, m, act=F.silu)
            dx = graph.scatter_sum(_segment_sum(rel * w.to(rel.dtype), recv))
            x = x + graph.gather_whole(dx / torch.clamp(deg, min=1.0)[:, None])
            magg = graph.scatter_sum(_segment_sum(m, recv))
            h = h + mlp_apply(lp["phi_h"], torch.cat([h, magg], -1),
                              act=F.silu)
        return h, x

    for lp in params["layers"]:
        if cfg.remat:
            # the backward recomputes the layer: without it every (n, d)
            # and (m, d) intermediate of every layer is kept for it
            h, x = checkpoint(layer_fn, lp, h, x, use_reentrant=False)
        else:
            h, x = layer_fn(lp, h, x)
    if cfg.readout == "graph":
        if graph_ids is None:
            raise ValueError(f"{cfg.name}: a graph readout needs graph_ids")
        out = mlp_apply(graph.pooled_params(params["head"]),
                        graph.pool(h, graph_ids, n_graphs), act=torch.relu)
    else:
        out = mlp_apply(params["head"], h, act=torch.relu)
    return out.float(), x


def gnn_loss(params: dict, cfg: GNNConfig, feats, senders, receivers,
             labels, *, coords=None, graph_ids=None, n_graphs: int = 1,
             label_mask=None,
             graph: Optional[LocalGraph] = None) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels`` (over the real nodes, or
    the graphs), weighted by ``label_mask`` where given. On a mesh
    ``labels`` and ``label_mask`` are whole (``graph``: ``gnn_forward``)."""
    graph = graph_of(graph, feats.shape[0])
    logits, _ = gnn_forward(params, cfg, feats, senders, receivers,
                            coords=coords, graph_ids=graph_ids,
                            n_graphs=n_graphs, graph=graph)
    if cfg.readout == "node" and graph.rows != graph.n1:
        # this rank's rows; the dump row (n1 - 1) has no label
        n = graph.n1 - 1
        if label_mask is None:
            label_mask = torch.ones((n,), device=logits.device)
        pad = (0, 1)
        labels = graph.block(F.pad(labels, pad))
        label_mask = graph.block(F.pad(label_mask.float(), pad))
    elif cfg.readout == "node":
        logits = logits[: feats.shape[0] - 1]
    logp = torch.log_softmax(logits.float(), -1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    if label_mask is not None:
        return graph.masked_mean(nll, label_mask)
    return nll.mean()


class GNN(ParamTree):
    """GIN, PNA or EGNN with the reference's parameter pytree."""

    def __init__(self, cfg: GNNConfig, params: dict):
        super().__init__(params)
        self.cfg = cfg

    @classmethod
    def from_params(cls, params, cfg: GNNConfig, *, device) -> "GNN":
        """From the reference's ``init_gnn`` pytree, as arrays."""
        return cls(cfg, ParamTree.tensors(params, device=device))

    def forward(self, feats, senders, receivers, *, coords=None,
                graph_ids=None, n_graphs: int = 1, graph=None) -> tuple:
        return gnn_forward(self.params(), self.cfg, feats, senders,
                           receivers, coords=coords, graph_ids=graph_ids,
                           n_graphs=n_graphs, graph=graph)

    def loss(self, feats, senders, receivers, labels, **kw) -> torch.Tensor:
        return gnn_loss(self.params(), self.cfg, feats, senders, receivers,
                        labels, **kw)


def init_gnn(cfg: GNNConfig, *, key: torch.Tensor, device=None,
             dtype=torch.float32) -> GNN:
    """``GNN`` with the reference's ``init_gnn(key, cfg)`` weights, drawn
    on ``device`` (the key's own when None)."""
    key = key.to(device) if device is not None else key
    return GNN(cfg, init_params(cfg, key=key, dtype=dtype))
