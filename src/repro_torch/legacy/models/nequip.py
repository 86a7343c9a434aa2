"""NequIP: an E(3)-equivariant interatomic potential (arXiv:2101.03164)
(mirrors ``repro.legacy.models.nequip``).

Features are direct sums of real-SH irreps {l=0,1,2} with a uniform channel
count. Each interaction layer:

  1. edge geometry: r̂_ij spherical harmonics Y_l, a Bessel radial basis ×
     a polynomial cutoff envelope;
  2. tensor-product messages: for every allowed path (l_in, l_f, l_out),
     the Gaunt contraction of the neighbours' features with Y_{l_f},
     weighted per channel by a radial MLP on the basis, and accumulated on
     the edge side for each output l;
  3. one segment sum per l to the receivers (``kernels/segments.py``: the
     hand-written CUDA kernel on the card, its gradient in a fixed order),
     a linear self-interaction per l, a residual and gates (silu on l=0, a
     sigmoid of the scalars for l>0).

Output: per-atom energy from the l=0 channels, summed per graph. The path
contraction ``mci,mj,ijk->mck`` is taken as ``Y_l2 · G`` first (m, i, k),
then a batched product with the features, so no (m, c, i, j) intermediate
is built.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ... import random as trandom
from ...kernels.segments import Segments, gather
from ...kernels.segments import segment_sum as _segment_sum
from .gnn import LocalGraph, graph_of
from .irreps import allowed_paths, gaunt, sh_torch
from .layers import (
    ParamTree,
    dense_init,
    div,
    mlp_apply,
    mlp_params,
    mlp_shapes,
)


@dataclasses.dataclass(frozen=True)
class NequIPConfig:
    name: str
    n_layers: int = 5
    channels: int = 32
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 4
    d_radial: int = 32
    remat: bool = False       # checkpoint each interaction layer


def bessel_basis(r: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """Bessel RBF with a C² polynomial envelope (DimeNet-style)."""
    r = torch.clamp(r, min=1e-6)
    n = torch.arange(1, n_rbf + 1, dtype=r.dtype, device=r.device)
    rb = float(np.sqrt(2.0 / cutoff)) * torch.sin(
        div(n * float(np.pi) * r[..., None], cutoff)) / r[..., None]
    u = torch.clamp(div(r, cutoff), 0.0, 1.0)
    u3 = u * u * u
    env = 1.0 - 10.0 * u3 + 15.0 * (u3 * u) - 6.0 * (u3 * u * u)
    return rb * env[..., None]


def param_shapes(cfg: NequIPConfig) -> dict:
    """Every leaf's shape of ``init_params``' pytree."""
    ch = cfg.channels
    layer = {"radial": {f"{a}{b}{c}": mlp_shapes([cfg.n_rbf, cfg.d_radial,
                                                  ch])
                        for a, b, c in allowed_paths(cfg.l_max)},
             "self": {str(l): (ch, ch) for l in range(cfg.l_max + 1)},
             "gate": (ch, cfg.l_max + 1)}
    return {"embed": (cfg.n_species, ch),
            "layers": [layer] * cfg.n_layers,
            "head": mlp_shapes([ch, cfg.d_radial, 1])}


def init_params(cfg: NequIPConfig, *, key: torch.Tensor,
                dtype=torch.float32) -> dict:
    """The reference's ``init_nequip(key, cfg, dtype)`` pytree, on the
    key's device."""
    paths = allowed_paths(cfg.l_max)
    ks = trandom.split(key, cfg.n_layers + 2)
    layers = []
    for i in range(cfg.n_layers):
        lk = trandom.split(ks[i], len(paths) + cfg.l_max + 2)
        layer = {"radial": {}, "self": {}}
        for j, (l1, l2, l3) in enumerate(paths):
            layer["radial"][f"{l1}{l2}{l3}"] = mlp_params(
                [cfg.n_rbf, cfg.d_radial, cfg.channels], key=lk[j],
                dtype=dtype)
        for l in range(cfg.l_max + 1):
            layer["self"][str(l)] = dense_init(
                cfg.channels, cfg.channels, key=lk[len(paths) + l],
                dtype=dtype)
        layer["gate"] = dense_init(cfg.channels, cfg.l_max + 1, key=lk[-1],
                                   dtype=dtype)
        layers.append(layer)
    return {
        "embed": dense_init(cfg.n_species, cfg.channels, key=ks[-2],
                            dtype=dtype, scale=1.0),
        "layers": layers,
        "head": mlp_params([cfg.channels, cfg.d_radial, 1], key=ks[-1],
                           dtype=dtype),
    }


def nequip_forward(params: dict, cfg: NequIPConfig, species: torch.Tensor,
                   coords: torch.Tensor, senders: torch.Tensor,
                   receivers: torch.Tensor, *,
                   graph_ids: Optional[torch.Tensor] = None,
                   n_graphs: int = 1,
                   graph: Optional[LocalGraph] = None) -> torch.Tensor:
    """species: (n+1,) int; coords: (n+1, 3). Returns the per-graph energy
    (n_graphs,), or the whole batch's (1,) without ``graph_ids``. On a mesh
    (``graph`` a ``gnn_spmd.GraphShard``) ``species``, ``coords`` and
    ``graph_ids`` are whole, the edges this rank's block: the features of
    this rank's node rows are gathered once a layer for the edges, and each
    output l's messages come back reduce-scattered (``gnn.gnn_forward``)."""
    graph = graph_of(graph, species.shape[0])
    n1 = graph.n1
    valid = senders < n1 - 1
    send, recv = Segments.of(senders, n1), Segments.of(receivers, n1)
    rel = gather(coords, recv) - gather(coords, send)
    r = torch.sqrt(torch.sum(rel * rel, -1) + 1e-12)
    rhat = rel / r[..., None]
    rbf = bessel_basis(r, cfg.n_rbf, cfg.cutoff)          # (m, n_rbf)
    rbf = torch.where(valid[:, None], rbf, 0.0)
    Y = {l: sh_torch(l, rhat) for l in range(cfg.l_max + 1)}  # (m, 2l+1)
    m_edges = senders.shape[0]
    dt, dev = coords.dtype, coords.device

    rows = graph.rows
    feats: Dict[int, torch.Tensor] = {
        l: torch.zeros((rows, cfg.channels, 2 * l + 1), dtype=dt, device=dev)
        for l in range(cfg.l_max + 1)}
    onehot = F.one_hot(graph.block(species).long(), cfg.n_species).to(dt)
    feats[0] = (onehot @ params["embed"])[:, :, None]
    paths = allowed_paths(cfg.l_max)
    gaunts = {p: torch.tensor(gaunt(*p), device=dev) for p in paths}
    v = valid[:, None, None]

    def layer_fn(layer, *fs):
        # edge-side accumulation per output l: one segment sum per l
        # instead of one per tensor-product path (3 against 11)
        hg = [graph.gather_nodes(f) for f in fs]
        radial = graph.edge_params(layer["radial"])
        edge_msgs = {l: torch.zeros((m_edges, cfg.channels, 2 * l + 1),
                                    dtype=dt, device=dev)
                     for l in range(cfg.l_max + 1)}
        for (l1, l2, l3) in paths:
            w = mlp_apply(radial[f"{l1}{l2}{l3}"], rbf,
                          act=F.silu)                     # (m, ch)
            src = gather(hg[l1], send)                    # (m, ch, 2l1+1)
            yg = torch.einsum("mj,ijk->mik", Y[l2], gaunts[(l1, l2, l3)])
            m = torch.bmm(src, yg)                        # (m, ch, 2l3+1)
            m = m * w[:, :, None]
            m = torch.where(v, m, 0.0)
            edge_msgs[l3] = edge_msgs[l3] + m
        msgs = {l: graph.scatter_sum(_segment_sum(edge_msgs[l], recv))
                for l in range(cfg.l_max + 1)}
        # self-interaction + residual + gate
        new = {}
        for l in range(cfg.l_max + 1):
            z = torch.einsum("ncv,cd->ndv", msgs[l], layer["self"][str(l)])
            new[l] = fs[l] + z
        scal = new[0][:, :, 0]
        gates = torch.sigmoid(scal @ layer["gate"])       # (n, l_max+1)
        for l in range(cfg.l_max + 1):
            if l == 0:
                new[0] = F.silu(new[0])
            else:
                new[l] = new[l] * gates[:, None, l: l + 1]
        return tuple(new[l] for l in range(cfg.l_max + 1))

    fs = tuple(feats[l] for l in range(cfg.l_max + 1))
    for layer in params["layers"]:
        if cfg.remat:
            fs = checkpoint(layer_fn, layer, *fs, use_reentrant=False)
        else:
            fs = layer_fn(layer, *fs)

    energy = mlp_apply(params["head"], fs[0][:, :, 0],
                       act=F.silu)[..., 0]                # (rows,)
    # the dump row's energy is left out
    return graph.pool(energy, graph_ids, n_graphs)


def nequip_loss(params: dict, cfg: NequIPConfig, species, coords, senders,
                receivers, targets, *, graph_ids=None, n_graphs: int = 1,
                graph: Optional[LocalGraph] = None) -> torch.Tensor:
    """Mean squared error of the energies against ``targets``."""
    e = nequip_forward(params, cfg, species, coords, senders, receivers,
                       graph_ids=graph_ids, n_graphs=n_graphs, graph=graph)
    return torch.mean((e - targets) ** 2)


class NequIP(ParamTree):
    """NequIP with the reference's parameter pytree."""

    def __init__(self, cfg: NequIPConfig, params: dict):
        super().__init__(params)
        self.cfg = cfg

    @classmethod
    def from_params(cls, params, cfg: NequIPConfig, *, device) -> "NequIP":
        """From the reference's ``init_nequip`` pytree, as arrays."""
        return cls(cfg, ParamTree.tensors(params, device=device))

    def forward(self, species, coords, senders, receivers, *, graph_ids=None,
                n_graphs: int = 1, graph=None) -> torch.Tensor:
        return nequip_forward(self.params(), self.cfg, species, coords,
                              senders, receivers, graph_ids=graph_ids,
                              n_graphs=n_graphs, graph=graph)

    def loss(self, species, coords, senders, receivers, targets,
             **kw) -> torch.Tensor:
        return nequip_loss(self.params(), self.cfg, species, coords, senders,
                           receivers, targets, **kw)


def init_nequip(cfg: NequIPConfig, *, key: torch.Tensor, device=None,
                dtype=torch.float32) -> NequIP:
    """``NequIP`` with the reference's ``init_nequip(key, cfg)`` weights,
    drawn on ``device`` (the key's own when None)."""
    key = key.to(device) if device is not None else key
    return NequIP(cfg, init_params(cfg, key=key, dtype=dtype))
