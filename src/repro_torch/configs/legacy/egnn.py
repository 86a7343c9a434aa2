"""EGNN [arXiv:2102.09844]: E(n)-equivariant message passing."""
from ...legacy.models.gnn import GNNConfig
from ..base import Arch, GNN_SHAPES, register

MODEL = GNNConfig(
    name="egnn", kind="egnn", n_layers=4, d_hidden=64, d_in=0, n_classes=0)

register(Arch(
    name="egnn", family="gnn", model=MODEL, shapes=GNN_SHAPES,
    smoke=dict(n_layers=2, d_hidden=16)))
