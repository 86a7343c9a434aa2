"""GIN [arXiv:1810.00826]: sum aggregation, learnable eps."""
from ...legacy.models.gnn import GNNConfig
from ..base import Arch, GNN_SHAPES, register

MODEL = GNNConfig(
    name="gin-tu", kind="gin", n_layers=5, d_hidden=64, d_in=0, n_classes=0,
    learn_eps=True)

register(Arch(
    name="gin-tu", family="gnn", model=MODEL, shapes=GNN_SHAPES,
    smoke=dict(n_layers=2, d_hidden=16)))
