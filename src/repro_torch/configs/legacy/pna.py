"""PNA [arXiv:2004.05718]: 4 aggregators x 3 degree scalers."""
from ...legacy.models.gnn import GNNConfig
from ..base import Arch, GNN_SHAPES, register

MODEL = GNNConfig(
    name="pna", kind="pna", n_layers=4, d_hidden=75, d_in=0, n_classes=0,
    aggregators=("mean", "max", "min", "std"),
    scalers=("identity", "amplification", "attenuation"))

register(Arch(
    name="pna", family="gnn", model=MODEL, shapes=GNN_SHAPES,
    smoke=dict(n_layers=2, d_hidden=16)))
