"""NequIP [arXiv:2101.03164]: O(3)-equivariant tensor products, l_max=2."""
from ...legacy.models.nequip import NequIPConfig
from ..base import Arch, GNN_SHAPES, register

MODEL = NequIPConfig(
    name="nequip", n_layers=5, channels=32, l_max=2, n_rbf=8, cutoff=5.0,
    n_species=8)

register(Arch(
    name="nequip", family="gnn", model=MODEL, shapes=GNN_SHAPES,
    smoke=dict(n_layers=2, channels=8, n_rbf=4)))
