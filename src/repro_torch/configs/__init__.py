"""Architecture registry: the paper's own ``connectit`` cells and the
seed-era ``dlrm-rm2``; the reference's other archs (LM, GNN) are queued in
ROADMAP (Queue 1 item 16)."""
from .base import Arch, all_archs, get_arch, load_all  # noqa: F401
