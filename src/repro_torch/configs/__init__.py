"""Architecture registry: the paper's own ``connectit`` cells, the seed-era
``dlrm-rm2`` and the five LM archs; the reference's GNN archs are queued in
ROADMAP (Queue 1 item 16, third part)."""
from .base import Arch, all_archs, get_arch, load_all  # noqa: F401
