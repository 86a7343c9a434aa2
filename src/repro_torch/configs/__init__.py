"""Architecture registry: the paper's own ``connectit`` cells, the seed-era
``dlrm-rm2``, the five LM archs and the four GNN archs (their cells on a
mesh of several ranks: ROADMAP Queue 1 item 16, third part (b))."""
from .base import Arch, all_archs, get_arch, load_all  # noqa: F401
