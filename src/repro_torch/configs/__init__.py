"""Architecture registry: the paper's own ``connectit`` cells, the seed-era
``dlrm-rm2``, the five LM archs and the four GNN archs, whose cells run on
one rank or a mesh (``launch/steps.py``)."""
from .base import Arch, all_archs, get_arch, load_all  # noqa: F401
