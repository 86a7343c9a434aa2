"""Architecture registry. Only ``dlrm-rm2`` is registered so far; the
reference's other archs (LM, GNN, connectit cells) are queued in ROADMAP."""
from .base import Arch, all_archs, get_arch, load_all  # noqa: F401
