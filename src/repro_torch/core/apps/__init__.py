"""ConnectIt applications (paper §5): AMSF and SCAN GS*-Query as consumers
of the variant space. ``AppSpec`` (spec.py) is the declarative grammar;
``amsf`` and ``scan`` hold the programs; the backends of
``core/execution.py`` run them behind ``repro_torch.api.ConnectIt.amsf`` /
``.msf`` / ``.scan``."""

from . import amsf, scan  # noqa: F401
from .spec import (  # noqa: F401
    APPS,
    AppSpec,
    as_app_spec,
    default_app_grid,
)
