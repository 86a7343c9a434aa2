"""ConnectIt core in PyTorch: primitives, the finish methods, the samplers
and the two-phase driver behind ``repro_torch.api``."""
from . import driver, finish, primitives, sampling, streaming  # noqa: F401
from .driver import (  # noqa: F401
    ConnectivityStats,
    run_connectivity,
    run_connectivity_fused,
)
from .finish import make_finish  # noqa: F401
from .sampling import make_sampler  # noqa: F401
