"""repro_torch.dynamic — batch-dynamic connectivity (inserts, deletes,
queries) behind ``ConnectIt(spec).stream(n, dynamic=True, log=...)``."""

from .engine import (  # noqa: F401
    DEFAULT_SEARCH_ROUNDS,
    DynamicState,
    default_log_cap,
    init_dynamic,
    make_update,
)
