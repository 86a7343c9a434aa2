"""``repro_torch.tune``: autotuning on the session's device, with a
persistent selection cache (the JAX package's ``repro.tune``).

The ConnectIt paper's central finding is that no single variant wins
everywhere, and the GPU follow-up (Hong et al., arXiv:2008.11839) shows
that the winner also changes with the backend. This package
micro-benchmarks the candidate (variant, block size) grid on the device
and graph family at hand (``tuner``/``harness``) and persists the winners
on disk (``cache``), so that later sessions resolve ``auto`` choices by a
lookup:

* ``ConnectIt("auto", device=...)`` resolves the variant per graph family
  (a cold cache gives the paper's recommended default, never an error);
* ``repro_torch.kernels.ops.tuned_block_m`` resolves each CUDA kernel's
  threads a block: 256, the one size the kernels are built for, which the
  block ladder's one point keeps;
* the ``tune`` ExecutionSpec opt re-measures for a session;
* ``python -m repro_torch.launch.tune`` is the offline driver.

Its file is its own (``REPRO_TORCH_TUNE_CACHE``, else
``~/.cache/repro_torch/tune.json``) and its keys name the device, so the
reference's winners and another device's never resolve here.
"""

from .cache import (  # noqa: F401
    ENV_VAR,
    SCHEMA_VERSION,
    SelectionCache,
    backend_key,
    cache_path,
    default_cache,
    fingerprint,
    fingerprint_graph,
    make_key,
    reset_default_cache,
)
from .harness import (  # noqa: F401
    PRIMITIVE_LABELS,
    PRIMITIVES,
    measure_primitives,
    primitive_drivers,
    primitive_problem,
    time_fn,
)
from .space import TuneSpec, as_tune_spec  # noqa: F401
from .tuner import (  # noqa: F401
    PAPER_DEFAULT_VARIANT,
    resolve_block_m,
    resolve_variant,
    tune_block_m,
    tune_families,
    tune_variant,
)

__all__ = [
    "TuneSpec", "as_tune_spec", "SelectionCache", "default_cache",
    "reset_default_cache", "cache_path", "make_key", "backend_key",
    "fingerprint", "fingerprint_graph", "time_fn", "primitive_problem",
    "primitive_drivers", "measure_primitives", "PRIMITIVES",
    "PRIMITIVE_LABELS", "PAPER_DEFAULT_VARIANT", "resolve_variant",
    "resolve_block_m", "tune_block_m", "tune_variant", "tune_families",
    "ENV_VAR", "SCHEMA_VERSION",
]
