"""ConnectIt in PyTorch, with hand-written CUDA kernels for Hopper.

A port of the JAX package ``repro``, which stays the reference. It imports
torch, numpy and scipy only. Entry points run on the card (``device="cuda"``)
unless the caller passes ``device="cpu"``; each hot-path op runs its CUDA
kernel on a CUDA tensor and its plain PyTorch version on a CPU tensor.

    from repro_torch import ConnectIt
    from repro_torch.graphs import generators as gen
    g = gen.rmat(1 << 16, 1 << 19, seed=0)
    labels = ConnectIt("kout_hybrid_k2+uf_sync_full").connectivity(g)
"""

from .api import (  # noqa: F401
    ConnectIt,
    FinishSpec,
    SamplingSpec,
    VariantSpec,
    enumerate_variants,
)
from .core.driver import ConnectivityStats  # noqa: F401
from .graphs import build_graph, components_oracle, graph_from_arrays  # noqa: F401
