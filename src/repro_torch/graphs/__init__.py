from .containers import (  # noqa: F401
    Graph,
    build_graph,
    components_oracle,
    graph_from_arrays,
    round_up,
    sort_dedup_edges,
    to_numpy_edges,
)
from . import generators  # noqa: F401
