from .containers import (  # noqa: F401
    ArrayEdgeSource,
    ChunkedEdgeSource,
    CompressedEdgeBlocks,
    Graph,
    build_graph,
    components_oracle,
    compress_edges,
    compress_graph,
    graph_from_arrays,
    open_edge_file,
    round_up,
    sort_dedup_edges,
    to_numpy_edges,
    write_edge_file,
)
from . import generators  # noqa: F401
