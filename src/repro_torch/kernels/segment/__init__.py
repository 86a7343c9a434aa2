"""segment_sum: the GNN's aggregation over a sorted segment layout."""
