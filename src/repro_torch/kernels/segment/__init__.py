"""segment_sum and gather_sum: the GNN's aggregations over a sorted segment
layout."""
