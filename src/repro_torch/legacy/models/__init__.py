"""Models of the ML stack: DLRM, the transformer and its MoE, and the GNN
family (GIN, PNA, EGNN) with NequIP."""
