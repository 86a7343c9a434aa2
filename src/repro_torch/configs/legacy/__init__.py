"""Seed-era model configs: DLRM-RM2, the five LM archs and the four GNN
archs (GIN, PNA, EGNN, NequIP)."""
