"""Seed-era stack of the reference (``repro.legacy``), ported as its paths
are: the DLRM model (serving), the data streams (DLRM batches, streaming
insert batches) and checkpoints."""
