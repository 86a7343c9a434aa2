"""Seed-era ML stack of the reference (``repro.legacy``), ported as its
paths are: the DLRM model (serving) and its data stream so far."""
