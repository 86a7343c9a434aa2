"""Seed-era model configs, ported as their paths are (DLRM-RM2 so far)."""
