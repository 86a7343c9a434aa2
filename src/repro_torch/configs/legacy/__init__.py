"""Seed-era model configs, ported as their paths are: DLRM-RM2 and the
five LM archs so far."""
