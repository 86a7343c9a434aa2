"""Seed-era LM launch drivers (mirrors ``repro.launch.legacy``):
``serve.py`` is the transformer prefill/decode driver over the LM configs'
smoke overrides. ``repro_torch.launch.serve`` serves the ConnectIt
workload."""
