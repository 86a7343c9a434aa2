"""The port's kernels (connectivity, and the ML-era ``legacy`` embedding_bag):
plain PyTorch versions and hand-written CUDA."""
