"""Connectivity kernels: plain PyTorch versions and hand-written CUDA."""
