"""The scatter_min kernel: plain version (ref.py) and CUDA wrapper (kernel.py)."""
