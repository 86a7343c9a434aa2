"""The hook_compress kernel: plain version (ref.py) and CUDA wrapper (kernel.py)."""
