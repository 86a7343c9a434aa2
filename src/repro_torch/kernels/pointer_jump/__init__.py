"""The pointer_jump kernel: plain version (ref.py) and CUDA wrapper (kernel.py)."""
