"""The threefry draws: plain version (ref.py) and CUDA wrappers (kernel.py)."""
