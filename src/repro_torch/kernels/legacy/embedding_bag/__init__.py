"""The embedding_bag kernel: plain version (ref.py) and CUDA wrapper (kernel.py)."""
