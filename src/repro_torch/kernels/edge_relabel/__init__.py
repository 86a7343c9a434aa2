"""The edge_relabel and edge_rewrite kernels: plain versions (ref.py) and CUDA
wrappers (kernel.py)."""
