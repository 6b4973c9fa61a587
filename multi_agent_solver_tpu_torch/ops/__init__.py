"""Kernels of the main path: each module holds one hand-written CUDA kernel's
wrapper, its plain PyTorch version and its launch counter (``STATS``)."""
