"""Attention ops and the CUDA flash kernels of the decision path."""
