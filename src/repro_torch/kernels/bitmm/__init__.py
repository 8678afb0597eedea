"""Packed boolean products for the dense-adjacency tier: plain versions, CUDA kernels."""
