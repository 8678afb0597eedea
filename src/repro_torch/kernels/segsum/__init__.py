"""Segmented OR for the edge engines: host layout, plain version, CUDA kernel."""
