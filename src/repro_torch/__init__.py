"""repro_torch: the dual-simulation query system on PyTorch and CUDA.

The JAX package ``repro`` is the reference; this package mirrors its
subpackage layout and imports neither JAX nor ``repro``.  Entry points run
on ``device="cuda"`` unless the caller passes ``device="cpu"``.
"""
