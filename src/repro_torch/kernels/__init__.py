"""Hand-written Hopper kernels of the torch port, and their launch counts.

Every wrapper adds one to its entry of :data:`LAUNCHES` where it launches
its CUDA kernel, and nowhere else: a call that takes the plain PyTorch
version (a tensor on the CPU) counts nothing.  A run reads the counts to
show that its path really went through the kernels.
"""
from __future__ import annotations

LAUNCHES: dict[str, int] = {}


def count_launch(name: str) -> None:
    """Record one launch of kernel ``name``."""
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


def reset_launches() -> None:
    """Set every launch count to zero."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0
