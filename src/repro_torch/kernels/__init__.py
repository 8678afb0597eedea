"""Hand-written Hopper kernels of the torch port, and their launch counts.

Every wrapper adds one to its entry of :data:`LAUNCHES` where it launches
its CUDA kernel, and nowhere else: a call that takes the plain PyTorch
version (a tensor on the CPU) counts nothing.  A run reads the counts to
show that its path really went through the kernels.  Serving replicas
launch from several threads at once, so the counts change under a lock.
"""
from __future__ import annotations

import threading

LAUNCHES: dict[str, int] = {}  # guarded-by: _lock
_lock = threading.Lock()


def count_launch(name: str) -> None:
    """Record one launch of kernel ``name``."""
    with _lock:
        LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


def reset_launches() -> None:
    """Set every launch count to zero."""
    with _lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def launch_counts() -> dict[str, int]:
    """A copy of every launch count, taken under the lock."""
    with _lock:
        return dict(LAUNCHES)
