"""Device resolution for the port's entry points.

Every entry point (``GraphDB``, ``Engine``, ``CompiledPlan``, the solvers)
takes an explicit ``device`` that defaults to ``"cuda"``.  Without a card
that default raises here instead of carrying on on the CPU: the CPU runs
only when the caller asks for it with ``device="cpu"``.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device = DEFAULT_DEVICE) -> torch.device:
    """``device`` as a :class:`torch.device`; raises when it cannot run."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain torch versions"
        )
    return dev
