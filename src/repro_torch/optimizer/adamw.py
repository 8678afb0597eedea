"""AdamW + cosine LR schedule + global-norm clipping, as plain functions.

The JAX package's formula, not ``torch.optim.AdamW``: the decoupled decay
is part of the step, ``p - lr * (m_hat / (sqrt(n_hat) + eps) + wd * p)``,
computed in f32 and cast back to the parameter's dtype, after the
gradients are clipped to a global norm.  The state is ``{"mu": [...],
"nu": [...], "step": int32 tensor}`` with one f32 moment per parameter, in
the order of the parameter list; every function works on lists of
tensors and updates in place.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (read as f32): linear warmup, then cosine
    decay to ``min_lr_frac * lr``."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0, 1.0,
    )
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def init(params: list[torch.Tensor]) -> dict:
    """Zero f32 moments beside each parameter, and the step counter."""
    device = params[0].device if params else torch.device("cpu")
    zeros = lambda: [torch.zeros_like(p, dtype=torch.float32) for p in params]  # noqa: E731
    return {"mu": zeros(), "nu": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32."""
    sq = [torch.sum(torch.square(t.to(torch.float32))) for t in tensors]
    total = sq[0]
    for s in sq[1:]:
        total = total + s
    return torch.sqrt(total)


@torch.no_grad()
def update(
    cfg: AdamWConfig,
    grads: list[torch.Tensor],
    state: dict,
    params: list[torch.Tensor],
) -> dict:
    """One AdamW step: ``params``, ``state["mu"]``, ``state["nu"]`` and
    ``state["step"]`` change in place.  Returns ``{"grad_norm", "lr"}``
    (0-d f32 tensors on the parameters' device; reading them waits for
    the device)."""
    state["step"].add_(1)
    step = state["step"].to(torch.float32)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    lr = schedule(cfg, step)
    b1c = 1 - torch.pow(cfg.b1, step)
    b2c = 1 - torch.pow(cfg.b2, step)
    for p, g, mu, nu in zip(params, grads, state["mu"], state["nu"]):
        g = (g * scale.to(g.dtype)).to(torch.float32)
        mu.copy_(cfg.b1 * mu + (1 - cfg.b1) * g)
        nu.copy_(cfg.b2 * nu + (1 - cfg.b2) * g * g)
        step_ = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps)
        step_ += cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * step_).to(p.dtype))
    return {"grad_norm": gnorm, "lr": lr}
