"""The train-step factory.

``make_train_step(loss, opt_cfg, microbatches=k)`` builds

    step(model, opt_state, batch) -> metrics

with gradient accumulation over ``k`` microbatches, so the live activation
set is the microbatch's, not the global batch's.  Gradients accumulate in
f32; the step then runs :func:`repro_torch.optimizer.adamw.update`, which
changes the model's parameters and ``opt_state`` in place.  ``metrics``
holds ``loss`` (the mean over microbatches), ``grad_norm`` and ``lr``, as
0-d tensors on the model's device.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from repro_torch.optimizer import adamw


def _split_batch(batch: dict, k: int) -> list[dict]:
    b = next(iter(batch.values())).shape[0]
    if b % k:
        raise ValueError(f"batch {b} not divisible by microbatches {k}")
    n = b // k
    return [{name: x[i * n:(i + 1) * n] for name, x in batch.items()} for i in range(k)]


def make_train_step(
    loss_fn: Callable[[nn.Module, dict], torch.Tensor],
    opt_cfg: adamw.AdamWConfig,
    *,
    microbatches: int = 1,
) -> Callable[[nn.Module, dict, dict], dict]:
    """loss_fn(model, microbatch) -> scalar."""

    def step(model: nn.Module, opt_state: dict, batch: dict) -> dict:
        params = list(model.parameters())
        if microbatches == 1:
            loss = loss_fn(model, batch)
            grads = list(torch.autograd.grad(loss, params))
        else:
            grads = [torch.zeros_like(p, dtype=torch.float32) for p in params]
            loss = torch.zeros((), dtype=torch.float32, device=params[0].device)
            for one in _split_batch(batch, microbatches):
                l = loss_fn(model, one)
                for acc, g in zip(grads, torch.autograd.grad(l, params)):
                    acc += g.to(torch.float32)
                loss = loss + l.detach()
            grads = [g / microbatches for g in grads]
            loss = loss / microbatches
        metrics = adamw.update(opt_cfg, grads, opt_state, params)
        metrics["loss"] = loss.detach()
        return metrics

    return step
