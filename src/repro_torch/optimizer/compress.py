"""Gradient compression for bandwidth-bound data parallelism.

Top-k sparsification with error feedback (memory): each step transmits only
the largest-|g| fraction of each gradient tensor; the residual is carried to
the next step.  A mostly-zero tensor does not shrink an all-reduce's bytes
by itself, so the practical win comes from pairing with int8 quantization
(``quantize_int8``), which does shrink the wire format.  Both are
composable hooks over lists of gradient tensors.
"""
from __future__ import annotations

import torch


def init_error(params: list[torch.Tensor]) -> list[torch.Tensor]:
    return [torch.zeros_like(p, dtype=torch.float32) for p in params]


def topk_sparsify(
    grads: list[torch.Tensor], error: list[torch.Tensor], fraction: float = 0.01
) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Keep the top-``fraction`` entries (by magnitude) of grad+error;
    returns (kept, new error)."""
    kept, resid = [], []
    for g, e in zip(grads, error):
        g = g.to(torch.float32) + e
        flat = torch.abs(g).reshape(-1)
        k = max(1, int(flat.shape[0] * fraction))
        thresh = torch.topk(flat, k).values[-1]
        keep = torch.where(torch.abs(g) >= thresh, g, torch.zeros_like(g))
        kept.append(keep)
        resid.append(g - keep)
    return kept, resid


def quantize_int8(
    grads: list[torch.Tensor],
) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Per-tensor symmetric int8 quantization; returns (q, scales)."""
    qs, scales = [], []
    for g in grads:
        g = g.to(torch.float32)
        s = torch.max(torch.abs(g)) / 127.0 + 1e-12
        qs.append(torch.clamp(torch.round(g / s), -127, 127).to(torch.int8))
        scales.append(s)
    return qs, scales


def dequantize_int8(
    q: list[torch.Tensor], scales: list[torch.Tensor]
) -> list[torch.Tensor]:
    return [qq.to(torch.float32) * ss for qq, ss in zip(q, scales)]
