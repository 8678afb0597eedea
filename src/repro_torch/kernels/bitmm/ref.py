"""Plain PyTorch versions of the packed boolean products.

* :func:`bitmm_packed_ref` — ``out[q, jw] = OR_{i: x[q, i]} A[i, jw]``
  over packed adjacency rows: the same function as the CUDA kernel
  ``bitmm_packed`` (``csrc/bitmm.cu``).
* :func:`bitmm_apply_ref` — the fused sweep step of the ``packed_fused``
  engine: ``y = chi ×b A``, then ``chi'[l] = chi[l] & ~OR_{r: F[l, r]}
  ~y[r]`` and a word that is nonzero iff any chi word moved: the same
  function as the CUDA kernel ``bitmm_apply_packed``.

Both are what the kernels' wrappers run for a tensor on the CPU, and what
the kernels are held against on the card.  They reduce word-wise, like the
JAX package's ``bitmm_apply_words``, but chunk the contraction: the full
``[V, n, nw]`` masked plane would not fit at the dense tier's largest
graphs.  Words are ``int32`` bit-views of the reference's ``uint32``;
torch has no OR reduction, so :func:`or_reduce` folds halves together.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitops

# words of one masked [rows, ..., nw] plane per chunk (256 MiB of int32)
PLANE_WORDS = 1 << 26


def or_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Bitwise OR of ``x`` along ``dim`` (zero words where ``dim`` is empty)."""
    x = x.movedim(dim, 0)
    if x.shape[0] == 0:
        return torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        folded = torch.bitwise_or(x[:half], x[half:2 * half])
        if x.shape[0] % 2:
            folded[0] |= x[-1]
        x = folded
    return x[0]


def _rows_per_chunk(per_row: int) -> int:
    """Rows of a masked plane that fit :data:`PLANE_WORDS` (at least one)."""
    return max(1, PLANE_WORDS // max(per_row, 1))


def bitmm_packed_ref(x: torch.Tensor, a_packed: torch.Tensor) -> torch.Tensor:
    """``int32 [V, nw]``: OR of the packed rows ``a_packed[i]`` that each
    variable's 0/1 (or bool) frontier ``x [V, n]`` selects.

    The contraction runs as many rows at a time as keep the masked ``[V,
    rows, nw]`` plane within :data:`PLANE_WORDS`.
    """
    v, n = x.shape
    nw = a_packed.shape[1]
    flags = x != 0
    out = torch.zeros((v, nw), dtype=torch.int32, device=a_packed.device)
    step = _rows_per_chunk(v * nw)
    for i0 in range(0, n, step):
        i1 = min(n, i0 + step)
        masked = torch.where(flags[:, i0:i1, None], a_packed[None, i0:i1], 0)
        out |= or_reduce(masked, 1)
    return out


def bitmm_apply_ref(
    chi_packed: torch.Tensor,
    a_packed: torch.Tensor,
    lhs_flags: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the fused sweep step; returns ``(chi', changed)``.

    ``chi_packed int32 [V, nw]``, ``a_packed int32 [n, nw]``,
    ``lhs_flags [V, V]`` (0/1; ``[l, r]`` set iff the SOI holds ``chi[l]
    <= chi[r] ×b A``).  ``changed`` is the ``int32`` OR of ``chi' ^ chi``
    over every word, as the Pallas kernel's changed word: nonzero iff any
    word moved.  ``~y`` sets the pad bits of the last word, but chi's pad
    bits are zero and ``chi & ~bad`` keeps them so.  :data:`PLANE_WORDS`
    bounds both the contraction's and the combine's ``[rows, V, nw]``
    planes.
    """
    v, nw = chi_packed.shape
    n = a_packed.shape[0]
    y = bitmm_packed_ref(bitops.unpack(chi_packed, n), a_packed)
    not_y = torch.bitwise_not(y)
    f = lhs_flags != 0
    new = torch.empty_like(chi_packed)
    step = _rows_per_chunk(v * nw)
    for l0 in range(0, v, step):
        l1 = min(v, l0 + step)
        bad = or_reduce(torch.where(f[l0:l1, :, None], not_y[None], 0), 1)
        new[l0:l1] = torch.bitwise_and(
            chi_packed[l0:l1], torch.bitwise_not(bad)
        )
    changed = or_reduce(torch.bitwise_xor(new, chi_packed).reshape(-1), 0)
    return new, changed
