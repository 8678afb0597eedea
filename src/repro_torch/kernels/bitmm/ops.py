"""Public packed boolean products: the JAX package's ``bitmm`` ops.

:func:`bitmm` is the ``packed`` engine's product (bool frontier in, bool
rows out), :func:`bitmm_packed` the same product over a *packed* frontier
(packed words in, packed words out), and :func:`bitmm_apply` the fused
sweep step of the ``packed_fused`` engine.  On a card they launch the CUDA
kernels of ``csrc/bitmm.cu`` (``bitmm_packed``, ``bitmm_apply_packed``);
on the CPU the wrappers run the plain versions.  There is no switch
between the two: the device decides.  Adjacency is square: ``a_packed
int32 [n, nw]`` with ``nw = ceil(n / 32)``; words are ``int32`` bit-views
of the JAX package's ``uint32``.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitops

from . import kernel as _kernel


def bitmm(x: torch.Tensor, a_packed: torch.Tensor) -> torch.Tensor:
    """Bool ``[V, n]`` frontier in, bool ``[V, n]`` rows out:
    ``out[v, j] = OR_{i: x[v, i]} A[i, j]``."""
    return _kernel.bitmm(x, a_packed)


def bitmm_packed(
    x_packed: torch.Tensor, a_packed: torch.Tensor, n: int | None = None
) -> torch.Tensor:
    """Packed frontier ``int32 [V, nw]`` in, packed rows ``int32 [V, nw]``
    out.

    The frontier's bits past the adjacency's ``n`` rows are ignored.  It is
    unpacked once (:func:`repro_torch.core.bitops.unpack`) and the product
    runs through :func:`repro_torch.kernels.bitmm.kernel.bitmm_packed`,
    which takes a bool frontier.  ``n``, where given, must equal the
    adjacency's row count.
    """
    rows = a_packed.shape[0]
    if n is not None and n != rows:
        raise ValueError(f"n={n} but the adjacency has {rows} rows")
    if x_packed.dtype != torch.int32:
        raise TypeError("bitmm_packed takes int32 frontier words")
    if x_packed.dim() != 2 or x_packed.shape[1] != bitops.packed_width(rows):
        raise ValueError(
            f"frontier must be [V, {bitops.packed_width(rows)}], got "
            f"{tuple(x_packed.shape)}"
        )
    return _kernel.bitmm_packed(bitops.unpack(x_packed, rows), a_packed)


def bitmm_apply(
    chi_packed: torch.Tensor, a_packed: torch.Tensor, lhs_flags: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """One fused operator application on packed chi: ``(chi', changed)``
    (see :func:`repro_torch.kernels.bitmm.kernel.bitmm_apply`)."""
    return _kernel.bitmm_apply(chi_packed, a_packed, lhs_flags)
