"""Public segment ops: host-side layout + kernel call in one step.

:func:`segsum` and :func:`segor` take numpy arrays and return a tensor on
``device``.  On a card they launch the CUDA kernels (``csrc/segsum.cu``,
``csrc/segor.cu``); on the CPU the wrappers run the plain versions.  There
is no switch between the two: the device decides.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import bitops
from repro_torch.core.device import DEFAULT_DEVICE, resolve_device

from . import kernel as _kernel


def segsum(
    vals: np.ndarray,
    seg_ids: np.ndarray,
    num_segments: int,
    *,
    block_e: int = 256,
    block_n: int = 256,
    device=DEFAULT_DEVICE,
) -> torch.Tensor:
    """Segment sum over (unsorted OK) segment ids -> ``[num_segments, D]``.

    ``out[s] = sum of vals[i] over seg_ids[i] == s`` for ``vals [E, D]``
    float32 or float64 (any other dtype raises ``TypeError``); ids outside
    ``[0, num_segments)`` belong to no segment.  The host sorts the rows by
    id (:func:`~repro_torch.kernels.segsum.kernel.prepare_csr`); the kernel
    sums each segment's rows in that order and writes each output row once.
    ``block_e`` and ``block_n`` are the JAX package's edge-block and window
    sizes; the sorted layout has neither, so they are only checked.
    """
    if block_e <= 0 or block_n <= 0:
        raise ValueError("block_e and block_n must be positive")
    vals = np.asarray(vals)
    if vals.dtype not in (np.float32, np.float64):
        raise TypeError(f"segsum takes float32 or float64 values, not {vals.dtype}")
    if vals.ndim != 2:
        raise ValueError(f"segsum takes vals [E, D], got shape {vals.shape}")
    seg_ids = np.asarray(seg_ids)
    if seg_ids.shape != vals.shape[:1]:
        raise ValueError("seg_ids must be [E] for vals [E, D]")
    dev = resolve_device(device)
    order, row_ptr = _kernel.prepare_csr(seg_ids, num_segments)
    vals_s = torch.from_numpy(np.ascontiguousarray(vals[order])).to(dev)
    return _kernel.segsum_csr(vals_s, torch.from_numpy(row_ptr).to(dev))


def segor(
    bits: np.ndarray,
    seg_ids: np.ndarray,
    num_segments: int,
    *,
    block_e: int = 256,
    block_n: int = 256,
    device=DEFAULT_DEVICE,
) -> torch.Tensor:
    """Segmented OR of 0/1 ``bits [V, E]`` over destination ids, packed.

    Returns ``int32 [V, ceil(num_segments / 32)]`` words (the bits of the
    JAX package's ``uint32`` words) with trailing pad bits zero; ids must
    lie in ``[0, num_segments)``.  The host builds the blocked layout
    (:func:`~repro_torch.kernels.segsum.kernel.prepare_segor`) and packs
    the bits along the edge axis; the kernel gathers each edge's bit and
    ORs it into its destination's word.
    """
    bits = np.asarray(bits)
    if bits.ndim != 2:
        raise ValueError(f"segor takes bits [V, E], got shape {bits.shape}")
    seg_ids = np.asarray(seg_ids, np.int32)
    if seg_ids.shape != bits.shape[1:]:
        raise ValueError("seg_ids must be [E] for bits [V, E]")
    dev = resolve_device(device)
    idx_b, seg_b, win, _ = _kernel.prepare_segor(
        seg_ids, num_segments, block_e=block_e, block_n=block_n
    )
    frontier = bitops.to_words(bitops.pack_np(bits != 0), dev)
    return _kernel.segor_blocks(
        frontier,
        torch.from_numpy(idx_b).to(dev),
        torch.from_numpy(seg_b).to(dev),
        torch.from_numpy(win).to(dev),
        num_segments=num_segments,
        block_n=block_n,
        num_sources=bits.shape[1],
    )
