"""Bit-packing utilities for boolean node-set vectors (torch).

The paper (Sect. 3.2) stores node sets as bit-vectors and adjacency as bit
matrices.  Packed words are ``torch.int32`` tensors holding the exact bit
pattern of the JAX package's ``uint32`` words: bit ``i`` of word ``w`` is
element ``32*w + i``.  ``int32`` is used because PyTorch's CPU ``uint32``
lacks ``~``, ``>>``, ``<<``, ``index_put`` and ``scatter_reduce``.  ``>>`` on
``int32`` is arithmetic, so every bit extraction masks with ``& 1``.  Shifts
go through ``torch.bitwise_left_shift`` / ``bitwise_right_shift``: on a
DTensor (the sharded sweeps) the ``<<`` and ``>>`` operators return their
input unshifted (torch 2.13).

Host-side helpers (``pack_np`` / ``unpack_np`` / ``ones_mask``) keep the
reference's numpy ``uint32`` layout; :func:`to_words` moves such an array
onto a device as the ``int32`` view.

Pad-bit rule (DESIGN.md Sect. 9): the trailing bits of the last word past
``n`` are zero by construction and every operation keeps them zero.
"""
from __future__ import annotations

import numpy as np
import torch

WORD = 32


def packed_width(n: int) -> int:
    """Number of 32-bit words needed to hold ``n`` bits."""
    return (n + WORD - 1) // WORD


def pack(bits: torch.Tensor) -> torch.Tensor:
    """Pack a 0/1 (or bool) tensor along the last axis into ``int32`` words.

    ``bits[..., n] -> packed[..., ceil(n/32)]``; little-endian within the
    word.  Lanes 0..30 are disjoint bits below ``2**31``, so their ``int32``
    sum is their OR and cannot overflow; lane 31 is ORed in on its own
    (``1 << 31`` is ``INT_MIN``, the sign bit).
    """
    n = bits.shape[-1]
    w = packed_width(n)
    b = bits.to(torch.int32)
    pad = w * WORD - n
    if pad:
        b = torch.nn.functional.pad(b, (0, pad))
    b = b.reshape(bits.shape[:-1] + (w, WORD))
    shifts = torch.arange(WORD - 1, dtype=torch.int32, device=bits.device)
    low = torch.bitwise_left_shift(b[..., : WORD - 1], shifts).sum(-1, dtype=torch.int32)
    return low | torch.bitwise_left_shift(b[..., WORD - 1], WORD - 1)


def unpack(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack`: ``packed[..., w] -> bool[..., n]``.

    Unpacks the words' bytes, so every intermediate is one byte an
    element.  Assumes a little-endian device (byte k of a word holds bits
    ``8k..8k+7``), as :func:`pack_np` assumes of the host.
    """
    if packed.dtype != torch.int32:
        raise ValueError(f"packed words are int32, not {packed.dtype}")
    b = packed.contiguous().view(torch.uint8)  # [..., 4 w]
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = torch.bitwise_right_shift(b[..., None], shifts) & 1
    bits = bits.reshape(packed.shape[:-1] + (packed.shape[-1] * WORD,))
    return bits[..., :n].to(torch.bool)


def pack_np(bits: np.ndarray) -> np.ndarray:
    """Host-side :func:`pack`: numpy in, ``uint32`` words out, same layout.

    Assumes a little-endian host (the ``uint8 -> uint32`` view identifies
    byte k with bits ``8k..8k+7``).
    """
    bits = np.asarray(bits, dtype=bool)
    packed8 = np.packbits(bits, axis=-1, bitorder="little")
    pad = (-packed8.shape[-1]) % 4
    if pad:
        packed8 = np.concatenate(
            [packed8, np.zeros(packed8.shape[:-1] + (pad,), np.uint8)], axis=-1
        )
    return np.ascontiguousarray(packed8).view(np.uint32)


def unpack_np(packed: np.ndarray, n: int) -> np.ndarray:
    """Host-side :func:`unpack`: inverse of :func:`pack_np` (accepts the
    ``uint32`` words or their ``int32`` view)."""
    packed = np.ascontiguousarray(packed)
    if packed.dtype == np.int32:
        packed = packed.view(np.uint32)
    packed8 = np.asarray(packed, np.uint32).view(np.uint8)
    bits = np.unpackbits(packed8, axis=-1, bitorder="little")
    return bits[..., :n].astype(bool)


def to_words(packed: np.ndarray, device) -> torch.Tensor:
    """Host ``uint32`` words -> the device ``int32`` view (same bits)."""
    arr = np.ascontiguousarray(np.asarray(packed, np.uint32)).view(np.int32)
    return torch.from_numpy(arr.copy()).to(device)


def words_np(packed: torch.Tensor) -> np.ndarray:
    """Device ``int32`` words -> host ``uint32`` words (same bits)."""
    return packed.cpu().numpy().view(np.uint32)


def popcount(packed: torch.Tensor) -> torch.Tensor:
    """Total number of set bits over the last axis (int64)."""
    x = packed.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = (x * 0x01010101) & 0xFFFFFFFF
    return (x >> 24).sum(-1)


def any_set(packed: torch.Tensor) -> torch.Tensor:
    """Whether any bit is set along the last axis."""
    return (packed != 0).any(-1)


def ones_mask(n: int) -> np.ndarray:
    """Packed all-ones vector of logical length ``n`` (trailing bits zero)."""
    w = packed_width(n)
    out = np.full((w,), np.uint32(0xFFFFFFFF), dtype=np.uint32)
    rem = n % WORD
    if rem:
        out[-1] = np.uint32((1 << rem) - 1)
    return out


def leq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Bit-set inclusion a <= b (as sets), reduced over the last axis."""
    return ~any_set(torch.bitwise_and(a, torch.bitwise_not(b)))
