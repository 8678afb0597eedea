"""Plain PyTorch versions of the segmented OR and the segment sum.

* :func:`edge_bits` — per-edge source bits gathered out of packed frontier
  words (the ``_edge_bits`` gather of the edge engines).
* :func:`segor_words` — segmented OR over a flat edge list, packed: the
  lowering of the flat ``edge_src`` / ``edge_dst`` layout; its unpacked
  ``uint8`` lanes (:func:`segor_lanes`) and their packing
  (:func:`pack_lanes`).
* :func:`segor_blocks_ref` — the same function as the CUDA kernel
  (``csrc/segor.cu``) over the blocked layout of ``prepare_segor``: what
  the kernel's wrapper runs for a tensor on the CPU, and what the kernel is
  held against on the card.
* :func:`source_major_ref` — the source-major copy of a packed frontier
  that the segmented-OR kernel gathers from (the transposition kernel of
  ``csrc/segor.cu``).
* :func:`segsum_ref` — the segment sum by ``index_add_``, and
  :func:`segsum_csr_ref`, the same over the sorted layout of the CUDA
  segment-sum kernel (``csrc/segsum.cu``): what its wrapper runs for a
  tensor on the CPU.

Words are ``int32`` bit-views of the reference's ``uint32``; ``int32 >>``
is arithmetic, so every extracted bit is masked with ``& 1``.  Shifts are
the ``torch.bitwise_*_shift`` functions, which DTensors compute (their
``<<`` / ``>>`` operators return the input unshifted).
"""
from __future__ import annotations

import torch

from repro_torch.core import bitops


def edge_bits(frontier_p: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``int32 [V, *src.shape]``: bit ``src % 32`` of word ``src // 32``."""
    word = frontier_p[:, torch.bitwise_right_shift(src, 5)]
    return torch.bitwise_right_shift(word, src & 31) & 1


def segor_lanes(
    bits: torch.Tensor, seg_ids: torch.Tensor, num_segments: int,
    n_words: int | None = None,
) -> torch.Tensor:
    """Segmented OR of 0/1 ``bits [V, E]`` over ``seg_ids [E]``, unpacked:
    ``uint8 [nw, 32, V]``, lane ``l`` of word ``w`` the OR into row ``32 w +
    l``, ``nw = n_words`` (at least ``ceil(num_segments / 32)``, the
    default).  Ids ``>= num_segments`` (the pad rows of every edge layout)
    are dropped: their bits are zeroed onto row 0, which cannot change an
    OR; rows past ``num_segments`` stay zero, so packing the lanes leaves
    trailing pad bits and pad words zero."""
    v = bits.shape[0]
    nw = bitops.packed_width(num_segments) if n_words is None else n_words
    rows = seg_ids.to(torch.int64)
    keep = rows < num_segments
    vals = torch.where(keep[:, None], bits.T.to(torch.uint8), 0)
    y = torch.zeros((nw * bitops.WORD, v), dtype=torch.uint8, device=bits.device)
    y.scatter_reduce_(0, torch.where(keep, rows, 0)[:, None].expand(-1, v), vals,
                      reduce="amax")
    return y.view(nw, bitops.WORD, v)


def pack_lanes(lanes: torch.Tensor) -> torch.Tensor:
    """``uint8 [nw, 32, V]`` 0/1 lanes -> ``int32 [V, nw]`` words.

    Each 32-row group is shifted into its lanes and folded: lanes 0..30 are
    disjoint bits below 2**31, so their int32 sum is their OR; lane 31 (the
    sign bit) is ORed in on its own.
    """
    lanes = lanes.to(torch.int32)
    shifts = torch.arange(bitops.WORD - 1, dtype=torch.int32, device=lanes.device)
    low = torch.bitwise_left_shift(lanes[:, :-1], shifts[:, None]).sum(1, dtype=torch.int32)
    words = low | torch.bitwise_left_shift(lanes[:, -1], bitops.WORD - 1)  # [nw, V]
    return words.T.contiguous()


def segor_words(
    bits: torch.Tensor, seg_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Segmented OR of 0/1 ``bits [V, E]`` over ``seg_ids [E]``, packed.

    Returns ``int32 [V, ceil(num_segments / 32)]``; ids ``>= num_segments``
    (the pad rows of every edge layout) are dropped, and trailing pad bits
    stay zero.
    """
    return pack_lanes(segor_lanes(bits, seg_ids, num_segments))


def segor_blocks_ref(
    frontier_p: torch.Tensor,
    seg_src_b: torch.Tensor,
    seg_dst_b: torch.Tensor,
    seg_win: torch.Tensor,
    *,
    num_segments: int,
    block_n: int = 256,
) -> torch.Tensor:
    """Plain version of the fused gather + blocked segmented OR.

    Equals ``segor_blocks(_edge_bits(frontier, src_b).transpose(1, 2, 0),
    dst_b, win)`` of the JAX package bit for bit: an edge counts only if its
    destination lies below ``num_segments`` and inside its block's window.
    """
    if frontier_p.shape[1] == 0:  # no sources: every edge is a pad row
        frontier_p = frontier_p.new_zeros((frontier_p.shape[0], 1))
    be = seg_src_b.shape[1]
    src = seg_src_b.reshape(-1).to(torch.int64)
    dst = seg_dst_b.reshape(-1).to(torch.int64)
    lo = (seg_win.to(torch.int64) * block_n).repeat_interleave(be)
    live = (dst < num_segments) & (dst >= lo) & (dst < lo + block_n)
    src = torch.where(live, src, 0)
    dst = torch.where(live, dst, num_segments)
    return segor_words(edge_bits(frontier_p, src), dst, num_segments)


def source_major_ref(frontier_p: torch.Tensor, num_sources: int) -> torch.Tensor:
    """Source-major copy of a packed frontier: ``int32 [32 * nw, ceil(V / 32)]``.

    ``frontier_p`` is ``[V, nw]`` with ``nw = ceil(num_sources / 32)``; bit
    ``v % 32`` of row ``s``, word ``v // 32`` of the result is bit ``s % 32``
    of ``frontier_p[v, s // 32]``.  Unpack, transpose, pack: every bit of a
    variable past ``V`` or a source past ``num_sources`` is zero.  Applied
    to its own result with ``num_sources = V``, it gives ``frontier_p`` back
    in its first ``V`` rows, with the pad bits past ``num_sources`` cleared.
    """
    v, nw = frontier_p.shape
    rows = torch.zeros((nw * bitops.WORD, v), dtype=torch.bool,
                       device=frontier_p.device)
    rows[:num_sources] = bitops.unpack(frontier_p, num_sources).T
    return bitops.pack(rows)


def segsum_ref(
    vals: torch.Tensor, seg_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """``[num_segments, D]``: ``out[s] = sum of vals[i] over seg_ids[i] == s``.

    ``vals [E, D]`` float, ``seg_ids [E]`` integer ids in
    ``[0, num_segments)`` in any order.
    """
    out = torch.zeros(
        (num_segments, *vals.shape[1:]), dtype=vals.dtype, device=vals.device
    )
    return out.index_add_(0, seg_ids.to(torch.int64), vals)


def segsum_csr_ref(vals_s: torch.Tensor, row_ptr: torch.Tensor) -> torch.Tensor:
    """:func:`segsum_ref` over rows sorted by segment: segment ``s`` owns
    rows ``row_ptr[s]:row_ptr[s + 1]`` of ``vals_s``."""
    n = row_ptr.numel() - 1
    ids = torch.repeat_interleave(
        torch.arange(n, device=row_ptr.device), (row_ptr[1:] - row_ptr[:-1]).long()
    )
    return segsum_ref(vals_s, ids, n)
