"""Plain PyTorch versions of the segmented OR and the segment sum.

* :func:`edge_bits` — per-edge source bits gathered out of packed frontier
  words (the ``_edge_bits`` gather of the edge engines).
* :func:`segor_words` — segmented OR over a flat edge list, packed: the
  lowering of the flat ``edge_src`` / ``edge_dst`` layout.
* :func:`segor_blocks_ref` — the same function as the CUDA kernel
  (``csrc/segor.cu``) over the blocked layout of ``prepare_segor``: what
  the kernel's wrapper runs for a tensor on the CPU, and what the kernel is
  held against on the card.
* :func:`segsum_ref` — the segment sum by ``index_add_``, and
  :func:`segsum_csr_ref`, the same over the sorted layout of the CUDA
  segment-sum kernel (``csrc/segsum.cu``): what its wrapper runs for a
  tensor on the CPU.

Words are ``int32`` bit-views of the reference's ``uint32``; ``int32 >>``
is arithmetic, so every extracted bit is masked with ``& 1``.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitops


def edge_bits(frontier_p: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``int32 [V, *src.shape]``: bit ``src % 32`` of word ``src // 32``."""
    word = frontier_p[:, src >> 5]
    return (word >> (src & 31)) & 1


def segor_words(
    bits: torch.Tensor, seg_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Segmented OR of 0/1 ``bits [V, E]`` over ``seg_ids [E]``, packed.

    Returns ``int32 [V, ceil(num_segments / 32)]``; ids ``>= num_segments``
    (the pad rows of every edge layout) are dropped, and trailing pad bits
    stay zero.
    """
    v = bits.shape[0]
    nw = bitops.packed_width(num_segments)
    n_pad = nw * bitops.WORD  # rows past num_segments stay zero: pad bits
    rows = seg_ids.to(torch.int64)
    rows = torch.where(rows < num_segments, rows, n_pad)  # dropped row
    y = torch.zeros((n_pad + 1, v), dtype=torch.int32, device=bits.device)
    y.scatter_reduce_(
        0, rows[:, None].expand(-1, v), bits.T.to(torch.int32), reduce="amax"
    )
    # shift each 32-row group into its lanes and fold: lanes 0..30 are
    # disjoint bits below 2**31, so their int32 sum is their OR; lane 31
    # (the sign bit) is ORed in on its own
    lanes = y[:n_pad].view(nw, bitops.WORD, v)
    shifts = torch.arange(bitops.WORD - 1, dtype=torch.int32, device=y.device)
    low = (lanes[:, :-1] << shifts[:, None]).sum(1, dtype=torch.int32)
    words = low | (lanes[:, -1] << (bitops.WORD - 1))  # [nw, V]
    return words.T.contiguous()


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
