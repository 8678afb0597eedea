"""Segmented OR over destination-blocked edges: host layout and kernel wrapper.

:func:`prepare_segor` builds the blocked layout the edge engines carry
(byte-identical to the JAX package's, so patched operands keep their
shapes under churn); :func:`segor_blocks` is the wrapper of the CUDA kernel
in ``csrc/segor.cu``, which fuses the frontier-bit gather into the
segmented OR and emits packed ``int32`` words.  For a tensor on the CPU the
wrapper runs the plain version (:func:`repro_torch.kernels.segsum.ref.
segor_blocks_ref`); for a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core import bitops
from repro_torch.kernels import _build, count_launch

from . import ref as _ref

# Edge-block counts are rounded up to this multiple so modest edge churn
# under ``patch_operands`` lands in existing pad blocks instead of changing
# the blocked-layout shapes (DESIGN.md Sect. 12).
SEG_G_PAD = 8
# dynamic shared memory one block may use on Hopper (227 KB)
SMEM_LIMIT = 232_448


def prepare_segor(
    seg_ids: np.ndarray, num_segments: int,
    block_e: int = 256, block_n: int = 256, min_g: int = 0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Host-side blocked layout for the segmented OR.

    Sorts edges by destination id, splits them into blocks of ``block_e``
    that each touch one destination window of ``block_n`` ids, and returns
    ``(idx_b, seg_b, win, n_pad)``: ``idx_b [G, BE]`` int32 gather indices
    into the original edge axis, ``seg_b [G, BE]`` absolute destination
    ids, ``win [G]`` the window each block writes, and the padded node
    count ``n_pad``.  Every window gets at least one block (an all-pad one
    where no edge lands), and ``G`` rounds up to ``SEG_G_PAD`` with trailing
    pad blocks on the last window.

    Pad entries carry gather index 0 and the sentinel id ``n_pad``, which
    lies outside every window and is ``>= num_segments``, so a pad row can
    never turn on a bit.  Callers pass RAW destination ids
    (``0 <= id < num_segments``): an EDGE_PAD-style pad id of ``n`` would
    alias bit ``n`` whenever ``n`` falls inside a live window.

    The layout equals the JAX package's ``prepare_segor`` byte for byte; it
    is computed with array operations instead of a loop over edges.
    """
    if block_n % 32:
        raise ValueError("block_n must be a multiple of 32")
    seg_ids = np.asarray(seg_ids, np.int32)
    e = len(seg_ids)
    order = np.argsort(seg_ids, kind="stable").astype(np.int32)
    seg_s = seg_ids[order]
    if e and int(seg_s[-1]) >= num_segments:
        raise ValueError(
            "seg_ids must be < num_segments (pass raw, unpadded edges)"
        )
    if e and int(seg_s[0]) < 0:
        raise ValueError("seg_ids must be >= 0")
    n_pad = max(-(-num_segments // block_n), 1) * block_n
    n_win = n_pad // block_n
    w_of = seg_s.astype(np.int64) // block_n  # window of each sorted edge
    counts = np.bincount(w_of, minlength=n_win)
    per_win = np.maximum(-(-counts // block_e), 1)  # blocks per window
    first_block = np.cumsum(per_win) - per_win
    first_edge = np.cumsum(counts) - counts
    pos = np.arange(e) - first_edge[w_of]  # rank inside its window
    blk = first_block[w_of] + pos // block_e
    slot = pos % block_e
    total = int(per_win.sum())
    g = -(-max(total, min_g, 1) // SEG_G_PAD) * SEG_G_PAD
    idx_b = np.zeros((g, block_e), np.int32)
    seg_b = np.full((g, block_e), n_pad, np.int32)
    idx_b[blk, slot] = order
    seg_b[blk, slot] = seg_s
    win = np.full(g, n_win - 1, np.int32)  # trailing pad blocks: last window
    win[:total] = np.repeat(np.arange(n_win, dtype=np.int32), per_win)
    return idx_b, seg_b, win, n_pad


@functools.cache
def _launcher():
    fn = _build.load("segor").segor_blocks_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(frontier_p, seg_src_b, seg_dst_b, seg_win, num_segments, block_n):
    tensors = (frontier_p, seg_src_b, seg_dst_b, seg_win)
    if any(t.dtype != torch.int32 for t in tensors):
        raise TypeError("segor_blocks takes int32 tensors")
    if any(t.device != frontier_p.device for t in tensors):
        raise ValueError("segor_blocks operands must share one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("segor_blocks operands must be contiguous")
    if block_n <= 0 or block_n % 32:
        raise ValueError("block_n must be a positive multiple of 32")
    if frontier_p.dim() != 2 or frontier_p.shape[1] != bitops.packed_width(
        num_segments
    ):
        raise ValueError(
            f"frontier must be [V, {bitops.packed_width(num_segments)}], "
            f"got {tuple(frontier_p.shape)}"
        )
    if seg_src_b.dim() != 2 or seg_src_b.shape != seg_dst_b.shape:
        raise ValueError("seg_src_b and seg_dst_b must both be [G, BE]")
    if seg_win.shape != seg_src_b.shape[:1]:
        raise ValueError("seg_win must be [G]")


def segor_blocks(
    frontier_p: torch.Tensor,  # int32 [V, nw] packed source frontier
    seg_src_b: torch.Tensor,  # int32 [G, BE] source ids (pads gather 0)
    seg_dst_b: torch.Tensor,  # int32 [G, BE] absolute dst ids (pads = n_pad)
    seg_win: torch.Tensor,  # int32 [G] destination window per block
    *,
    num_segments: int,
    block_n: int = 256,
) -> torch.Tensor:
    """Fused frontier gather + segmented OR -> packed ``int32 [V, nw]``.

    Computes the JAX package's ``segor_blocks(_edge_bits(frontier,
    src_b).transpose(1, 2, 0), dst_b, win)`` bit for bit.  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel on the
    current stream (no synchronisation) or raises.
    """
    _check(frontier_p, seg_src_b, seg_dst_b, seg_win, num_segments, block_n)
    dev = frontier_p.device
    if dev.type == "cpu":
        return _ref.segor_blocks_ref(
            frontier_p, seg_src_b, seg_dst_b, seg_win,
            num_segments=num_segments, block_n=block_n,
        )
    if dev.type != "cuda":
        raise ValueError(f"segor_blocks runs on cuda or cpu, not {dev}")
    v, nw = frontier_p.shape
    g, be = seg_src_b.shape
    smem = v * (block_n // 32) * 4
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"V={v} needs {smem} bytes of shared memory per block, past the "
            f"{SMEM_LIMIT} a Hopper block may use"
        )
    out = torch.zeros((v, nw), dtype=torch.int32, device=dev)
    if v == 0 or g == 0:
        return out
    fn = _launcher()
    with torch.cuda.device(dev):
        err = fn(
            frontier_p.data_ptr(), seg_src_b.data_ptr(), seg_dst_b.data_ptr(),
            seg_win.data_ptr(), out.data_ptr(),
            v, nw, g, be, num_segments, block_n,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"segor_blocks launch failed: CUDA error {err}")
    count_launch("segor_blocks")
    return out
