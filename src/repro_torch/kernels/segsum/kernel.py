"""Segmented OR and segment sum: host layouts and kernel wrappers.

:func:`prepare_segor` builds the blocked layout the edge engines carry
(byte-identical to the JAX package's, so patched operands keep their
shapes under churn); :func:`segor_blocks` is the wrapper of the CUDA kernel
in ``csrc/segor.cu``, which fuses the frontier-bit gather into the
segmented OR and emits packed ``int32`` words.  :func:`prepare_csr` sorts a
segment sum's rows by segment id and :func:`segsum_csr` wraps the CUDA
kernel in ``csrc/segsum.cu`` that sums each segment's rows.  For tensors on
the CPU a wrapper runs the plain version (:mod:`repro_torch.kernels.segsum.
ref`); for CUDA tensors it launches the kernel or raises.
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
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(frontier_p, seg_src_b, seg_dst_b, seg_win, num_sources, block_n):
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
        num_sources
    ):
        raise ValueError(
            f"frontier must be [V, {bitops.packed_width(num_sources)}], "
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
    num_sources: int | None = None,
) -> torch.Tensor:
    """Fused frontier gather + segmented OR -> packed ``int32 [V, nw]``.

    Computes the JAX package's ``segor_blocks(_edge_bits(frontier,
    src_b).transpose(1, 2, 0), dst_b, win)`` bit for bit.  The frontier
    holds ``num_sources`` bits per variable (default ``num_segments``: the
    edge engines' square node axis).  A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel on the current stream (no
    synchronisation) or raises.
    """
    n_src = num_segments if num_sources is None else num_sources
    _check(frontier_p, seg_src_b, seg_dst_b, seg_win, n_src, block_n)
    dev = frontier_p.device
    if dev.type == "cpu":
        return _ref.segor_blocks_ref(
            frontier_p, seg_src_b, seg_dst_b, seg_win,
            num_segments=num_segments, block_n=block_n,
        )
    if dev.type != "cuda":
        raise ValueError(f"segor_blocks runs on cuda or cpu, not {dev}")
    v = frontier_p.shape[0]
    nw = bitops.packed_width(num_segments)
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
            v, nw, g, be, num_segments, block_n, n_src, frontier_p.shape[1],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"segor_blocks launch failed: CUDA error {err}")
    count_launch("segor_blocks")
    return out


def prepare_csr(
    seg_ids: np.ndarray, num_segments: int
) -> tuple[np.ndarray, np.ndarray]:
    """Host layout of the segment sum: ``(order, row_ptr)``.

    ``order`` lists the rows whose id lies in ``[0, num_segments)``, sorted
    by id (stable: a segment's rows keep their input order); rows with any
    other id belong to no segment and are dropped (the JAX package's
    ``segsum`` drops ids past the last segment the same way).
    ``row_ptr [num_segments + 1]`` (int32) gives
    segment ``s`` the sorted rows ``row_ptr[s]:row_ptr[s + 1]``.
    """
    seg_ids = np.asarray(seg_ids)
    if seg_ids.ndim != 1:
        raise ValueError("seg_ids must be one-dimensional")
    keep = np.flatnonzero((seg_ids >= 0) & (seg_ids < num_segments))
    if len(keep) > np.iinfo(np.int32).max:
        raise ValueError("segsum takes fewer than 2**31 rows")
    order = keep[np.argsort(seg_ids[keep], kind="stable")]
    counts = np.bincount(seg_ids[keep], minlength=num_segments)
    row_ptr = np.zeros(num_segments + 1, np.int32)
    np.cumsum(counts, out=row_ptr[1:])
    return order, row_ptr


@functools.cache
def _segsum_launcher():
    fn = _build.load("segsum").segsum_csr_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


# columns per grid row of the kernel (csrc/segsum.cu kTileD), and the most
# grid rows CUDA allows
_SEGSUM_TILE_D, _MAX_GRID_Y = 128, 65_535


def segsum_csr(vals_s: torch.Tensor, row_ptr: torch.Tensor) -> torch.Tensor:
    """Segment sum over rows sorted by segment -> ``[N, D]``, ``N =
    row_ptr.numel() - 1``: row ``s`` sums ``vals_s[row_ptr[s]:row_ptr[s+1]]``
    in order.

    ``vals_s [E, D]`` f32 or f64 (any other dtype raises ``TypeError``),
    ``row_ptr`` int32, non-decreasing from 0 to ``E`` (as
    :func:`prepare_csr` builds it).  A CPU tensor takes the plain version
    (:func:`repro_torch.kernels.segsum.ref.segsum_csr_ref`); a CUDA tensor
    launches the kernel on the current stream (no synchronisation) or
    raises.
    """
    if vals_s.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"segsum takes float32 or float64 values, not {vals_s.dtype}")
    if row_ptr.dtype != torch.int32:
        raise TypeError("segsum takes int32 row pointers")
    if vals_s.dim() != 2 or row_ptr.dim() != 1 or row_ptr.numel() < 1:
        raise ValueError("segsum takes vals [E, D] and row_ptr [N + 1]")
    if row_ptr.device != vals_s.device:
        raise ValueError("segsum operands must share one device")
    if not (vals_s.is_contiguous() and row_ptr.is_contiguous()):
        raise ValueError("segsum operands must be contiguous")
    dev = vals_s.device
    if dev.type == "cpu":
        return _ref.segsum_csr_ref(vals_s, row_ptr)
    if dev.type != "cuda":
        raise ValueError(f"segsum runs on cuda or cpu, not {dev}")
    n, d = row_ptr.numel() - 1, vals_s.shape[1]
    if -(-d // _SEGSUM_TILE_D) > _MAX_GRID_Y:
        raise ValueError(f"segsum takes at most {_SEGSUM_TILE_D * _MAX_GRID_Y} columns")
    out = torch.empty((n, d), dtype=vals_s.dtype, device=dev)
    if n == 0 or d == 0:
        return out
    fn = _segsum_launcher()
    with torch.cuda.device(dev):
        err = fn(
            vals_s.data_ptr(), row_ptr.data_ptr(), out.data_ptr(), n, d,
            int(vals_s.dtype == torch.float64),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"segsum launch failed: CUDA error {err}")
    count_launch("segsum")
    return out
