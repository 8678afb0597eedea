"""Packed boolean products: the wrappers of the CUDA kernels.

:func:`bitmm_packed` wraps ``bitmm_packed`` and :func:`bitmm_apply` wraps
``bitmm_apply_packed``, both in ``csrc/bitmm.cu``; :func:`bitmm` is the
``packed`` engine's product on bool rows.  For tensors on the CPU a wrapper
runs the plain version (:mod:`repro_torch.kernels.bitmm.ref`); for CUDA
tensors it launches the kernel on the current stream, without
synchronising, or raises.  Adjacency is square: ``a_packed int32 [n, nw]``
with ``nw = ceil(n / 32)``.  :func:`geometry` picks the products' grid:
column tiles times contraction slices times variable groups, with enough
slices to put :data:`BLOCKS_PER_SM` blocks on every SM of the card.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core import bitops
from repro_torch.kernels import _build, count_launch

from . import ref as _ref

# dynamic shared memory one block may use on Hopper (227 KB)
SMEM_LIMIT = 232_448
# streaming multiprocessors of an H100 SXM, geometry's default; the
# wrappers pass the card's own count
SMS = 132
# The product's tiling, chosen on the card (PERF.md §6) and fixed in
# csrc/bitmm.cu: each lane holds WORDS_PER_LANE column words (a block's
# column tile is TILE words), WARPS consumer warps hold VARS_PER_WARP
# variables' accumulators each (a block's variable group is GROUP), and the
# contraction is split for BLOCKS_PER_SM blocks on every SM.
WORDS_PER_LANE = 4
TILE = 32 * WORDS_PER_LANE
WARPS = 8
VARS_PER_WARP = 8
GROUP = WARPS * VARS_PER_WARP
BLOCKS_PER_SM = 2
# the product's contraction words per block at most, which bounds its
# shared copy of the frontier words
MAX_SLICE_WORDS = 128
# the update's shared memory per variable: ~y over 32 column words
UPDATE_BYTES_PER_VAR = 32 * 4
# the largest V the products take (1,816)
MAX_VARS = SMEM_LIMIT // UPDATE_BYTES_PER_VAR


class Geometry(NamedTuple):
    """One launch's grid: ``col_tiles × slices × var_groups`` blocks; block
    ``(x, y, z)`` owns column words ``[x * TILE, (x + 1) * TILE)``,
    contraction words ``[y * slice_words, (y + 1) * slice_words)`` and
    variables ``[z * GROUP, (z + 1) * GROUP)``."""

    col_tiles: int
    slices: int
    slice_words: int
    var_groups: int

    @property
    def blocks(self) -> int:
        return self.col_tiles * self.slices * self.var_groups


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def geometry(n_vars: int, nw: int, sms: int = SMS) -> Geometry:
    """The grid of both products for ``V = n_vars`` over ``nw`` words
    (square adjacency: ``nw`` column and contraction words) on a card of
    ``sms`` SMs.

    The contraction is cut into equal slices: as many as give
    :data:`BLOCKS_PER_SM` blocks per SM (fewer where equal slices cannot
    reach that count exactly, never more: past a multiple of the SM count,
    a few more blocks would run as one more wave), at least as many as
    keep a slice within :data:`MAX_SLICE_WORDS`, never more than
    contraction words, and never an empty one.  Raises ``ValueError`` for
    a V whose update stage (``[V, 32]`` words of ~y) passes the shared
    memory a Hopper block may use: past :data:`MAX_VARS`.
    """
    update_smem = n_vars * UPDATE_BYTES_PER_VAR
    if update_smem > SMEM_LIMIT:
        raise ValueError(
            f"V={n_vars} needs {update_smem} bytes of shared memory per block, "
            f"past the {SMEM_LIMIT} a Hopper block may use"
        )
    col_tiles = _cdiv(nw, TILE)
    var_groups = _cdiv(n_vars, GROUP)
    want = _cdiv(BLOCKS_PER_SM * sms, max(1, col_tiles * var_groups))
    slices = max(1, min(nw, max(want, _cdiv(nw, MAX_SLICE_WORDS))))
    slice_words = max(1, _cdiv(nw, slices))
    return Geometry(col_tiles, _cdiv(nw, slice_words), slice_words, var_groups)


@functools.cache
def _sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


@functools.cache
def _launchers():
    lib = _build.load("bitmm")
    packed = lib.bitmm_packed_launch
    packed.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    packed.restype = ctypes.c_int
    apply = lib.bitmm_apply_launch
    apply.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    apply.restype = ctypes.c_int
    return packed, apply


def _check_adjacency(name: str, a_packed: torch.Tensor, device) -> int:
    if a_packed.dtype != torch.int32:
        raise TypeError(f"{name} takes int32 packed adjacency")
    if a_packed.device != device:
        raise ValueError(f"{name} operands must share one device")
    if not a_packed.is_contiguous():
        raise ValueError(f"{name} operands must be contiguous")
    if a_packed.dim() != 2 or a_packed.shape[1] != bitops.packed_width(
        a_packed.shape[0]
    ):
        raise ValueError(
            f"{name} needs square packed adjacency [n, ceil(n/32)], got "
            f"{tuple(a_packed.shape)}"
        )
    return a_packed.shape[0]


def _device(name: str, t: torch.Tensor) -> torch.device:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {t.device}")
    return t.device


def bitmm_packed(x: torch.Tensor, a_packed: torch.Tensor) -> torch.Tensor:
    """``int32 [V, nw]``: ``out[v, jw] = OR_{i: x[v, i]} a_packed[i, jw]``.

    ``x`` is the bool frontier ``[V, n]``.  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel, which reads the frontier as
    bytes.
    """
    dev = _device("bitmm_packed", x)
    n = _check_adjacency("bitmm_packed", a_packed, dev)
    if x.dtype != torch.bool:
        raise TypeError("bitmm_packed takes a bool frontier")
    if not x.is_contiguous():
        raise ValueError("bitmm_packed operands must be contiguous")
    if x.dim() != 2 or x.shape[1] != n:
        raise ValueError(f"frontier must be [V, {n}], got {tuple(x.shape)}")
    if dev.type == "cpu":
        return _ref.bitmm_packed_ref(x, a_packed)
    v, nw = x.shape[0], a_packed.shape[1]
    sms = _sms(dev)
    geo = geometry(v, nw, sms)
    out = torch.empty((v, nw), dtype=torch.int32, device=dev)  # zeroed in C
    if v == 0 or nw == 0:
        return out
    xw = torch.empty((v, nw), dtype=torch.int32, device=dev)
    fn, _ = _launchers()
    with torch.cuda.device(dev):
        err = fn(x.view(torch.uint8).data_ptr(), a_packed.data_ptr(),
                 xw.data_ptr(), out.data_ptr(), v, n, nw, geo.slice_words,
                 sms, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bitmm_packed launch failed: CUDA error {err}")
    count_launch("bitmm_packed")
    return out


def bitmm(x: torch.Tensor, a_packed: torch.Tensor) -> torch.Tensor:
    """The ``packed`` engine's product: bool ``[V, n]`` in, bool ``[V, n]``
    out, through :func:`bitmm_packed`."""
    return bitops.unpack(bitmm_packed(x, a_packed), x.shape[-1])


def bitmm_apply(
    chi_packed: torch.Tensor,  # int32 [V, nw] packed chi
    a_packed: torch.Tensor,  # int32 [n, nw] packed adjacency of one operator
    lhs_flags: torch.Tensor,  # int32 [V, V] 0/1 inequality flags
) -> tuple[torch.Tensor, torch.Tensor]:
    """One fused operator application on packed chi: ``(chi', changed)``.

    ``y = chi ×b A`` and ``chi'[l] = chi[l] & AND_{r: F[l, r]} y[r]``;
    ``changed`` is a 0-dim ``int32`` tensor on the operands' device, the OR
    of ``chi' ^ chi`` over every word (nonzero iff any word moved).  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel into
    a new ``chi'`` (the kernel reads ``chi`` as its frontier while it
    writes, so it never updates in place).
    """
    dev = _device("bitmm_apply", chi_packed)
    n = _check_adjacency("bitmm_apply", a_packed, dev)
    for t in (chi_packed, lhs_flags):
        if t.dtype != torch.int32:
            raise TypeError("bitmm_apply takes int32 chi words and flags")
        if t.device != dev:
            raise ValueError("bitmm_apply operands must share one device")
        if not t.is_contiguous():
            raise ValueError("bitmm_apply operands must be contiguous")
    v = chi_packed.shape[0]
    if chi_packed.dim() != 2 or chi_packed.shape[1] != a_packed.shape[1]:
        raise ValueError(
            f"chi must be [V, {a_packed.shape[1]}], got {tuple(chi_packed.shape)}"
        )
    if lhs_flags.shape != (v, v):
        raise ValueError(f"lhs_flags must be [{v}, {v}], got "
                         f"{tuple(lhs_flags.shape)}")
    if dev.type == "cpu":
        return _ref.bitmm_apply_ref(chi_packed, a_packed, lhs_flags)
    nw = a_packed.shape[1]
    sms = _sms(dev)
    geo = geometry(v, nw, sms)
    out = torch.empty_like(chi_packed)
    if v == 0 or nw == 0:
        return out, torch.zeros((), dtype=torch.int32, device=dev)
    # y [V, nw] for the product's atomicOr, then the changed word (both
    # zeroed by the launcher)
    scratch = torch.empty((v * nw + 1,), dtype=torch.int32, device=dev)
    changed = scratch[-1:]
    _, fn = _launchers()
    with torch.cuda.device(dev):
        err = fn(chi_packed.data_ptr(), a_packed.data_ptr(),
                 lhs_flags.data_ptr(), scratch.data_ptr(), out.data_ptr(),
                 changed.data_ptr(), v, n, nw, geo.slice_words, sms,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bitmm_apply_packed launch failed: CUDA error {err}")
    count_launch("bitmm_apply_packed")
    return out, changed.reshape(())
