"""Packed boolean products: the wrappers of the CUDA kernels.

:func:`bitmm_packed` wraps ``bitmm_packed`` and :func:`bitmm_apply` wraps
``bitmm_apply_packed``, both in ``csrc/bitmm.cu``; :func:`bitmm` is the
``packed`` engine's product on bool rows.  For tensors on the CPU a wrapper
runs the plain version (:mod:`repro_torch.kernels.bitmm.ref`); for CUDA
tensors it launches the kernel on the current stream, without
synchronising, or raises.  Adjacency is square: ``a_packed int32 [n, nw]``
with ``nw = ceil(n / 32)``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import bitops
from repro_torch.kernels import _build, count_launch

from . import ref as _ref

# dynamic shared memory one block may use on Hopper (227 KB)
SMEM_LIMIT = 232_448
MAX_WARPS = 16


@functools.cache
def _launchers():
    lib = _build.load("bitmm")
    packed = lib.bitmm_packed_launch
    packed.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    packed.restype = ctypes.c_int
    apply = lib.bitmm_apply_launch
    apply.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    apply.restype = ctypes.c_int
    return packed, apply


def warps_for(n_vars: int) -> int:
    """Warps per block for ``n_vars`` variables: as many as
    :data:`MAX_WARPS` while each warp's ``[V, 33]``-word slice fits the
    shared memory of a block; raises past the limit."""
    per_warp = n_vars * 33 * 4
    warps = min(MAX_WARPS, SMEM_LIMIT // max(per_warp, 1))
    if warps < 1:
        raise ValueError(
            f"V={n_vars} needs {per_warp} bytes of shared memory per block, "
            f"past the {SMEM_LIMIT} a Hopper block may use"
        )
    return warps


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
    warps = warps_for(v)
    out = torch.empty((v, nw), dtype=torch.int32, device=dev)
    if v == 0 or nw == 0:
        return out
    fn, _ = _launchers()
    with torch.cuda.device(dev):
        err = fn(x.view(torch.uint8).data_ptr(), a_packed.data_ptr(), out.data_ptr(),
                 v, n, nw, warps, torch.cuda.current_stream(dev).cuda_stream)
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
    warps = warps_for(v)
    out = torch.empty_like(chi_packed)
    changed = torch.zeros((1,), dtype=torch.int32, device=dev)
    if v == 0 or nw == 0:
        return out, changed.reshape(())
    _, fn = _launchers()
    with torch.cuda.device(dev):
        err = fn(chi_packed.data_ptr(), a_packed.data_ptr(),
                 lhs_flags.data_ptr(), out.data_ptr(), changed.data_ptr(),
                 v, n, nw, warps, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bitmm_apply_packed launch failed: CUDA error {err}")
    count_launch("bitmm_apply_packed")
    return out, changed.reshape(())
