"""Production mesh construction.

``make_production_mesh`` is a function (never a module-level constant) so
importing this module touches no process group.  The single-pod mesh is
16x16 = 256 devices (data, model); the multi-pod mesh adds a leading pod
axis: 2 x 16 x 16 = 512 devices (pod, data, model).

A :class:`~torch.distributed.device_mesh.DeviceMesh` needs a default
process group of the mesh's size.  Where no real world of that size
exists, the production mesh is built over the ``fake`` process group
(``torch.testing._internal.distributed.fake_pg``): one process plays rank
0 of the world, its collectives move nothing, and DTensor programs trace
on it with fake tensors — the dry-run's setting.  ``make_host_mesh`` is
the degenerate 1x1 mesh over one real device: a world-size-1 group (NCCL
on a card, gloo on the CPU) rendezvoused through an in-process
``HashStore``, so nothing touches the network.  The process holds one
default group at a time: each of these replaces a default group of
another backend or size, and :func:`release` destroys it.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.core.device import DEFAULT_DEVICE, resolve_device


def _world(backend: str, size: int, store) -> None:
    """Make the default process group ``backend`` over ``size`` ranks, this
    process rank 0 (kept if it already is)."""
    if dist.is_initialized():
        if dist.get_backend() == backend and dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    dist.init_process_group(backend, store=store, rank=0, world_size=size)


def release() -> None:
    """Destroy the default process group, if any (with every mesh over it)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def make_fake_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> DeviceMesh:
    """A ``shape`` mesh named ``axes`` over the fake process group: this
    process is rank 0 of ``prod(shape)``, and no collective moves data."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    _world("fake", math.prod(shape), FakeStore())
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    if (dist.is_initialized() and dist.get_backend() != "fake"
            and dist.get_world_size() == n):
        return init_device_mesh("cuda", shape, mesh_dim_names=axes)
    return make_fake_mesh(shape, axes)


def make_host_mesh(device=DEFAULT_DEVICE) -> DeviceMesh:
    """Degenerate 1x1 (data, model) mesh over one real device: the card
    (NCCL) by default, the CPU (gloo) with ``device="cpu"``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    _world("nccl" if dev.type == "cuda" else "gloo", 1, dist.HashStore())
    return init_device_mesh(dev.type, (1, 1), mesh_dim_names=("data", "model"))
