"""The node mesh of the partitioned engine, and the MoE layer's group count.

:func:`node_mesh` builds the 1-D mesh the partitioned dual-simulation
engine splits chi's node axis over (DESIGN.md Sect. 7): block w of the
destination-partitioned edges, and block w's columns of chi, live on the
block's device.  The port runs one process that drives every device of
the mesh, as the JAX package's single controller does, so a mesh is a
tuple of ``torch.device`` and its axis name, and nothing of
``torch.distributed``.  On ``"cuda"`` it takes the first ``n`` visible
cards and raises if there are fewer; on ``"cpu"`` it is ``n`` simulated
shards on the host (:func:`force_host_device_count` sets how many by
default), which run the same sharded sweep on one device.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.device import DEFAULT_DEVICE, resolve_device

NODE_AXIS = "nodes"  # mesh axis name chi's node dimension shards over

_host_device_count = 1


def force_host_device_count(n: int) -> None:
    """Make ``node_mesh(device="cpu")`` simulate ``n`` host devices when it
    is not given a count."""
    global _host_device_count
    if n < 1:
        raise ValueError(f"need at least one host device, got {n}")
    _host_device_count = int(n)


@dataclasses.dataclass(frozen=True)
class NodeMesh:
    """A 1-D mesh: the devices, in mesh order, and the axis name."""

    devices: tuple[torch.device, ...]
    axis_name: str = NODE_AXIS

    @property
    def size(self) -> int:
        """Number of devices (shards) on the axis."""
        return len(self.devices)

    @property
    def device_type(self) -> str:
        """``"cuda"`` or ``"cpu"``."""
        return self.devices[0].type


def node_mesh(n_devices: int | None = None, *, device=DEFAULT_DEVICE) -> NodeMesh:
    """1-D mesh of ``n_devices`` devices for the partitioned fixpoint engine.

    On ``"cuda"`` (the default) the mesh is the first ``n_devices`` visible
    cards (all of them by default) and raises if there are fewer; there is
    no CPU fallback.  On ``"cpu"`` it is ``n_devices`` simulated shards of
    the host (default: :func:`force_host_device_count`'s count).  Edge
    blocks are placed block-major along the mesh so segment reductions
    stay device-local, and the only cross-shard traffic is the packed
    frontier copy (one ``n/8``-byte copy per device per sweep).
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        have = torch.cuda.device_count()
        n = have if n_devices is None else n_devices
        if n < 1 or have < n:
            raise RuntimeError(f"need {n} CUDA devices, have {have}")
        return NodeMesh(tuple(torch.device("cuda", i) for i in range(n)))
    n = _host_device_count if n_devices is None else n_devices
    if n < 1:
        raise ValueError(f"need at least one host device, got {n}")
    return NodeMesh((torch.device("cpu"),) * n)


def group_count(name: str, dim: int) -> int:
    """Number of shard groups the logical axis ``name`` would split ``dim``
    into under the active rules (1 outside a rule context).  Used by the MoE
    layer to block its dispatch into shard-local groups.

    The port has no logical-axis rule context yet (the JAX package's
    ``logical_axis_rules``), so every call is outside one and returns 1.
    """
    del name, dim
    return 1
