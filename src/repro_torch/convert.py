"""Carry state across from the JAX package, handed over as numpy arrays.

The reference has no weights: its state is the graph and the device
operands built from it.  These two functions rebuild that state in the
port from plain arrays, so a test can feed identical inputs to both
packages.  Nothing here imports the JAX package; the caller converts its
objects to numpy first.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.core.dualsim import Operands
from repro_torch.core.graph import Graph


def graph_from_arrays(
    triples: np.ndarray, node_names: list[str], label_names: list[str]
) -> Graph:
    """A port :class:`Graph` over ``(E, 3)`` int id triples and the name
    dictionaries they index (ids are positions in the lists)."""
    return Graph(
        n_nodes=len(node_names),
        n_labels=len(label_names),
        triples=np.asarray(triples, np.int32).reshape(-1, 3).copy(),
        node_names=list(node_names),
        label_names=list(label_names),
    )


def _tensor(x: np.ndarray, device) -> torch.Tensor:
    x = np.ascontiguousarray(x)
    if x.dtype == np.uint32:
        x = x.view(np.int32)  # the packed words' bit pattern, unchanged
    elif x.dtype != np.bool_:
        x = x.astype(np.int32)
    return torch.from_numpy(x.copy()).to(device)


_FLAT = ("edge_src", "edge_dst")
_BLOCKED = ("seg_src_b", "seg_dst_b", "seg_win")


def operands_from_numpy(fields: dict, *, device=DEFAULT_DEVICE) -> Operands:
    """The port's :class:`Operands` from a reference ``Operands``' arrays.

    ``fields`` maps field names to numpy arrays, or to tuples of them for
    the per-operator fields; ``uint32`` words become their ``int32`` view,
    bool stays bool and every index array becomes ``int32``: dense
    adjacency ``adj_dense`` stays bool ``[M, n, n]``, packed adjacency
    ``adj_packed`` (``uint32 [M, n, nw]``) becomes its ``int32`` view.  The
    port's operands hold one adjacency layout: given one, it is taken as it
    is (a card refuses the flat lists); given both edge layouts, as the
    reference carries them, the device's own is taken, as
    ``make_sparse_operands`` builds it — the blocked layout on a card, the
    flat lists on the CPU.  The partitioned layout's ``[W, Eb]`` blocks
    (``edge_src_b`` / ``edge_dst_b``) are the CPU's, as the flat lists
    are.  A field the port's ``Operands`` does not have must be ``None``.
    """
    device = resolve_device(device)
    known = {f.name for f in dataclasses.fields(Operands)}
    given = {name for name, value in fields.items() if value is not None}
    dropped = ()
    if given & set(_FLAT) and given & set(_BLOCKED):
        dropped = _FLAT if device.type == "cuda" else _BLOCKED
    kw = {}
    for name, value in fields.items():
        if value is None or name in dropped:
            continue
        if name not in known:
            raise ValueError(f"the port's Operands has no field {name!r}")
        if isinstance(value, tuple):
            kw[name] = tuple(_tensor(np.asarray(v), device) for v in value)
        else:
            kw[name] = _tensor(np.asarray(value), device)
    return Operands(**kw)
