"""Carry state across from the JAX package, handed over as numpy arrays.

The query path's state is the graph and the device operands built from
it; the LM's, the GNN's and the recsys model's are their parameters and
AdamW state.  These
functions rebuild that state in the port from plain arrays, so a test can
feed identical inputs to both packages (JAX's PRNG cannot be reproduced in
torch, so every model parity test starts both packages from the same
converted parameters).  Nothing here imports the JAX package; the caller converts
its objects to numpy first.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.core.dualsim import Operands
from repro_torch.core.graph import Graph
from repro_torch.models import gnn, recsys
from repro_torch.models import transformer as tr


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


def _walk(node, parts: list[str], name: str):
    for part in parts:
        try:
            node = node[int(part)] if isinstance(node, (list, tuple)) else node[part]
        except (KeyError, IndexError):
            raise ValueError(f"the JAX package's tree has no leaf for {name!r}") from None
    return node


def _leaf(tree: dict, name: str) -> np.ndarray:
    """The JAX package's array for a port LM parameter name:
    ``layers.<i>.a.b`` is row ``i`` of the stacked ``tree["layers"]["a"]["b"]``
    (``a`` is ``moe`` for an MoE layer's router and experts)."""
    parts = name.split(".")
    if parts[0] != "layers":
        return np.asarray(_walk(tree, parts, name))
    return np.asarray(_walk(tree["layers"], parts[2:], name))[int(parts[1])]


def _copy_leaves(model: torch.nn.Module, leaf) -> None:
    """Copy ``leaf(name)``, a numpy array, into each parameter of ``model``."""
    for name, p in model.named_parameters():
        arr = leaf(name)
        if arr.shape != tuple(p.shape):
            raise ValueError(f"{name}: shape {arr.shape}, the port has {tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(arr, np.float32)))


@torch.no_grad()
def lm_params_from_numpy(tree: dict, cfg: tr.LMConfig, *, device=DEFAULT_DEVICE) -> tr.LM:
    """The port's :class:`~repro_torch.models.transformer.LM` from the JAX
    package's parameter tree (``init_params``' nested dict, layers stacked
    on a leading ``[L, ...]`` axis), as numpy arrays; each layer becomes
    one module of the ``ModuleList``, its ``moe`` leaves (router and
    expert stacks) included."""
    model = tr.LM(cfg, resolve_device(device))
    _copy_leaves(model, lambda name: _leaf(tree, name))
    return model


@torch.no_grad()
def gnn_params_from_numpy(tree: dict, cfg: gnn.GNNConfig, *,
                          device=DEFAULT_DEVICE) -> torch.nn.Module:
    """The port's GNN module for ``cfg.arch`` from the JAX package's
    parameter tree (``gnn.init_params``' nested dict, one dict per layer
    in the ``layers`` list), as numpy arrays: parameter ``layers.<i>.a.b``
    is ``tree["layers"][i]["a"]["b"]``."""
    model = gnn.MODULES[cfg.arch](cfg, resolve_device(device))
    _copy_leaves(model, lambda name: np.asarray(_walk(tree, name.split("."), name)))
    return model


@torch.no_grad()
def recsys_params_from_numpy(tree: dict, cfg: recsys.RecsysConfig, *,
                             device=DEFAULT_DEVICE) -> recsys.Recsys:
    """The port's :class:`~repro_torch.models.recsys.Recsys` from the JAX
    package's parameter tree (``recsys.init_params``' nested dict: the
    table, one dict per cross and MLP layer in lists, the head), as numpy
    arrays: parameter ``cross.<i>.w`` is ``tree["cross"][i]["w"]``."""
    model = recsys.Recsys(cfg, resolve_device(device))
    _copy_leaves(model, lambda name: np.asarray(_walk(tree, name.split("."), name)))
    return model


def adamw_state_from_numpy(state: dict, model: tr.LM) -> dict:
    """The port's AdamW state (moments in ``model.parameters()`` order, on
    the model's device) from the JAX package's ``{"mu", "nu", "step"}`` of
    an LM, dense or MoE."""
    names = [name for name, _ in model.named_parameters()]
    device = next(model.parameters()).device
    moments = {
        key: [torch.from_numpy(np.asarray(_leaf(state[key], n), np.float32).copy()).to(device)
              for n in names]
        for key in ("mu", "nu")
    }
    step = torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32, device=device)
    return {**moments, "step": step}
