"""Sharding rule tables: parameter/input PartitionSpecs per model family,
and their translation into DTensor placements.

Strategy (DESIGN.md Sect. 4), the JAX package's:

* LMs — FSDP over ``data`` (params' d_model-ish dim) x TP over ``model``
  (heads / ffn columns / vocab); MoE experts over ``model`` when the expert
  count divides (EP), else expert-internal d_ff over ``model`` (TP).
  Batch over ``(pod, data)``.
* GNNs — edge arrays fully sharded over ``(pod, data, model)``; node arrays
  sharded over ``(data, model)``.
* RecSys — the embedding table row-sharded over ``(data, model)`` (it IS
  the memory); dense trunk replicated but for the MLP's columns, batch
  over ``(pod, data)``.

Every spec passes through :func:`safe_spec`, which drops mesh axes that do
not divide the dimension — so one rule table serves every (config x mesh)
combination without divisibility crashes.

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` with named
dimensions, or, where only its sizes matter, a mapping of axis name to
size.  The port keeps each LM layer's parameters apart
(``layers.3.attn.wq``) where the JAX package stacks them on a leading
``[L, ...]`` axis, so its LM rules match per-layer names and drop that
axis's leading ``None``.
"""
from __future__ import annotations

import dataclasses
import math
import re
from collections.abc import Mapping
from typing import Any, Callable

import torch
from torch import nn


class PartitionSpec(tuple):
    """One entry per tensor dimension: ``None`` (replicated), a mesh axis
    name, or a tuple of axis names (major to minor).  Trailing dimensions
    without an entry are replicated."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_shape(mesh) -> dict[str, int]:
    """Axis name -> size, in mesh order."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    shape = mesh_shape(mesh)
    if isinstance(axes, str):
        return shape[axes]
    return math.prod(shape[a] for a in axes)


def safe_spec(shape: tuple[int, ...], spec: P, mesh) -> P:
    """Drop axes that don't divide their dimension (replicate instead)."""
    out = []
    for i, dim in enumerate(shape):
        axes = spec[i] if i < len(spec) else None
        if axes is None:
            out.append(None)
            continue
        if dim % axis_size(mesh, axes) == 0 and dim > 0:
            out.append(axes)
        else:
            # try a prefix of the axis tuple before giving up
            if isinstance(axes, tuple):
                kept = None
                for j in range(len(axes) - 1, 0, -1):
                    if dim % axis_size(mesh, axes[:j]) == 0:
                        kept = axes[:j]
                        break
                out.append(kept)
            else:
                out.append(None)
    return P(*out)


def to_placements(spec: P, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dimension: a
    mesh axis named at tensor dim ``i`` gives ``Shard(i)``; an axis named
    nowhere ``Replicate()``.  A tuple of axes on one dim shards it over each,
    major to minor, which DTensor does in mesh-dimension order, so the
    tuple must list its axes in mesh order."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for i, axes in enumerate(spec):
        if axes is None:
            continue
        group = (axes,) if isinstance(axes, str) else tuple(axes)
        where = [names.index(a) for a in group]
        if where != sorted(where):
            raise NotImplementedError(
                f"{spec}: axes {group} of dim {i} are not in mesh order {names}")
        for k in where:
            if out[k] != Replicate():
                raise ValueError(f"{spec}: mesh axis {names[k]!r} named twice")
            out[k] = Shard(i)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, as ``jax.sharding.NamedSharding``."""

    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return to_placements(self.spec, self.mesh)

    def shard_shape(self, shape: tuple[int, ...]) -> tuple[int, ...]:
        """The shape of one device's shard of a ``shape`` tensor (every
        named axis divides its dimension: see :func:`safe_spec`)."""
        out = list(shape)
        for i, axes in enumerate(self.spec):
            n = axis_size(self.mesh, axes)
            if out[i] % n:
                raise ValueError(f"{self.spec} does not divide {tuple(shape)}")
            out[i] //= n
        return tuple(out)


def named(mesh, shape: tuple[int, ...], spec: P) -> NamedSharding:
    """``NamedSharding(mesh, safe_spec(shape, spec, mesh))``."""
    return NamedSharding(mesh, safe_spec(tuple(shape), spec, mesh))


# --------------------------------------------------------------------- #
# trees: nested dicts, lists and tuples; a module stands for the dict of
# its named parameters
# --------------------------------------------------------------------- #
def _children(tree) -> list[tuple[str, Any]] | None:
    if isinstance(tree, nn.Module):
        return list(tree.named_parameters())
    if isinstance(tree, Mapping):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, PartitionSpec):
        return [(str(i), x) for i, x in enumerate(tree)]
    if (dataclasses.is_dataclass(tree) and not isinstance(tree, type)
            and not isinstance(tree, NamedSharding)):
        return [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)
                if getattr(tree, f.name) is not None]
    return None


def leaves_with_path(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``(path, leaf)`` pairs, the path ``/``-joined (a module's parameter
    names are one component each: ``params/layers.0.attn.wq``)."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for k, v in kids:
        out += leaves_with_path(v, f"{prefix}/{k}" if prefix else k)
    return out


def map_with_path(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``: lists and
    tuples are rebuilt, a dict, a module (its parameters) or a dataclass
    (its fields that are set) becomes a dict."""
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    vals = {k: map_with_path(fn, v, f"{prefix}/{k}" if prefix else k) for k, v in kids}
    if isinstance(tree, (list, tuple)):
        return type(tree)(vals[str(i)] for i in range(len(tree)))
    return vals


def shard_by_rules(tree: Any, mesh, rules: list[tuple[str, P]]) -> Any:
    """Tree of NamedShardings: first rule whose regex matches the leaf path."""

    def one(path, leaf):
        shape = tuple(leaf.shape)
        for pat, spec in rules:
            if re.search(pat, path):
                return named(mesh, shape, spec)
        return NamedSharding(mesh, P())

    return map_with_path(one, tree)


def data_axes(mesh) -> tuple[str, ...]:
    """All batch-parallel axes present in the mesh (pod first)."""
    shape = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in shape)


def batch_spec(mesh, batch: int) -> P:
    """Shard the batch dim over (pod, data) with divisibility fallback.
    An axis of one device is left out: it splits nothing, and DTensor
    refuses to reshape a dim sharded over it (a batch-1 ``[1, S, d]``
    hidden state flattened for a product)."""
    axes = tuple(a for a in data_axes(mesh) if mesh_shape(mesh)[a] > 1)
    while axes and batch % axis_size(mesh, axes) != 0:
        axes = axes[1:]
    return P(axes if axes else None)


def all_axes(mesh) -> tuple[str, ...]:
    return tuple(mesh_shape(mesh))


# --------------------------------------------------------------------- #
# LM rules (per-layer names; the JAX package's leading layer None dropped)
# --------------------------------------------------------------------- #
def lm_param_rules(cfg, mesh=None) -> list[tuple[str, P]]:
    rules = [
        # NB: anchored — "embed" must not shadow "unembed".
        (r"^unembed", P(None, "model")),
        (r"^embed", P("model", "data")),
        (r"ln_f|ln1|ln2|q_norm|k_norm", P()),
        (r"attn\.wq", P("data", "model")),
        (r"attn\.wk|attn\.wv", P("data", None)),
        (r"attn\.wo", P("model", "data")),
        (r"mlp\.w_gate|mlp\.w_up", P("data", "model")),
        (r"mlp\.w_down", P("model", "data")),
        (r"moe\.router", P("data", None)),
    ]
    if cfg.moe is not None:
        model_size = mesh_shape(mesh)["model"] if mesh is not None else 1
        if model_size > 1 and cfg.moe.n_experts % model_size == 0:
            # EP: experts across 'model'
            rules += [
                (r"moe\.w_gate|moe\.w_up", P("model", "data", None)),
                (r"moe\.w_down", P("model", None, "data")),
            ]
        else:
            # TP fallback: expert-internal d_ff across 'model'
            rules += [
                (r"moe\.w_gate|moe\.w_up", P(None, "data", "model")),
                (r"moe\.w_down", P(None, "model", "data")),
            ]
    return rules


def lm_input_specs(mesh, batch: int) -> dict[str, P]:
    bs = batch_spec(mesh, batch)
    return {"tokens": bs, "labels": bs}


def lm_cache_spec(mesh, cfg, batch: int, seq: int) -> dict[str, P]:
    """KV cache [L, B, S, kv, hd]: batch over (pod,data) when divisible,
    else the cache sequence dim (flash-decoding-style split)."""
    baxes = data_axes(mesh)
    if batch % axis_size(mesh, baxes) == 0 and batch > 1:
        # batch over (pod, data); cache sequence over 'model'
        kv = P(None, baxes, "model", None, None)
        pos = P(baxes)
    else:
        kv = P(None, None, ("data", "model"), None, None)
        pos = P()
    return {"k": kv, "v": kv, "pos": pos}


# --------------------------------------------------------------------- #
# GNN rules
# --------------------------------------------------------------------- #
def gnn_param_rules(cfg) -> list[tuple[str, P]]:
    return [(r".*", P())]  # GNN trunks are tiny: replicate params


def gnn_input_specs(mesh) -> dict[str, P]:
    shape = mesh_shape(mesh)
    eaxes = all_axes(mesh)
    naxes = tuple(a for a in ("data", "model") if a in shape)
    return {
        "feat": P(naxes, None),
        "edges": P(eaxes, None),
        "edge_mask": P(eaxes),
        "labels": P(naxes),
        "node_graph": P(naxes),
        "positions": P(naxes, None),
    }


# --------------------------------------------------------------------- #
# RecSys rules
# --------------------------------------------------------------------- #
def recsys_param_rules(cfg) -> list[tuple[str, P]]:
    return [
        (r"table", P(("data", "model"), None)),
        (r"mlp\.\d+\.w", P(None, "model")),
        (r".*", P()),
    ]


def recsys_input_specs(mesh, batch: int) -> dict[str, P]:
    bs = batch_spec(mesh, batch)
    return {
        "dense": P(*bs, None),
        "sparse": P(*bs, None),
        "labels": bs,
        "candidates": P(("data", "model"), None),
    }


# --------------------------------------------------------------------- #
# dual-simulation (paper workload) rules
# --------------------------------------------------------------------- #
def dualsim_sparse_specs(mesh) -> dict[str, P]:
    """Sparse engine: edges fully sharded; chi columns over the non-pod
    axes (the chi working set is the HBM hot spot at DB scale)."""
    shape = mesh_shape(mesh)
    eaxes = all_axes(mesh)
    chi_axes = tuple(a for a in ("data", "model") if a in shape)
    return {
        "init": P(None, chi_axes),
        "edge_src": P(eaxes),
        "edge_dst": P(eaxes),
        "mat_rhs": P(),
        "mat_table": P(),
        "copy_rhs": P(),
        "var_copy": P(),
    }


def dualsim_dense_specs(mesh) -> dict[str, P]:
    """Dense engine: adjacency 2-D sharded (rows x cols)."""
    return {
        "init": P(None, "model"),
        "adj_dense": P(None, "data", "model"),
        "adj_packed": P(None, "data", "model"),
        "mat_rhs": P(),
        "mat_table": P(),
        "copy_rhs": P(),
        "var_copy": P(),
    }


# --------------------------------------------------------------------- #
# placing a tree on a mesh
# --------------------------------------------------------------------- #
def place(tree: Any, shardings: Any, make: Callable[[torch.Tensor, NamedSharding], Any]):
    """``tree`` with each tensor leaf replaced by ``make(leaf, sharding)``,
    ``shardings`` a tree of :class:`NamedSharding` of the same paths.  A
    module keeps its identity: its parameters are swapped in place for
    parameters over ``make``'s tensors."""
    return _place(tree, "", dict(leaves_with_path(shardings)), make)


def _place(tree, prefix: str, by_path: dict, make):
    join = (lambda k: f"{prefix}/{k}") if prefix else (lambda k: k)  # noqa: E731
    if isinstance(tree, nn.Module):
        for name, p in list(tree.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            mod = tree.get_submodule(owner) if owner else tree
            mod._parameters[leaf] = nn.Parameter(make(p.detach(), by_path[join(name)]),
                                                 requires_grad=p.requires_grad)
        return tree
    kids = _children(tree)
    if kids is None:
        return make(tree, by_path[prefix]) if isinstance(tree, torch.Tensor) else tree
    out = {k: _place(v, join(k), by_path, make) for k, v in kids}
    if isinstance(tree, (list, tuple)):
        return type(tree)(out[str(i)] for i in range(len(tree)))
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **out)
    return out
