"""The node mesh of the partitioned engine, and the logical-axis sharding
context of the model zoo.

Model code annotates tensors with *logical* axes (``batch``, ``vocab``,
``expert``, ...); the launcher activates a mapping to the axes of a
:class:`torch.distributed.device_mesh.DeviceMesh` around a step
(``with logical_axis_rules(mesh): step(state, batch)``).  Outside the
context every annotation is a no-op, so the same model code runs unsharded
in the CPU tests and on one card, and sharded (over DTensors) in the
production dry-run.  Inside it :func:`constrain` redistributes a DTensor
to the placements the rules give, :func:`group_count` blocks the MoE
dispatch into shard-local groups, and two operations that DTensor would
otherwise run by gathering a sharded operand whole run shard-local
instead: :func:`lookup` (a row-sharded table's gather, as a masked
partial sum) and :func:`segment_reduce` (a segment sum, max or min over
sharded edges, as a partial reduction).  Every redistribution any of them
makes is an explicit DTensor collective, which the dry-run counts.

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

import contextlib
import dataclasses
import threading

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.distributed import shard as sh

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


_STATE = threading.local()

DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "vocab": ("model",),
    "heads": ("model",),
    "ff": ("model",),
    "expert": ("model",),
    "expert_cap": ("data",),
    "moe_tokens": ("pod", "data", "model"),  # flat (token, k) dispatch dim
    "embed_fsdp": ("data",),
    "kv_seq": ("data",),
    "nodes": ("data", "model"),
    "edges": ("pod", "data", "model"),
}


@contextlib.contextmanager
def logical_axis_rules(mesh, rules: dict[str, tuple[str, ...]] | None = None):
    """Map logical axes to ``mesh``'s axes (:data:`DEFAULT_RULES`, updated
    by ``rules``) for the duration of the block."""
    prev = getattr(_STATE, "ctx", None)
    _STATE.ctx = (mesh, {**DEFAULT_RULES, **(rules or {})})
    try:
        yield
    finally:
        _STATE.ctx = prev


def _axes_for(mesh, rules, name: str, dim: int) -> tuple[str, ...]:
    """The rule's mesh axes for logical axis ``name`` that the mesh has
    (of more than one device: a split over one device splits nothing, and
    DTensor refuses to reshape a dim sharded over it), shortened from the
    front until their product divides ``dim``."""
    shape = sh.mesh_shape(mesh)
    axes = tuple(a for a in rules.get(name, ()) if shape.get(a, 1) > 1)
    while axes:
        size = sh.axis_size(mesh, axes)
        if size and dim % size == 0:
            return axes
        axes = axes[1:]
    return ()


def group_count(name: str, dim: int) -> int:
    """Number of shard groups the logical axis ``name`` would split ``dim``
    into under the active rules (1 outside a rule context).  Used by the MoE
    layer to block its dispatch into shard-local groups."""
    ctx = getattr(_STATE, "ctx", None)
    if ctx is None:
        return 1
    mesh, rules = ctx
    axes = _axes_for(mesh, rules, name, dim)
    return sh.axis_size(mesh, axes) if axes else 1


def logical_spec(shape, *logical: str | None) -> sh.P | None:
    """The mesh spec the active rules give a ``shape`` tensor annotated
    with ``logical`` (one logical axis name or None per dim); None outside
    a rule context.  Mesh axes that are absent or do not divide the dim are
    dropped."""
    ctx = getattr(_STATE, "ctx", None)
    if ctx is None:
        return None
    mesh, rules = ctx
    spec = []
    for dim, name in zip(shape, logical):
        axes = _axes_for(mesh, rules, name, dim) if name is not None else ()
        spec.append(axes if axes else None)
    return sh.P(*spec)


class _GradLike(torch.autograd.Function):
    """Identity whose backward hands on the gradient in the forward
    input's placements."""

    @staticmethod
    def forward(ctx, x):
        ctx.placements = x.placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if isinstance(grad, DTensor) and tuple(grad.placements) != tuple(ctx.placements):
            grad = grad.redistribute(grad.device_mesh, ctx.placements)
        return grad


def constrain(x: torch.Tensor, *logical: str | None) -> torch.Tensor:
    """Redistribute a DTensor to the placements the active rules give its
    logical axes (one logical axis name or None per dim), and its gradient
    likewise in the backward.  The identity outside a rule context and on a
    plain tensor."""
    spec = logical_spec(tuple(x.shape), *logical)
    if spec is None or not isinstance(x, DTensor):
        return x
    placements = sh.to_placements(spec, x.device_mesh)
    if tuple(x.placements) != placements:
        x = x.redistribute(x.device_mesh, placements)
    return _GradLike.apply(x) if x.requires_grad else x


def as_dtensor(x: torch.Tensor, mesh) -> DTensor:
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def local_map(fn, out_placements, in_placements, mesh, in_grad_placements=None):
    """``fn`` over the local shards of DTensor arguments, each first
    redistributed to its ``in_placements`` (a DTensor collective where they
    differ); ``out_placements`` is a list of placements for one output, a
    tuple of such lists for several.  ``in_grad_placements`` (one entry an
    argument, None for the default) are those of each argument's local
    gradient: by default its ``in_placements``, which is wrong where an
    argument is replicated on a mesh dim while the shards compute
    different things with it (another argument sharded there, or a slice
    of it taken a shard): there its gradient is ``Partial()``."""
    from torch.distributed.tensor.experimental import local_map as _local_map

    if in_grad_placements is not None:
        in_grad_placements = tuple(g if g is not None else p
                                   for g, p in zip(in_grad_placements, in_placements))
    return _local_map(fn, out_placements=out_placements, in_placements=in_placements,
                      in_grad_placements=in_grad_placements, device_mesh=mesh,
                      redistribute_inputs=True)


def partial_where(placements, dims) -> tuple:
    """``placements`` with ``Partial()`` on the mesh dims ``dims`` (the
    gradient placements of an argument replicated there, see
    :func:`local_map`)."""
    return tuple(Partial() if k in dims else p for k, p in enumerate(placements))


def shard_index(mesh, axes) -> tuple[int, int]:
    """(this device's index, the count) among the shards that the mesh
    axes ``axes`` (a name, a tuple of names major to minor, or None) split
    a dimension into."""
    if axes is None:
        return 0, 1
    names = list(mesh.mesh_dim_names)
    rank, n = 0, 1
    for a in (axes,) if isinstance(axes, str) else axes:
        k = names.index(a)
        rank, n = rank * mesh.size(k) + mesh.get_local_rank(k), n * mesh.size(k)
    return rank, n


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``, rows of ``table`` gathered by the integer ``ids``.

    On a DTensor table it runs shard-local, never gathering the table
    whole: the mesh dimensions that split the table's columns are gathered
    first (FSDP's unshard of a ``[vocab, d]`` embedding); on those that
    split its rows, ``ids`` are replicated (an all-gather of the ids), each
    shard looks up the rows it owns and zeroes the rest, and the partial
    results are summed back onto the ids' own placements (a reduce-scatter
    where the ids were sharded, an all-reduce where they were replicated).
    The backward of the masked lookup stays on the shard that owns the row,
    summed over the shards whose ids it served.
    """
    if not isinstance(table, DTensor) and not isinstance(ids, DTensor):
        return table[ids]
    mesh = table.device_mesh if isinstance(table, DTensor) else ids.device_mesh
    table, ids = as_dtensor(table, mesh), as_dtensor(ids, mesh)
    tpl = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                for p in table.placements)
    rows = [k for k, p in enumerate(tpl) if isinstance(p, Shard)]
    ipl = tuple(Replicate() if k in rows else p for k, p in enumerate(ids.placements))
    if any(isinstance(p, Partial) for p in ipl):
        raise ValueError(f"lookup ids must not be partial: {ids.placements}")
    opl = tuple(Partial() if k in rows else p for k, p in enumerate(ipl))
    rank, n = shard_index(mesh, tuple(mesh.mesh_dim_names[k] for k in rows))
    if table.shape[0] % n:
        raise ValueError(f"{n} row shards do not divide {table.shape[0]} rows")
    n_local = table.shape[0] // n
    lo = rank * n_local

    def local(t, i):
        j = i - lo
        ok = (j >= 0) & (j < n_local)
        got = t[torch.where(ok, j, torch.zeros_like(j))]
        return torch.where(ok[..., None], got, torch.zeros_like(got))

    # where the ids are split and the table is not, each shard's table
    # gradient holds only its own ids' rows: a partial sum
    tgrad = partial_where(tpl, {k for k, p in enumerate(ipl)
                                if isinstance(p, Shard) and not isinstance(tpl[k], Shard)})
    out = local_map(local, list(opl), (tpl, ipl), mesh, (tgrad, None))(table, ids)
    return out.redistribute(mesh, ids.placements)


_IDENTITY = {"sum": 0.0, "amax": float("-inf"), "amin": float("inf")}
_PARTIAL = {"sum": "sum", "amax": "max", "amin": "min"}


def _local_reduce(v: torch.Tensor, i: torch.Tensor, n: int, reduce: str) -> torch.Tensor:
    """One shard's reduction of its rows ``v`` into all ``n`` segments,
    the identity where it has none."""
    ident = _IDENTITY[reduce]
    if not v.dtype.is_floating_point and reduce != "sum":
        ident = torch.iinfo(v.dtype).min if reduce == "amax" else torch.iinfo(v.dtype).max
    out = torch.full((n, *v.shape[1:]), ident, dtype=v.dtype, device=v.device)
    i = i.to(torch.int64)
    if reduce == "sum":
        return out.index_add(0, i, v)
    ix = i.reshape(-1, *([1] * (v.dim() - 1))).expand_as(v)
    return out.scatter_reduce(0, ix, v, reduce, include_self=True)


class _ShardedExtreme(torch.autograd.Function):
    """One edge shard's partial max or min, whose backward is exact over
    every shard: the gradient of a segment goes to the edges whose value
    equals the segment's extreme over all shards, split evenly among them
    (the tie count summed over all shards), as ``scatter_reduce``'s and
    JAX's ``segment_max`` gradients split it.  ``groups`` are the mesh
    dims that shard the edges (none: the collectives are skipped); the two
    cross-shard reductions are functional collectives over them."""

    @staticmethod
    def forward(ctx, v, i, n, reduce, groups):
        out = _local_reduce(v, i, n, reduce)
        ctx.save_for_backward(v, i, out)
        ctx.reduce, ctx.groups = reduce, groups
        return out

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed import _functional_collectives as funcol

        v, i, extreme = ctx.saved_tensors
        op = _PARTIAL[ctx.reduce]
        for group in ctx.groups:
            extreme = funcol.all_reduce(extreme, op, group)
        ix = i.to(torch.int64)
        hit = v == extreme[ix]
        ties = torch.zeros_like(grad).index_add(0, ix, hit.to(grad.dtype))
        for group in ctx.groups:
            ties = funcol.all_reduce(ties, "sum", group)
        share = grad[ix] / torch.clamp(ties[ix], min=1.0)
        return torch.where(hit, share, torch.zeros_like(share)), None, None, None, None


def segment_reduce(vals: torch.Tensor, idx: torch.Tensor, n: int, reduce: str):
    """The ``reduce`` ("sum", "amax" or "amin") of the rows of ``vals [E,
    ...]`` into ``n`` segments by ``idx [E]``, on DTensors whose edge dim
    is sharded: each shard reduces its own edges into all ``n`` rows (the
    reduction's identity where it has none), and the result is that
    partial reduction (a ``Partial`` DTensor; reading it reduces across
    the shards).  An empty segment is the identity (±inf for a float max
    and min, the dtype's extreme for an integer one).  The gradient is
    exact across shards: for the sum every edge takes its segment's
    gradient; for max and min the backward all-reduces each segment's
    extreme and its tie count over the edge-sharding mesh dims, and only
    the edges equal to the extreme take the gradient, split evenly among
    them."""
    mesh = vals.device_mesh if isinstance(vals, DTensor) else idx.device_mesh
    vals, idx = as_dtensor(vals, mesh), as_dtensor(idx, mesh)
    ipl = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                for p in idx.placements)
    opl = tuple(Partial(_PARTIAL[reduce]) if isinstance(p, Shard) else p for p in ipl)
    groups = tuple((mesh, k) for k, p in enumerate(ipl) if isinstance(p, Shard))

    def local(v, i):
        if reduce == "sum":
            return _local_reduce(v, i, n, reduce)
        return _ShardedExtreme.apply(v, i, n, reduce, groups)

    return local_map(local, list(opl), (ipl, ipl), mesh)(vals, idx)

