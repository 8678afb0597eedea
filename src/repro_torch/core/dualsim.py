"""Dual-simulation fixpoint engines on torch (paper Sect. 3).

Port of the JAX package's single-device engines, in two tiers.

The dense-adjacency tier, for graphs whose ``[n, n]`` plane may be built
(:func:`repro_torch.engine.cost.dense_tier_feasible`):

* ``solve_dense`` — Gauss–Seidel over dense bool adjacency ``[M, n, n]``,
  one f32 matrix product per operator followed by ``> 0``.
* ``solve_packed`` — the same sweep over bit-packed ``int32 [M, n, nw]``
  adjacency through :func:`repro_torch.kernels.bitmm.kernel.bitmm`; chi
  stays bool between launches (the baseline ``packed_fused`` is measured
  against).
* ``solve_packed_fused`` — chi bit-packed end to end: one fused
  :func:`repro_torch.kernels.bitmm.kernel.bitmm_apply` per operator does
  product, AND-combine and change detection on packed words.

The edge path, always feasible.  Both sweep orders carry chi bit-packed as
``int32 [V, nw]`` words (the reference's ``uint32`` bit pattern) through
the whole fixpoint:

* ``solve_sparse(mode="gs")`` — Gauss–Seidel: operators apply in order
  within a sweep, each reading the freshly-shrunk chi.  Same operator order
  as the reference, so the sweep counts are equal, not just similar.
* ``solve_sparse(mode="jacobi_packed")`` — all operators read one frontier
  per sweep; their shrink masks AND together.
* ``solve_partitioned`` — Jacobi sweeps over edges split by destination
  block (:func:`make_partitioned_operands`), one segmented OR per block;
  over a :class:`repro_torch.distributed.ctx.NodeMesh` each block's
  columns of chi live on its device.
* ``solve_worklist`` — the paper's own sequential strategy (numpy), kept as
  the oracle.

The operands' edge layout picks the segmented-OR lowering.  On a card they
always hold the blocked layout, run through
:func:`repro_torch.kernels.segsum.kernel.segor_blocks` (the CUDA kernel).
On the CPU :func:`make_sparse_operands` builds the flat edge lists, run
through plain torch ops; CPU operands in the blocked layout (handed over
by :func:`repro_torch.convert.operands_from_numpy`, or built by the tests)
run the wrapper's plain version.  The packed tier's kernels likewise run
their plain versions on CPU operands and launch on card operands.
DTensor operands (:func:`shard_operands`) run the sharded sweeps of the
``sparse`` and partitioned engines, under the same rule a shard: on a card
each shard holds its edges in the blocked layout.

All engines implement the same monotone operator

    chi[lhs] &= chi[rhs] ×b M        (edge inequalities, Eq. 11)
    chi[lhs] &= chi[rhs]             (copy inequalities, Eq. 15)

iterated to the (unique) greatest fixpoint; order of application does not
change the fixpoint (Knaster–Tarski on the finite powerset lattice).  JAX's
``lax.while_loop`` becomes a host loop with one convergence read per sweep.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch import spans
from repro_torch.distributed import ctx
from repro_torch.distributed import shard as sh
from repro_torch.kernels.bitmm import kernel as bitmm_kernel
from repro_torch.kernels.segsum import kernel as segsum_kernel
from repro_torch.kernels.segsum import ref as segsum_ref

from . import bitops
from .device import DEFAULT_DEVICE, resolve_device
from .graph import Graph
from .soi import BWD, FWD, CompiledSOI, SOI, build_soi, compile_soi

_edge_bits = segsum_ref.edge_bits

# --------------------------------------------------------------------- #
# operand construction (numpy -> device tensors)
# --------------------------------------------------------------------- #


def _i32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.int32), device=device)


def _pad_table(groups: list[list[int]], pad: int) -> np.ndarray:
    k = max((len(g) for g in groups), default=0)
    k = max(k, 1)
    out = np.full((len(groups), k), pad, dtype=np.int32)
    for i, g in enumerate(groups):
        out[i, : len(g)] = g
    return out


def _per_mat_tables(c: CompiledSOI, device) -> tuple[tuple, tuple]:
    """Per-operator inequality tables.

    For operator m: ``mat_rhs[m]`` lists the RHS variable of each inequality
    using m; ``mat_table[m]`` is the per-variable padded index list into
    those inequalities (pad = I_m, pointing at an appended all-ones row) so
    multiple inequalities on the same LHS AND-combine with gathers only.
    """
    n_mats = len(c.mats)
    rhs_by_mat: list[list[int]] = [[] for _ in range(n_mats)]
    var_by_mat: list[list[list[int]]] = [
        [[] for _ in range(c.n_vars)] for _ in range(n_mats)
    ]
    for l, r, m in zip(c.ineq_lhs, c.ineq_rhs, c.ineq_mat):
        var_by_mat[m][l].append(len(rhs_by_mat[m]))
        rhs_by_mat[m].append(r)
    mat_rhs = tuple(_i32(r, device) for r in rhs_by_mat)
    mat_table = tuple(
        _i32(_pad_table(v, pad=len(rhs_by_mat[m])), device)
        for m, v in enumerate(var_by_mat)
    )
    return mat_rhs, mat_table


def _mat_lhs_flags(c: CompiledSOI, device) -> tuple:
    """Per-operator ``[V, V]`` inequality flags: ``flags[m][l, r] = 1`` iff
    the SOI holds ``chi[l] <= chi[r] ×b M_m`` (the fused engine's form of
    ``mat_rhs`` / ``mat_table``)."""
    flags = [np.zeros((c.n_vars, c.n_vars), np.int32) for _ in c.mats]
    for l, r, m in zip(c.ineq_lhs, c.ineq_rhs, c.ineq_mat):
        flags[m][l, r] = 1
    return tuple(_i32(f, device) for f in flags)


def _copy_tables(c: CompiledSOI, device) -> tuple[torch.Tensor, torch.Tensor]:
    by_copy: list[list[int]] = [[] for _ in range(c.n_vars)]
    for i, l in enumerate(c.copy_lhs):
        by_copy[l].append(i)
    return (
        _i32(c.copy_rhs, device),
        _i32(_pad_table(by_copy, pad=len(c.copy_lhs)), device),
    )


@dataclasses.dataclass
class Operands:
    """Device operands shared by the engines.

    Words are ``int32`` views of the reference's ``uint32``; index tables
    and edge lists are ``int32``.  The operands hold exactly one adjacency
    layout: dense ``bool [M, n, n]`` (``dense``), packed ``int32 [M, n,
    nw]`` (``packed``, ``packed_fused``), the flat per-operator edge lists
    (plain torch, CPU only) or the blocked segmented-OR layout
    (``segor_blocks``).  A card takes every layout but the flat lists, so
    the card never runs a plain version.  Any of them may be DTensors, the
    operands of a sharded sweep (:func:`shard_operands`).
    """

    init: torch.Tensor  # bool [V, n]
    mat_rhs: tuple  # per mat: int32 [I_m]
    mat_table: tuple  # per mat: int32 [V, K_m] (padded with I_m)
    copy_rhs: torch.Tensor  # int32 [C]
    var_copy: torch.Tensor  # int32 [V, Kc]  (padded with C)
    init_packed: torch.Tensor | None = None  # int32 [V, nw]
    mat_lhs_flags: tuple | None = None  # per mat: int32 [V, V]
    adj_dense: torch.Tensor | None = None  # bool [M, n, n]
    adj_packed: torch.Tensor | None = None  # int32 [M, n, nw]
    edge_src: tuple | None = None  # per-mat int32 [E_m] source nodes
    edge_dst: tuple | None = None  # per-mat int32 [E_m] dst nodes (pad = n)
    # blocked segmented-OR layout: edges sorted and blocked by destination
    # window; pad rows carry the sentinel n_pad (see prepare_segor)
    seg_src_b: tuple | None = None  # per-mat int32 [G_m, BE] source nodes
    seg_dst_b: tuple | None = None  # per-mat int32 [G_m, BE] absolute dst
    seg_win: tuple | None = None  # per-mat int32 [G_m] dst window
    # partitioned layout: edges split by destination block, W blocks of
    # n_local = n_pad / W nodes; sources stay global ids in [0, n_pad)
    edge_src_b: tuple | None = None  # per-mat int32 [W, Eb] source nodes
    edge_dst_b: tuple | None = None  # per-mat int32 [W, Eb] local dst (pad = n_local)
    # the same blocks in the blocked segmented-OR layout over local dst ids:
    # per mat, per block a (seg_src_b [G, BE], seg_dst_b [G, BE], seg_win [G]);
    # as DTensors, per mat one such triple stacked over the blocks, [W, G,
    # BE], [W, G, BE] and [W, G], split along W (shard_operands)
    part_seg: tuple | None = None

    def __post_init__(self):
        layouts = (self.adj_dense, self.adj_packed, self.edge_src,
                   self.seg_win, self.edge_src_b, self.part_seg)
        if sum(x is not None for x in layouts) != 1:
            raise ValueError(
                "Operands hold exactly one edge layout: adj_dense, "
                "adj_packed, edge_src/edge_dst, seg_src_b/seg_dst_b/seg_win, "
                "edge_src_b/edge_dst_b or part_seg"
            )
        flat = self.edge_src is not None or self.edge_src_b is not None
        if flat and self.init.device.type != "cpu":
            raise ValueError(
                f"operands on {self.init.device} need the blocked layout "
                "(or the dense or packed one): only the CPU runs the flat "
                "edge lists"
            )

    @property
    def blocked(self) -> bool:
        """Whether the edges are in the blocked segmented-OR layout."""
        return self.seg_win is not None

    @property
    def partitioned(self) -> bool:
        """Whether the edges are split by destination block."""
        return self.edge_src_b is not None or self.part_seg is not None

    @property
    def n_blocks(self) -> int | None:
        """Destination blocks of the partitioned layout (``None`` for any
        other layout, or when there is no operator to read it from)."""
        if self.part_seg:
            first = self.part_seg[0]  # a triple a block, or stacked DTensors
            return int(first[0].shape[0]) if isinstance(first[0], DTensor) else len(first)
        if self.edge_src_b:
            return int(self.edge_src_b[0].shape[0])
        return None


def _init_fields(init_np: np.ndarray, device, n_pad: int | None = None) -> dict:
    """``init`` and ``init_packed`` (packed once on the host: the sweep
    starts from these words), padded with dead columns to ``n_pad``."""
    n = init_np.shape[-1]
    if n_pad is not None and n_pad != n:
        init_np = np.pad(init_np, ((0, 0), (0, n_pad - n)))
    return dict(init=torch.as_tensor(init_np, device=device),
                init_packed=bitops.to_words(bitops.pack_np(init_np), device))


def _base_operands(c: CompiledSOI, device, n_pad: int | None = None) -> dict:
    mat_rhs, mat_table = _per_mat_tables(c, device)
    copy_rhs, var_copy = _copy_tables(c, device)
    return dict(
        **_init_fields(np.asarray(c.init, bool), device, n_pad),
        mat_rhs=mat_rhs,
        mat_table=mat_table,
        mat_lhs_flags=_mat_lhs_flags(c, device),
        copy_rhs=copy_rhs,
        var_copy=var_copy,
    )


def _cached_adj(adj_cache: dict | None, key, g: Graph, build):
    """Adjacency depends only on (engine, mats, graph) — never on the SOI's
    variables — so plan caches share it across templates and batch buckets.
    Entries store the graph they were built from and only hit on the *same*
    graph object: sharing one cache dict across graphs can never return
    another graph's adjacency (it just misses and rebuilds)."""
    if adj_cache is not None:
        try:
            hit_g, adj = adj_cache[key]
        except KeyError:
            pass
        else:
            if hit_g is g:
                return adj
    adj = build()
    if adj_cache is not None:
        adj_cache[key] = (g, adj)
    return adj


def _adjacency(
    c: CompiledSOI, g: Graph, mats: list[int], packed: bool, device
) -> torch.Tensor:
    """Stacked adjacency of operators ``mats``: bool ``[len(mats), n, n]``
    or packed ``int32 [len(mats), n, nw]``, filled one operator at a time so
    the host never holds more than one operator's plane."""
    n = g.n_nodes
    width = bitops.packed_width(n) if packed else n
    out = torch.empty((len(mats), n, width),
                      dtype=torch.int32 if packed else torch.bool,
                      device=device)
    for k, m in enumerate(mats):
        a, d = c.mats[m]
        if packed:
            plane = g.packed_adjacency(a, backward=(d == BWD)).view(np.int32)
        else:
            plane = g.dense_adjacency(a, backward=(d == BWD))
        out[k] = torch.from_numpy(plane)
    return out


def make_dense_operands(
    c: CompiledSOI, g: Graph, adj_cache: dict | None = None,
    *, device=DEFAULT_DEVICE,
) -> Operands:
    """Operands of the ``dense`` engine: bool ``[M, n, n]`` adjacency."""
    device = resolve_device(device)
    adj = _cached_adj(
        adj_cache, ("dense", tuple(c.mats), str(device)), g,
        lambda: _adjacency(c, g, list(range(len(c.mats))), False, device),
    )
    return Operands(adj_dense=adj, **_base_operands(c, device))


def make_packed_operands(
    c: CompiledSOI, g: Graph, adj_cache: dict | None = None,
    *, device=DEFAULT_DEVICE,
) -> Operands:
    """Operands of the ``packed`` and ``packed_fused`` engines: bit-packed
    ``int32 [M, n, nw]`` adjacency, row ``i`` of operator m holding the
    successors of node ``i``."""
    device = resolve_device(device)
    adj = _cached_adj(
        adj_cache, ("packed", tuple(c.mats), str(device)), g,
        lambda: _adjacency(c, g, list(range(len(c.mats))), True, device),
    )
    return Operands(adj_packed=adj, **_base_operands(c, device))


# Per-operator edge lists round up to this capacity multiple; pad rows use
# the out-of-range destination id ``n`` and are dropped by the segment
# reduce.  Rounding keeps operand shapes stable under small insert/delete
# deltas (DESIGN.md Sect. 8).
EDGE_PAD = 64


def _padded_edge_list(
    s: np.ndarray, t: np.ndarray, n: int, min_cap: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """(src, dst) int32 arrays padded to an ``EDGE_PAD`` multiple >= min_cap."""
    e = len(s)
    cap = max(-(-e // EDGE_PAD) * EDGE_PAD if e else 0, min_cap)
    if cap == e:
        return np.asarray(s, np.int32), np.asarray(t, np.int32)
    ps = np.zeros(cap, np.int32)
    pt = np.full(cap, n, np.int32)  # pad dst = n -> dropped by segment reduce
    ps[:e], pt[:e] = s, t
    return ps, pt


def _oriented_edges(g: Graph, a: int, d: int) -> tuple[np.ndarray, np.ndarray]:
    e = g.edges_for_label(a)
    return (e[:, 0], e[:, 1]) if d == FWD else (e[:, 1], e[:, 0])


def _segor_mat(
    s: np.ndarray, t: np.ndarray, n: int, device, min_g: int = 0
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Blocked segmented-OR layout for one operator's RAW edge list.

    Pad rows gather source 0 but carry the sentinel destination ``n_pad``,
    which can never turn on a bit (:func:`repro_torch.kernels.segsum.kernel.
    prepare_segor`) — crucially NOT the flat layout's pad id ``n``, which
    would alias bit ``n`` whenever ``n`` lies inside a live window.
    """
    idx_b, seg_b, win, _ = segsum_kernel.prepare_segor(t, n, min_g=min_g)
    src_b = (
        np.asarray(s, np.int32)[idx_b]
        if len(s)
        else np.zeros(idx_b.shape, np.int32)
    )
    return _i32(src_b, device), _i32(seg_b, device), _i32(win, device)


def _edge_layout(
    c: CompiledSOI, g: Graph, device, blocked: bool,
    mats: list[int] | None = None, old: Operands | None = None,
) -> dict:
    """The edge-layout fields of operator ``mats`` (all by default) built
    against ``g``; the other operators carry over from ``old``, and rebuilt
    ones keep ``old``'s padded capacity whenever their edges still fit."""
    n = g.n_nodes
    names = ("seg_src_b", "seg_dst_b", "seg_win") if blocked else (
        "edge_src", "edge_dst")
    cols = (
        [list(getattr(old, f)) for f in names]
        if old is not None
        else [[None] * len(c.mats) for _ in names]
    )
    for m in range(len(c.mats)) if mats is None else mats:
        s, t = _oriented_edges(g, *c.mats[m])
        cap = 0 if old is None else int(cols[0][m].shape[0])
        if blocked:
            arrays = _segor_mat(s, t, n, device, min_g=cap)
        else:
            arrays = tuple(
                _i32(x, device) for x in _padded_edge_list(s, t, n, cap)
            )
        for col, x in zip(cols, arrays):
            col[m] = x
    return {f: tuple(col) for f, col in zip(names, cols)}


def make_sparse_operands(
    c: CompiledSOI, g: Graph, adj_cache: dict | None = None,
    *, device=DEFAULT_DEVICE,
) -> Operands:
    """Operands of the edge-list engines for ``c`` against ``g`` on ``device``:
    the blocked segmented-OR layout on a card, the flat edge lists on the
    CPU."""
    device = resolve_device(device)
    blocked = device.type == "cuda"
    layout = _cached_adj(
        adj_cache, ("sparse", tuple(c.mats), str(device), blocked), g,
        lambda: _edge_layout(c, g, device, blocked),
    )
    return Operands(**layout, **_base_operands(c, device))


# --------------------------------------------------------------------- #
# the partitioned layout: edges split by destination block
# --------------------------------------------------------------------- #
def _partitioned_mat(
    s: np.ndarray, t: np.ndarray, n_blocks: int, n_local: int, min_eb: int = 1
) -> tuple[np.ndarray, np.ndarray]:
    """Destination-partitioned (block, local-dst) layout for one operator.

    Blocks pad to a common edge count ``>= min_eb`` (pad rows use the
    out-of-range local id ``n_local`` and are dropped by the segment
    reduce); ``min_eb`` lets an operand patch keep the superseded shape.
    Equal to the JAX package's arrays element for element.
    """
    blk = t // n_local
    order = np.argsort(blk, kind="stable")
    s, t, blk = s[order], t[order], blk[order]
    counts = np.bincount(blk, minlength=n_blocks)
    eb = max(int(counts.max()) if counts.size else 1, 1, min_eb)
    src_b = np.zeros((n_blocks, eb), np.int32)
    dst_b = np.full((n_blocks, eb), n_local, np.int32)  # pad -> dropped
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    for w in range(n_blocks):
        k = counts[w]
        src_b[w, :k] = s[starts[w] : starts[w] + k]
        dst_b[w, :k] = t[starts[w] : starts[w] + k] - w * n_local
    return src_b, dst_b


def padded_node_count(n: int, n_blocks: int) -> int:
    """Smallest node count splitting into ``n_blocks`` uniform blocks of
    whole 32-bit words, so the blocks' packed local words concatenate
    directly into the global word order (pad columns are dead and sliced
    off after the solve)."""
    n_local = -(-max(-(-n // n_blocks), 1) // bitops.WORD) * bitops.WORD
    return n_local * n_blocks


def _block_shard(b: int, n_blocks: int, n_shards: int) -> int:
    """The mesh position of destination block ``b``: blocks are placed
    block-major, ``n_blocks / n_shards`` consecutive blocks a device."""
    return b * n_shards // n_blocks


def _block_devices(n_blocks: int, mesh, device) -> tuple:
    """The device of each destination block: block-major over ``mesh``'s
    devices (a :class:`repro_torch.distributed.ctx.NodeMesh`), or ``device``
    for every block without a mesh."""
    if mesh is None:
        return (device,) * n_blocks
    return tuple(mesh.devices[_block_shard(b, n_blocks, mesh.size)]
                 for b in range(n_blocks))


def _partitioned_layout(
    c: CompiledSOI, g: Graph, n_blocks: int, n_pad: int, device,
    blocked: bool, mesh=None, mats: list[int] | None = None,
    old: Operands | None = None,
) -> dict:
    """The partitioned edge fields of operators ``mats`` (all by default)
    built against ``g``; the other operators carry over from ``old``, and
    rebuilt ones keep ``old``'s capacity (``min_eb`` of the flat blocks,
    ``min_g`` of each block's segmented-OR layout) whenever their edges
    still fit.

    The flat layout (the CPU's) is the JAX package's ``int32 [W, Eb]``
    pair.  The blocked layout (a card's) gives each block K1's layout
    (:func:`repro_torch.kernels.segsum.kernel.prepare_segor`) over its RAW
    local destinations with ``num_segments = n_local``: its pad rows carry
    that layout's sentinel, never the flat layout's ``n_local``, which
    would alias a live bit where ``n_local`` is not a multiple of the
    window.  Sources stay global ids, and each block lives on its device
    (:func:`_block_devices`).
    """
    n_local = n_pad // n_blocks
    mats = range(len(c.mats)) if mats is None else mats
    if blocked:
        col = list(old.part_seg) if old is not None else [None] * len(c.mats)
        devices = _block_devices(n_blocks, mesh, device)
        for m in mats:
            s, t = _oriented_edges(g, *c.mats[m])
            blk = t // n_local
            order = np.argsort(blk, kind="stable")
            s, t = s[order], t[order]
            bounds = np.searchsorted(blk[order], np.arange(n_blocks + 1))
            blocks = []
            for w in range(n_blocks):
                lo, hi = bounds[w], bounds[w + 1]
                cap = 0 if old is None else int(old.part_seg[m][w][0].shape[0])
                blocks.append(_segor_mat(s[lo:hi], t[lo:hi] - w * n_local,
                                         n_local, devices[w], min_g=cap))
            col[m] = tuple(blocks)
        return {"part_seg": tuple(col)}
    srcs = list(old.edge_src_b) if old is not None else [None] * len(c.mats)
    dsts = list(old.edge_dst_b) if old is not None else [None] * len(c.mats)
    for m in mats:
        cap = 1 if old is None else int(old.edge_src_b[m].shape[1])
        sb, db = _partitioned_mat(*_oriented_edges(g, *c.mats[m]), n_blocks,
                                  n_local, min_eb=cap)
        srcs[m], dsts[m] = _i32(sb, device), _i32(db, device)
    return {"edge_src_b": tuple(srcs), "edge_dst_b": tuple(dsts)}


def make_partitioned_operands(
    c: CompiledSOI, g: Graph, n_blocks: int, adj_cache: dict | None = None,
    *, device=DEFAULT_DEVICE, mesh=None,
) -> Operands:
    """Destination-partitioned (vertex-cut) edge layout: the host-side graph
    partitioner of the ``partitioned`` engine.

    The node axis is padded up to ``n_pad`` (:func:`padded_node_count`), a
    multiple of ``n_blocks`` blocks of whole words: pad columns start
    all-False in ``init``, receive no edges and stay dead through every
    sweep; slice ``chi[:, :g.n_nodes]`` after solving.  A card takes each
    block's segmented-OR layout, the CPU the JAX package's flat ``[W,
    Eb]`` blocks (see :func:`_partitioned_layout`).  With ``mesh`` (a
    :class:`repro_torch.distributed.ctx.NodeMesh` of ``device``'s type),
    block w's edges live on its device (:func:`_block_devices`).  The edge
    blocks depend only on (mats, graph, n_blocks, device, mesh) and are
    shared across plans through ``adj_cache``.
    """
    device = resolve_device(device)
    if mesh is not None and mesh.device_type != device.type:
        raise ValueError(f"a mesh of {mesh.device_type} devices cannot hold "
                         f"operands on {device}")
    blocked = device.type == "cuda"
    n_pad = padded_node_count(g.n_nodes, n_blocks)
    layout = _cached_adj(
        adj_cache,
        ("partitioned", tuple(c.mats), n_blocks, str(device), blocked, mesh),
        g,
        lambda: _partitioned_layout(c, g, n_blocks, n_pad, device, blocked,
                                    mesh),
    )
    return Operands(**layout, **_base_operands(c, device, n_pad))


# --------------------------------------------------------------------- #
# the operands of a sharded sweep
# --------------------------------------------------------------------- #
def shard_operands(ops: Operands, mesh, spec_of: Callable, *,
                   blocked: bool | None = None) -> Operands:
    """``ops`` (plain tensors, with flat edges or dense / packed adjacency)
    placed on ``mesh`` as DTensors, the operands of a sharded sweep: each
    tensor field ``f`` split as ``spec_of(f)`` says (a
    :class:`~repro_torch.distributed.shard.P`).

    With ``blocked`` (by default on a mesh of cards, which runs no flat
    edge list) the flat edges first become the blocked segmented-OR layout
    a shard, built on the host, so that each device's reduce is one
    ``segor_blocks`` call:

    * the ``sparse`` lists: chi's words are split as ``init`` is
      (``spec_of("init")`` is the sweep's ``chi_spec``), and each edge
      shard (:func:`_edge_placements`) takes a contiguous run of every
      operator's edges in K1's layout (:func:`_segor_mat`), padded to one
      block count ``G``: ``seg_src_b`` ``[S * G, BE]``, split as the edges;
    * the partitioned blocks: each block's K1 layout over its local
      destinations, padded to one ``G`` and stacked, ``part_seg`` ``[W, G,
      BE]`` per operator, split as ``spec_of("edge_src_b")`` splits the
      blocks.
    """
    from torch.distributed.tensor import distribute_tensor

    if ops.blocked or ops.part_seg is not None:
        raise ValueError("shard_operands takes flat edges (operands built on the CPU)")
    if blocked is None:
        blocked = mesh.device_type == "cuda"

    def put(t, spec):
        return distribute_tensor(t, mesh, sh.named(mesh, t.shape, spec).placements)

    fields = {}
    if blocked and ops.edge_src is not None:
        epl = _edge_placements(_sparse_chi(ops, mesh, spec_of("init")).placements)
        n_shards = int(np.prod([mesh.size(k) for k, p in enumerate(epl) if p == Shard(0)]))
        n = ops.init.shape[-1]
        cols = []
        for src, dst in zip(ops.edge_src, ops.edge_dst):
            live = dst < n  # the flat lists' pad rows
            runs = zip(*(np.array_split(x[live].numpy(), n_shards) for x in (src, dst)))
            cols.append(tuple(distribute_tensor(t.flatten(0, 1), mesh, epl)
                              for t in _common_segor(runs, n)))
        fields.update(dict(zip(("seg_src_b", "seg_dst_b", "seg_win"), zip(*cols))),
                      edge_src=None, edge_dst=None)
    elif blocked and ops.edge_src_b is not None:
        n_local = ops.init.shape[-1] // ops.n_blocks
        spec = spec_of("edge_src_b")
        col = []
        for src_b, dst_b in zip(ops.edge_src_b, ops.edge_dst_b):
            live = dst_b < n_local  # the flat blocks' pad rows
            runs = [(s[k].numpy(), d[k].numpy()) for s, d, k in zip(src_b, dst_b, live)]
            col.append(tuple(put(t, spec) for t in _common_segor(runs, n_local)))
        fields.update(part_seg=tuple(col), edge_src_b=None, edge_dst_b=None)
    for f in dataclasses.fields(ops):
        val = getattr(ops, f.name)
        if f.name in fields or val is None:
            continue
        spec = spec_of(f.name)
        fields[f.name] = (tuple(put(t, spec) for t in val) if isinstance(val, tuple)
                          else put(val, spec))
    return dataclasses.replace(ops, **fields)


def _common_segor(runs, n: int) -> tuple[torch.Tensor, ...]:
    """K1's layout (:func:`_segor_mat`) of each ``(src, dst)`` run of raw
    edges over ``n`` destinations, padded to one block count ``G`` and
    stacked: ``[K, G, BE]``, ``[K, G, BE]``, ``[K, G]`` on the CPU."""
    runs = list(runs)
    mats = [_segor_mat(s, t, n, "cpu") for s, t in runs]
    g = max(m[0].shape[0] for m in mats)
    mats = [m if m[0].shape[0] == g else _segor_mat(s, t, n, "cpu", min_g=g)
            for m, (s, t) in zip(mats, runs)]
    return tuple(torch.stack(x) for x in zip(*mats))


# --------------------------------------------------------------------- #
# incremental maintenance: operand patching + destabilization closure
# --------------------------------------------------------------------- #
def patch_operands(
    ops: Operands,
    c_new: CompiledSOI,
    g: Graph,
    touched_labels: set[int],
    *,
    adj_cache: dict | None = None,
    mesh=None,
) -> Operands:
    """Patch device operands in place of a full rebuild (DESIGN.md Sect. 8).

    Precondition: the delta from the operands' snapshot to ``g`` is
    *shape-stable* (no new nodes or labels) and the SOI structure is
    unchanged, so ``c_new.mats`` matches the old operator list and all
    inequality tables stay valid.  Only operators whose label appears in
    ``touched_labels`` are rebuilt against ``g``; untouched adjacency rows
    and edge lists carry over unchanged.  The edge layout (flat lists or
    blocked) keeps its superseded padded capacity whenever the new edge
    count still fits, so patched operand *shapes* stay stable.  Dense and
    packed adjacency is patched out of place: the stacked tensor may be
    shared, through ``adj_cache``, with sibling plans and with plans still
    bound to the previous snapshot, so it is never written to.  The Eq.-13
    ``init`` always refreshes (over the partitioned layout's padded node
    axis, which keeps its block count).  The shared ``adj_cache`` entry is
    re-keyed to ``g`` so sibling plans pick the patched arrays up as a hit;
    ``mesh`` is the one the partitioned operands were built over, and each
    rebuilt block goes back to its device.
    """
    device = ops.init.device
    touched = [
        m for m, (la, _) in enumerate(c_new.mats) if la in touched_labels
    ]
    init_np = np.asarray(c_new.init, bool)
    if ops.adj_dense is not None or ops.adj_packed is not None:
        packed = ops.adj_packed is not None
        adj = ops.adj_packed if packed else ops.adj_dense

        def patch_adjacency():
            if not touched:
                return adj
            rows = _adjacency(c_new, g, touched, packed, device)
            index = torch.as_tensor(touched, device=device)
            return adj.index_copy(0, index, rows)  # a new tensor

        kind = "packed" if packed else "dense"
        layout = {f"adj_{kind}": _cached_adj(
            adj_cache, (kind, tuple(c_new.mats), str(device)), g,
            patch_adjacency,
        )}
    elif ops.partitioned:
        n_pad, w = ops.init.shape[-1], ops.n_blocks
        blocked = ops.part_seg is not None
        layout = _cached_adj(
            adj_cache,
            ("partitioned", tuple(c_new.mats), w, str(device), blocked, mesh),
            g,
            lambda: _partitioned_layout(c_new, g, w, n_pad, device, blocked,
                                        mesh, touched, ops),
        )
    else:
        layout = _cached_adj(
            adj_cache, ("sparse", tuple(c_new.mats), str(device), ops.blocked),
            g, lambda: _edge_layout(c_new, g, device, ops.blocked, touched, ops),
        )
    return dataclasses.replace(
        ops, **_init_fields(init_np, device, ops.init.shape[-1]), **layout
    )


def destabilized_rows(c: CompiledSOI, inserted_labels: set[int]) -> np.ndarray:
    """SOI rows whose greatest solution can *grow* under an edge insertion.

    Returns a ``bool[n_vars]`` mask.  Seed: the LHS of every inequality
    whose operator carries an inserted label.  The seed then closes
    transitively over the dependency direction *lhs depends on rhs* (edge
    and copy inequalities alike).  Rows OUTSIDE the closure provably keep
    ``gfp_new[row] <= gfp_old[row]``, which is the soundness argument for
    re-seeding exactly the closure to ⊤ before a warm resume (DESIGN.md
    Sect. 8.2).
    """
    touched_mats = {
        m for m, (la, _) in enumerate(c.mats) if la in inserted_labels
    }
    grow = np.zeros(c.n_vars, dtype=bool)
    if not touched_mats:
        return grow
    for lhs, m in zip(c.ineq_lhs, c.ineq_mat):
        if int(m) in touched_mats:
            grow[lhs] = True
    deps = list(zip(c.ineq_lhs, c.ineq_rhs)) + list(
        zip(c.copy_lhs, c.copy_rhs)
    )
    changed = True
    while changed:
        changed = False
        for lhs, rhs in deps:
            if grow[rhs] and not grow[lhs]:
                grow[lhs] = True
                changed = True
    return grow


# --------------------------------------------------------------------- #
# packed sweep engines
# --------------------------------------------------------------------- #
_ALL_ONES = -1  # int32 with every bit set


def _and_rows(x: torch.Tensor) -> torch.Tensor:
    """AND-reduce ``[V, K, nw]`` words over K (torch has no AND reduction;
    K is the handful of inequalities one variable has per operator)."""
    out = x[:, 0]
    for k in range(1, x.shape[1]):
        out = torch.bitwise_and(out, x[:, k])
    return out


def _and_of_rows(x: torch.Tensor, rhs: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``AND_k x[rhs[table[l, k]]]`` for every row ``l`` of ``table``, on
    packed words ``[V, nw]``; an entry equal to ``len(rhs)`` points at an
    appended all-ones row (AND's identity, pad bits included).  On a
    DTensor: :func:`_sharded_and_of_rows`."""
    if isinstance(x, DTensor):
        return _sharded_and_of_rows(x, rhs, table)
    return _and_of_table(x[rhs], table)


def _and_of_table(rows: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``AND_k rows[table[l, k]]`` per row ``l`` of ``table``, the entry
    ``len(rows)`` the appended all-ones row."""
    nw = rows.shape[-1]
    vals = torch.cat([
        rows,
        torch.full((1, nw), _ALL_ONES, dtype=rows.dtype, device=rows.device),
    ])
    return _and_rows(vals[table])


def _sharded_and_of_rows(x: DTensor, rhs, table) -> DTensor:
    """:func:`_and_of_rows` of a DTensor ``x`` (chi's words, or y's), in
    ``x``'s placements, with no gather of ``x``.  Where its rows (the query
    variables) are sharded, the rows ``rhs`` names are taken as a masked
    partial sum (each row lives on one shard, zeros elsewhere) all-reduced
    over those mesh dims: ``[len(rhs), words]``, not ``x`` whole.  Each
    device then ANDs the rows of its own variables; words stay where they
    are."""
    mesh = x.device_mesh
    pl = tuple(x.placements)
    row_axes = tuple(mesh.mesh_dim_names[k] for k, p in enumerate(pl) if p == Shard(0))
    rank, n_row = ctx.shard_index(mesh, row_axes or None)
    if x.shape[0] % n_row:
        raise ValueError(f"{n_row} row shards do not divide {x.shape[0]} rows")
    vl = x.shape[0] // n_row
    lo = rank * vl
    rows = [Replicate() if p == Shard(0) else p for p in pl]
    summed = [Partial("sum") if p == Shard(0) else p for p in pl]
    rep = [Replicate()] * mesh.ndim

    def take(xl, r):
        j = r.to(torch.int64) - lo
        ok = (j >= 0) & (j < vl)
        return torch.where(ok[:, None], xl[torch.where(ok, j, 0)], 0)

    def mine(y_rhs, t):
        return _and_of_table(y_rhs, t[lo:lo + vl])

    got = ctx.local_map(take, summed, (pl, rep), mesh)(x, rhs).redistribute(mesh, rows)
    return ctx.local_map(mine, list(pl), (rows, rep), mesh)(got, table)


def _apply_copies_packed(chi_p: torch.Tensor, ops: Operands) -> torch.Tensor:
    """Copy inequalities on bit-packed chi: word-wise gathers and ANDs.

    The appended pad row is all-ones *including* trailing pad bits — AND is
    its identity, and chi's own pad bits are already zero, so no pad bit can
    ever turn on.

    A pass with copy inequalities is the span ``solve.copies`` (inside the
    caller's ``solve.sweeps``), with the inequalities and chi's rows as its
    attributes; on a card it times the pass's dispatch, not its kernels.
    """
    if ops.copy_rhs.shape[0] == 0:
        return chi_p
    t = spans.begin()
    out = torch.bitwise_and(chi_p, _and_of_rows(chi_p, ops.copy_rhs, ops.var_copy))
    spans.end("solve.copies", t, copies=ops.copy_rhs.shape[0], rows=chi_p.shape[0])
    return out


def _per_var_mask_packed(y_p: torch.Tensor, m: int, ops: Operands) -> torch.Tensor:
    """``AND_{(l,r) in ineqs_m} y[r]`` per LHS variable l, on packed words.

    ``int32 [V, nw]``; rows with no operator-m inequality are all-ones (the
    padded table entry points at an appended all-ones row); chi's pad bits
    are already zero, so no pad bit can turn on.
    """
    return _and_of_rows(y_p, ops.mat_rhs[m], ops.mat_table[m])


def _moved(new, old) -> bool:
    """Whether any word of chi moved: one read to the host.  chi is a
    tensor, or a tuple of column shards on their devices, whose flags
    gather onto the first shard's device before the read."""
    if isinstance(new, DTensor):
        return bool(torch.any(new != old).full_tensor())
    if isinstance(new, torch.Tensor):
        return bool(torch.any(new != old))
    flags = [torch.any(a != b) for a, b in zip(new, old)]
    return bool(torch.stack([f.to(flags[0].device) for f in flags]).any())


def _sweep_fixpoint(
    sweep: Callable,
    init,
    max_sweeps: int | None,
) -> tuple:
    """The fixpoint driver: iterate ``sweep`` from ``init`` until chi stops
    changing (or ``max_sweeps``), reading convergence to the host once per
    sweep.  Counts sweeps as the reference's ``lax.while_loop`` does: the
    last, unchanging sweep counts.  The sweep that reaches ``max_sweeps``
    returns without the read (so ``max_sweeps=1`` reads nothing).
    Returns (chi, n_sweeps)."""
    chi, it = init, 0
    while True:
        new = sweep(chi)
        it += 1
        if max_sweeps is not None and it >= max_sweeps:
            return new, it
        changed = _moved(new, chi)
        chi = new
        if not changed:
            return chi, it


def _packed_start(ops: Operands, chi0: torch.Tensor | None) -> torch.Tensor:
    """The sweep start: the packed Eq.-13 init, ANDed with a warm start.

    ``chi0`` may be bool ``[V, n]`` or already-packed ``int32 [V, nw]``
    words (what the plan cache's chi memo feeds back).  Every sweep only
    shrinks chi, so starting anywhere above the greatest fixpoint converges
    to exactly that fixpoint (DESIGN.md Sect. 8.2).
    """
    init_p = ops.init_packed
    if init_p is None:  # hand-built Operands: pack once, outside the loop
        init_p = bitops.pack(ops.init)
    if chi0 is None:
        return init_p
    if chi0.dtype == torch.bool:
        chi0 = bitops.pack(chi0)
    return torch.bitwise_and(init_p, chi0)


def _packed_edge_fixpoint(
    propagate: Callable[[torch.Tensor, int], torch.Tensor],
    ops: Operands,
    max_sweeps: int | None,
    chi0: torch.Tensor | None = None,
    *,
    jacobi: bool = True,
    shards: list | None = None,
    sharded: "_ShardedChi | None" = None,
) -> tuple[torch.Tensor, int]:
    """Shared driver of the packed-state edge-list engines.

    ``propagate(chi_words, m)`` is operator m's segmented OR and returns
    ``y`` already packed ``int32 [V, nw]``.  Jacobi: one frontier serves
    every operator and all per-operator shrink masks AND together.
    Gauss–Seidel (``jacobi=False``): operators apply sequentially, each
    reading the freshly-shrunk chi, in the reference's order.  Returns
    (bool chi, sweeps), unpacked once after the fixpoint.

    ``shards`` (Jacobi only) splits chi's words into column shards, each a
    ``(device, blocks, words)`` triple (:func:`_column_shards`): shard k's
    words live on its device, where its shrink masks and copy step run
    (both are column-local), and ``propagate(frontier, m, blocks)`` returns
    the shard's ``y`` words.  The one cross-device copy of a sweep is the
    frontier, replicated whole onto every shard's device
    (:func:`_replicated_frontier`).

    ``sharded`` holds chi's words as a DTensor (:class:`_ShardedChi`): the
    sweep starts from its placed words, a Jacobi sweep gathers one frontier
    that every operator reads, and the fixpoint is unpacked from it.
    """
    n = ops.init.shape[-1]
    n_mats = len(ops.mat_rhs)

    def jacobi_step(chi_p, frontier, y_of, tables):
        shrink = None
        for m in range(n_mats):
            pv = _per_var_mask_packed(y_of(frontier, m), m, tables)
            shrink = pv if shrink is None else torch.bitwise_and(shrink, pv)
        if shrink is not None:
            chi_p = torch.bitwise_and(chi_p, shrink)
        return _apply_copies_packed(chi_p, tables)

    if shards is not None:
        start = _packed_start(ops, chi0)
        home = start.device
        tables = [_tables_on(ops, dev) for dev, _, _ in shards]
        y_of = [
            lambda f, m, blocks=blocks: propagate(f, m, blocks)
            for _, blocks, _ in shards
        ]

        def sweep_shards(parts: tuple) -> tuple:
            frontier = _replicated_frontier(parts, [d for d, _, _ in shards])
            return tuple(
                jacobi_step(p, f, y, t)
                for p, f, y, t in zip(parts, frontier, y_of, tables)
            )

        parts, it = _sweep_fixpoint(
            sweep_shards,
            tuple(start[:, words].to(dev) for dev, _, words in shards),
            max_sweeps,
        )
        chi_p = torch.cat([p.to(home) for p in parts], dim=1)
        return bitops.unpack(chi_p, n), it

    if sharded is not None and chi0 is not None:
        raise NotImplementedError("a sharded sweep starts from the init alone")
    if jacobi:

        def sweep(chi_p: torch.Tensor) -> torch.Tensor:
            frontier = chi_p if sharded is None else sharded.frontier(chi_p)
            return jacobi_step(chi_p, frontier, propagate, ops)

    else:

        def sweep(chi_p: torch.Tensor) -> torch.Tensor:
            for m in range(n_mats):
                y_p = propagate(chi_p, m)
                chi_p = torch.bitwise_and(chi_p, _per_var_mask_packed(y_p, m, ops))
            return _apply_copies_packed(chi_p, ops)

    if sharded is not None:
        chi_p, it = _sweep_fixpoint(sweep, sharded.start(ops.init), max_sweeps)
        return sharded.unpack(chi_p, n), it
    chi_p, it = _sweep_fixpoint(sweep, _packed_start(ops, chi0), max_sweeps)
    return bitops.unpack(chi_p, n), it


@dataclasses.dataclass(frozen=True)
class _ShardedChi:
    """chi's packed words as a DTensor through a sharded sweep.

    ``placements`` on ``mesh``: the rows (query variables) ``Shard(0)`` on
    some mesh dims, the words ``Shard(1)`` on others; the words are padded
    with zero words to ``n_words`` so that every shard is even.
    ``frontier_placements`` are those of the copy a segmented OR reads: the
    words gathered on every mesh dim (the rows stay split).
    """

    mesh: object
    placements: tuple
    n_words: int
    frontier_placements: tuple

    def _aligned(self, n: int) -> bool:
        """Whether ``n`` bool columns split as the words are: each shard's
        columns are exactly the bits of its words."""
        return n == self.n_words * bitops.WORD

    def start(self, init: torch.Tensor) -> DTensor:
        """The packed words of ``init`` (bool ``[V, n]``), placed: each
        device packs only the words it holds (from its own columns where
        they split as the words do, else from its rows' columns)."""
        axes = tuple(self.mesh.mesh_dim_names[k]
                     for k, p in enumerate(self.placements) if p == Shard(1))
        k, n_c = ctx.shard_index(self.mesh, axes or None)
        nwl = self.n_words // n_c
        aligned = self._aligned(init.shape[-1])

        def local(bits):
            if not aligned:
                bits = bits[:, k * nwl * bitops.WORD:(k + 1) * nwl * bitops.WORD]
            part = bitops.pack(bits)
            return torch.nn.functional.pad(part, (0, nwl - part.shape[1]))

        rows = self.placements if aligned else self.frontier_placements
        return ctx.local_map(local, list(self.placements), (rows,), self.mesh)(
            ctx.as_dtensor(init, self.mesh))

    def frontier(self, chi_p: DTensor) -> DTensor:
        """The copy of chi's words a segmented OR reads: one all-gather of
        the words."""
        return chi_p.redistribute(self.mesh, self.frontier_placements)

    def unpack(self, chi_p: DTensor, n: int) -> DTensor:
        """Bool chi ``[V, n]``, unpacked on each device a byte an
        intermediate element: split as the words are where the columns
        align with them, else with the words gathered first (its rows
        split as chi's)."""
        aligned = self._aligned(n)
        rows = self.placements if aligned else self.frontier_placements

        def local(w):
            return bitops.unpack(w, w.shape[1] * bitops.WORD if aligned else n)

        return ctx.local_map(local, list(rows), (rows,), self.mesh)(chi_p)


def _present(axes, mesh) -> tuple[str, ...]:
    """The mesh axes among ``axes`` (a name, a tuple of names or None)
    that ``mesh`` has."""
    names = mesh.mesh_dim_names
    group = () if axes is None else (axes,) if isinstance(axes, str) else tuple(axes)
    return tuple(a for a in group if a in names)


def _sparse_chi(ops: Operands, mesh, chi_spec) -> _ShardedChi:
    """chi's layout for a sharded ``sparse`` sweep: ``chi_spec``, a
    :class:`~repro_torch.distributed.shard.P` over chi's ``(rows, words)``
    (the reference's ``chi_spec``; axes the mesh lacks are dropped, and row
    axes that do not divide the rows)."""
    if chi_spec is None:
        raise ValueError("a sparse sweep over DTensor operands needs chi_spec")
    v, n = ops.init.shape
    rows = sh.safe_spec((v,), sh.P(_present(chi_spec[0], mesh) or None), mesh)[0]
    words = _present(chi_spec[1], mesh) if len(chi_spec) > 1 else ()
    placements = sh.to_placements(sh.P(rows, words or None), mesh)
    n_c = sh.axis_size(mesh, words)
    n_words = -(-bitops.packed_width(n) // n_c) * n_c
    return _ShardedChi(mesh, placements, n_words,
                       tuple(Shard(0) if p == Shard(0) else Replicate() for p in placements))


def _edge_placements(chi_placements) -> list:
    """The placements of a sharded sweep's edges, flat or blocked:
    ``Shard(0)`` on the mesh dims that split chi's words, replicated on the
    rest (those that split chi's rows, and those chi is replicated on), so
    each group of devices that shares chi's rows holds every edge once."""
    return [Shard(0) if p == Shard(1) else Replicate() for p in chi_placements]


def _segor_sharded(frontier_p: DTensor, edges: tuple, lanes_of: Callable) -> DTensor:
    """The segmented OR of one operator on DTensors: chi's words in
    ``frontier_p``'s placements.

    ``frontier_p`` holds chi's words ``[V, nw]`` in chi's placements: the
    rows (the query variables) ``Shard(0)`` on some mesh dims, the words
    ``Shard(1)`` on others.  ``edges`` are laid out by
    :func:`_edge_placements`.  Each device gathers the words of its own rows
    (an all-gather over the word dims) and ``lanes_of(words, *edges)``
    reduces its edges into ``uint8 [nw, 32, V_local]`` lanes over every node
    of its own variables, one byte an element; the partials are
    max-reduced and scattered so that each device keeps the words it owns
    (a reduce-scatter over the word dims), which it packs."""
    mesh = frontier_p.device_mesh
    cpl = tuple(frontier_p.placements)
    rows = [Shard(0) if p == Shard(0) else Replicate() for p in cpl]
    lanes = [Shard(0) if p == Shard(1) else Shard(2) if p == Shard(0) else Replicate()
             for p in cpl]
    partial = [Partial("max") if p == Shard(1) else q for p, q in zip(cpl, lanes)]
    epl = _edge_placements(cpl)
    y = ctx.local_map(lanes_of, partial, (rows, *(epl,) * len(edges)), mesh)(
        frontier_p, *edges)
    y = y.redistribute(mesh, lanes)
    return ctx.local_map(segsum_ref.pack_lanes, list(cpl), (lanes,), mesh)(y)


def _blocked_lanes(n: int) -> Callable:
    """A device's lanes (:func:`_segor_sharded`) from its edges in the
    blocked layout: one :func:`repro_torch.kernels.segsum.kernel.segor_blocks`
    call (on a card, the CUDA kernel), its words unpacked a byte a bit."""

    def lanes_of(f, src_b, dst_b, win):
        v, nw = f.shape
        words = segsum_kernel.segor_blocks(f.contiguous(), src_b, dst_b, win,
                                           num_segments=n, num_sources=nw * bitops.WORD)
        words = torch.nn.functional.pad(words, (0, nw - words.shape[1]))
        bits = bitops.unpack(words, nw * bitops.WORD).T.contiguous()
        return bits.view(torch.uint8).view(nw, bitops.WORD, v)

    return lanes_of


def _flat_lanes(n: int) -> Callable:
    """A device's lanes (:func:`_segor_sharded`) from its flat edge lists,
    in plain torch (the CPU's)."""

    def lanes_of(f, src, dst):
        return segsum_ref.segor_lanes(_edge_bits(f, src), dst, n, f.shape[1])

    return lanes_of


def solve_sparse(
    ops: Operands, *, max_sweeps: int | None = None,
    mode: str = "gs", chi0: torch.Tensor | None = None, chi_spec=None,
) -> tuple[torch.Tensor, int]:
    """Edge-list engine: segmented-OR message passing over bit-packed chi.

    ``mode="gs"`` (Gauss–Seidel, the paper's SOI order) or
    ``"jacobi_packed"`` (all operators read one frontier a sweep).  The two
    take different sweep counts to the same (unique) greatest
    fixpoint.  The blocked layout runs through ``segor_blocks`` (on a card,
    always: the CUDA kernel), the flat edge lists through plain torch ops
    on the CPU.  Returns (bool chi ``[V, n]``, sweeps).

    DTensor operands (:func:`shard_operands`) run the sharded sweep:
    chi's words are split as ``chi_spec`` says (:func:`_sparse_chi`; it is
    required there), flat edges are laid out once a solve by
    :func:`_edge_placements` (blocked ones must already be), and each
    operator is :func:`_segor_sharded`, whose device-local reduce is the
    same ``segor_blocks`` call or plain reduce.  The result is a DTensor
    whose rows are split as chi's.
    """
    n = ops.init.shape[-1]
    if ops.edge_src is None and not ops.blocked:
        raise ValueError("solve_sparse needs an edge layout")
    if mode not in ("gs", "jacobi_packed"):
        raise ValueError(f"unknown sparse mode {mode!r}")
    edges = (tuple(zip(ops.seg_src_b, ops.seg_dst_b, ops.seg_win)) if ops.blocked
             else tuple(zip(ops.edge_src, ops.edge_dst)))
    mesh = _mesh_of(ops.init, *(e[0] for e in edges))
    sharded = None if mesh is None else _sparse_chi(ops, mesh, chi_spec)
    if sharded is not None:
        epl = _edge_placements(sharded.placements)
        if ops.blocked:
            if any(list(t.placements) != epl for e in edges for t in e):
                raise ValueError(f"blocked edges must be placed {epl} for chi's "
                                 f"{sharded.placements} (shard_operands)")
        else:
            edges = tuple(tuple(ctx.as_dtensor(t, mesh).redistribute(mesh, epl) for t in e)
                          for e in edges)
        lanes_of = _blocked_lanes(n) if ops.blocked else _flat_lanes(n)

    def propagate(frontier_p: torch.Tensor, m: int) -> torch.Tensor:
        if sharded is not None:
            return _segor_sharded(frontier_p, edges[m], lanes_of)
        if ops.blocked:
            return segsum_kernel.segor_blocks(frontier_p, *edges[m], num_segments=n)
        msgs = _edge_bits(frontier_p, ops.edge_src[m])  # int32 [V, E_m]
        return segsum_ref.segor_words(msgs, ops.edge_dst[m], n)

    return _packed_edge_fixpoint(
        propagate, ops, max_sweeps, chi0, jacobi=(mode != "gs"), sharded=sharded
    )


def _mesh_of(*tensors):
    """The device mesh of the first DTensor among ``tensors``, else None."""
    for t in tensors:
        if isinstance(t, DTensor):
            return t.device_mesh
    return None


@dataclasses.dataclass(frozen=True)
class _Tables:
    """The index tables of :class:`Operands` that the shrink mask and the
    copy step read, copied onto one shard's device."""

    mat_rhs: tuple
    mat_table: tuple
    copy_rhs: torch.Tensor
    var_copy: torch.Tensor


def _tables_on(ops: Operands, device):
    """The inequality and copy tables a shard's column-local steps read,
    on ``device`` (``ops`` itself where they already live there)."""
    if device == ops.copy_rhs.device:
        return ops
    return _Tables(
        mat_rhs=tuple(t.to(device) for t in ops.mat_rhs),
        mat_table=tuple(t.to(device) for t in ops.mat_table),
        copy_rhs=ops.copy_rhs.to(device),
        var_copy=ops.var_copy.to(device),
    )


def _replicated_frontier(parts: tuple, devices: list) -> list:
    """Replicate the packed chi words across the mesh: the whole frontier
    on each shard's device, from the column shards ``parts``.  One
    ``n/8``-byte copy a device serves every operator of a Jacobi sweep;
    shards on one device share one copy."""
    whole: dict = {}
    for dev in devices:
        if dev not in whole:
            whole[dev] = torch.cat([p.to(dev) for p in parts], dim=1)
    return [whole[dev] for dev in devices]


def _column_shards(n_blocks: int, nlw: int, mesh) -> list:
    """The column shards of chi over ``mesh``: ``(device, blocks, words)``
    per mesh position that holds a block, in block order (blocks placed
    as :func:`_block_devices` places them, ``nlw`` words a block)."""
    shards = []
    for k, dev in enumerate(mesh.devices):
        blocks = [b for b in range(n_blocks)
                  if _block_shard(b, n_blocks, mesh.size) == k]
        if blocks:
            shards.append((dev, range(blocks[0], blocks[-1] + 1),
                           slice(blocks[0] * nlw, (blocks[-1] + 1) * nlw)))
    return shards


def _sharded_block_words(frontier_p, blocks: tuple, n_local: int, n: int):
    """The packed words of every destination block, on DTensor blocks split
    along their first dim W: each shard reduces its own blocks against the
    whole frontier (``frontier_p``, replicated once a sweep by the caller
    and read by every operator) and holds their words, block-major, as its
    columns of ``[V, W * n_local / 32]``.  ``blocks`` is one operator's
    blocked triple (``part_seg``'s stacked form; a ``segor_blocks`` call a
    block, on a card the CUDA kernel) or its flat pair ``[W, Eb]`` (the
    CPU's, a plain reduce a block)."""
    mesh = blocks[0].device_mesh
    bpl = tuple(blocks[0].placements)
    opl = [Shard(1) if isinstance(pl, Shard) else Replicate() for pl in bpl]

    def local(f, *b):
        if len(b) == 3:
            f = f.contiguous()
            words = [segsum_kernel.segor_blocks(f, b[0][i], b[1][i], b[2][i],
                                                num_segments=n_local, num_sources=n)
                     for i in range(b[0].shape[0])]
        else:
            words = [segsum_ref.segor_words(_edge_bits(f, b[0][i]), b[1][i], n_local)
                     for i in range(b[0].shape[0])]
        return torch.cat(words, dim=1)

    rep = (Replicate(),) * mesh.ndim
    return ctx.local_map(local, opl, (rep, *(bpl,) * len(blocks)), mesh)(frontier_p, *blocks)


def _partitioned_chi(ops: Operands, blocks: tuple) -> _ShardedChi:
    """chi's layout for a partitioned sweep over DTensor blocks (``blocks``
    one operator's): the words split as the blocks are (block w's words
    where block w lives), the frontier replicated whole."""
    mesh = blocks[0].device_mesh
    placements = tuple(Shard(1) if isinstance(p, Shard) else Replicate()
                       for p in blocks[0].placements)
    return _ShardedChi(mesh, placements, ops.init.shape[-1] // bitops.WORD,
                       (Replicate(),) * mesh.ndim)


def solve_partitioned(
    ops: Operands, *, max_sweeps: int | None = None,
    chi0: torch.Tensor | None = None, mesh=None,
) -> tuple[torch.Tensor, int]:
    """Vertex-cut partitioned engine: Jacobi sweeps over destination blocks.

    Edges are pre-partitioned by destination block
    (:func:`make_partitioned_operands`), so every segmented OR is
    block-local and emits the block's packed words ``[V, n_local / 32]``
    directly; the block size is a 32-multiple, so block words concatenate
    into the global word order.  A block's reduce is one
    :func:`repro_torch.kernels.segsum.kernel.segor_blocks` call over its
    segmented-OR layout (on a card, always the CUDA kernel: ``n_local``
    destinations, the whole ``n_pad``-source frontier), or the word-wise
    plain torch reduce over the CPU's flat ``[W, Eb]`` blocks.

    Without ``mesh`` every block runs on the operands' device.  With
    ``mesh`` (a :class:`repro_torch.distributed.ctx.NodeMesh`; the
    operands built over it), chi's columns split into the mesh's shards,
    block w's columns on block w's device, where its reduces, shrink masks
    and copy step run; the only cross-device traffic of a sweep is
    replicating the packed chi words, plus the host's one convergence
    read.  Same fixpoint as the other engines.  Returns (bool chi ``[V,
    n_pad]``, sweeps).

    DTensor blocks (:func:`shard_operands`; flat on the CPU, the stacked
    blocked triple on a card) run the sharded sweep: chi's words split as
    the blocks are, one copy of the frontier a sweep that every operator
    reads (:func:`_sharded_block_words`).
    """
    if not ops.partitioned:
        raise ValueError("solve_partitioned needs partitioned operands "
                         "(make_partitioned_operands)")
    v, n = ops.init.shape
    w = ops.n_blocks
    n_local = n // w if w else n
    if n_local % bitops.WORD:
        raise ValueError(
            "partitioned operands need 32-aligned blocks "
            f"(n={n}, n_blocks={w}); build them via make_partitioned_operands"
        )

    def block_words(frontier_p: torch.Tensor, m: int, b: int) -> torch.Tensor:
        if ops.part_seg is not None:
            src_b, dst_b, win = ops.part_seg[m][b]
            return segsum_kernel.segor_blocks(
                frontier_p, src_b, dst_b, win,
                num_segments=n_local, num_sources=n,
            )
        msgs = _edge_bits(frontier_p, ops.edge_src_b[m][b])  # [V, Eb]
        # pad rows (dst = n_local) dropped by the segment reduce
        return segsum_ref.segor_words(msgs, ops.edge_dst_b[m][b], n_local)

    # per operator: the flat pair, or the blocked triple(s)
    per_mat = (tuple(zip(ops.edge_src_b, ops.edge_dst_b)) if ops.part_seg is None
               else ops.part_seg)
    sharded = (_partitioned_chi(ops, per_mat[0])
               if per_mat and isinstance(per_mat[0][0], DTensor) else None)

    def propagate_blocks(frontier_p: torch.Tensor, m: int, blocks) -> torch.Tensor:
        if sharded is not None:
            return _sharded_block_words(frontier_p, per_mat[m], n_local, n)
        return torch.cat([block_words(frontier_p, m, b) for b in blocks], dim=1)

    if mesh is None or not w:
        return _packed_edge_fixpoint(
            lambda f, m: propagate_blocks(f, m, range(w)), ops, max_sweeps,
            chi0, jacobi=True, sharded=sharded,
        )
    return _packed_edge_fixpoint(
        propagate_blocks, ops, max_sweeps, chi0, jacobi=True,
        shards=_column_shards(w, n_local // bitops.WORD, mesh),
    )


# --------------------------------------------------------------------- #
# the dense-adjacency tier
# --------------------------------------------------------------------- #
def _per_var_mask(y: torch.Tensor, m: int, ops: Operands) -> torch.Tensor:
    """``AND_{(l,r) in ineqs_m} y[r]`` per LHS variable l (gathers only).

    Bool ``[V, n]``; rows with no operator-m inequality are all-True (the
    padded table entry points at an appended all-ones row).
    """
    n = y.shape[-1]
    vals = torch.cat([
        y[ops.mat_rhs[m]],
        torch.ones((1, n), dtype=torch.bool, device=y.device),
    ])
    return vals[ops.mat_table[m]].all(dim=1)


def _apply_mat(
    chi: torch.Tensor, y: torch.Tensor, m: int, ops: Operands
) -> torch.Tensor:
    """``chi[l] &= y[rhs_l]`` for every inequality of operator m."""
    return torch.logical_and(chi, _per_var_mask(y, m, ops))


def _apply_copies(chi: torch.Tensor, ops: Operands) -> torch.Tensor:
    """Copy inequalities on bool chi."""
    if ops.copy_rhs.shape[0] == 0:
        return chi
    n = chi.shape[-1]
    cvals = torch.cat([
        chi[ops.copy_rhs],
        torch.ones((1, n), dtype=torch.bool, device=chi.device),
    ])
    return torch.logical_and(chi, cvals[ops.var_copy].all(dim=1))


def _warm_init(ops: Operands, chi0: torch.Tensor | None) -> torch.Tensor:
    """The bool sweep start: the Eq.-13 init, ANDed with a warm start
    ``chi0`` (a previous fixpoint, re-seeded by the caller where an
    insertion may grow the solution — :func:`destabilized_rows`)."""
    if chi0 is None:
        return ops.init
    return torch.logical_and(ops.init, chi0)


def _fixpoint(
    propagate_m: Callable[[torch.Tensor, int], torch.Tensor],
    ops: Operands,
    max_sweeps: int | None,
    chi0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, int]:
    """Gauss–Seidel sweeps over bool chi: one product ``y = chi ×b M_m``
    per operator m (all variables batched), AND-updates applied at once —
    one y tensor live at a time."""
    n_mats = len(ops.mat_rhs)

    def sweep(chi: torch.Tensor) -> torch.Tensor:
        for m in range(n_mats):
            chi = _apply_mat(chi, propagate_m(chi, m), m, ops)
        return _apply_copies(chi, ops)

    return _sweep_fixpoint(sweep, _warm_init(ops, chi0), max_sweeps)


def solve_dense(
    ops: Operands, *, max_sweeps: int | None = None,
    chi0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, int]:
    """Sweeps with dense boolean products: OR-AND as an f32 ``(+, x)``
    matrix product followed by ``> 0``.  Returns (bool chi, sweeps)."""
    if ops.adj_dense is None:
        raise ValueError("solve_dense needs dense adjacency (adj_dense)")

    def propagate_m(chi: torch.Tensor, m: int) -> torch.Tensor:
        # 0 and 1 are exact in f32 and in TF32, and every sum is an integer
        # of at most n <= 46,340 < 2**24, so the product is exact whether or
        # not the card runs it in TF32
        y = chi.to(torch.float32) @ ops.adj_dense[m].to(torch.float32)
        return y > 0

    return _fixpoint(propagate_m, ops, max_sweeps, chi0)


def solve_packed(
    ops: Operands, *, max_sweeps: int | None = None,
    chi0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, int]:
    """Sweeps over bit-packed adjacency through ``bitmm`` (the CUDA kernel
    ``bitmm_packed`` on a card, its plain version on the CPU).

    chi itself stays bool between launches: this is the baseline the fused
    engine (:func:`solve_packed_fused`) is measured against.  Returns (bool
    chi, sweeps).
    """
    if ops.adj_packed is None:
        raise ValueError("solve_packed needs packed adjacency (adj_packed)")

    def propagate_m(chi: torch.Tensor, m: int) -> torch.Tensor:
        return bitmm_kernel.bitmm(chi, ops.adj_packed[m])

    return _fixpoint(propagate_m, ops, max_sweeps, chi0)


def solve_packed_fused(
    ops: Operands, *, max_sweeps: int | None = None,
    chi0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, int]:
    """Bit-packed chi end to end: one fused launch per operator application.

    The loop carries ``int32 [V, nw]`` words; every sweep is M
    ``bitmm_apply`` calls (packed product + AND-combine + changed word; the
    CUDA kernel ``bitmm_apply_packed`` on a card) plus the word-wise copy
    step.  A sweep moved iff a kernel's changed word is nonzero or the copy
    step moved a word, read to the host once per sweep; ``max_sweeps`` caps
    the count as in :func:`_sweep_fixpoint`.  chi is unpacked once, after
    the fixpoint.  Returns (bool chi, sweeps).
    """
    if ops.adj_packed is None or ops.mat_lhs_flags is None:
        raise ValueError(
            "solve_packed_fused needs packed adjacency and mat_lhs_flags"
        )
    n = ops.init.shape[-1]
    n_mats = len(ops.mat_rhs)
    chi_p, it = _packed_start(ops, chi0), 0
    while True:
        changed = None
        for m in range(n_mats):
            chi_p, ch = bitmm_kernel.bitmm_apply(
                chi_p, ops.adj_packed[m], ops.mat_lhs_flags[m]
            )
            changed = ch if changed is None else torch.bitwise_or(changed, ch)
        before = chi_p
        chi_p = _apply_copies_packed(chi_p, ops)
        moved = torch.any(chi_p != before)
        if changed is not None:
            moved = torch.logical_or(moved, changed != 0)
        it += 1
        if not bool(moved) or (max_sweeps is not None and it >= max_sweeps):
            return bitops.unpack(chi_p, n), it


# --------------------------------------------------------------------- #
# the paper's sequential worklist engine (numpy reference)
# --------------------------------------------------------------------- #
def solve_worklist(
    c: CompiledSOI,
    g: Graph,
    *,
    heuristic: str = "sparse_first",
    eq13_init: bool = True,
) -> tuple[np.ndarray, int]:
    """Paper Sect. 3.2 algorithm: pick an unstable inequality, validate or
    update, destabilize dependents.  Heuristics from Sect. 3.3:

    * ``sparse_first`` — static order preferring operators with more empty
      columns (sparser matrices shrink the relation earlier);
    * ``fifo`` — arrival order;
    * row- vs column-wise evaluation of ``r`` chosen dynamically by comparing
      ``|chi(rhs)|`` with ``|chi(lhs)|``.

    Returns (chi, number of inequality evaluations).
    """
    n = g.n_nodes
    chi = (
        c.init.copy()
        if eq13_init
        else _eq12_init(c, g)
    )
    ineqs = list(zip(c.ineq_lhs, c.ineq_rhs, c.ineq_mat))
    copies = list(zip(c.copy_lhs, c.copy_rhs))

    # CSR per operator for row-wise evaluation.
    csr: list[tuple[np.ndarray, np.ndarray]] = []
    csc: list[tuple[np.ndarray, np.ndarray]] = []
    nonempty_cols: list[int] = []
    for a, d in c.mats:
        e = g.edges_for_label(a)
        s, t = (e[:, 0], e[:, 1]) if d == FWD else (e[:, 1], e[:, 0])
        csr.append(_csr(s, t, n))
        csc.append(_csr(t, s, n))
        nonempty_cols.append(len(np.unique(t)))

    if heuristic == "sparse_first":
        order = sorted(range(len(ineqs)), key=lambda i: nonempty_cols[ineqs[i][2]])
    else:
        order = list(range(len(ineqs)))

    # dependents: inequalities whose rhs is a given variable.
    dep_edge: list[list[int]] = [[] for _ in range(c.n_vars)]
    for i, (_, r, _) in enumerate(ineqs):
        dep_edge[r].append(i)
    dep_copy: list[list[int]] = [[] for _ in range(c.n_vars)]
    for i, (_, r) in enumerate(copies):
        dep_copy[r].append(i)

    unstable = set(range(len(ineqs)))
    unstable_c = set(range(len(copies)))
    evaluations = 0
    while unstable or unstable_c:
        if unstable:
            idx = next(i for i in order if i in unstable)
            unstable.discard(idx)
            l, r, m = ineqs[idx]
            evaluations += 1
            rr = _bit_product(chi[r], chi[l], csr[m], csc[m], n)
            new = chi[l] & rr
            if not np.array_equal(new, chi[l]):
                chi[l] = new
                # destabilize dependents (rhs == l); a self-loop inequality
                # (l == r) legitimately re-enters the worklist here.
                unstable.update(dep_edge[l])
                unstable_c.update(dep_copy[l])
        else:
            idx = unstable_c.pop()
            l, r = copies[idx]
            evaluations += 1
            new = chi[l] & chi[r]
            if not np.array_equal(new, chi[l]):
                chi[l] = new
                unstable.update(dep_edge[l])
                unstable_c.update(dep_copy[l])
    return chi, evaluations


def _eq12_init(c: CompiledSOI, g: Graph) -> np.ndarray:
    init = np.ones((c.n_vars, g.n_nodes), dtype=bool)
    for i, const in enumerate(c.soi.is_const):
        if const is not None:
            init[i] = c.init[i]
    # labels absent from the DB still force emptiness
    for i in range(c.n_vars):
        if not c.init[i].any():
            init[i] = False
    return init


def _csr(src: np.ndarray, dst: np.ndarray, n: int):
    order = np.argsort(src, kind="stable")
    s, t = src[order], dst[order]
    ptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(ptr, s + 1, 1)
    np.cumsum(ptr, out=ptr)
    return ptr, t.astype(np.int32)


def _bit_product(
    x: np.ndarray, lhs: np.ndarray, csr, csc, n: int
) -> np.ndarray:
    """r = x ×b A, evaluated row- or column-wise per the paper's heuristic."""
    if x.sum() <= lhs.sum():
        # row-wise: union the A-rows of set bits of x.
        ptr, idx = csr
        out = np.zeros(n, dtype=bool)
        for i in np.flatnonzero(x):
            out[idx[ptr[i] : ptr[i + 1]]] = True
        return out
    # column-wise: only decide the columns where lhs is set.
    ptr, idx = csc
    out = np.zeros(n, dtype=bool)
    for j in np.flatnonzero(lhs):
        out[j] = x[idx[ptr[j] : ptr[j + 1]]].any()
    return out


# --------------------------------------------------------------------- #
# high-level API
# --------------------------------------------------------------------- #
EDGE_ENGINES = ("sparse", "jacobi_packed", "partitioned")
DENSE_TIER_ENGINES = ("dense", "packed", "packed_fused")
ENGINES = DENSE_TIER_ENGINES + EDGE_ENGINES


def pattern_graph_soi(pattern: Graph) -> SOI:
    """SOI for classic graph-to-graph dual simulation (pattern = G1)."""
    from .sparql import BGP, Triple, Var

    trs = tuple(
        Triple(Var(f"v{s}"), int(a), Var(f"v{o}"))
        for (s, a, o) in pattern.triples
    )
    return build_soi(BGP(trs))


def largest_dual_simulation(
    pattern: Graph,
    db: Graph,
    *,
    engine: str = "sparse",
    device=DEFAULT_DEVICE,
    n_blocks: int = 4,
) -> tuple[np.ndarray, int]:
    """Largest dual simulation between ``pattern`` and ``db`` (Prop. 1).

    Returns ``(S, sweeps)`` with ``S`` a bool matrix of shape
    ``(pattern.n_nodes, db.n_nodes)``: ``S[v, x]`` iff x dual-simulates v.
    """
    soi = pattern_graph_soi(pattern)
    # map var ids back to pattern node order: vars are created in triple
    # order, so build the permutation explicitly.  Isolated pattern nodes
    # (no incident edges) are unconstrained: simulated by every db node.
    c = compile_soi(soi, db)
    seen = {b: i for i, b in enumerate(soi.base)}
    isolated = [n for n in range(pattern.n_nodes) if f"v{n}" not in seen]

    def reorder(chi: np.ndarray) -> np.ndarray:
        out = np.ones((pattern.n_nodes, db.n_nodes), dtype=bool)
        for node in range(pattern.n_nodes):
            if node not in isolated:
                out[node] = chi[seen[f"v{node}"]]
        return out

    chi, it = solve_compiled(c, db, engine=engine, device=device,
                             n_blocks=n_blocks)
    return reorder(chi), it


def solve_compiled(
    c: CompiledSOI,
    g: Graph,
    *,
    engine: str = "sparse",
    chi0: np.ndarray | None = None,
    device=DEFAULT_DEVICE,
    n_blocks: int = 4,
) -> tuple[np.ndarray, int]:
    """Solve a compiled SOI with the chosen engine; returns (chi, iters).

    Engines: ``dense``, ``packed``, ``packed_fused`` (bit-packed chi end to
    end through the fused ``bitmm_apply``), ``sparse`` (Gauss–Seidel),
    ``jacobi_packed`` (one frontier per sweep), ``partitioned``
    (destination-partitioned edge blocks over packed chi; ``n_blocks``
    blocks, node axis padded), ``worklist`` (numpy reference, host only).
    ``chi0`` warm-starts any other engine from a previous fixpoint (callers
    are responsible for the re-seeding rule — use :func:`resume_fixpoint`
    for the safe path).
    """
    if engine == "worklist":
        if chi0 is not None:
            raise ValueError("the worklist engine does not take a warm start")
        return solve_worklist(c, g)
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    device = resolve_device(device)
    if chi0 is not None:
        chi0 = torch.as_tensor(np.asarray(chi0, dtype=bool), device=device)
    if engine == "dense":
        chi, it = solve_dense(make_dense_operands(c, g, device=device),
                              chi0=chi0)
    elif engine == "packed":
        chi, it = solve_packed(make_packed_operands(c, g, device=device),
                               chi0=chi0)
    elif engine == "packed_fused":
        chi, it = solve_packed_fused(
            make_packed_operands(c, g, device=device), chi0=chi0
        )
    elif engine == "partitioned":
        ops = make_partitioned_operands(c, g, n_blocks, device=device)
        if chi0 is not None and chi0.shape[-1] != ops.init.shape[-1]:
            chi0 = torch.nn.functional.pad(
                chi0, (0, ops.init.shape[-1] - chi0.shape[-1])
            )
        chi, it = solve_partitioned(ops, chi0=chi0)
        chi = chi[:, : g.n_nodes]  # drop block-padding columns
    else:
        chi, it = solve_sparse(
            make_sparse_operands(c, g, device=device),
            mode=("gs" if engine == "sparse" else "jacobi_packed"),
            chi0=chi0,
        )
    return chi.cpu().numpy(), it


def resume_fixpoint(
    c: CompiledSOI,
    g: Graph,
    chi0: np.ndarray,
    *,
    inserted_labels: set[int] | frozenset[int] = frozenset(),
    engine: str = "sparse",
    device=DEFAULT_DEVICE,
    n_blocks: int = 4,
) -> tuple[np.ndarray, int]:
    """Warm-started fixpoint: resume from a previous snapshot's solution.

    ``chi0`` is the greatest solution computed against the *previous* graph
    snapshot; ``c`` is the SOI re-compiled against the mutated graph ``g``.
    Deletions only shrink the solution, so resuming from ``chi0 ∧ init_new``
    is exact; for insertions, rows in the :func:`destabilized_rows` closure
    of the inserted labels are re-seeded to ⊤ first (DESIGN.md 8.2).

    Returns ``(chi, sweeps)`` bit-identical to a cold solve on ``g``.
    """
    chi0 = np.array(chi0, dtype=bool, copy=True)
    if inserted_labels:
        chi0[destabilized_rows(c, set(inserted_labels))] = True
    return solve_compiled(c, g, engine=engine, chi0=chi0, device=device,
                          n_blocks=n_blocks)
