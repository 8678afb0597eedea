"""ArchSpec for the paper's own workloads: dual-simulation query processing
over LUBM-scale and DBpedia-scale graph databases (dry-run).

Cells (all ``kind="dualsim"``):

* ``q_sparse``       — one query (paper-faithful SOI sweep), sparse engine.
* ``batch16_sparse`` — 16 constant-parameterized instances of one query
  template solved together (disjoint-union batching), the serving regime.
* ``block_dense``    — dense engine on a 16k-node partition block (the
  bit-matrix regime the paper's Sect. 3.2 engineering targets).
* ``q_partitioned``  — destination-partitioned (vertex-cut) edge blocks +
  one bit-packed frontier broadcast per sweep.

The operands are abstract: fake CPU tensors (``FakeTensorMode``: shape
and dtype, no storage), as :class:`~repro_torch.core.dualsim.Operands`
holds the flat edge lists only on the CPU.  The edge engines take the flat
per-operator edge lists, the layout the port's plain path runs (the
blocked layout of the CUDA kernel is built on the host from real edges),
as the JAX package's dry-run lowers its plain path.  The port's fixpoint
is a host loop with one convergence read a sweep, which an abstract trace
cannot answer, so ``step`` runs one sweep (``max_sweeps=1``, which reads
nothing) and ``hlo_trip_factor`` multiplies it by the sweeps it stands
for: the paper's ~5 Gauss–Seidel sweeps, ~10 for the Jacobi-style
partitioned engine.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core import dualsim
from repro_torch.distributed import shard as sh
from repro_torch.distributed.shard import P
from .base import Cell


def sds(shape, dtype) -> torch.Tensor:
    """An abstract CPU tensor: ``shape`` and ``dtype``, no storage."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return torch.empty(tuple(int(x) for x in shape), dtype=dtype)


@dataclasses.dataclass(frozen=True)
class DualsimScale:
    n_nodes: int
    edges_per_mat: tuple[int, ...]  # one entry per (label, dir) operator
    n_vars: int
    n_ineqs: int
    n_copies: int = 0


class DualsimArch:
    family = "dualsim"

    def __init__(self, arch_id: str, scale: DualsimScale, batch16_nodes: int,
                 dense_block: int = 16384):
        self.id = arch_id
        self.scale = scale
        self.batch16_nodes = batch16_nodes
        self.dense_block = dense_block

    def cells(self) -> dict[str, Cell]:
        return {
            "q_sparse": Cell("q_sparse", "dualsim"),
            "batch16_sparse": Cell("batch16_sparse", "dualsim",
                                   extras=dict(n_queries=16)),
            "block_dense": Cell("block_dense", "dualsim"),
            "q_partitioned": Cell("q_partitioned", "dualsim",
                                  extras=dict(n_blocks=256)),
        }

    def skip_reason(self, cell_name: str) -> str | None:
        return None

    # ------------------------------------------------------------------ #
    def _abstract_operands(self, n_nodes: int, dense: bool,
                           q: int = 1) -> dualsim.Operands:
        """q > 1 = disjoint-union batching: q constant-parameterized copies
        of the query template solved as one SOI (n_vars and the per-operator
        inequality counts scale by q; edges are shared)."""
        s = self.scale
        n_mats = len(s.edges_per_mat)
        per_mat = max(1, s.n_ineqs // n_mats)
        kw = dict(
            init=sds((q * s.n_vars, n_nodes), torch.bool),
            mat_rhs=tuple(sds((q * per_mat,), torch.int32) for _ in range(n_mats)),
            mat_table=tuple(sds((q * s.n_vars, 1), torch.int32) for _ in range(n_mats)),
            copy_rhs=sds((q * s.n_copies,), torch.int32),
            var_copy=sds((q * s.n_vars, max(s.n_copies, 1)), torch.int32),
        )
        if dense:
            kw["adj_dense"] = sds((n_mats, n_nodes, n_nodes), torch.bool)
        else:
            kw["edge_src"] = tuple(sds((e,), torch.int32) for e in s.edges_per_mat)
            kw["edge_dst"] = tuple(sds((e,), torch.int32) for e in s.edges_per_mat)
        return dualsim.Operands(**kw)

    def abstract_state(self, cell: Cell) -> dualsim.Operands:
        if cell.name == "block_dense":
            return self._abstract_operands(self.dense_block, dense=True)
        if cell.name == "batch16_sparse":
            return self._abstract_operands(
                self.batch16_nodes, dense=False, q=cell.extras["n_queries"]
            )
        if cell.name == "q_partitioned":
            s = self.scale
            w = cell.extras["n_blocks"]
            n = -(-s.n_nodes // 8192) * 8192  # pad for packed sharding
            ops = self._abstract_operands(n, dense=False)
            eb = [int(e / w * 1.2) for e in s.edges_per_mat]  # 20% imbalance
            return dataclasses.replace(
                ops,
                edge_src=None, edge_dst=None,
                edge_src_b=tuple(sds((w, e), torch.int32) for e in eb),
                edge_dst_b=tuple(sds((w, e), torch.int32) for e in eb),
            )
        return self._abstract_operands(self.scale.n_nodes, dense=False)

    def abstract_inputs(self, cell: Cell) -> dict:
        return {}

    def step(self, cell: Cell) -> Callable:
        """One sweep of the cell's engine: ``step(operands, {}) -> (bool chi,
        1)``.  On DTensor operands the sparse cells split chi as ``init``
        is (:meth:`spec_for`, the reference's ``chi_spec``)."""
        if cell.name == "block_dense":
            return lambda state, batch: dualsim.solve_dense(state, max_sweeps=1)
        if cell.name == "q_partitioned":
            return lambda state, batch: dualsim.solve_partitioned(state, max_sweeps=1)

        def sweep(state, batch):
            mesh = getattr(state.init, "device_mesh", None)
            chi_spec = None if mesh is None else self.spec_for("init", cell, mesh)
            return dualsim.solve_sparse(state, max_sweeps=1, chi_spec=chi_spec)

        return sweep

    # ------------------------------------------------------------------ #
    def spec_for(self, field: str, cell: Cell, mesh) -> P:
        """The placement of the operands' ``field`` in ``cell`` on ``mesh``:
        the one rule that :meth:`state_shardings` applies to the abstract
        state, :meth:`place` to real operands, and :meth:`step` takes chi's
        split from (chi is split as ``init`` is).  A batch's query variables
        go over ``data`` (query parallelism) and its words over ``model``;
        one query's words over every non-pod axis; the partitioned blocks
        over those axes, as chi's words.  Axes the mesh lacks are dropped."""
        if cell.name == "block_dense":
            spec = sh.dualsim_dense_specs(mesh).get(field, P())
        elif field == "init" and cell.name == "batch16_sparse":
            spec = P("data", "model")
        elif field in ("edge_src_b", "edge_dst_b"):
            spec = P(("data", "model"), None)
        else:
            spec = sh.dualsim_sparse_specs(mesh).get(field, P())
        names = mesh.mesh_dim_names

        def present(axes):
            if isinstance(axes, str):
                return axes if axes in names else None
            return tuple(a for a in axes or () if a in names) or None

        return P(*(present(a) for a in spec))

    def state_shardings(self, mesh, cell: Cell) -> Any:
        return sh.map_with_path(
            lambda path, leaf: sh.named(mesh, leaf.shape,
                                        self.spec_for(path.split("/")[0], cell, mesh)),
            self.abstract_state(cell))

    def place(self, ops: dualsim.Operands, cell: Cell, mesh, *,
              blocked: bool | None = None) -> dualsim.Operands:
        """Real operands (built on the CPU) placed on ``mesh`` by
        :meth:`spec_for` (:func:`repro_torch.core.dualsim.shard_operands`;
        on a mesh of cards, or with ``blocked``, the edges in the blocked
        layout a shard)."""
        return dualsim.shard_operands(ops, mesh, lambda f: self.spec_for(f, cell, mesh),
                                      blocked=blocked)

    def input_shardings(self, mesh, cell: Cell) -> Any:
        return {}

    def model_flops(self, cell: Cell) -> float:
        """Useful ops: per sweep each edge feeds V OR-AND ops per direction;
        assume the paper's observed ~5 sweep average (Sect. 5.3)."""
        s = self.scale
        sweeps = 5.0
        if cell.name == "block_dense":
            e = sum(self.scale.edges_per_mat) * (
                self.dense_block / self.scale.n_nodes
            )
            return 2.0 * sweeps * s.n_vars * e
        q = cell.extras.get("n_queries", 1)
        return 2.0 * sweeps * q * s.n_vars * sum(s.edges_per_mat)

    def hlo_trip_factor(self, cell: Cell) -> float:
        """The sweeps one traced sweep stands for: ~5 Gauss–Seidel sweeps
        typical; the Jacobi-style partitioned engine takes ~2x as many."""
        return 10.0 if cell.name == "q_partitioned" else 5.0

    def trip_schedule(self, cell: Cell) -> list[float]:
        """The one loop left out of the trace: the fixpoint's sweeps."""
        return [self.hlo_trip_factor(cell)]

    def reduced(self):
        return None
