"""Compiled, constant-rebindable execution plans (DESIGN.md 5.2).

A :class:`CompiledPlan` is everything about a query that does not depend on
the constants: the (batched) SOI built from the template, its compilation
against one graph's label table, and the engine's device operands.  The
per-request constants enter as an *input* — a ``[K, n]`` stack of one-hot
rows ANDed into the Eq.-13 init, as packed ``[K, nw]`` words for the
engines whose chi is packed and as bool rows for ``dense`` and ``packed``
— so rebinding a template to
new constants builds no operands: the ``operand_builds`` counter stays at
the one build the plan's construction made.

Slot handling: the template SOI marks constants as ``$slot{k}`` (see
:mod:`repro_torch.engine.template`).  For compilation we strip those markers
so :func:`repro_torch.core.soi.compile_soi` gives slot rows the full
structural (Eq.-13 summary) init of a variable; binding then ANDs in the
one-hot row, which reproduces exactly what ``compile_soi`` does for a
literal constant.  One slot may map to *several* internal variables — the
SOI builder gives constants a private singleton variable per BGP — so the
scatter index list carries one entry per (instance, slot variable).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch import spans
from repro_torch.core import bitops, dualsim, soi as soi_mod
from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.core.graph import Graph, GraphDelta

from . import cost as cost_mod
from .batcher import BatchLayout, batch_layout
from .cache import BoundedDict
from .template import QueryTemplate, slot_index


def _widen(x: torch.Tensor, width: int) -> torch.Tensor:
    """``x`` with zero columns (or words) appended up to ``width``: the
    partitioned layout's node axis is padded past the graph's, and its pad
    columns are dead."""
    if x.shape[-1] == width:
        return x
    return torch.nn.functional.pad(x, (0, width - x.shape[-1]))


@dataclasses.dataclass
class PlanMetrics:
    """Observable counters of one plan."""

    operand_builds: int = 0  # operand sets built from the graph (1 per plan)
    executions: int = 0  # fixpoint solves run
    patches: int = 0  # shape-stable graph deltas adopted in place
    warm_resumes: int = 0  # executions warm-started from a previous chi


class CompiledPlan:
    """One (template, graph, bucket) entry of the plan cache."""

    def __init__(
        self,
        template: QueryTemplate,
        db: Graph,
        *,
        engine: str = "auto",
        batch: int = 1,
        node_index: dict[str, int] | None = None,
        device=DEFAULT_DEVICE,
        adj_cache: dict | None = None,
        mesh=None,
        n_blocks: int | None = None,
        incremental: bool = True,
        spec=None,
    ):
        """Compile ``template`` against ``db`` at batch size ``batch``.

        ``engine`` is ``"auto"`` (cost model) or one of
        :data:`repro_torch.engine.cost.ENGINES`.  ``device`` holds the
        operands and runs the
        fixpoint (``"cuda"`` by default; raises without a card).  ``mesh``
        (a :class:`repro_torch.distributed.ctx.NodeMesh` of ``device``'s
        type) is what the partitioned engine places its ``n_blocks``
        destination blocks (default: one per mesh device) and chi's columns
        over; the cost model sees its size.  ``spec`` is the
        :class:`repro_torch.engine.machine.MachineSpec` the
        ``engine="auto"`` selection prices with.
        """
        t0 = spans.begin()
        self.device = resolve_device(device)
        self.template = template
        self.batch = batch
        self.n_nodes = db.n_nodes
        self.mesh = mesh
        n_devices = mesh.size if mesh is not None else 1
        self.n_blocks = n_blocks if n_blocks is not None else n_devices
        self.incremental = incremental
        if node_index is None:
            node_index = db.node_index() if db.node_names is not None else {}
        self._node_index = node_index

        base = soi_mod.build_soi(template.query)
        self.base_soi = base
        self.layout: BatchLayout = batch_layout([base] * batch)
        union = self.layout.soi

        # strip slot markers so compile_soi inits slot rows like variables
        stripped = dataclasses.replace(
            union,
            is_const=[
                None if (c is not None and slot_index(c) is not None) else c
                for c in union.is_const
            ],
        )
        self._stripped = stripped  # kept for shape-stable recompiles (patch)
        self.csoi = soi_mod.compile_soi(stripped, db, node_index=node_index)

        # (instance, slot variable) scatter order; row j of const_rows lands
        # in init row scatter_ids[j] and carries constants[slot_of[j]]
        per_part = [
            (vid, slot_index(c))
            for vid, c in enumerate(base.is_const)
            if c is not None and slot_index(c) is not None
        ]
        self._scatter_ids = np.asarray(
            [
                self.layout.offsets[i] + vid
                for i in range(batch)
                for vid, _ in per_part
            ],
            dtype=np.int64,
        )
        self._scatter_slot = [k for _ in range(batch) for _, k in per_part]
        self._scatter_instance = [
            i for i in range(batch) for _ in per_part
        ]

        self.cost: cost_mod.CostEstimate | None = None
        if engine == "auto":
            self.cost = cost_mod.choose_engine(
                db, self.csoi, backend=self.device.type, n_devices=n_devices,
                spec=spec,
            )
            engine = self.cost.engine
        if engine not in cost_mod.ENGINES:
            raise ValueError(f"unknown engine {engine!r}")
        self.engine = engine
        # engines whose fixpoint carries bit-packed chi take constants and
        # warm starts as int32 words; dense and packed keep bool chi
        self._packed_chi = engine not in ("dense", "packed")
        spans.end("plan.compile", t0)

        t1 = spans.begin()
        # the adjacency entries before the build, to tell a shared upload
        # from a new one (a span attribute, so only while tracing)
        adj_before = (dict(dict.items(adj_cache))
                      if adj_cache is not None and spans.enabled() else None)
        if engine == "partitioned":
            # block-major placement: block w's edges on block w's device
            self.operands = dualsim.make_partitioned_operands(
                self.csoi, db, self.n_blocks, adj_cache, device=self.device,
                mesh=mesh,
            )
        else:
            if engine == "dense":
                make = dualsim.make_dense_operands
            elif engine in ("packed", "packed_fused"):
                make = dualsim.make_packed_operands
            else:
                make = dualsim.make_sparse_operands
            self.operands = make(self.csoi, db, adj_cache, device=self.device)
        self._scatter = torch.as_tensor(self._scatter_ids, device=self.device)
        spans.end("plan.operands", t1, adj_cache_hit=adj_before is not None and all(
            adj_before.get(k) is v for k, v in dict.items(adj_cache)))
        self.metrics = PlanMetrics(operand_builds=1)
        self._adj_cache = adj_cache
        # incremental maintenance state (DESIGN.md Sect. 8): the last solved
        # chi per constant tuple (bit-packed, 8x smaller than bool), and
        # re-seeded warm starts staged by patch_graph for the next
        # execution of the same constants
        self._chi_memo: BoundedDict = BoundedDict(capacity=4)
        self._warm: dict = {}
        self.last_sweeps: int | None = None

    # ------------------------------------------------------------------ #
    @property
    def n_slot_rows(self) -> int:
        """Init rows the per-request constants scatter into."""
        return len(self._scatter_ids)

    def const_rows(self, bindings: Sequence[tuple[str, ...]]) -> np.ndarray:
        """One-hot ``bool[K, n]`` rows for a batch of constant tuples.

        ``bindings[i]`` is instance i's slot->constant assignment; a constant
        missing from the database yields an all-zero row (forces that
        instance's component empty, same as ``compile_soi``).
        """
        if len(bindings) != self.batch:
            raise ValueError(
                f"plan is compiled for batch={self.batch}, "
                f"got {len(bindings)} binding tuples"
            )
        rows = np.zeros((self.n_slot_rows, self.n_nodes), dtype=bool)
        for j, (i, k) in enumerate(
            zip(self._scatter_instance, self._scatter_slot)
        ):
            if k >= len(bindings[i]):
                raise ValueError(
                    f"instance {i} binds {len(bindings[i])} constants, "
                    f"template needs {self.template.n_slots}"
                )
            node = self._node_index.get(bindings[i][k])
            # the index may be a live dict shared with a mutating source;
            # a name minted after this plan's snapshot has an id past our
            # node axis and (correctly) binds to the empty set here
            if node is not None and node < self.n_nodes:
                rows[j, node] = True
        return rows

    def _run(self, const_rows: torch.Tensor, chi0: torch.Tensor | None):
        """Scatter the constant rows into the init (packed words or bool,
        as the engine's chi), AND in the warm start, and run the fixpoint."""
        packed = self._packed_chi
        init = self.operands.init_packed if packed else self.operands.init
        if const_rows.shape[0]:
            init = init.index_put(
                (self._scatter,),
                init[self._scatter] & _widen(const_rows, init.shape[-1]),
            )
        if chi0 is not None:
            init = init & _widen(chi0, init.shape[-1])
        ops = dataclasses.replace(
            self.operands, **{"init_packed" if packed else "init": init}
        )
        if self.engine == "dense":
            return dualsim.solve_dense(ops)
        if self.engine == "packed":
            return dualsim.solve_packed(ops)
        if self.engine == "packed_fused":
            return dualsim.solve_packed_fused(ops)
        if self.engine == "partitioned":
            chi, sweeps = dualsim.solve_partitioned(ops, mesh=self.mesh)
            return chi[:, : self.n_nodes], sweeps  # drop block padding
        return dualsim.solve_sparse(
            ops, mode="jacobi_packed" if self.engine == "jacobi_packed" else "gs"
        )

    def execute(
        self, bindings: Sequence[tuple[str, ...]]
    ) -> tuple[np.ndarray, int]:
        """Solve the fixpoint for one batch of constant tuples.

        Returns ``(chi, sweeps)`` with ``chi`` of shape
        ``[batch * n_vars, n_nodes]``; use ``self.layout.chi_slice(i)`` to
        demux instance i.  When :meth:`patch_graph` staged a re-seeded warm
        start for exactly these constants, the solve resumes from it
        instead of the Eq.-13 init (same fixpoint, far fewer sweeps).
        """
        # the packed-chi engines take constants, init and warm starts as
        # packed words; dense and packed take them as bool rows
        t0 = spans.begin()
        rows = self.const_rows(bindings)
        if self._packed_chi:
            rows = bitops.to_words(bitops.pack_np(rows), self.device)
        else:
            rows = torch.as_tensor(rows, device=self.device)
        key = tuple(bindings)
        warm = self._warm.pop(key, None)
        chi0 = None
        if warm is not None:
            chi0 = (
                bitops.to_words(warm, self.device) if self._packed_chi
                else torch.as_tensor(warm, device=self.device)
            )
            self.metrics.warm_resumes += 1
        spans.end("solve.bind", t0)
        # the sweeps end at their last convergence read; chi's unpack, queued
        # behind it on the device, is waited for by the copy back
        t = spans.begin()
        chi, sweeps = self._run(rows, chi0)
        spans.end("solve.sweeps", t, sweeps=sweeps)
        self.metrics.executions += 1
        t = spans.begin()
        chi = chi.cpu().numpy()
        spans.end("solve.readback", t, bytes=chi.nbytes)
        self.last_sweeps = sweeps
        if self.incremental:
            # bit-packed: 8x smaller than the bool chi it warm-starts, and
            # fed straight back into the packed sweep (DESIGN.md Sect. 9)
            t = spans.begin()
            self._chi_memo[key] = bitops.pack_np(chi)
            spans.end("solve.memo", t)
        return chi, sweeps

    def patch_graph(
        self,
        db: Graph,
        delta: GraphDelta,
        node_index: dict[str, int] | None = None,
        adj_cache: dict | None = None,
    ) -> None:
        """Adopt a shape-stable mutated snapshot without a rebuild.

        The template SOI and batch layout survive; only the graph-dependent
        pieces move: the compiled SOI's Eq.-13 init is recomputed, touched
        operators are patched in place
        (:func:`repro_torch.core.dualsim.patch_operands` — untouched
        operators and operand *shapes* carry over), and every memoized
        fixpoint becomes a staged warm start with the delta's destabilized
        rows re-seeded to ⊤ (DESIGN.md Sect. 8.2).
        """
        if not delta.shape_stable or db.n_nodes != self.n_nodes:
            raise ValueError("patch_graph needs a shape-stable delta")
        if node_index is not None:
            self._node_index = node_index
        old_mats = self.csoi.mats
        self.csoi = soi_mod.compile_soi(
            self._stripped, db, node_index=self._node_index
        )
        if self.csoi.mats != old_mats:  # dictionary change slipped through
            raise ValueError("operator list moved; delta is not resumable")
        cache = adj_cache if adj_cache is not None else self._adj_cache
        self.operands = dualsim.patch_operands(
            self.operands,
            self.csoi,
            db,
            delta.touched_labels(),
            adj_cache=cache,
            mesh=self.mesh,  # rebuilt blocks go back to their devices
        )
        grow = dualsim.destabilized_rows(self.csoi, delta.inserted_labels())
        self._warm = {}
        if self._packed_chi:
            # stay packed: destabilized rows re-seed to the all-ones mask
            # (trailing pad bits zero), the memo words go back verbatim
            ones = bitops.ones_mask(self.n_nodes)
            for key, packed in self._chi_memo.items():
                chi0 = packed.copy()
                chi0[grow] = ones
                self._warm[key] = chi0
        else:
            for key, packed in self._chi_memo.items():
                chi0 = bitops.unpack_np(packed, self.n_nodes)
                chi0[grow] = True
                self._warm[key] = chi0
        # superseded fixpoints are warm seeds now, not current results
        self._chi_memo.clear()
        self.metrics.patches += 1
