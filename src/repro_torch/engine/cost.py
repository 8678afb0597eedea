"""Cost-based fixpoint-engine selection (DESIGN.md 5.3 / 7.2 / 13).

Given the database statistics and the compiled SOI, estimate the per-sweep
work of each engine the port has and pick the cheapest *feasible* one.  All
engines compute the same greatest fixpoint, so the choice is purely a
performance decision — a wrong pick is slow, never incorrect.

The port has the two edge-list engines (``sparse`` and ``jacobi_packed``),
so :data:`ENGINES` holds only those; the dense tier of the JAX package
comes with a later slice.  Its hard feasibility gate,
:func:`dense_tier_feasible`, is kept byte-identical so the tier boundary
is known when it arrives.

Per-sweep model (V = SOI variables, n = nodes, M = distinct
(label, direction) operators, E = total edges touched by the SOI's
operators):

* ``sparse`` / ``jacobi_packed`` — the segmented-OR sweep, priced from
  BYTES MOVED: per sweep the engine streams ``E * (8 + V)`` bytes of edge
  ids + gathered frontier messages, and ``3 * M * V * n/8`` bytes of packed
  ``y`` words through the per-variable AND (write + read + chi fold), plus
  M per-operator dispatch overheads.  Always feasible.  ``jacobi_packed``
  pays a ~2x sweep-count inflation over Gauss–Seidel.

Every constant lives in a :class:`CostModel`: :data:`HAND_TUNED` (the JAX
package's constants in arbitrary units) or :meth:`CostModel.from_spec`
(seconds, from a probed :class:`~repro_torch.engine.machine.MachineSpec`).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.dualsim import EDGE_ENGINES
from repro_torch.core.graph import DENSE_ADJ_MAX_BYTES, Graph
from repro_torch.core.soi import CompiledSOI

from . import machine as machine_mod
from .machine import MachineSpec

ENGINES = EDGE_ENGINES

# hand-tuned model constants (arbitrary units), equal to the JAX package's
C_SPARSE = 4.0  # per edge message (admission envelope only)
C_APPLY = 0.5  # per chi element per operator (admission envelope only)
C_SEGOR_BYTE = 1.0  # per byte moved through the segmented-OR sweep
JACOBI_SWEEP_FACTOR = 2.0  # Jacobi needs ~2x the sweeps of Gauss–Seidel
# any single [n, n] plane past this cannot be BUILT (graph.dense_adjacency
# raises MemoryError) — shared with the data layer so the model's hard gate
# and the constructor's guard can never disagree
DENSE_TIER_MAX_BYTES = DENSE_ADJ_MAX_BYTES

# resume-vs-cold model constants (DESIGN.md Sect. 8.3).  A cold rebuild
# pays SOI build + compile + operand construction and upload; TRACE_COST
# keeps the JAX package's value so both packages classify a delta alike.
TRACE_COST = 5e7  # fixed cost of building a plan cold
PATCH_COST_PER_EDGE = 16.0  # host-side rebuild of touched operators
RESUME_SWEEP_RATE = 50.0  # extra-sweep inflation per fractional delta
DEFAULT_SWEEPS = 8.0  # sweep prior when the plan never executed
RESUME_MAX_DELTA_FRACTION = 0.25  # past this, the old chi is mostly reseeded


def dense_tier_feasible(n: int) -> bool:
    """Whether any ``[n, n]`` operand plane may be materialized at all.

    Gates dense AND both packed engines: ``graph.packed_adjacency`` packs
    through a transient dense ``[n, n]`` build, so the packed tier is just
    as impossible past the budget even though its *resident* operand is 32x
    smaller.
    """
    return n * n <= DENSE_TIER_MAX_BYTES


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Every constant the engine/resume/admission models read, as one unit.

    Two provenances: :data:`HAND_TUNED` (arbitrary units) and
    :meth:`from_spec` (seconds, derived from a probed
    :class:`~repro_torch.engine.machine.MachineSpec`).
    """

    c_sparse: float  # per edge message (admission envelope)
    c_apply: float  # per chi element per operator (admission envelope)
    c_segor_byte: float  # per byte through the segmented-OR sweep
    c_dispatch: float  # per-operator per-sweep fixed overhead
    trace_cost: float  # fixed cost of building a plan cold
    patch_cost_per_edge: float  # host-side rebuild of touched operators
    source: str  # "hand-tuned" or the spec fingerprint
    unit: str  # "arb" (hand-tuned) or "s" (calibrated)

    @classmethod
    def from_spec(cls, spec: MachineSpec) -> "CostModel":
        """Derive every constant from a machine's probed ceilings (seconds),
        with the JAX package's derivations: ``c_segor_byte = 1 / stream``,
        ``c_sparse = 12 / stream``, ``c_apply = 0.375 / stream``,
        ``patch_cost_per_edge = 64 / stream``, the measured dispatch
        overhead and the measured cold-build latency."""
        stream = spec.stream_bytes_per_s
        return cls(
            c_sparse=12.0 / stream,
            c_apply=0.375 / stream,
            c_segor_byte=1.0 / stream,
            c_dispatch=spec.dispatch_s,
            trace_cost=spec.trace_s,
            patch_cost_per_edge=64.0 / stream,
            source=spec.fingerprint,
            unit="s",
        )


HAND_TUNED = CostModel(
    c_sparse=C_SPARSE,
    c_apply=C_APPLY,
    c_segor_byte=C_SEGOR_BYTE,
    c_dispatch=0.0,  # the arb-unit envelope never priced per-op overhead
    trace_cost=TRACE_COST,
    patch_cost_per_edge=PATCH_COST_PER_EDGE,
    source="hand-tuned",
    unit="arb",
)


def resolve_model(
    spec: MachineSpec | None = None,
    model: CostModel | None = None,
    backend: str = "cuda",
) -> CostModel:
    """The model a cost query should price with.

    Precedence: an explicit ``model``; an explicit ``spec``; the machine's
    persisted spec (:func:`repro_torch.engine.machine.default_spec`,
    governed by ``REPRO_MACHINE_SPEC``); the hand-tuned fallback.
    """
    if model is not None:
        return model
    if spec is None:
        spec = machine_mod.default_spec(backend)
    return CostModel.from_spec(spec) if spec is not None else HAND_TUNED


def segor_sweep_cost(
    v: int, n: int, m: int, e: int, model: CostModel = HAND_TUNED
) -> float:
    """Bytes-moved model of one segmented-OR Gauss–Seidel sweep.

    ``E * (8 + V)`` bytes of edge ids (src + dst int32) and frontier
    messages, plus ``3 * M * V * n/8`` bytes of packed ``y`` words (written
    by the segmented OR, read by the per-variable AND, folded into chi),
    plus M per-operator dispatch overheads (zero in the hand-tuned model).
    """
    return (
        model.c_segor_byte * (e * (8.0 + v) + 3.0 * m * v * (n / 8.0))
        + m * model.c_dispatch
    )


@dataclasses.dataclass(frozen=True)
class CostEstimate:
    """Chosen engine plus the full per-engine cost breakdown."""

    engine: str
    costs: dict[str, float]  # per-sweep model cost; float('inf') = infeasible
    reason: str


def _soi_stats(g: Graph, c: CompiledSOI) -> tuple[int, int, int]:
    """(V, M, E_total) for a compiled SOI against ``g``."""
    hist = g.label_histogram()
    e_total = int(sum(hist[la] for la, _ in c.mats))
    return c.n_vars, len(c.mats), e_total


def estimate_costs(
    g: Graph,
    c: CompiledSOI,
    *,
    backend: str = "cuda",
    spec: MachineSpec | None = None,
    model: CostModel | None = None,
) -> dict[str, float]:
    """Per-sweep model cost of every engine (``inf`` when infeasible).

    ``backend`` is the device type the plan runs on (``"cuda"`` or
    ``"cpu"``); it selects the persisted machine spec.  ``spec`` / ``model``
    select the calibration (see :func:`resolve_model`).
    """
    mdl = resolve_model(spec, model, backend)
    v, m, e = _soi_stats(g, c)
    sweep = segor_sweep_cost(v, g.n_nodes, m, e, mdl)
    return {
        "sparse": sweep,
        "jacobi_packed": JACOBI_SWEEP_FACTOR * sweep,
    }


def admission_estimate(
    g: Graph,
    q,
    *,
    spec: MachineSpec | None = None,
    model: CostModel | None = None,
) -> float:
    """Admission-control price of a parsed query (DESIGN.md Sect. 10.2).

    Estimates the always-feasible sparse engine's solve cost from the query
    text alone plus the graph's label histogram: ``DEFAULT_SWEEPS *
    (M*c_dispatch + V*E*c_sparse + V*n*M*c_apply)`` with V = distinct
    variables, M = 2x distinct labels, and E the total edges under the
    query's labels.  An *envelope*, not the per-engine model: a monotone
    handle on "how much worse than the median template is this request".
    """
    from repro_torch.core import sparql

    mdl = resolve_model(spec, model)

    def walk(node):
        if isinstance(node, sparql.BGP):
            return list(node.triples)
        return walk(node.left) + walk(node.right)

    triples = walk(q)
    v = len(sparql.vars_of(q))
    labels = {t.p for t in triples}
    m = 2 * len(labels)
    hist = g.label_histogram()
    label_index = g.label_index() if g.label_names is not None else {}
    e = sum(int(hist[label_index[name]])
            for name in labels if name in label_index)
    return DEFAULT_SWEEPS * (
        m * mdl.c_dispatch
        + v * e * mdl.c_sparse
        + v * g.n_nodes * m * mdl.c_apply
    )


@dataclasses.dataclass(frozen=True)
class ResumeDecision:
    """Outcome of the resume-vs-cold classification for one stale plan."""

    resume: bool
    est_resume: float  # model cost of patch + warm-started sweeps
    est_cold: float  # model cost of rebuild + cold sweeps
    reason: str


def resume_decision(
    g: Graph,
    c: CompiledSOI,
    *,
    engine: str,
    delta_edges: int,
    last_sweeps: int | None = None,
    backend: str = "cuda",
    spec: MachineSpec | None = None,
    model: CostModel | None = None,
) -> ResumeDecision:
    """Should a superseded (shape-stable) plan warm-resume or rebuild cold?

    A warm start from the old fixpoint re-runs roughly ``1 + S_cold *
    min(1, rate * delta/E)`` sweeps, whereas a cold rebuild pays the full
    sweep count *plus* the build.  Past :data:`RESUME_MAX_DELTA_FRACTION`
    of the edges changing, rebuild cold.  Either choice is correct; this is
    purely a latency call.
    """
    mdl = resolve_model(spec, model, backend)
    per_sweep = estimate_costs(g, c, backend=backend, model=mdl)[engine]
    _, _, e = _soi_stats(g, c)
    frac = delta_edges / max(e, 1)
    s_cold = float(last_sweeps) if last_sweeps else DEFAULT_SWEEPS
    s_resume = 1.0 + s_cold * min(1.0, RESUME_SWEEP_RATE * frac)
    est_cold = mdl.trace_cost + s_cold * per_sweep
    est_resume = mdl.patch_cost_per_edge * delta_edges + s_resume * per_sweep
    resume = frac <= RESUME_MAX_DELTA_FRACTION and est_resume < est_cold
    reason = (
        f"{'resume' if resume else 'cold'}: delta {delta_edges}/{e} edges "
        f"({frac:.2%}), est resume {est_resume:.3g} vs cold {est_cold:.3g} "
        f"({engine}, ~{s_cold:.0f} sweeps cold / {s_resume:.1f} resumed)"
    )
    return ResumeDecision(
        resume=resume, est_resume=est_resume, est_cold=est_cold, reason=reason
    )


def choose_engine(
    g: Graph,
    c: CompiledSOI,
    *,
    backend: str = "cuda",
    allow: tuple[str, ...] = ENGINES,
    spec: MachineSpec | None = None,
    model: CostModel | None = None,
) -> CostEstimate:
    """Pick the cheapest feasible engine for this (SOI, graph) pair."""
    mdl = resolve_model(spec, model, backend)
    costs = estimate_costs(g, c, backend=backend, model=mdl)
    feasible = {k: v for k, v in costs.items() if k in allow and v != float("inf")}
    if not feasible:  # sparse is always feasible unless excluded by `allow`
        raise ValueError(f"no feasible engine among {allow}")
    best = min(feasible, key=feasible.get)
    v, m, e = _soi_stats(g, c)
    reason = (
        f"{best}: cost {feasible[best]:.3g}{mdl.unit} over "
        f"{{V={v}, n={g.n_nodes}, M={m}, E={e}}} "
        f"[{mdl.source}] (candidates: "
        + ", ".join(f"{k}={costs[k]:.3g}" for k in costs)
        + ")"
    )
    return CostEstimate(engine=best, costs=costs, reason=reason)
