"""Cost-based fixpoint-engine selection (DESIGN.md 5.3 / 7.2 / 13).

Given the database statistics and the compiled SOI, estimate the per-sweep
work of each engine the port has and pick the cheapest *feasible* one.  All
engines compute the same greatest fixpoint, so the choice is purely a
performance decision — a wrong pick is slow, never incorrect.

:data:`ENGINES` holds the six engines, in the JAX package's order.

Per-sweep model (V = SOI variables, n = nodes, M = distinct
(label, direction) operators, E = total edges touched by the SOI's
operators, W = devices in the mesh):

* ``dense`` — M boolean products: ``V * n * n * M`` elements at
  ``c_dense``.  Infeasible when the stacked ``bool[M, n, n]`` adjacency
  exceeds ``DENSE_MAX_BYTES``.
* ``packed`` — the ``bitmm_packed`` path: 32 bits per word cut the element
  count by 32x; on the CPU the plain version stands where the JAX package
  interprets its kernel, priced at ``c_packed_interpret``; per operator it
  also pays a launch overhead.
* ``packed_fused`` — chi bit-packed end to end through ``bitmm_apply``: the
  same word count at a lower per-word cost; on the CPU the plain version
  stands where the JAX package runs its word-wise XLA lowering, priced at
  ``c_packed_fused_cpu``.
* ``sparse`` / ``jacobi_packed`` — the segmented-OR sweep, priced from
  BYTES MOVED: per sweep the engine streams ``E * (8 + V)`` bytes of edge
  ids + gathered frontier messages, and ``3 * M * V * n/8`` bytes of packed
  ``y`` words through the per-variable AND (write + read + chi fold), plus
  M per-operator dispatch overheads.  Always feasible on one device.
  Under Gauss–Seidel every operator re-gathers the freshly-updated packed
  chi, so on a mesh it pays M packed-chi copies (``M * V * n/8`` bytes)
  per sweep; ``jacobi_packed`` reads ONE packed frontier copy per sweep
  but pays a ~2x sweep-count inflation over Gauss–Seidel.
* ``partitioned`` — jacobi_packed with destination-partitioned edge
  blocks: compute divides across the W devices, cross-device traffic stays
  the one packed frontier copy.  Needs a mesh (infeasible at W = 1, where
  it only adds block padding over jacobi_packed).

Communication terms enter only when ``n_devices > 1``: on one device the
model reduces to the single-device model exactly.

On a calibrated card (a model in seconds, ``backend`` not ``"cpu"``) the
three dense-tier engines are priced by the work the port's own kernels do
instead (B = set bits of the compiled SOI's Eq.-13 init ``c.init``, nw =
ceil(n / 32)), each sweep also paying one ``c_dispatch`` for its tail:
the copy inequalities and the convergence read to the host, a plain-torch
chain run once a sweep by every dense-tier solver:

* ``packed_fused`` — ``M * (B * nw * c_packed_fused + fused_launch) +
  c_dispatch``: K2 (``kernels/bitmm/csrc/bitmm.cu``) ORs one staged row
  word for each set frontier bit and column word and never reads a row no
  variable selects.  chi only shrinks from ``c.init``, so this bounds
  every sweep and is exact on the first.
* ``packed`` — ``M * (B * nw * c_packed + packed_launch + c_dispatch) +
  c_dispatch``: the same work at the packed engine's own step rate (K3 on
  a bool frontier, then the unpacked AND chain of ``dualsim._fixpoint``),
  plus that chain's plain-torch dispatch per operator, as the
  segmented-OR sweep pays it.
* ``dense`` — ``M * dense_step + c_dispatch``, with :func:`dense_step` =
  ``V * n * n * c_dense + DENSE_PLANE_BYTES * n * n * c_segor_byte``: the
  product's elements, plus the operator's bool plane turned into f32 and
  read back by the product each sweep (:data:`DENSE_PLANE_BYTES` a plane
  element) at the stream rate, a cost that does not shrink with V.

The card also lets the packed engines' stacked operands take a
:data:`ADJ_CACHE_STACKS`-th of its memory where that exceeds
:data:`PACKED_MAX_BYTES` (:func:`packed_max_bytes`): the engine's
adjacency cache keeps that many stacks, so a full cache of the largest
still fits.  The probe (``launch/roofline.py``) fits the rates and the
launch on the card's own kernels; the edge engines, the other gates, the
CPU's prices and the hand-tuned model's stay the reference's.

``backend`` is the device type the plan runs on; as in the JAX package,
``"cpu"`` takes the CPU prices and any other backend (the port's
``"cuda"``) the accelerator's.  Feasibility is a HARD gate on graph shape,
never on calibration: past :func:`dense_tier_feasible` no dense-layout
engine can build its operands.

Every constant lives in a :class:`CostModel`: :data:`HAND_TUNED` (the JAX
package's constants in arbitrary units) or :meth:`CostModel.from_spec`
(seconds, from a probed :class:`~repro_torch.engine.machine.MachineSpec`).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from repro_torch.core import dualsim
from repro_torch.core.graph import DENSE_ADJ_MAX_BYTES, Graph
from repro_torch.core.soi import CompiledSOI

from . import machine as machine_mod
from .machine import MachineSpec

ENGINES = dualsim.ENGINES

# hand-tuned model constants (arbitrary units), equal to the JAX package's
C_DENSE = 1.0 / 8.0  # per dense boolean-product element
C_PACKED = 2.0  # per int32 word, the bitmm_packed kernel
C_PACKED_INTERPRET = 256.0  # per word where the JAX package interprets (CPU)
C_PACKED_FUSED = 1.0  # per word, the fused kernel: no unpack/gather chain
C_PACKED_FUSED_CPU = 24.0  # per word, the word-wise lowering (CPU)
PACKED_LAUNCH = 65536.0  # per-operator kernel launch overhead
C_SPARSE = 4.0  # per edge message (admission envelope only)
C_APPLY = 0.5  # per chi element per operator (admission envelope only)
C_SEGOR_BYTE = 1.0  # per byte moved through the segmented-OR sweep
C_COMM = 8.0  # per byte of cross-device collective traffic
JACOBI_SWEEP_FACTOR = 2.0  # Jacobi needs ~2x the sweeps of Gauss–Seidel
DENSE_MAX_BYTES = 2 << 30  # stacked bool[M, n, n] adjacency budget
PACKED_MAX_BYTES = 2 << 30
# stacked operands the engine's adjacency cache keeps (engine.py); on a
# calibrated card a packed stack may take this share of the card's memory
ADJ_CACHE_STACKS = 16
# bytes a dense-engine plane element moves a sweep on a calibrated card:
# the bool plane read (1), its f32 copy written (4) and read by the
# product (4)
DENSE_PLANE_BYTES = 9.0
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
    straight from the edge list, with no ``[n, n]`` plane, but keeps the JAX
    package's ``DENSE_ADJ_MAX_BYTES`` gate for parity, so both packages
    price the packed tier out at the same ``n`` even though its *resident*
    operand is 32x smaller.
    """
    return n * n <= DENSE_TIER_MAX_BYTES


def _card_memory_bytes() -> int | None:
    """The current card's memory in bytes, or None without a card."""
    import torch

    if not torch.cuda.is_available():
        return None
    return _device_memory_bytes(torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def _device_memory_bytes(index: int) -> int:
    import torch

    return int(torch.cuda.get_device_properties(index).total_memory)


def packed_max_bytes(card: bool) -> int:
    """The packed engines' stacked-operand budget: :data:`PACKED_MAX_BYTES`,
    or on a calibrated card (``card``) with a card present an
    :data:`ADJ_CACHE_STACKS`-th of its memory where that is larger."""
    memory = _card_memory_bytes() if card else None
    if memory is None:
        return PACKED_MAX_BYTES
    return max(PACKED_MAX_BYTES, memory // ADJ_CACHE_STACKS)


def dense_step(v: int, n: int, model: CostModel) -> float:
    """One dense-engine operator on a calibrated card: the ``[V, n] x
    [n, n]`` product's elements, and the bool plane's f32 conversion and
    read, :data:`DENSE_PLANE_BYTES` a plane element at the stream rate."""
    return v * n * n * model.c_dense + DENSE_PLANE_BYTES * n * n * model.c_segor_byte


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Every constant the engine/resume/admission models read, as one unit.

    Two provenances: :data:`HAND_TUNED` (arbitrary units) and
    :meth:`from_spec` (seconds, derived from a probed
    :class:`~repro_torch.engine.machine.MachineSpec`).
    """

    c_dense: float  # per dense boolean-product element
    c_packed: float  # per word, the compiled kernel path
    c_packed_interpret: float  # per word, the JAX package's interpret mode
    c_packed_fused: float  # per word, the fused kernel path
    c_packed_fused_cpu: float  # per word, the word-wise CPU lowering
    packed_launch: float  # per-operator launch overhead, packed engine
    fused_launch: float  # per-operator launch overhead, fused engine
    c_sparse: float  # per edge message (admission envelope)
    c_apply: float  # per chi element per operator (admission envelope)
    c_segor_byte: float  # per byte through the segmented-OR sweep
    c_comm: float  # per byte of cross-device collective traffic
    c_dispatch: float  # per-operator per-sweep fixed overhead
    trace_cost: float  # fixed cost of building a plan cold
    patch_cost_per_edge: float  # host-side rebuild of touched operators
    source: str  # "hand-tuned" or the spec fingerprint
    unit: str  # "arb" (hand-tuned) or "s" (calibrated)

    @classmethod
    def from_spec(cls, spec: MachineSpec) -> "CostModel":
        """Derive every constant from a machine's probed ceilings (seconds),
        with the JAX package's derivations: ``c_dense = 1 / dense``; the
        packed and fused per-word costs are reciprocals of the measured word
        throughputs, the lowering the spec's backend does not ship falling
        back to the word-wise measurement; the packed engine pays the
        measured kernel launch per operator, the fused engine the same on
        an accelerator but only a dispatch on the CPU; ``c_segor_byte = 1 /
        stream``, ``c_sparse = 12 / stream``, ``c_apply = 0.375 / stream``,
        ``patch_cost_per_edge = 64 / stream``, ``c_comm`` the reciprocal
        of the probed collective rate (``4 / stream`` below 2 devices,
        where no collective is probed), the measured dispatch overhead and
        the measured cold-build latency.  On a card the spec's rates are
        the port's own kernels' (``launch/roofline.py``), which
        :func:`estimate_costs` prices by set frontier bits."""
        stream = spec.stream_bytes_per_s
        cpu = spec.backend == "cpu"
        shipping = 1.0 / spec.packed_words_per_s
        words = 1.0 / spec.packed_words_per_s_xla
        fused = 1.0 / spec.fused_words_per_s
        return cls(
            c_dense=1.0 / spec.dense_elems_per_s,
            c_packed=words if cpu else shipping,
            c_packed_interpret=shipping if cpu else words,
            c_packed_fused=fused,
            c_packed_fused_cpu=fused if cpu else words,
            packed_launch=spec.kernel_launch_s,
            fused_launch=spec.dispatch_s if cpu else spec.kernel_launch_s,
            c_sparse=12.0 / stream,
            c_apply=0.375 / stream,
            c_segor_byte=1.0 / stream,
            c_comm=(
                1.0 / spec.collective_bytes_per_s
                if spec.collective_bytes_per_s
                else 4.0 / stream
            ),
            c_dispatch=spec.dispatch_s,
            trace_cost=spec.trace_s,
            patch_cost_per_edge=64.0 / stream,
            source=spec.fingerprint,
            unit="s",
        )


HAND_TUNED = CostModel(
    c_dense=C_DENSE,
    c_packed=C_PACKED,
    c_packed_interpret=C_PACKED_INTERPRET,
    c_packed_fused=C_PACKED_FUSED,
    c_packed_fused_cpu=C_PACKED_FUSED_CPU,
    packed_launch=PACKED_LAUNCH,
    fused_launch=PACKED_LAUNCH,
    c_sparse=C_SPARSE,
    c_apply=C_APPLY,
    c_segor_byte=C_SEGOR_BYTE,
    c_comm=C_COMM,
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
    n_devices: int = 1,
    spec: MachineSpec | None = None,
    model: CostModel | None = None,
) -> dict[str, float]:
    """Per-sweep model cost of every engine (``inf`` when infeasible).

    ``backend`` is the device type the plan runs on (``"cuda"`` or
    ``"cpu"``); it selects the persisted machine spec.  ``n_devices`` is
    the mesh size the partitioned engine would run on: it divides that
    engine's compute and switches the communication terms on.  ``spec`` /
    ``model`` select the calibration (see :func:`resolve_model`).
    """
    mdl = resolve_model(spec, model, backend)
    v, m, e = _soi_stats(g, c)
    n = g.n_nodes
    n_words = (n + 31) // 32
    cpu = backend == "cpu"
    # hard gate first: past the [n, n] budget no dense-layout engine can
    # even BUILD its operands (m > 0 — an operator-free SOI builds nothing)
    tier_ok = m == 0 or dense_tier_feasible(n)
    dense_bytes = m * n * n
    packed_bytes = m * n * n_words * 4
    card = mdl.unit == "s" and not cpu
    packed_ok = tier_ok and packed_bytes <= packed_max_bytes(card)
    c_packed = mdl.c_packed_interpret if cpu else mdl.c_packed
    c_fused = mdl.c_packed_fused_cpu if cpu else mdl.c_packed_fused
    sweep = segor_sweep_cost(v, n, m, e, mdl)
    multi = n_devices > 1
    # Gauss–Seidel re-gathers the packed chi per operator: M packed-chi
    # copies (n/8 bytes each) per sweep; Jacobi reads one
    sparse_comm = m * v * (n / 8.0) * mdl.c_comm if multi else 0.0
    bcast_comm = v * (n / 8.0) * mdl.c_comm if multi else 0.0
    inf = float("inf")
    if card and tier_ok:
        # the port's kernels' work and each sweep's tail (module docstring)
        words = int(np.count_nonzero(c.init)) * n_words
        tail = mdl.c_dispatch
        dense = m * dense_step(v, n, mdl) + tail
        packed = m * (words * c_packed + mdl.packed_launch + mdl.c_dispatch) + tail
        fused = m * (words * c_fused + mdl.fused_launch) + tail
    else:
        # the reference's: every variable's row over every column word
        dense = v * n * n * m * mdl.c_dense
        packed = v * n * n_words * m * c_packed + m * mdl.packed_launch
        fused = v * n * n_words * m * c_fused + m * mdl.fused_launch
    return {
        "dense": (
            dense if tier_ok and dense_bytes <= DENSE_MAX_BYTES else inf
        ),
        "packed": packed if packed_ok else inf,
        "packed_fused": fused if packed_ok else inf,
        "sparse": sweep + sparse_comm,
        "jacobi_packed": JACOBI_SWEEP_FACTOR * (sweep + bcast_comm),
        # no mesh: pure block-padding overhead over jacobi_packed
        "partitioned": (
            JACOBI_SWEEP_FACTOR * (sweep / n_devices + bcast_comm)
            if multi else inf
        ),
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
    n_devices: int = 1,
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
    costs = estimate_costs(
        g, c, backend=backend, n_devices=n_devices, model=mdl
    )
    per_sweep = costs[engine]
    if per_sweep == float("inf"):
        # the plan exists and runs with this engine whatever the model's
        # feasibility gate says (e.g. partitioned pinned on one device);
        # price its sweeps with the always-finite sparse estimate instead
        per_sweep = costs["sparse"]
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
    n_devices: int = 1,
    allow: tuple[str, ...] = ENGINES,
    spec: MachineSpec | None = None,
    model: CostModel | None = None,
) -> CostEstimate:
    """Pick the cheapest feasible engine for this (SOI, graph, mesh) triple."""
    mdl = resolve_model(spec, model, backend)
    costs = estimate_costs(
        g, c, backend=backend, n_devices=n_devices, model=mdl
    )
    feasible = {k: v for k, v in costs.items() if k in allow and v != float("inf")}
    if not feasible:  # sparse is always feasible unless excluded by `allow`
        raise ValueError(f"no feasible engine among {allow}")
    best = min(feasible, key=feasible.get)
    v, m, e = _soi_stats(g, c)
    reason = (
        f"{best}: cost {feasible[best]:.3g}{mdl.unit} over "
        f"{{V={v}, n={g.n_nodes}, M={m}, E={e}, W={n_devices}}} "
        f"[{mdl.source}] (candidates: "
        + ", ".join(f"{k}={costs[k]:.3g}" for k in costs)
        + ")"
    )
    return CostEstimate(engine=best, costs=costs, reason=reason)
