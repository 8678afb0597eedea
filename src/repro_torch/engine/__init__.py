"""`repro_torch.engine` — the query-engine subsystem (DESIGN.md Sect. 5).

Ties the pipeline together — ``sparql`` → ``union_split`` → ``soi`` →
``dualsim`` → ``pruning`` — behind one facade::

    from repro_torch.engine import Engine
    eng = Engine(db, device="cuda")       # cost model picks the fixpoint engine
    res = eng.execute("{ ?d subOrganizationOf Univ3 . ?s memberOf ?d }")
    res.survivors, res.bindings, res.timings, res.cache_hit

Constants are abstracted out of a parsed query into a canonical template
(:mod:`template`), the template is compiled once into a
:class:`~repro_torch.engine.plan.CompiledPlan` whose fixpoint takes the
per-request constant rows as an *input* (:mod:`plan`), and later requests
with the same shape rebind constants without building operands again
(:mod:`cache`).  Same-template requests are solved as one disjoint-union
SOI, padded to bucketed batch sizes (:mod:`batcher`), and the fixpoint
engine (dense / packed / packed_fused / sparse / jacobi_packed) is chosen
per plan by a cost model (:mod:`cost`).
"""
from .batcher import BatchLayout, MicroBatcher, batch_layout, batched_soi, bucket_for
from .cache import CacheStats, PlanCache
from .cost import (
    CostEstimate,
    CostModel,
    HAND_TUNED,
    ResumeDecision,
    choose_engine,
    estimate_costs,
    resume_decision,
)
from .engine import Engine, EngineMetrics
from .machine import MachineSpec, default_spec, machine_fingerprint
from .plan import CompiledPlan, PlanMetrics
from .template import (
    SLOT_PREFIX,
    QueryTemplate,
    TemplateInstance,
    canonicalize,
    template_key,
)


__all__ = [
    "BatchLayout",
    "CacheStats",
    "CompiledPlan",
    "CostEstimate",
    "CostModel",
    "Engine",
    "EngineMetrics",
    "HAND_TUNED",
    "MachineSpec",
    "MicroBatcher",
    "PlanCache",
    "PlanMetrics",
    "QueryTemplate",
    "ResumeDecision",
    "SLOT_PREFIX",
    "TemplateInstance",
    "batch_layout",
    "batched_soi",
    "bucket_for",
    "canonicalize",
    "choose_engine",
    "default_spec",
    "estimate_costs",
    "machine_fingerprint",
    "resume_decision",
    "template_key",
]
