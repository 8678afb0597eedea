"""The query-engine facade (DESIGN.md 5.5).

``Engine(db)`` owns everything a serving process needs: the parsed-query →
template canonicalizer, the LRU plan cache keyed by (template, graph
fingerprint, batch bucket), the cost model that picks a fixpoint engine per
plan, and the microbatcher that groups same-template requests into one
disjoint-union solve.  ``execute`` handles one request end-to-end (UNION
queries run one plan per union-free part and union the results);
``execute_many`` batches a request list through the microbatcher.

Results carry the survivor triple mask (Sect. 5 pruning), per-variable
candidate bindings under the query's own variable names, per-stage timings,
and the cache/batch provenance — enough for a caller to assert the warm
path did no recompilation.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from typing import Sequence

import numpy as np

from repro_torch.core import pruning, soi as soi_mod, sparql
from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.core.graph import Graph
from repro_torch.core.sparql import Query

from . import cost as cost_mod, machine as machine_mod
from .batcher import DEFAULT_BUCKETS, MicroBatcher, bucket_for
from .cache import BoundedDict, CacheStats, PlanCache
from .plan import CompiledPlan
from .template import TemplateInstance, canonicalize


@dataclasses.dataclass
class ExecResult:
    """Outcome of one request."""

    survivors: np.ndarray  # bool mask over db.triples (Sect. 5 pruning)
    stats: pruning.PruneStats
    bindings: dict[str, np.ndarray]  # query var -> candidate node mask
    sweeps: int
    engine: str  # fixpoint engine(s) used
    template_keys: tuple[str, ...]
    cache_hit: bool  # every plan this request needed was cached
    batch: int  # microbatch bucket the request rode in
    timings: dict[str, float]  # per-stage seconds


@dataclasses.dataclass
class EngineMetrics:
    """Cumulative serving counters, split by the invalidation taxonomy.

    On a mutation, a superseded plan is either *cold-invalidated*
    (``cache.invalidations``: dictionary/shape change, or no delta log —
    full rebuild on next use) or *reclassified resumable*
    (``plans_resumable``: staged with its delta; on next use it is patched
    in place and warm-started — ``plans_resumed``).  ``resumes_declined``
    counts staged plans that went cold after all: the cost model judged
    the delta too large, a later dictionary-changing mutation discarded
    the staging area, or the bounded staging evicted them — so
    ``plans_resumable == plans_resumed + resumes_declined + |staged|``.  ``warm_resume_solves`` counts solves
    that actually started from a previous fixpoint, and
    ``adj_rebuilds_saved`` counts adjacency uploads avoided because the
    delta touched none of an entry's labels (DESIGN.md Sect. 8).
    """

    requests: int
    microbatches: int  # == fixpoint solves: one disjoint-union solve each
    engine_counts: dict[str, int]
    cache: CacheStats
    stage_seconds: dict[str, float]
    invalidation_events: int = 0  # refreshes that adopted a mutated snapshot
    adj_invalidations: int = 0  # adjacency entries dropped on those refreshes
    plans_resumable: int = 0  # stale plans reclassified resumable (staged)
    plans_resumed: int = 0  # staged plans actually patched + reused
    resumes_declined: int = 0  # staged plans the cost model sent cold
    warm_resume_solves: int = 0  # fixpoint solves warm-started from old chi
    adj_rebuilds_saved: int = 0  # adjacency kept because its labels were untouched

    @property
    def plan_builds(self) -> int:
        """Plans built from scratch (cache misses minus in-place resumes)."""
        return self.cache.misses - self.plans_resumed

    @property
    def plan_invalidations(self) -> int:
        """Cold invalidations: superseded plans dropped outright."""
        return self.cache.invalidations


def graph_fingerprint(g: Graph) -> str:
    """Content hash binding cached plans to one database state.

    The name dictionaries are part of the state: two snapshots with
    identical int arrays but different ``node_names``/``label_names``
    encodings are *different* databases (constants resolve to different
    ids), so they must not share plans.
    """
    h = hashlib.blake2b(digest_size=12)
    h.update(np.ascontiguousarray(g.triples).tobytes())
    h.update(f"{g.n_nodes}/{g.n_labels}".encode())
    for names in (g.node_names, g.label_names):
        # length-prefix each list so the node/label boundary is unambiguous
        # (['a','bc']/['d'] must not collide with ['a','b']/['cd'])
        if names is None:
            h.update(b"\x00")
        else:
            h.update(f"{len(names)}\x1e".encode())
            h.update("\x1f".join(names).encode())
            h.update(b"\x1e")
    return h.hexdigest()


class Engine:
    """Facade over template → plan-cache → microbatch → fixpoint → prune."""

    def __init__(
        self,
        db,
        *,
        engine: str = "auto",
        cache_capacity: int = 64,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        device=DEFAULT_DEVICE,
        incremental: bool = True,
        spec: machine_mod.MachineSpec | None = None,
    ):
        """Build the facade over ``db`` (a Graph or a mutable GraphDB source).

        ``device`` holds every plan's operands and runs every fixpoint
        (``"cuda"`` by default; raises without a card unless ``"cpu"`` is
        asked for).  ``incremental`` enables warm-resume maintenance of
        superseded plans across shape-stable mutations (DESIGN.md Sect. 8);
        with it off, every mutation invalidates cold, as before.

        ``spec`` pins the machine calibration every cost decision (engine
        auto-selection, resume-vs-cold, serving admission) prices with;
        ``None`` resolves the machine's persisted spec via
        :func:`repro_torch.engine.machine.default_spec` (hand-tuned fallback when
        absent or disabled — DESIGN.md Sect. 13).
        """
        # ``db`` is either an immutable core Graph or a mutable source with
        # (graph, version, fingerprint, node_index) — i.e. repro_torch.db.GraphDB.
        # Duck-typed so this module never imports the layer above it.
        self._source = db if hasattr(db, "graph") and hasattr(db, "version") else None
        self.db: Graph = self._source.graph if self._source is not None else db
        self.engine_pref = engine
        self.buckets = tuple(sorted(buckets))
        self.device = resolve_device(device)
        # resolved once so introspection (`eng.spec`) shows the calibration
        # actually in force; None means the hand-tuned fallback model
        self.spec = (
            spec if spec is not None
            else machine_mod.default_spec(self.device.type)
        )
        self.cache = PlanCache(cache_capacity)
        # (engine, mats) -> device adjacency, shared across plans; bounded so
        # a churning template mix cannot pin unbounded device memory
        self._adj_cache = BoundedDict(capacity=16)
        if self._source is not None:
            self.fingerprint = self._source.fingerprint
            self._version = self._source.version
            self._node_index = self._source.node_index
        else:
            self.fingerprint = graph_fingerprint(self.db)
            self._version = None
            self._node_index = (
                self.db.node_index() if self.db.node_names is not None else {}
            )
        self._prev_db: Graph = self.db  # adjacency retention window
        self.incremental = incremental
        # superseded-but-resumable plans: (template key, bucket, engine)
        # -> (plan, composed delta from its snapshot to now)
        self._resumable: dict = {}
        # one lock for every serving counter below: updates that belong to
        # one event (a microbatch's count + its engine tally) commit
        # atomically, and stats() copies under the same lock, so a reader
        # thread can never observe a torn snapshot (DESIGN.md 10.5)
        self._stats_lock = threading.Lock()
        self._requests = 0  # guarded-by: _stats_lock
        self._microbatches = 0  # guarded-by: _stats_lock
        self._invalidation_events = 0  # guarded-by: _stats_lock
        self._adj_invalidations = 0  # guarded-by: _stats_lock
        self._plans_resumable = 0  # guarded-by: _stats_lock
        self._plans_resumed = 0  # guarded-by: _stats_lock
        self._resumes_declined = 0  # guarded-by: _stats_lock
        self._warm_solves = 0  # guarded-by: _stats_lock
        self._adj_rebuilds_saved = 0  # guarded-by: _stats_lock
        self._engine_counts: dict[str, int] = {}  # guarded-by: _stats_lock
        self._stage_seconds: dict[str, float] = {}  # guarded-by: _stats_lock
        # fault-injection hook armed by the serving layer (a
        # repro_torch.faults.BoundFaults); None disarms the site at the
        # cost of one attribute read per batch
        self.faults = None

    # ------------------------------------------------------------------ #
    # versioned invalidation (repro_torch.db.GraphDB mutations)
    # ------------------------------------------------------------------ #
    def refresh(self) -> int:
        """Adopt the source database's current snapshot if it has mutated.

        Called on every execute/plan access; a no-op unless the source's
        monotone version counter moved.  Invalidation is *precise*, not a
        flush, and it is also *classified* (DESIGN.md 8.3):

        * **resumable** — the source's delta log covers the gap and the
          delta is shape-stable (no new nodes/labels).  Plans keyed at the
          superseded fingerprint are moved into a staging area together
          with the delta; on next use they are patched in place and their
          last fixpoint warm-starts the solve.  Plans staged by an earlier
          refresh compose their delta forward.  Adjacency entries whose
          operator labels the delta does not touch are bit-identical in the
          new snapshot, so they are re-keyed instead of rebuilt (counted in
          ``adj_rebuilds_saved``).
        * **cold** — dictionary/shape change, or no usable delta.  Plans
          keyed outside the {current, previous} fingerprint window are
          dropped and counted in ``cache.invalidations`` (the previous
          window survives so results in flight keep their plans); staged
          resumables are discarded; adjacency from graphs outside the
          window is dropped (it can never hit again — the adjacency cache
          matches on graph identity).

        Returns the number of plans cold-invalidated by this call.
        """
        if self._source is None or self._source.version == self._version:
            return 0
        prev_fp, prev_db, prev_version = self.fingerprint, self.db, self._version
        version = self._source.version
        self.db = self._source.graph
        self.fingerprint = self._source.fingerprint
        self._node_index = self._source.node_index
        delta = None
        if self.incremental:
            delta_since = getattr(self._source, "delta_since", None)
            if delta_since is not None:
                delta = delta_since(prev_version)
        if self._source.version != version:
            # the source mutated between reading the snapshot and the delta
            # (an unlocked direct Engine): the pair may be torn, so fall
            # back to cold — patching with a mismatched delta could mix two
            # graph versions inside one plan's operands.  self._version
            # stays at the first read, so the next refresh re-adopts.
            delta = None
        self._version = version
        resumable = delta is not None and delta.shape_stable

        staged = declined = adj_saved = adj_dropped = 0
        if resumable:
            # earlier-staged plans ride forward under the composed delta
            self._resumable = {
                k: (plan, d.compose(delta))
                for k, (plan, d) in self._resumable.items()
            }
            moved = self.cache.pop_matching(lambda key: key[1] == prev_fp)
            for key, plan in moved:
                self._resumable[(key[0], *key[2:])] = (plan, delta)
            staged = len(moved)
            # bounded staging: never pin more superseded plans (device
            # operands + chi memos) than the live cache could hold — the
            # oldest staged entries go cold, counted as declined resumes
            while len(self._resumable) > self.cache.capacity:
                self._resumable.pop(next(iter(self._resumable)))
                declined += 1
        else:
            # staged plans cannot survive a dictionary/shape change (or a
            # truncated delta log): they go cold, counted as declined
            declined = len(self._resumable)
            self._resumable.clear()

        keep_fp = {self.fingerprint, prev_fp}
        dropped = self.cache.invalidate(lambda key: key[1] not in keep_fp)
        touched = delta.touched_labels() if resumable else None
        for k, (g_stored, adj) in list(self._adj_cache.items()):
            if g_stored is self.db:
                continue
            if g_stored is prev_db:
                if resumable and not ({la for la, _ in k[1]} & touched):
                    # untouched labels: the arrays are bit-identical in the
                    # new snapshot — re-key instead of rebuilding later
                    self._adj_cache[k] = (self.db, adj)
                    adj_saved += 1
                continue  # retention window: in-flight plans share these
            del self._adj_cache[k]
            adj_dropped += 1
        self._prev_db = prev_db
        # RL3: the whole refresh commits as one atomic stats event — a
        # stats() reader on another thread sees all of it or none of it
        with self._stats_lock:
            self._plans_resumable += staged
            self._resumes_declined += declined
            self._adj_rebuilds_saved += adj_saved
            self._adj_invalidations += adj_dropped
            self._invalidation_events += 1
        return dropped

    # ------------------------------------------------------------------ #
    # plan access
    # ------------------------------------------------------------------ #
    def plan_for(
        self, instance_or_template, bucket: int = 1, *, _refresh: bool = True
    ) -> tuple[CompiledPlan, bool]:
        """Fetch (or build) the plan for a template at one batch bucket.

        Returns ``(plan, cache_hit)``.  ``_refresh=False`` is the internal
        mid-batch path: the snapshot was already pinned at the batch
        boundary and must not move under in-flight requests.
        """
        if _refresh:
            self.refresh()
        template = (
            instance_or_template.template
            if isinstance(instance_or_template, TemplateInstance)
            else instance_or_template
        )
        key = (template.key, self.fingerprint, bucket, self.engine_pref)
        hit = key in self.cache
        plan = self.cache.get_or_build(
            key, lambda: self._build_or_resume(template, bucket, key)
        )
        return plan, hit

    def _build_or_resume(self, template, bucket: int, key) -> CompiledPlan:
        """Miss path: patch a staged resumable plan, or build from scratch.

        A staged plan resumes when the cost model expects the patch + warm
        sweeps to undercut a rebuild (:func:`repro_torch.engine.cost.
        resume_decision`); either way the outcome is re-keyed under the
        current fingerprint by the caller's ``get_or_build``.
        """
        staged = self._resumable.pop((key[0], *key[2:]), None)
        if staged is not None:
            plan, delta = staged
            decision = cost_mod.resume_decision(
                self.db,
                plan.csoi,
                engine=plan.engine,
                delta_edges=delta.n_changes,
                last_sweeps=plan.last_sweeps,
                backend=self.device.type,
                spec=self.spec,
            )
            if decision.resume:
                try:
                    plan.patch_graph(
                        self.db, delta, self._node_index, self._adj_cache
                    )
                except ValueError:
                    with self._stats_lock:
                        self._resumes_declined += 1  # not actually patchable
                else:
                    with self._stats_lock:
                        self._plans_resumed += 1
                    return plan
            else:
                with self._stats_lock:
                    self._resumes_declined += 1
        return CompiledPlan(
            template,
            self.db,
            engine=self.engine_pref,
            batch=bucket,
            node_index=self._node_index,
            device=self.device,
            adj_cache=self._adj_cache,
            spec=self.spec,
            # chi memoization only pays off when the graph can mutate: a
            # plan over a plain immutable Graph never stages warm starts
            incremental=self.incremental and self._source is not None,
        )

    # ------------------------------------------------------------------ #
    # execution
    # ------------------------------------------------------------------ #
    def execute(self, query: str | Query) -> ExecResult:
        """Run one query end-to-end (parse → plans → solve → prune)."""
        self.refresh()
        return self._execute_pinned(query)

    def _execute_pinned(self, query: str | Query) -> ExecResult:
        """``execute`` against the already-adopted snapshot (no refresh):
        the mid-batch path of :meth:`execute_prepared`, where every request
        of one call must see one graph version even if the source mutates
        concurrently."""
        t0 = time.perf_counter()
        q, t_parse = self._parse(query)
        parts = sparql.union_split(q)
        partials = []
        for part in parts:
            inst = canonicalize(part)
            partials.append(self._solve_microbatch([(0, inst)])[0][1])
        res = _merge_union(partials, self.db)
        res.timings["parse"] = t_parse
        res.timings["total"] = time.perf_counter() - t0
        res.timings["batch_total"] = res.timings["total"]  # batch of one
        with self._stats_lock:
            self._requests += 1
        self._bump_stage("parse", t_parse)
        return res

    def prepare(self, query: str | Query) -> tuple[Query, TemplateInstance | None]:
        """Parse + canonicalize a request once, ahead of execution.

        Returns ``(query, instance)`` where ``instance`` is the canonical
        template instance for union-free requests and ``None`` for UNION
        requests (which need cross-part merging and run unbatched).  The
        result is graph-independent, so it stays valid across mutations —
        sessions prepare at submit time (they need the template key for
        admission anyway) and hand the prepared pairs to
        :meth:`execute_prepared` at flush, paying canonicalization once.
        """
        q, t_parse = self._parse(query)
        self._bump_stage("parse", t_parse)
        parts = sparql.union_split(q)
        return q, canonicalize(parts[0]) if len(parts) == 1 else None

    def execute_many(self, queries: Sequence[str | Query]) -> list[ExecResult]:
        """Run a request list, microbatching same-template requests."""
        return self.execute_prepared([self.prepare(q) for q in queries])

    def execute_prepared(
        self, prepared: Sequence[tuple[Query, TemplateInstance | None]]
    ) -> list[ExecResult]:
        """Run requests already split by :meth:`prepare`.

        The snapshot is pinned ONCE here: every request of the call —
        microbatched and multipart (UNION) alike — executes against the
        same graph version, even when the source database mutates while
        the batch is in flight.
        """
        if self.faults is not None:
            # deterministic injection site (DESIGN.md 14.1): a poisoned
            # request raises here, on every replica it is retried on
            self.faults.on_execute_prepared(list(prepared))
        self.refresh()
        results: list[ExecResult | None] = [None] * len(prepared)
        batcher = MicroBatcher(self.buckets)
        multipart: list[tuple[int, Query]] = []
        for idx, (q, inst) in enumerate(prepared):
            if inst is not None:
                batcher.add(idx, inst)
            else:
                # UNION requests need cross-part merging; run them unbatched
                multipart.append((idx, q))
        for mb in batcher.drain():
            t_mb = time.perf_counter()
            solved = self._solve_microbatch(mb.requests, bucket=mb.bucket)
            dt = time.perf_counter() - t_mb
            # honest attribution: the microbatch wall time is a *batch*
            # property; a request's own "total" is its fair share of it
            share = dt / len(mb.requests)
            for idx, res in solved:
                res.timings["batch_total"] = dt
                res.timings["total"] = share
                results[idx] = res
        for idx, q in multipart:
            # NOT self.execute(): that would refresh() mid-batch and let one
            # execute_many call mix two graph versions under mutation
            results[idx] = self._execute_pinned(q)
        with self._stats_lock:
            self._requests += len(prepared) - len(multipart)  # _execute_pinned counted the rest
        return results  # type: ignore[return-value]

    # ------------------------------------------------------------------ #
    def _parse(self, query: str | Query) -> tuple[Query, float]:
        t = time.perf_counter()
        q = sparql.parse(query) if isinstance(query, str) else query
        return q, time.perf_counter() - t

    def _solve_microbatch(
        self,
        requests: list[tuple[int, TemplateInstance]],
        bucket: int | None = None,
    ) -> list[tuple[int, ExecResult]]:
        """Solve same-template requests as one padded disjoint-union batch."""
        # requests with identical constants share one instance slot
        by_consts: dict[tuple[str, ...], list[tuple[int, TemplateInstance]]] = {}
        for idx, inst in requests:
            by_consts.setdefault(inst.constants, []).append((idx, inst))
        uniq = list(by_consts)
        if bucket is None:
            bucket = bucket_for(len(uniq), self.buckets)
        bindings = uniq + [uniq[-1]] * (bucket - len(uniq))  # pad: repeat last

        t = time.perf_counter()
        # snapshot already pinned by the caller (execute/execute_prepared)
        plan, hit = self.plan_for(requests[0][1].template, bucket, _refresh=False)
        t_plan = time.perf_counter() - t

        t = time.perf_counter()
        warm_before = plan.metrics.warm_resumes
        chi, sweeps = plan.execute(bindings)
        t_solve = time.perf_counter() - t
        with self._stats_lock:
            # one atomic commit per microbatch event, so every stats()
            # snapshot satisfies sum(engine_counts) == microbatches
            self._warm_solves += plan.metrics.warm_resumes - warm_before
            self._microbatches += 1
            self._engine_counts[plan.engine] = (
                self._engine_counts.get(plan.engine, 0) + 1
            )
        self._bump_stage("plan", t_plan)
        self._bump_stage("solve", t_solve)

        out: list[tuple[int, ExecResult]] = []
        for i, consts in enumerate(uniq):
            t = time.perf_counter()
            chi_i = chi[plan.layout.chi_slice(i)]
            mask, stats = pruning.prune_triples(plan.base_soi, chi_i, self.db)
            canon_rows = soi_mod.collect(plan.base_soi, chi_i)
            t_prune = time.perf_counter() - t
            self._bump_stage("prune", t_prune)
            for idx, inst in by_consts[consts]:
                out.append(
                    (
                        idx,
                        ExecResult(
                            survivors=mask,
                            stats=stats,
                            bindings=inst.rename_bindings(canon_rows),
                            sweeps=sweeps,
                            engine=plan.engine,
                            template_keys=(plan.template.key,),
                            cache_hit=hit,
                            batch=bucket,
                            timings={
                                "plan": t_plan,
                                "solve": t_solve,
                                "prune": t_prune,
                            },
                        ),
                    )
                )
        return out

    def _bump_stage(self, stage: str, seconds: float) -> None:
        with self._stats_lock:
            self._stage_seconds[stage] = (
                self._stage_seconds.get(stage, 0.0) + seconds
            )

    # ------------------------------------------------------------------ #
    def stats(self) -> EngineMetrics:
        """A *consistent* point-in-time snapshot of the serving counters.

        The whole copy happens under the counters' lock, so concurrent
        sessions and the serving loop can read mid-flight without torn
        values: in every snapshot ``sum(engine_counts.values()) ==
        microbatches``, and the dict copies never race their writers
        (asserted under a multithreaded hammer in ``tests/test_serve.py``).
        """
        with self._stats_lock:
            return EngineMetrics(
                requests=self._requests,
                microbatches=self._microbatches,
                engine_counts=dict(self._engine_counts),
                cache=self.cache.stats(),
                stage_seconds=dict(self._stage_seconds),
                invalidation_events=self._invalidation_events,
                adj_invalidations=self._adj_invalidations,
                plans_resumable=self._plans_resumable,
                plans_resumed=self._plans_resumed,
                resumes_declined=self._resumes_declined,
                warm_resume_solves=self._warm_solves,
                adj_rebuilds_saved=self._adj_rebuilds_saved,
            )

    def metrics(self) -> EngineMetrics:
        """Alias of :meth:`stats` (the original name, kept for callers)."""
        return self.stats()


def _merge_union(partials: list[ExecResult], db: Graph) -> ExecResult:
    """Union the per-part results of a UNION query (single part: identity)."""
    if len(partials) == 1:
        return partials[0]
    mask = np.zeros(db.n_edges, dtype=bool)
    bindings: dict[str, np.ndarray] = {}
    per_edge: list[int] = []
    sweeps = 0
    timings: dict[str, float] = {}
    for p in partials:
        mask |= p.survivors
        sweeps += p.sweeps
        per_edge += p.stats.per_edge_survivors
        for var, row in p.bindings.items():
            bindings[var] = bindings.get(var, np.zeros(db.n_nodes, bool)) | row
        for k, v in p.timings.items():
            timings[k] = timings.get(k, 0.0) + v
    n_after = int(mask.sum())
    stats = pruning.PruneStats(
        n_triples=db.n_edges,
        n_after=n_after,
        fraction_pruned=1.0 - n_after / max(db.n_edges, 1),
        per_edge_survivors=per_edge,
    )
    return ExecResult(
        survivors=mask,
        stats=stats,
        bindings=bindings,
        sweeps=sweeps,
        engine=",".join(sorted({p.engine for p in partials})),
        template_keys=tuple(k for p in partials for k in p.template_keys),
        cache_hit=all(p.cache_hit for p in partials),
        batch=max(p.batch for p in partials),
        timings=timings,
    )
