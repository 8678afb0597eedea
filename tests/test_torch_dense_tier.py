"""The port's dense-adjacency tier (``dense``, ``packed``, ``packed_fused``)
against the JAX package: the same operands, the same chi and sweep counts
from the solvers (the reference's ``packed`` interprets its Pallas kernel,
its ``packed_fused`` runs both the word-wise lowering and the interpreted
kernel), replays of the cross-engine and churn-resume properties over all
five engines, ``GraphDB`` end to end with each engine pinned, and the cost
model's prices and choices.  No tolerance anywhere: the greatest fixpoint
is unique."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dualsim as ref_dualsim
from repro.core import soi as ref_soi
from repro.core import sparql as ref_sparql
from repro.data import synth as ref_synth
from repro.db import GraphDB as RefGraphDB
from repro.engine import cost as ref_cost
from repro.engine import machine as ref_machine
from repro_torch import convert
from repro_torch.core import bitops, dualsim, soi, sparql
from repro_torch.core.graph import DENSE_ADJ_MAX_BYTES
from repro_torch.data import synth
from repro_torch.db import GraphDB
from repro_torch.engine import canonicalize, cost, machine
from tests.test_torch_db import MEMBERS_OF, QUERIES, _dbs, _same_result
from tests.test_torch_dualsim import (
    _mutate,
    _pattern_instance,
    _random_query,
    _ref_fields,
    _ref_query,
    _same_operands,
)

TIER = dualsim.DENSE_TIER_ENGINES


def _kind(engine: str) -> str:
    return "dense" if engine == "dense" else "packed"


def _adj(ops):
    return ops.adj_dense if ops.adj_dense is not None else ops.adj_packed


def _ref_solve(engine, rops, impl="words", **kw):
    """The reference solver of ``engine`` on the CPU."""
    if engine == "dense":
        return ref_dualsim.solve_dense(rops, **kw)
    if engine == "packed":
        return ref_dualsim.solve_packed(rops, interpret=True, **kw)
    return ref_dualsim.solve_packed_fused(rops, impl=impl, **kw)


def _solve(engine, ops, **kw):
    return getattr(dualsim, f"solve_{engine}")(ops, **kw)


# --------------------------------------------------------------------- #
# operands and solvers
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("kind", ["dense", "packed"])
@pytest.mark.parametrize("seed", [21, 5])
def test_operands_equal_reference(kind, seed):
    """The stacked adjacency, init and tables equal the reference's arrays
    (packed words as uint32); the graph packs straight from its edges to
    the reference's packed planes."""
    g, rg, c, rc = _pattern_instance(seed)
    ops = getattr(dualsim, f"make_{kind}_operands")(c, g, device="cpu")
    rops = getattr(ref_dualsim, f"make_{kind}_operands")(rc, rg)
    _same_operands(ops, rops)
    assert _adj(ops).shape[0] == len(c.mats)
    for la in range(g.n_labels):
        for backward in (False, True):
            assert np.array_equal(g.packed_adjacency(la, backward),
                                  rg.packed_adjacency(la, backward))


def test_packed_adjacency_dedups_edges_and_keeps_the_tier_gate():
    g = synth.random_graph(40, 1, 10, seed=0)
    g.triples = np.vstack([g.triples, g.triples])  # every edge twice
    want = bitops.pack_np(g.dense_adjacency(0))
    assert np.array_equal(g.packed_adjacency(0), want)
    big = synth.random_graph(int(DENSE_ADJ_MAX_BYTES ** 0.5) + 1, 1, 10, seed=0)
    with pytest.raises(MemoryError):
        big.packed_adjacency(0)
    with pytest.raises(MemoryError):
        big.dense_adjacency(0)


def test_operands_hold_one_layout_and_a_card_takes_the_dense_tier():
    """Dense and packed adjacency are layouts of their own; a card
    (``meta`` stands in for it) takes them, never the flat lists."""
    g, _, c, _ = _pattern_instance(21)
    packed = dualsim.make_packed_operands(c, g, device="cpu")
    dense = dualsim.make_dense_operands(c, g, device="cpu")
    with pytest.raises(ValueError, match="exactly one edge layout"):
        dataclasses.replace(packed, adj_dense=dense.adj_dense)
    fields = {f.name: getattr(packed, f.name)
              for f in dataclasses.fields(packed)}
    on_meta = dualsim.Operands(**{
        **fields, "init": packed.init.to("meta"),
        "adj_packed": packed.adj_packed.to("meta"),
    })
    assert on_meta.adj_packed.device.type == "meta"
    with pytest.raises(ValueError, match="edge layout"):
        dualsim.solve_sparse(packed)
    with pytest.raises(ValueError, match="packed adjacency"):
        dualsim.solve_packed_fused(dense)


@pytest.mark.parametrize("engine", TIER)
@pytest.mark.parametrize("seed", [21, 8, 40])
def test_solvers_match_reference(engine, seed):
    """Same chi and sweeps as the reference (every lowering it has on the
    CPU), with operands handed over through convert.operands_from_numpy
    and built by the port itself."""
    g, rg, c, rc = _pattern_instance(seed)
    kind = _kind(engine)
    rops = getattr(ref_dualsim, f"make_{kind}_operands")(rc, rg)
    impls = ("words", "interpret") if engine == "packed_fused" else ("words",)
    runs = [_ref_solve(engine, rops, impl) for impl in impls]
    truth, _ = ref_dualsim.solve_worklist(rc, rg)
    ops = convert.operands_from_numpy(_ref_fields(rops), device="cpu")
    assert _adj(ops) is not None and ops.edge_src is None
    own = getattr(dualsim, f"make_{kind}_operands")(c, g, device="cpu")
    for operands in (ops, own):
        chi, it = _solve(engine, operands)
        assert np.array_equal(chi.numpy(), truth)
        for rchi, rit in runs:
            assert np.array_equal(chi.numpy(), np.asarray(rchi))
            assert it == int(rit)


@pytest.mark.parametrize("engine", TIER)
@pytest.mark.parametrize("max_sweeps", [1, 2, 3])
def test_max_sweeps_cap_matches_reference(engine, max_sweeps):
    g, rg, c, rc = _pattern_instance(13, n=120)
    kind = _kind(engine)
    rops = getattr(ref_dualsim, f"make_{kind}_operands")(rc, rg)
    rchi, rit = _ref_solve(engine, rops, max_sweeps=max_sweeps)
    ops = getattr(dualsim, f"make_{kind}_operands")(c, g, device="cpu")
    chi, it = _solve(engine, ops, max_sweeps=max_sweeps)
    assert it == int(rit) <= max_sweeps
    assert np.array_equal(chi.numpy(), np.asarray(rchi))


@pytest.mark.parametrize("engine", TIER)
def test_warm_start_matches_reference(engine):
    """A warm start above the fixpoint reaches it in the reference's sweep
    count; the fused engine takes the start as bool or as packed words."""
    g, rg, c, rc = _pattern_instance(3)
    truth, _ = ref_dualsim.solve_worklist(rc, rg)
    rng = np.random.default_rng(3)
    chi0 = truth | (rng.random(truth.shape) < 0.3)
    kind = _kind(engine)
    rops = getattr(ref_dualsim, f"make_{kind}_operands")(rc, rg)
    rchi, rit = _ref_solve(engine, rops, chi0=jnp.asarray(chi0))
    ops = getattr(dualsim, f"make_{kind}_operands")(c, g, device="cpu")
    starts = [torch.as_tensor(chi0)]
    if engine == "packed_fused":
        starts.append(bitops.pack(torch.as_tensor(chi0)))
    for start in starts:
        chi, it = _solve(engine, ops, chi0=start)
        assert np.array_equal(chi.numpy(), truth)
        assert np.array_equal(chi.numpy(), np.asarray(rchi))
        assert it == int(rit)


def test_largest_dual_simulation_matches_reference():
    pat = ref_synth.random_pattern(4, 2, 6, seed=9)
    rg = ref_synth.random_graph(60, 2, 200, seed=10)
    want, _ = ref_dualsim.largest_dual_simulation(pat, rg, engine="dense")
    pat_t = synth.random_pattern(4, 2, 6, seed=9)
    g = synth.random_graph(60, 2, 200, seed=10)
    for engine in TIER:
        got, it = dualsim.largest_dual_simulation(pat_t, g, engine=engine,
                                                  device="cpu")
        assert np.array_equal(got, want), engine
        assert it == ref_dualsim.largest_dual_simulation(pat, rg,
                                                         engine=engine)[1]


# --------------------------------------------------------------------- #
# replays of the reference's cross-engine and churn-resume properties
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [0, 1, 2, 3, 7, 42])
def test_cross_engine_equivalence_replay_all_engines(seed):
    """All six port engines, in the reference's order, reach the worklist
    fixpoint, each in the reference's sweep count for that engine, on the
    reference's random graph x BGP/AND/OPTIONAL instances."""
    rng = np.random.default_rng(seed)
    n_labels = int(rng.integers(1, 4))
    kw = dict(n_nodes=int(rng.integers(3, 40)), n_labels=n_labels,
              n_edges=int(rng.integers(5, 120)), seed=seed + 1)
    g, rg = synth.random_graph(**kw), ref_synth.random_graph(**kw)
    q = _random_query(rng, n_labels, g.node_names)
    c = soi.compile_soi(soi.build_soi(q), g)
    rc = ref_soi.compile_soi(ref_soi.build_soi(_ref_query(q)), rg)
    want, _ = ref_dualsim.solve_worklist(rc, rg)
    assert dualsim.ENGINES == TIER + dualsim.EDGE_ENGINES == ref_cost.ENGINES
    for eng in dualsim.ENGINES:
        chi, it = dualsim.solve_compiled(c, g, engine=eng, device="cpu")
        assert np.array_equal(chi, want), f"{eng} != worklist (seed {seed})"
        assert it == ref_dualsim.solve_compiled(rc, rg, engine=eng)[1], eng


@pytest.mark.parametrize("seed", [0, 1, 2, 5, 11])
def test_churn_resume_replay(seed):
    """Across a random mutation sequence, the port's resume_fixpoint equals
    the reference's and the cold worklist, chi and sweeps, for the three
    dense-tier engines."""
    from repro.core.graph import Graph as RefGraph

    rng = np.random.default_rng(seed)
    n_labels = int(rng.integers(1, 4))
    kw = dict(n_nodes=int(rng.integers(8, 40)), n_labels=n_labels,
              n_edges=int(rng.integers(10, 120)), seed=seed + 1)
    g = synth.random_graph(**kw)
    names, labels = g.node_names, g.label_names
    q = _random_query(rng, n_labels, names)
    s, rs = soi.build_soi(q), ref_soi.build_soi(_ref_query(q))
    rg = ref_synth.random_graph(**kw)
    prev = {e: dualsim.solve_compiled(soi.compile_soi(s, g), g, engine=e,
                                      device="cpu")[0] for e in TIER}
    rprev = dict(prev)
    triples = g.triples
    for _ in range(3):
        triples, ins = _mutate(rng, triples, g.n_nodes, g.n_labels)
        g = convert.graph_from_arrays(triples, names, labels)
        rg = RefGraph(rg.n_nodes, rg.n_labels, triples.copy(), names, labels)
        c, rc = soi.compile_soi(s, g), ref_soi.compile_soi(rs, rg)
        want, _ = ref_dualsim.solve_worklist(rc, rg)
        for eng in TIER:
            warm, it = dualsim.resume_fixpoint(
                c, g, prev[eng], inserted_labels=ins, engine=eng, device="cpu"
            )
            rwarm, rit = ref_dualsim.resume_fixpoint(
                rc, rg, rprev[eng], inserted_labels=ins, engine=eng
            )
            assert np.array_equal(warm, want), f"{eng} (seed {seed})"
            assert np.array_equal(warm, rwarm) and it == rit
            prev[eng], rprev[eng] = warm, rwarm


@pytest.mark.parametrize("kind", ["dense", "packed"])
def test_patch_leaves_shared_adjacency_untouched(kind):
    """patch_operands builds a new stacked tensor: operands that share the
    old one through the adjacency cache (a sibling plan, or a plan still
    bound to the previous snapshot) keep it bit for bit; the patched
    operands equal a fresh build, are what the cache serves for the new
    snapshot, and resume to the cold fixpoint."""
    rng = np.random.default_rng(6)
    g = synth.random_graph(70, 3, 220, seed=6)  # 70 % 32 != 0
    names, labels = g.node_names, g.label_names
    s = soi.build_soi(sparql.parse(
        "{ ?a p0 ?b . ?b p1 ?c } OPTIONAL { ?c p2 ?d }"))
    make = getattr(dualsim, f"make_{kind}_operands")
    cache: dict = {}
    c = soi.compile_soi(s, g)
    ops = make(c, g, cache, device="cpu")
    sibling = make(c, g, cache, device="cpu")
    assert _adj(sibling) is _adj(ops)
    first = before = _adj(ops).clone()
    chi_prev = dualsim.solve_compiled(c, g, engine=kind, device="cpu")[0]
    for _ in range(3):
        triples, ins = _mutate(rng, g.triples, g.n_nodes, g.n_labels)
        g = convert.graph_from_arrays(triples, names, labels)
        c = soi.compile_soi(s, g)
        patched = dualsim.patch_operands(ops, c, g, set(range(g.n_labels)),
                                         adj_cache=cache)
        assert torch.equal(_adj(ops), before)
        assert torch.equal(_adj(sibling), first)
        assert torch.equal(_adj(patched), _adj(make(c, g, device="cpu")))
        assert _adj(make(c, g, cache, device="cpu")) is _adj(patched)
        chi0 = chi_prev.copy()
        chi0[dualsim.destabilized_rows(c, ins)] = True
        warm, _ = _solve(kind, patched, chi0=torch.from_numpy(chi0))
        assert np.array_equal(warm.numpy(), dualsim.solve_worklist(c, g)[0])
        ops, before, chi_prev = patched, _adj(patched).clone(), warm.numpy()


# --------------------------------------------------------------------- #
# GraphDB end to end with each engine pinned
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("engine", TIER)
@pytest.mark.parametrize("q", range(len(QUERIES)))
def test_query_matches_reference(engine, q):
    db, ref = _dbs(engine)
    _same_result(db.query(QUERIES[q]), ref.query(QUERIES[q]))
    again = db.query(QUERIES[q])
    assert again.cache_hit
    _same_result(again, ref.query(QUERIES[q]))


@pytest.mark.parametrize("engine", TIER)
def test_execute_many_and_session_like_reference(engine):
    db, ref = _dbs(engine, n_universities=4)
    qs = [MEMBERS_OF.format(uni=f"Univ{u}") for u in (0, 1, 2, 3, 0)]
    qs.append(QUERIES[4])
    got, want = db.execute_many(qs), ref.execute_many(qs)
    assert [r.batch for r in got] == [r.batch for r in want]
    assert max(r.batch for r in got) > 1
    for a, b in zip(got, want):
        _same_result(a, b)
    assert db.metrics().microbatches == ref.metrics().microbatches
    with db.session(max_delay_ms=1e6) as s, ref.session(max_delay_ms=1e6) as rs:
        futs = [s.submit(q) for q in qs[:4]]
        rfuts = [rs.submit(q) for q in qs[:4]]
    for f, rf in zip(futs, rfuts):
        _same_result(f.result(), rf.result())


@pytest.mark.parametrize("engine", TIER)
def test_mutation_resumes_like_reference(engine):
    """Delete + re-insert of one triple: the superseded plan is patched and
    warm-resumed in both packages, with the same answers and counters; the
    plan never builds its operands again, rebinding constants builds none,
    and a plan of another batch bucket still bound to the old snapshot
    keeps its adjacency unchanged."""
    db, ref = _dbs(engine)
    q = MEMBERS_OF.format(uni="Univ0")
    pair = [MEMBERS_OF.format(uni=f"Univ{u}") for u in (1, 2)]
    db.query(q)
    ref.query(q)
    db.execute_many(pair)
    ref.execute_many(pair)
    template = canonicalize(sparql.parse(q))
    plan, _ = db._engine.plan_for(template, bucket=1)
    other, _ = db._engine.plan_for(template, bucket=2)
    assert plan.metrics.operand_builds == other.metrics.operand_builds == 1
    assert _adj(plan.operands) is _adj(other.operands)  # one cached tensor
    kept = _adj(other.operands).clone()
    g = db.graph
    row = g.triples[int(np.flatnonzero(
        g.triples[:, 1] == g.label_id("memberOf"))[0])]
    t = (g.node_names[row[0]], g.label_names[row[1]], g.node_names[row[2]])
    for mutate in ("delete", "insert"):
        assert getattr(db, mutate)([t]) == getattr(ref, mutate)([t]) == 1
        _same_result(db.query(q), ref.query(q))
        m, rm = db.metrics(), ref.metrics()
        for name in ("plans_resumable", "plans_resumed", "resumes_declined",
                     "warm_resume_solves", "adj_rebuilds_saved",
                     "invalidation_events"):
            assert getattr(m, name) == getattr(rm, name), name
        assert torch.equal(_adj(other.operands), kept)
    assert db.metrics().plans_resumed >= 2
    assert plan.metrics.patches == 2 and plan.metrics.warm_resumes == 2
    for u in range(3):
        _same_result(db.query(MEMBERS_OF.format(uni=f"Univ{u}")),
                     ref.query(MEMBERS_OF.format(uni=f"Univ{u}")))
    assert plan.metrics.operand_builds == 1


# --------------------------------------------------------------------- #
# the cost model
# --------------------------------------------------------------------- #
def _specs(backend: str):
    """(port spec, reference spec) of one golden calibration."""
    kw = dict(
        device_kind="golden", fingerprint=f"golden-{backend}", n_devices=1,
        stream_bytes_per_s=8e11, dense_elems_per_s=1e12,
        packed_words_per_s=2.5e11, packed_words_per_s_xla=1e11,
        fused_words_per_s=1e12, kernel_launch_s=5e-6, dispatch_s=1e-6,
        trace_s=0.02,
    )
    if backend == "cpu":
        kw.update(stream_bytes_per_s=8e9, dense_elems_per_s=5e9,
                  packed_words_per_s=2e7, packed_words_per_s_xla=5e8,
                  fused_words_per_s=5e8, kernel_launch_s=2e-3,
                  dispatch_s=2e-5, trace_s=0.05)
    return (machine.MachineSpec(backend="cpu" if backend == "cpu" else "cuda",
                                **kw),
            ref_machine.MachineSpec(backend=backend, **kw))


# the port's backend and the JAX package's for the same kind of device
BACKENDS = [("cpu", "cpu"), ("cuda", "tpu")]


def _card_tier_prices(g, c, spec) -> dict[str, float]:
    """The dense-tier engines' per-sweep prices under a calibrated card
    spec, from the spec's fields (``engine/cost.py``'s docstring): the
    work is the init's set bits times the packed width; the dense engine
    also streams ``DENSE_PLANE_BYTES`` a plane element; every sweep pays
    one dispatch for its tail."""
    n, v, m = g.n_nodes, c.n_vars, len(c.mats)
    words = int(np.count_nonzero(c.init)) * ((n + 31) // 32)
    tail = spec.dispatch_s
    return {
        "dense": m * (v * n * n / spec.dense_elems_per_s
                      + cost.DENSE_PLANE_BYTES * n * n / spec.stream_bytes_per_s) + tail,
        "packed": m * (words / spec.packed_words_per_s + spec.kernel_launch_s
                       + spec.dispatch_s) + tail,
        "packed_fused": m * (words / spec.fused_words_per_s + spec.kernel_launch_s) + tail,
    }


def _resume_on(g, c, price, spec, delta, last_sweeps):
    """(resume, est_resume, est_cold) of the reference's resume rule over
    ``price`` a sweep under ``spec``."""
    e = int(sum(g.label_histogram()[la] for la, _ in c.mats))
    frac = delta / max(e, 1)
    s_resume = 1.0 + last_sweeps * min(1.0, ref_cost.RESUME_SWEEP_RATE * frac)
    est_cold = spec.trace_s + last_sweeps * price
    est_resume = 64.0 / spec.stream_bytes_per_s * delta + s_resume * price
    return (frac <= ref_cost.RESUME_MAX_DELTA_FRACTION and est_resume < est_cold,
            est_resume, est_cold)


def _graphs():
    return [
        (synth.lubm_like(3, seed=0), ref_synth.lubm_like(3, seed=0)),
        (synth.random_graph(48, 2, 1500, seed=0),
         ref_synth.random_graph(48, 2, 1500, seed=0)),
        (synth.random_graph(2000, 2, 20_000, seed=1),
         ref_synth.random_graph(2000, 2, 20_000, seed=1)),
    ]


@pytest.mark.parametrize("calibrated", [False, True])
@pytest.mark.parametrize("backends", BACKENDS)
@pytest.mark.parametrize("graph", range(3))
def test_cost_model_matches_reference(graph, backends, calibrated):
    """Every engine's price, the choice, and every engine's resume decision
    equal the reference's for the same graph and calibration; under a
    calibrated card's spec the edge engines' still do, and the three
    dense-tier engines are priced by the port's kernels' work, their
    resume decisions by the reference's rule over those prices."""
    g, rg = _graphs()[graph]
    texts = (["{ ?a p0 ?b . ?b p1 ?c }", "{ ?a p1 ?b } OPTIONAL { ?b p0 ?c }"]
             if graph else QUERIES[:4])
    port_backend, ref_backend = backends
    spec, rspec = _specs(ref_backend) if calibrated else (None, None)
    card = calibrated and port_backend == "cuda"
    for text in texts:
        c = soi.compile_soi(soi.build_soi(sparql.parse(text)), g)
        rc = ref_soi.compile_soi(ref_soi.build_soi(ref_sparql.parse(text)), rg)
        got = cost.estimate_costs(g, c, backend=port_backend, spec=spec)
        want = ref_cost.estimate_costs(rg, rc, backend=ref_backend, spec=rspec)
        assert list(got) == list(cost.ENGINES)
        tier = _card_tier_prices(g, c, spec) if card else {}
        for engine in cost.ENGINES:  # all six, partitioned included
            if engine in tier:
                assert got[engine] == pytest.approx(tier[engine], rel=1e-12), engine
            else:
                assert got[engine] == want[engine], engine
        assert want["partitioned"] == float("inf")  # one device
        pick = cost.choose_engine(g, c, backend=port_backend, spec=spec).engine
        assert pick == min(got, key=got.get)
        if not card:
            assert pick == ref_cost.choose_engine(rg, rc, backend=ref_backend,
                                                  spec=rspec).engine
        for engine in cost.ENGINES:
            for delta in (1, 10_000):
                a = cost.resume_decision(
                    g, c, engine=engine, delta_edges=delta, last_sweeps=5,
                    backend=port_backend, spec=spec)
                b = ref_cost.resume_decision(
                    rg, rc, engine=engine, delta_edges=delta, last_sweeps=5,
                    backend=ref_backend, spec=rspec)
                if engine in tier:
                    b = _resume_on(g, c, tier[engine], spec, delta, 5)
                    assert a.resume == b[0], engine
                    assert (a.est_resume, a.est_cold) == pytest.approx(b[1:], rel=1e-12)
                else:
                    assert (a.resume, a.est_resume, a.est_cold) == (
                        b.resume, b.est_resume, b.est_cold), engine


def test_from_spec_derives_every_constant_like_reference():
    """Every constant derives from a spec as the reference derives it; on
    a card the per-word costs are the reciprocals of the fitted rates of
    K2 and the packed step, both engines pay K2's fitted launch, and the
    packed step's chain the measured dispatch."""
    for backend in ("cpu", "tpu"):
        spec, rspec = _specs(backend)
        got, want = cost.CostModel.from_spec(spec), ref_cost.CostModel.from_spec(rspec)
        for f in dataclasses.fields(got):
            if f.name != "source":
                assert getattr(got, f.name) == getattr(want, f.name), f.name
        if backend == "tpu":  # the card's spec (port backend "cuda")
            assert got.c_packed_fused == 1.0 / spec.fused_words_per_s
            assert got.c_packed == 1.0 / spec.packed_words_per_s
            assert got.fused_launch == got.packed_launch == spec.kernel_launch_s
            assert got.c_dispatch == spec.dispatch_s
            assert got.c_segor_byte == 1.0 / spec.stream_bytes_per_s
        fields = {f.name for f in dataclasses.fields(cost.CostModel)}
        assert all(hasattr(cost.HAND_TUNED, f) for f in fields)
    for name in ("c_dense", "c_packed", "c_packed_interpret", "c_packed_fused",
                 "c_packed_fused_cpu", "packed_launch", "fused_launch"):
        assert getattr(cost.HAND_TUNED, name) == getattr(ref_cost.HAND_TUNED, name)


def test_golden_cpu_spec_prefers_wordwise_over_interpreted_packed():
    spec, _ = _specs("cpu")
    mdl = cost.CostModel.from_spec(spec)
    assert mdl.c_packed_interpret > mdl.c_packed_fused_cpu
    g = synth.random_graph(n_nodes=2_000, n_labels=2, n_edges=20_000, seed=1)
    c = soi.compile_soi(soi.build_soi(sparql.parse("{ ?a p0 ?b . ?b p1 ?c }")), g)
    costs = cost.estimate_costs(g, c, backend="cpu", spec=spec)
    assert costs["packed_fused"] < costs["packed"]


def test_golden_accel_spec_picks_fused_past_the_launch_knee():
    """On the card, past the knee (n=4096, 2M edges) packed_fused wins, as
    the reference's accelerator golden; below it (n=256) dense is the
    dense tier's cheapest, but with the tier priced by the port's kernels'
    work (the plane's f32 conversion, a sweep's tail) this spec's 1 us
    dispatch leaves sparse cheaper still, where the reference picks dense
    (the H100's own spec picks dense there:
    ``test_golden_h100_spec_picks_the_engine_the_card_runs_fastest``)."""
    spec, _ = _specs("tpu")
    text = "{ ?a p0 ?b . ?b p1 ?c }"
    for n, e, engine in ((4096, 2_000_000, "packed_fused"), (256, 8192, "sparse")):
        g = synth.random_graph(n_nodes=n, n_labels=2, n_edges=e, seed=2)
        c = soi.compile_soi(soi.build_soi(sparql.parse(text)), g)
        est = cost.choose_engine(g, c, spec=spec, backend="cuda")
        assert est.engine == engine
        tier = _card_tier_prices(g, c, spec)
        for name, price in tier.items():
            assert est.costs[name] == pytest.approx(price, rel=1e-12), name
        if n == 256:
            assert min(tier, key=tier.get) == "dense"


def test_hand_tuned_card_picks_fused_on_the_block_dense_graph():
    """The hand-tuned model on the card picks packed_fused on the
    16,384-node, 8M-edge random graph (the smoke's auto-selection case),
    with the reference's prices on an accelerator."""
    kw = dict(n_nodes=16_384, n_labels=2, n_edges=8_000_000, seed=0)
    g, rg = synth.random_graph(**kw), ref_synth.random_graph(**kw)
    text = "{ ?a p0 ?b . ?b p1 ?c }"
    c = soi.compile_soi(soi.build_soi(sparql.parse(text)), g)
    rc = ref_soi.compile_soi(ref_soi.build_soi(ref_sparql.parse(text)), rg)
    est = cost.choose_engine(g, c, backend="cuda")
    want = ref_cost.estimate_costs(rg, rc, backend="tpu")
    assert est.engine == "packed_fused"
    assert est.costs == want  # all six engines, partitioned included
    assert est.costs["packed_fused"] < est.costs["sparse"]


# phase 2c of chip_smoke.py on an NVIDIA H100 80GB HBM3 at a 700.00 W
# power limit: the spec the card's probe measured
H100_SPEC = dict(
    backend="cuda", device_kind="NVIDIA H100 80GB HBM3", fingerprint="golden-h100",
    n_devices=1, stream_bytes_per_s=1697798061846.4106,
    dense_elems_per_s=8472383100553.069, packed_words_per_s=12270117282470.234,
    packed_words_per_s_xla=6776285688.46118, fused_words_per_s=4098097831387.773,
    kernel_launch_s=9.201744526280389e-05, dispatch_s=0.0006189679999977216,
    trace_s=0.0010238620000109222,
)


def _batched_csoi(g, text: str, batch: int):
    """The compiled SOI a plan of ``batch`` requests of ``text`` prices
    (``engine/plan.py``: the batch's disjoint union, slot rows initialized
    like variables)."""
    from repro_torch.engine.batcher import batch_layout
    from repro_torch.engine.template import slot_index

    union = batch_layout(
        [soi.build_soi(canonicalize(sparql.parse(text)).template.query)] * batch).soi
    stripped = dataclasses.replace(union, is_const=[
        None if (k is not None and slot_index(k) is not None) else k
        for k in union.is_const])
    return soi.compile_soi(stripped, g)


def test_golden_h100_spec_picks_the_engine_the_card_runs_fastest():
    """Under the H100's own spec, auto picks dense below the launch knee
    (n = 256); packed_fused on the 16,384-node, 8M-edge block and on the
    46,200-node LUBM graph's serving microbatch (V = 48, 380,800 set
    bits), where the card ran it fastest; and sparse past the dense-tier
    bound."""
    spec = machine.MachineSpec(**H100_SPEC)
    text = "{ ?a p0 ?b . ?b p1 ?c }"
    small = synth.random_graph(n_nodes=256, n_labels=2, n_edges=8192, seed=2)
    c = soi.compile_soi(soi.build_soi(sparql.parse(text)), small)
    assert cost.choose_engine(small, c, backend="cuda", spec=spec).engine == "dense"
    block = synth.random_graph(n_nodes=16_384, n_labels=2, n_edges=8_000_000, seed=0)
    c = soi.compile_soi(soi.build_soi(sparql.parse(text)), block)
    est = cost.choose_engine(block, c, backend="cuda", spec=spec)
    assert est.engine == "packed_fused", est.reason
    assert est.costs["packed_fused"] < est.costs["packed"] < est.costs["dense"]
    g = synth.lubm_like(280, seed=0)
    c = _batched_csoi(g, MEMBERS_OF.format(uni="Univ0"), 16)
    assert (g.n_nodes, c.n_vars, int(np.count_nonzero(c.init))) == (46_200, 48, 380_800)
    est = cost.choose_engine(g, c, backend="cuda", spec=spec)
    assert est.engine == "packed_fused", est.reason
    big = synth.random_graph(int(DENSE_ADJ_MAX_BYTES ** 0.5) + 1, 2, 10_000, seed=0)
    c = soi.compile_soi(soi.build_soi(sparql.parse(text)), big)
    est = cost.choose_engine(big, c, backend="cuda", spec=spec)
    assert est.engine == "sparse", est.reason
    assert all(est.costs[tier] == float("inf") for tier in TIER)


def test_card_memory_sizes_the_packed_budget(monkeypatch):
    """On a calibrated card the packed engines' stacked operands may take
    an ``ADJ_CACHE_STACKS``-th of its memory: ``lubm_l1`` on the 46,200-node
    LUBM graph (M = 10, 2.67 GB packed, past the reference's 2 GiB) prices
    packed_fused finite on an 80 GB card and picks it under the H100's
    spec; with no card, with the hand-tuned model and on the CPU the
    budget stays the reference's."""
    spec = machine.MachineSpec(**H100_SPEC)
    g = synth.lubm_like(280, seed=0)
    c = soi.compile_soi(soi.build_soi(synth.lubm_l1_like()), g)
    n_words = (g.n_nodes + 31) // 32
    packed_bytes = len(c.mats) * g.n_nodes * n_words * 4
    assert cost.PACKED_MAX_BYTES < packed_bytes < 80 * 10**9 // cost.ADJ_CACHE_STACKS
    monkeypatch.setattr(cost, "_card_memory_bytes", lambda: None)
    est = cost.choose_engine(g, c, backend="cuda", spec=spec)
    assert est.engine == "sparse" and est.costs["packed_fused"] == float("inf")
    monkeypatch.setattr(cost, "_card_memory_bytes", lambda: 80 * 10**9)
    assert cost.packed_max_bytes(True) == 80 * 10**9 // cost.ADJ_CACHE_STACKS
    assert cost.packed_max_bytes(False) == cost.PACKED_MAX_BYTES
    est = cost.choose_engine(g, c, backend="cuda", spec=spec)
    assert est.engine == "packed_fused", est.reason
    tier = _card_tier_prices(g, c, spec)
    for name in ("packed", "packed_fused"):
        assert est.costs[name] == pytest.approx(tier[name], rel=1e-12), name
    assert est.costs["dense"] == float("inf")  # M n^2 bytes past DENSE_MAX_BYTES
    for kw in (dict(backend="cuda", model=cost.HAND_TUNED), dict(backend="cpu", spec=spec)):
        assert cost.estimate_costs(g, c, **kw)["packed_fused"] == float("inf")


@pytest.mark.parametrize("seed", range(4))
def test_no_spec_can_unrefuse_the_dense_tier(seed):
    """Past the [n, n] budget the three dense-tier engines price at inf
    under any calibration, on the CPU and on the card."""
    rng = np.random.default_rng(seed)
    rate = lambda: float(10 ** rng.uniform(3, 15))  # noqa: E731
    overhead = lambda: float(10 ** rng.uniform(-9, -1))  # noqa: E731
    g = synth.random_graph(int(DENSE_ADJ_MAX_BYTES ** 0.5) + 1, 1, 10, seed=0)
    c = soi.compile_soi(soi.build_soi(sparql.parse("{ ?a p0 ?b }")), g)
    assert not cost.dense_tier_feasible(g.n_nodes)
    for backend in ("cpu", "cuda"):
        spec = machine.MachineSpec(
            backend=backend, device_kind="random", fingerprint="random",
            n_devices=1, stream_bytes_per_s=rate(), dense_elems_per_s=rate(),
            packed_words_per_s=rate(), packed_words_per_s_xla=rate(),
            fused_words_per_s=rate(), kernel_launch_s=overhead(),
            dispatch_s=overhead(), trace_s=overhead(),
        )
        est = cost.choose_engine(g, c, spec=spec, backend=backend)
        for tier in TIER:
            assert est.costs[tier] == float("inf"), tier
        assert est.engine in dualsim.EDGE_ENGINES


def test_auto_on_a_cpu_graphdb_picks_what_the_reference_picks():
    """A small dense graph: auto picks dense on the CPU in both packages,
    with the same answers; the LUBM graph stays on sparse in both."""
    text = "{ ?a p0 ?b . ?b p1 ?c }"
    g, rg = _graphs()[1]
    db, ref = GraphDB(g, device="cpu"), RefGraphDB(rg)
    rs, want = db.query(text), ref.query(text)
    assert rs.engine == want.engine == "dense"
    _same_result(rs, want)
    db, ref = _dbs("auto")
    for text in QUERIES[:4]:
        assert db.query(text).engine == ref.query(text).engine
