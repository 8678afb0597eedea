"""The port's query path end to end against the JAX package:
``GraphDB.query`` / ``execute_many`` / ``Session.submit`` return the same
survivor masks, bindings and sweep counts as ``repro.db.GraphDB`` with the
same edge engine, mutations resume the same plans, the cost model prices
the edge engines alike, and the entry points refuse to run without a card
unless the CPU is asked for."""
import numpy as np
import pytest
import torch

from repro.core import soi as ref_soi
from repro.core import sparql as ref_sparql
from repro.data import synth as ref_synth
from repro.db import GraphDB as RefGraphDB
from repro.engine import cost as ref_cost
from repro_torch.core import soi, sparql
from repro_torch.data import synth
from repro_torch.db import GraphDB, Q
from repro_torch.engine import Engine, canonicalize, cost

MEMBERS_OF = "{{ ?d subOrganizationOf {uni} . ?s memberOf ?d }}"
QUERIES = [
    MEMBERS_OF.format(uni="Univ0"),
    sparql.format_query(synth.lubm_l0_like()),
    sparql.format_query(synth.lubm_l1_like()),
    sparql.format_query(synth.optional_query()),
    "{ { ?s memberOf ?d } UNION { ?s worksFor ?d } } AND "
    "{ ?d subOrganizationOf Univ1 }",
    "{ ?s memberOf Dept0_0 } AND { ?s noSuchLabel ?x }",
]


def _dbs(engine, n_universities=3):
    return (
        GraphDB(synth.lubm_like(n_universities, seed=0), engine=engine,
                device="cpu"),
        RefGraphDB(ref_synth.lubm_like(n_universities, seed=0), engine=engine),
    )


def _same_result(rs, ref):
    assert np.array_equal(rs.survivor_mask, ref.survivor_mask)
    assert rs.variables == ref.variables
    for var in rs.variables:
        assert np.array_equal(rs.binding_mask(var), ref.binding_mask(var)), var
    assert rs.sweeps == ref.sweeps
    assert rs.engine == ref.engine
    assert rs.batch == ref.batch
    assert rs.stats.per_edge_survivors == ref.stats.per_edge_survivors


@pytest.mark.parametrize("engine", ["sparse", "jacobi_packed", "partitioned"])
@pytest.mark.parametrize("q", range(len(QUERIES)))
def test_query_matches_reference(engine, q):
    db, ref = _dbs(engine)
    _same_result(db.query(QUERIES[q]), ref.query(QUERIES[q]))
    # warm: a cache hit with the same answer
    again = db.query(QUERIES[q])
    assert again.cache_hit
    _same_result(again, ref.query(QUERIES[q]))


def test_auto_picks_sparse_and_matches_reference():
    db, ref = _dbs("auto")
    _, ref_sparse = _dbs("sparse")
    for text in QUERIES[:4]:
        rs = db.query(text)
        assert set(rs.engine.split(",")) == {"sparse"}
        want = ref_sparse.query(text)
        assert np.array_equal(rs.survivor_mask, want.survivor_mask)
        assert np.array_equal(rs.survivor_mask, ref.query(text).survivor_mask)


@pytest.mark.parametrize("engine", ["sparse", "jacobi_packed", "partitioned"])
def test_execute_many_microbatches_like_reference(engine):
    db, ref = _dbs(engine, n_universities=6)
    qs = [MEMBERS_OF.format(uni=f"Univ{u}") for u in (0, 1, 2, 3, 4, 0)]
    qs.append(sparql.format_query(synth.lubm_l0_like()))
    got, want = db.execute_many(qs), ref.execute_many(qs)
    assert [r.batch for r in got] == [r.batch for r in want]
    assert max(r.batch for r in got) > 1
    for a, b in zip(got, want):
        _same_result(a, b)
    assert db.metrics().microbatches == ref.metrics().microbatches


def test_session_submit_matches_reference():
    db, ref = _dbs("sparse", n_universities=4)
    qs = [MEMBERS_OF.format(uni=f"Univ{u}") for u in range(4)] + [QUERIES[4]]
    with db.session(max_delay_ms=1e6) as s, ref.session(max_delay_ms=1e6) as rs:
        futs = [s.submit(q) for q in qs]
        rfuts = [rs.submit(q) for q in qs]
    for f, rf in zip(futs, rfuts):
        _same_result(f.result(), rf.result())
    builder = Q.triple("?d", "subOrganizationOf", "Univ2").triple(
        "?s", "memberOf", "?d")
    _same_result(db.query(builder), ref.query(MEMBERS_OF.format(uni="Univ2")))


@pytest.mark.parametrize("engine", ["sparse", "jacobi_packed", "partitioned"])
def test_mutation_resumes_like_reference(engine):
    """Delete + re-insert of one triple: the superseded plan is patched and
    warm-resumed in both packages, with the same answers and counters, and
    the plan never builds its operands again."""
    db, ref = _dbs(engine)
    q = MEMBERS_OF.format(uni="Univ0")
    db.query(q)
    ref.query(q)
    plan, _ = db._engine.plan_for(canonicalize(sparql.parse(q)), bucket=1)
    assert plan.metrics.operand_builds == 1
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
        assert m.cache.invalidations == rm.cache.invalidations == 0
    assert db.metrics().plans_resumed >= 2
    assert plan.metrics.patches == 2 and plan.metrics.warm_resumes == 2
    assert plan.metrics.operand_builds == 1
    memo = list(plan._chi_memo.items())
    assert memo and all(v.dtype == np.uint32 for _, v in memo)


def test_dictionary_change_is_cold_like_reference():
    db, ref = _dbs("sparse")
    q = MEMBERS_OF.format(uni="Univ0")
    db.query(q)
    ref.query(q)
    t = ("NodeFromTheFuture", "memberOf", "Univ0")
    db.insert([t])
    ref.insert([t])
    rs, rref = db.query(q), ref.query(q)
    _same_result(rs, rref)
    assert not rs.cache_hit
    assert db.metrics().plans_resumed == ref.metrics().plans_resumed == 0


def test_rebinding_constants_builds_no_operands():
    db, _ = _dbs("sparse")
    for u in range(3):
        db.query(MEMBERS_OF.format(uni=f"Univ{u}"))
    plan, hit = db._engine.plan_for(
        canonicalize(sparql.parse(MEMBERS_OF.format(uni="Univ0"))), bucket=1)
    assert hit and plan.metrics.executions == 3
    assert plan.metrics.operand_builds == 1


@pytest.mark.parametrize("text", QUERIES[:4])
def test_cost_model_prices_edge_engines_like_reference(text):
    g, rg = synth.lubm_like(3, seed=0), ref_synth.lubm_like(3, seed=0)
    c = soi.compile_soi(soi.build_soi(sparql.parse(text)), g)
    rc = ref_soi.compile_soi(ref_soi.build_soi(ref_sparql.parse(text)), rg)
    got = cost.estimate_costs(g, c, backend="cpu")
    want = ref_cost.estimate_costs(rg, rc, backend="cpu")
    assert got == want  # all six engines, partitioned included
    assert cost.choose_engine(g, c, backend="cpu").engine == "sparse"
    for delta in (1, 50, 10_000):
        a = cost.resume_decision(g, c, engine="sparse", delta_edges=delta,
                                 last_sweeps=5, backend="cpu")
        b = ref_cost.resume_decision(rg, rc, engine="sparse",
                                     delta_edges=delta, last_sweeps=5,
                                     backend="cpu")
        assert (a.resume, a.est_resume, a.est_cold) == (
            b.resume, b.est_resume, b.est_cold)
    assert cost.admission_estimate(g, sparql.parse(text)) == (
        ref_cost.admission_estimate(rg, ref_sparql.parse(text)))
    assert cost.dense_tier_feasible(46_000) and not cost.dense_tier_feasible(47_000)


def test_entry_points_refuse_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = synth.lubm_like(2, seed=0)
    with pytest.raises(RuntimeError, match="cuda"):
        GraphDB(g)
    with pytest.raises(RuntimeError, match="cuda"):
        Engine(g)
    from repro_torch.core import dualsim

    c = soi.compile_soi(soi.build_soi(sparql.parse(QUERIES[0])), g)
    with pytest.raises(RuntimeError, match="cuda"):
        dualsim.solve_compiled(c, g)
    GraphDB(g, device="cpu")  # the CPU only when asked for


def test_machine_fingerprint_never_names_a_reference_spec():
    """On one host the port's fingerprint differs from the JAX package's,
    so the unset-env lookup never loads a spec calibrated for XLA."""
    from repro.engine import machine as ref_machine
    from repro_torch.engine import machine

    got = machine.machine_fingerprint("cpu")
    assert got.startswith("torch-cpu__cpu__")
    assert got != ref_machine.machine_fingerprint()
    assert machine.spec_path(got) != ref_machine.spec_path(
        ref_machine.machine_fingerprint())


def test_persisted_machine_spec_prices_like_reference(tmp_path, monkeypatch):
    """A spec file the JAX package's probe format writes loads in the port
    (via REPRO_MACHINE_SPEC) and yields the same seconds-unit constants."""
    from repro.engine import machine as ref_machine
    from repro_torch.engine import machine

    spec = ref_machine.MachineSpec(
        backend="cuda", device_kind="test-card", fingerprint="fp-test",
        n_devices=1, stream_bytes_per_s=2.0e12, dense_elems_per_s=1e13,
        packed_words_per_s=1e11, packed_words_per_s_xla=1e10,
        fused_words_per_s=2e11, kernel_launch_s=5e-6, dispatch_s=8e-6,
        trace_s=0.25,
    )
    path = ref_machine.save_spec(spec, str(tmp_path / "spec.json"))
    monkeypatch.setenv(machine.ENV_VAR, path)
    got = cost.resolve_model(backend="cuda")
    want = ref_cost.CostModel.from_spec(spec)
    assert got.unit == "s" and got.source == "fp-test"
    for name in ("c_sparse", "c_apply", "c_segor_byte", "c_dispatch",
                 "trace_cost", "patch_cost_per_edge"):
        assert getattr(got, name) == getattr(want, name), name
