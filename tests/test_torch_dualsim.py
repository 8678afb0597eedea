"""The port's edge engines against the JAX package: the same operands, the
same packed chi words and the same sweep counts for Gauss–Seidel and
Jacobi under both segmented-OR lowerings, the same worklist fixpoint, and
replays of the reference's cross-engine and churn-resume properties.  No
tolerance anywhere: the greatest fixpoint is unique."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dualsim as ref_dualsim
from repro.core import soi as ref_soi
from repro.core import sparql as ref_sparql
from repro.data import synth as ref_synth
from repro_torch import convert
from repro_torch.core import bitops, dualsim, soi
from repro_torch.core import sparql
from repro_torch.core.sparql import And, BGP, Const, Optional_, Triple, Var
from repro_torch.data import synth

MODES = ["gs", "jacobi_packed"]


def _to_np(x):
    if x is None:
        return None
    if isinstance(x, tuple):
        return tuple(np.asarray(a) for a in x)
    return np.asarray(x)


def _ref_fields(ops) -> dict:
    return {f.name: _to_np(getattr(ops, f.name))
            for f in dataclasses.fields(ops)}


def _same_operands(got, want):
    """Every port field equals the reference field (words as uint32); a
    field the reference has not (``part_seg``, the partitioned blocks in
    the card's segmented-OR layout) is empty."""
    for f in dataclasses.fields(got):
        a = getattr(got, f.name)
        if not hasattr(want, f.name):
            assert a is None, f.name
            continue
        b = getattr(want, f.name)
        if a is None:
            assert b is None, f.name
            continue
        pairs = zip(a, b) if isinstance(a, tuple) else [(a, b)]
        for x, y in pairs:
            x, y = x.cpu().numpy(), np.asarray(y)
            if y.dtype == np.uint32:
                x = x.view(np.uint32)
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name


def _pattern_instance(seed, n=77):
    rg = ref_synth.random_graph(n, 3, 4 * n, seed=seed)
    g = synth.random_graph(n, 3, 4 * n, seed=seed)
    pat = ref_synth.random_pattern(3, 3, 4, seed=seed)
    rc = ref_soi.compile_soi(ref_dualsim.pattern_graph_soi(pat), rg)
    c = soi.compile_soi(
        dualsim.pattern_graph_soi(synth.random_pattern(3, 3, 4, seed=seed)), g
    )
    return g, rg, c, rc


FLAT = ("edge_src", "edge_dst")
BLOCKED = ("seg_src_b", "seg_dst_b", "seg_win")


def _cpu_operands(c, g, blocked: bool):
    """CPU operands in either edge layout: the blocked one is what
    make_sparse_operands builds on a card."""
    cpu = torch.device("cpu")
    return dualsim.Operands(**dualsim._edge_layout(c, g, cpu, blocked),
                            **dualsim._base_operands(c, cpu))


@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("seed", [21, 5])
def test_sparse_operands_equal_reference(seed, blocked):
    """Either edge layout equals the reference's arrays of that layout."""
    g, rg, c, rc = _pattern_instance(seed)
    ops = _cpu_operands(c, g, blocked)
    assert ops.blocked == blocked
    rops = ref_dualsim.make_sparse_operands(rc, rg)
    _same_operands(ops, dataclasses.replace(
        rops, adj_dense=None, adj_packed=None, edge_src_b=None,
        edge_dst_b=None, **dict.fromkeys(FLAT if blocked else BLOCKED),
    ))


def test_operands_hold_one_layout_and_a_card_only_the_blocked_one():
    """The CPU defaults to the flat lists; mixing or omitting layouts is
    refused, and operands on any device but the CPU need the blocked
    layout (``meta`` stands in for a card here)."""
    g, _, c, _ = _pattern_instance(21)
    flat = dualsim.make_sparse_operands(c, g, device="cpu")
    blocked = _cpu_operands(c, g, True)
    assert not flat.blocked and flat.seg_win is None
    assert blocked.blocked and blocked.edge_src is None
    with pytest.raises(ValueError, match="exactly one edge layout"):
        dataclasses.replace(flat, seg_src_b=blocked.seg_src_b,
                            seg_dst_b=blocked.seg_dst_b,
                            seg_win=blocked.seg_win)
    with pytest.raises(ValueError, match="exactly one edge layout"):
        dataclasses.replace(flat, edge_src=None, edge_dst=None)
    on_meta = {f.name: getattr(flat, f.name) for f in dataclasses.fields(flat)}
    on_meta["init"] = flat.init.to("meta")
    with pytest.raises(ValueError, match="need the blocked layout"):
        dualsim.Operands(**on_meta)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", [21, 8, 40])
def test_solve_sparse_matches_reference(mode, seed):
    """Same chi and sweep counts as the reference under both lowerings,
    with operands handed over through convert.operands_from_numpy."""
    g, rg, c, rc = _pattern_instance(seed)
    rops = ref_dualsim.make_sparse_operands(rc, rg)
    chi_w, it_w = ref_dualsim.solve_sparse(rops, mode=mode, impl="words")
    chi_k, it_k = ref_dualsim.solve_sparse(rops, mode=mode, impl="kernel",
                                           interpret=True)
    ref_chi, _ = ref_dualsim.solve_worklist(rc, rg)
    assert np.array_equal(np.asarray(chi_w), ref_chi)
    fields = _ref_fields(rops)
    for name in ("adj_dense", "adj_packed", "edge_src_b", "edge_dst_b"):
        fields.pop(name)
    # both layouts handed over: the CPU takes its own, the flat lists
    assert not convert.operands_from_numpy(fields, device="cpu").blocked
    for blocked in (False, True):
        one = {k: v for k, v in fields.items()
               if k not in (FLAT if blocked else BLOCKED)}
        ops = convert.operands_from_numpy(one, device="cpu")
        assert ops.blocked == blocked
        chi, it = dualsim.solve_sparse(ops, mode=mode)
        assert np.array_equal(chi.numpy(), np.asarray(chi_w)), blocked
        assert np.array_equal(bitops.pack_np(chi.numpy()),
                              np.asarray(ref_dualsim.bitops.pack(chi_k)))
        assert it == int(it_w) == int(it_k), blocked
    own = dualsim.make_sparse_operands(c, g, device="cpu")
    chi, it = dualsim.solve_sparse(own, mode=mode)
    assert np.array_equal(chi.numpy(), ref_chi) and it == int(it_w)
    wl, evals = dualsim.solve_worklist(c, g)
    assert np.array_equal(wl, ref_chi)
    assert evals == ref_dualsim.solve_worklist(rc, rg)[1]


@pytest.mark.parametrize("max_sweeps", [1, 2, 3])
def test_max_sweeps_cap_matches_reference(max_sweeps):
    g, rg, c, rc = _pattern_instance(13, n=120)
    chi, it = dualsim.solve_sparse(
        dualsim.make_sparse_operands(c, g, device="cpu"), max_sweeps=max_sweeps
    )
    rchi, rit = ref_dualsim.solve_sparse(
        ref_dualsim.make_sparse_operands(rc, rg), max_sweeps=max_sweeps,
        impl="words",
    )
    assert it == int(rit) <= max_sweeps
    assert np.array_equal(chi.numpy(), np.asarray(rchi))


def test_warm_start_packed_and_bool_agree():
    g, rg, c, rc = _pattern_instance(3)
    ops = dualsim.make_sparse_operands(c, g, device="cpu")
    cold, _ = dualsim.solve_sparse(ops)
    warm_bool, it_b = dualsim.solve_sparse(ops, chi0=cold)
    warm_words, it_w = dualsim.solve_sparse(ops, chi0=bitops.pack(cold))
    assert torch.equal(warm_bool, cold) and torch.equal(warm_words, cold)
    assert it_b == it_w == 1


def test_largest_dual_simulation_matches_reference():
    pat = ref_synth.random_pattern(4, 2, 6, seed=9)
    rg = ref_synth.random_graph(60, 2, 200, seed=10)
    want, _ = ref_dualsim.largest_dual_simulation(pat, rg, engine="sparse")
    pat_t = synth.random_pattern(4, 2, 6, seed=9)
    g = synth.random_graph(60, 2, 200, seed=10)
    for engine in ("sparse", "jacobi_packed", "worklist"):
        got, _ = dualsim.largest_dual_simulation(pat_t, g, engine=engine,
                                                 device="cpu")
        assert np.array_equal(got, want), engine


# --------------------------------------------------------------------- #
# replays of the reference's cross-engine and churn-resume properties
# --------------------------------------------------------------------- #
def _random_query(rng, n_labels: int, node_names):
    def term():
        if rng.random() < 0.15:
            return Const(str(node_names[rng.integers(len(node_names))]))
        return Var(f"v{rng.integers(4)}")

    def bgp():
        return BGP(tuple(
            Triple(term(), f"p{rng.integers(n_labels)}", term())
            for _ in range(rng.integers(1, 4))
        ))

    q = bgp()
    r = rng.random()
    if r < 0.35:
        q = And(q, bgp())
    elif r < 0.7:
        q = Optional_(q, bgp())
    return q


def _ref_query(q):
    return ref_sparql.parse(sparql.format_query(q))


@pytest.mark.parametrize("seed", range(8))
def test_cross_engine_equivalence_replay(seed):
    """Both edge engines reach the worklist fixpoint (port and reference) on
    the reference's random graph x BGP/AND/OPTIONAL instances."""
    rng = np.random.default_rng(seed)
    n_labels = int(rng.integers(1, 4))
    kw = dict(n_nodes=int(rng.integers(3, 40)), n_labels=n_labels,
              n_edges=int(rng.integers(5, 120)), seed=seed + 1)
    g, rg = synth.random_graph(**kw), ref_synth.random_graph(**kw)
    q = _random_query(rng, n_labels, g.node_names)
    c = soi.compile_soi(soi.build_soi(q), g)
    rc = ref_soi.compile_soi(ref_soi.build_soi(_ref_query(q)), rg)
    want, _ = ref_dualsim.solve_worklist(rc, rg)
    for eng in dualsim.EDGE_ENGINES + ("worklist",):
        chi, it = dualsim.solve_compiled(c, g, engine=eng, device="cpu")
        assert np.array_equal(chi, want), f"{eng} != worklist (seed {seed})"
        if eng != "worklist":
            assert it == ref_dualsim.solve_compiled(rc, rg, engine=eng)[1]


def _mutate(rng, triples, n_nodes, n_labels):
    if len(triples) and rng.random() < 0.7:
        keep = np.ones(len(triples), bool)
        keep[rng.choice(len(triples),
                        size=min(len(triples), int(rng.integers(1, 5))),
                        replace=False)] = False
        triples = triples[keep]
    inserted: set[int] = set()
    if rng.random() < 0.7:
        k = int(rng.integers(1, 5))
        new = np.stack([
            rng.integers(0, n_nodes, k),
            rng.integers(0, n_labels, k),
            rng.integers(0, n_nodes, k),
        ], axis=1).astype(np.int32)
        triples = np.vstack([triples, new])
        inserted = {int(x) for x in np.unique(new[:, 1])}
    return triples, inserted


@pytest.mark.parametrize("seed", [0, 1, 2, 5, 11])
def test_churn_resume_replay(seed):
    """Across a random mutation sequence, the port's resume_fixpoint equals
    the reference's resume_fixpoint and its cold worklist, chi and sweeps,
    for both edge engines."""
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
                                      device="cpu")[0]
            for e in dualsim.EDGE_ENGINES}
    rprev = dict(prev)
    triples = g.triples
    for _ in range(3):
        triples, ins = _mutate(rng, triples, g.n_nodes, g.n_labels)
        g = convert.graph_from_arrays(triples, names, labels)
        rg = RefGraph(rg.n_nodes, rg.n_labels, triples.copy(), names, labels)
        c, rc = soi.compile_soi(s, g), ref_soi.compile_soi(rs, rg)
        want, _ = ref_dualsim.solve_worklist(rc, rg)
        for eng in dualsim.EDGE_ENGINES:
            warm, it = dualsim.resume_fixpoint(
                c, g, prev[eng], inserted_labels=ins, engine=eng, device="cpu"
            )
            rwarm, rit = ref_dualsim.resume_fixpoint(
                rc, rg, rprev[eng], inserted_labels=ins, engine=eng
            )
            assert np.array_equal(warm, want), f"{eng} (seed {seed})"
            assert np.array_equal(warm, rwarm) and it == rit
            prev[eng], rprev[eng] = warm, rwarm


@pytest.mark.parametrize("blocked", [True, False])
def test_blocked_layout_patch_keeps_shapes_and_resumes(blocked):
    """patch_operands keeps the blocked (and the flat) layout's superseded
    shapes, as the reference does, and the patched warm resume equals the
    cold worklist fixpoint."""
    rng = np.random.default_rng(6)
    g = synth.random_graph(70, 3, 220, seed=6)  # 70 % 32 != 0
    names, labels = g.node_names, g.label_names
    s = soi.build_soi(_random_query(rng, 3, names))
    ops = _cpu_operands(soi.compile_soi(s, g), g, blocked)
    chi_prev = dualsim.solve_sparse(ops)[0].numpy()
    layout = BLOCKED if blocked else FLAT
    triples = g.triples
    for _ in range(3):
        triples, ins = _mutate(rng, triples, g.n_nodes, g.n_labels)
        g = convert.graph_from_arrays(triples, names, labels)
        c = soi.compile_soi(s, g)
        shapes = [tuple(a.shape) for f in layout for a in getattr(ops, f)]
        ops = dualsim.patch_operands(ops, c, g, set(range(g.n_labels)))
        assert ops.blocked == blocked
        assert [tuple(a.shape) for f in layout
                for a in getattr(ops, f)] == shapes
        chi0 = chi_prev.copy()
        chi0[dualsim.destabilized_rows(c, ins)] = True
        warm, _ = dualsim.solve_sparse(ops, chi0=torch.from_numpy(chi0))
        assert np.array_equal(warm.numpy(), dualsim.solve_worklist(c, g)[0])
        chi_prev = warm.numpy()


def test_destabilized_rows_match_reference():
    text = "{ ?a p0 ?b . ?b p1 ?c } OPTIONAL { ?c p2 ?d }"
    g = synth.random_graph(10, 3, 30, seed=0)
    rg = ref_synth.random_graph(10, 3, 30, seed=0)
    c = soi.compile_soi(soi.build_soi(sparql.parse(text)), g)
    rc = ref_soi.compile_soi(ref_soi.build_soi(ref_sparql.parse(text)), rg)
    for labels in ({0}, {1}, {2}, set(), {0, 2}, {999}):
        assert np.array_equal(dualsim.destabilized_rows(c, labels),
                              ref_dualsim.destabilized_rows(rc, labels))


def test_reference_words_view_round_trips():
    """The uint32 <-> int32 view the tests compare through is lossless."""
    words = np.asarray([[0, 1, 0x80000000, 0xFFFFFFFF]], np.uint32)
    t = bitops.to_words(words, "cpu")
    assert t.dtype == torch.int32 and np.array_equal(bitops.words_np(t), words)
    assert np.array_equal(np.asarray(jnp.asarray(words)), bitops.words_np(t))
