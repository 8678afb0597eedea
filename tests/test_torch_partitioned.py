"""The port's partitioned engine and node mesh against the JAX package: the
same destination-partitioned operand arrays, the same packed chi words and
sweep counts from ``solve_partitioned`` (unsharded, over a simulated CPU
mesh of 1 to 8 shards, and through the card's per-block segmented-OR
layout run by the kernel wrapper's plain version), the same cost model
with ``n_devices`` 1 and 8, the same answers and resumed plans through
``Engine`` / ``GraphDB(engine="partitioned")`` with and without a mesh, and
the serving driver's ``--engine partitioned --devices N``.  No tolerance
anywhere: the greatest fixpoint is unique."""
import contextlib
import io

import numpy as np
import pytest
import torch

from repro.core import bitops as ref_bitops
from repro.core import dualsim as ref_dualsim
from repro.core import soi as ref_soi
from repro.core import sparql as ref_sparql
from repro.core.graph import Graph as RefGraph
from repro.data import synth as ref_synth
from repro.engine import Engine as RefEngine
from repro.engine import cost as ref_cost
from repro.engine import machine as ref_machine
from repro_torch import convert, kernels
from repro_torch.core import bitops, dualsim, soi, sparql
from repro_torch.data import synth
from repro_torch.db import GraphDB
from repro_torch.distributed import ctx
from repro_torch.engine import Engine, canonicalize, cost, machine
from repro_torch.launch import serve as launch_serve
from tests.test_torch_db import MEMBERS_OF, QUERIES, _same_result
from tests.test_torch_dense_tier import _card_tier_prices, _resume_on
from tests.test_torch_dualsim import (
    _mutate,
    _random_query,
    _ref_query,
    _same_operands,
)

CPU = torch.device("cpu")


def _instance(seed, n):
    """The same random graph and pattern SOI in both packages."""
    rg = ref_synth.random_graph(n, 3, 4 * n, seed=seed)
    g = synth.random_graph(n, 3, 4 * n, seed=seed)
    rc = ref_soi.compile_soi(
        ref_dualsim.pattern_graph_soi(ref_synth.random_pattern(3, 3, 4, seed=seed)),
        rg)
    c = soi.compile_soi(
        dualsim.pattern_graph_soi(synth.random_pattern(3, 3, 4, seed=seed)), g)
    return g, rg, c, rc


def _blocked(c, g, n_blocks, mesh=None):
    """CPU operands in the card's layout: each block's segmented-OR layout
    (what a card builds), run through the kernel wrapper's plain version."""
    n_pad = dualsim.padded_node_count(g.n_nodes, n_blocks)
    return dualsim.Operands(
        **dualsim._partitioned_layout(c, g, n_blocks, n_pad, CPU, True, mesh),
        **dualsim._base_operands(c, CPU, n_pad),
    )


def _words(chi_bool: torch.Tensor) -> np.ndarray:
    return bitops.words_np(bitops.pack(chi_bool))


# --------------------------------------------------------------------- #
# layout
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("n_blocks", [1, 2, 4, 8])
@pytest.mark.parametrize("seed,n", [(3, 64), (9, 61), (21, 77), (5, 300)])
def test_partitioned_operands_equal_reference(seed, n, n_blocks):
    """Every field of the CPU's partitioned operands equals the JAX
    package's array, element for element (pad rows carry ``n_local``)."""
    g, rg, c, rc = _instance(seed, n)
    ops = dualsim.make_partitioned_operands(c, g, n_blocks, device="cpu")
    _same_operands(ops, ref_dualsim.make_partitioned_operands(rc, rg, n_blocks))
    assert ops.n_blocks == n_blocks and ops.partitioned
    assert ops.init.shape[-1] == dualsim.padded_node_count(n, n_blocks)
    assert dualsim.padded_node_count(n, n_blocks) == (
        ref_dualsim.padded_node_count(n, n_blocks))


def test_partitioned_operands_layout():
    """Every edge lands in the block owning its destination; pad rows use
    the out-of-range local id (the reference's layout test)."""
    db = synth.random_graph(64, 2, 300, seed=3)
    pat = synth.random_pattern(2, 2, 2, seed=3)
    c = soi.compile_soi(dualsim.pattern_graph_soi(pat), db)
    ops = dualsim.make_partitioned_operands(c, db, n_blocks=8, device="cpu")
    n_local = dualsim.padded_node_count(64, 8) // 8  # 32-aligned per block
    for (a, d), src_b, dst_b in zip(c.mats, ops.edge_src_b, ops.edge_dst_b):
        assert src_b.shape == dst_b.shape
        dst = dst_b.numpy()
        assert ((dst >= 0) & (dst <= n_local)).all()
        e = db.edges_for_label(a)
        s, t = (e[:, 0], e[:, 1]) if d == soi.FWD else (e[:, 1], e[:, 0])
        got = {(int(src_b[w, k]), int(dst[w, k]) + w * n_local)
               for w in range(8) for k in range(dst.shape[1])
               if dst[w, k] < n_local}
        assert got == set(zip(s.tolist(), t.tolist()))


def test_partitioned_operands_pad_unaligned_graph():
    """n % n_blocks != 0: the node axis pads to 8 whole-word blocks, pad
    columns stay dead, and the sliced fixpoint equals the sparse engine's
    and the reference's words."""
    db = synth.random_graph(61, 2, 200, seed=9)  # 61 % 8 != 0
    rdb = ref_synth.random_graph(61, 2, 200, seed=9)
    c = soi.compile_soi(
        dualsim.pattern_graph_soi(synth.random_pattern(2, 2, 3, seed=9)), db)
    rc = ref_soi.compile_soi(
        ref_dualsim.pattern_graph_soi(ref_synth.random_pattern(2, 2, 3, seed=9)),
        rdb)
    ops = dualsim.make_partitioned_operands(c, db, n_blocks=8, device="cpu")
    n_pad = dualsim.padded_node_count(61, 8)
    assert n_pad == 256 and ops.init.shape[-1] == n_pad
    assert not ops.init[:, 61:].any()  # pad columns dead
    chi_p, it = dualsim.solve_partitioned(ops)
    assert not chi_p[:, 61:].any()
    chi_ref, _ = dualsim.solve_sparse(
        dualsim.make_sparse_operands(c, db, device="cpu"))
    assert torch.equal(chi_p[:, :61], chi_ref)
    want, rit = ref_dualsim.solve_partitioned(
        ref_dualsim.make_partitioned_operands(rc, rdb, n_blocks=8))
    assert np.array_equal(_words(chi_p), ref_bitops.pack_np(np.asarray(want)))
    assert it == int(rit)


def test_partitioned_operands_adj_cache_shared():
    """Edge blocks depend only on (mats, graph, n_blocks, device, mesh):
    two compilations against one graph share the tensors through the
    adjacency cache; another block count or mesh is another layout."""
    db = synth.random_graph(32, 2, 100, seed=4)
    c = soi.compile_soi(
        dualsim.pattern_graph_soi(synth.random_pattern(2, 2, 2, seed=4)), db)
    cache: dict = {}
    make = dualsim.make_partitioned_operands
    a = make(c, db, n_blocks=4, adj_cache=cache, device="cpu")
    b = make(c, db, n_blocks=4, adj_cache=cache, device="cpu")
    assert a.edge_src_b[0] is b.edge_src_b[0]
    d = make(c, db, n_blocks=2, adj_cache=cache, device="cpu")
    assert d.edge_src_b[0] is not a.edge_src_b[0]
    mesh = ctx.node_mesh(4, device="cpu")
    e = make(c, db, n_blocks=4, adj_cache=cache, device="cpu", mesh=mesh)
    f = make(c, db, n_blocks=4, adj_cache=cache, device="cpu", mesh=mesh)
    assert e.edge_src_b[0] is not a.edge_src_b[0]
    assert e.edge_src_b[0] is f.edge_src_b[0]


@pytest.mark.parametrize("seed,n", [(3, 64), (9, 61), (21, 300)])
def test_blocked_layout_holds_the_flat_blocks(seed, n):
    """Each block's segmented-OR layout holds exactly that block's edges
    over its local destinations, with global sources, and its pad rows
    carry the layout's sentinel (never a live local id)."""
    g, _, c, _ = _instance(seed, n)
    ops = dualsim.make_partitioned_operands(c, g, 4, device="cpu")
    blk = _blocked(c, g, 4)
    n_local = ops.init.shape[-1] // 4
    for m in range(len(c.mats)):
        for w in range(4):
            src_b, dst_b, win = blk.part_seg[m][w]
            live = dst_b < n_local
            assert (dst_b[~live] >= n_local).all()
            got = sorted(zip(src_b[live].tolist(), dst_b[live].tolist()))
            fs, fd = ops.edge_src_b[m][w], ops.edge_dst_b[m][w]
            keep = fd < n_local
            assert got == sorted(zip(fs[keep].tolist(), fd[keep].tolist()))
            lo = win.long().repeat_interleave(dst_b.shape[1]) * 256
            flat = dst_b.reshape(-1).long()
            assert ((flat[live.reshape(-1)] >= lo[live.reshape(-1)])
                    & (flat[live.reshape(-1)] < lo[live.reshape(-1)] + 256)).all()


# --------------------------------------------------------------------- #
# the solver
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("shards", [None, 1, 2, 3, 8])
@pytest.mark.parametrize("layout", ["flat", "blocked"])
@pytest.mark.parametrize("seed,n,n_blocks", [(21, 77, 4), (9, 61, 8), (5, 300, 8),
                                             (13, 45, 2)])
def test_solve_partitioned_matches_reference(seed, n, n_blocks, layout, shards):
    """chi words (as uint32) and sweep counts equal the reference's
    ``solve_partitioned``, unsharded and over a simulated mesh of 1 to 8
    shards, in the CPU's flat layout and in the card's blocked one."""
    g, rg, c, rc = _instance(seed, n)
    mesh = None if shards is None else ctx.node_mesh(shards, device="cpu")
    ops = (dualsim.make_partitioned_operands(c, g, n_blocks, device="cpu",
                                             mesh=mesh)
           if layout == "flat" else _blocked(c, g, n_blocks, mesh))
    chi, it = dualsim.solve_partitioned(ops, mesh=mesh)
    want, rit = ref_dualsim.solve_partitioned(
        ref_dualsim.make_partitioned_operands(rc, rg, n_blocks))
    assert np.array_equal(_words(chi),
                          ref_bitops.pack_np(np.asarray(want)))
    assert it == int(rit)
    worklist, _ = dualsim.solve_worklist(c, g)
    assert np.array_equal(chi[:, :n].numpy(), worklist)


@pytest.mark.parametrize("max_sweeps", [1, 2])
def test_max_sweeps_and_warm_start_match_reference(max_sweeps):
    g, rg, c, rc = _instance(21, 77)
    ops = dualsim.make_partitioned_operands(c, g, 4, device="cpu")
    rops = ref_dualsim.make_partitioned_operands(rc, rg, 4)
    chi, it = dualsim.solve_partitioned(ops, max_sweeps=max_sweeps)
    want, rit = ref_dualsim.solve_partitioned(rops, max_sweeps=max_sweeps)
    assert np.array_equal(chi.numpy(), np.asarray(want)) and it == int(rit)
    # warm start from that state, bool and packed: the same fixpoint
    full, _ = dualsim.solve_partitioned(ops)
    for chi0 in (chi, bitops.pack(chi)):
        warm, _ = dualsim.solve_partitioned(ops, chi0=chi0)
        assert torch.equal(warm, full)


@pytest.mark.parametrize("seed", range(6))
def test_optimized_engines_same_fixpoint_replay(seed):
    """jacobi_packed and partitioned reach the Gauss–Seidel sparse
    engine's fixpoint (the reference's property, fixed seeds), on a mesh
    too."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 30)) * 16
    db = synth.random_graph(n, 3, int(rng.integers(10, 200)), seed=seed)
    c = soi.compile_soi(
        dualsim.pattern_graph_soi(synth.random_pattern(3, 3, 4, seed=seed)), db)
    ops = dualsim.make_sparse_operands(c, db, device="cpu")
    chi_gs, _ = dualsim.solve_sparse(ops, mode="gs")
    chi_j, _ = dualsim.solve_sparse(ops, mode="jacobi_packed")
    assert torch.equal(chi_gs, chi_j)
    for mesh in (None, ctx.node_mesh(4, device="cpu")):
        ops_p = dualsim.make_partitioned_operands(c, db, 4, device="cpu",
                                                  mesh=mesh)
        chi_p, _ = dualsim.solve_partitioned(ops_p, mesh=mesh)
        assert torch.equal(chi_gs, chi_p[:, :n])


def test_unaligned_blocks_are_refused():
    g, _, c, _ = _instance(21, 77)
    ops = dualsim.make_partitioned_operands(c, g, 4, device="cpu")
    bad = dualsim.Operands(
        **{f: getattr(ops, f) for f in ("mat_rhs", "mat_table", "copy_rhs",
                                        "var_copy", "mat_lhs_flags",
                                        "edge_src_b", "edge_dst_b")},
        init=ops.init[:, :100], init_packed=ops.init_packed[:, :4])
    with pytest.raises(ValueError, match="32-aligned"):
        dualsim.solve_partitioned(bad)
    with pytest.raises(ValueError, match="partitioned operands"):
        dualsim.solve_partitioned(dualsim.make_sparse_operands(c, g, device="cpu"))


def test_card_refuses_the_flat_blocks():
    """The [W, Eb] blocks are the CPU's: operands on another device must
    take the per-block segmented-OR layout."""
    g, _, c, _ = _instance(3, 64)
    ops = dualsim.make_partitioned_operands(c, g, 4, device="cpu")
    fields = {f: getattr(ops, f) for f in ("mat_rhs", "mat_table", "copy_rhs",
                                           "var_copy", "edge_src_b",
                                           "edge_dst_b")}
    with pytest.raises(ValueError, match="only the CPU runs the flat"):
        dualsim.Operands(init=ops.init.to("meta"), **fields)
    with pytest.raises(ValueError, match="exactly one edge layout"):
        dualsim.Operands(init=ops.init, part_seg=_blocked(c, g, 4).part_seg,
                         **fields)


def test_convert_takes_the_reference_partitioned_operands():
    g, rg, c, rc = _instance(21, 77)
    rops = ref_dualsim.make_partitioned_operands(rc, rg, 4)
    fields = {f: getattr(rops, f) for f in rops.__dataclass_fields__}
    fields = {k: (tuple(np.asarray(a) for a in v) if isinstance(v, tuple)
                  else None if v is None else np.asarray(v))
              for k, v in fields.items()}
    ops = convert.operands_from_numpy(fields, device="cpu")
    chi, it = dualsim.solve_partitioned(ops)
    want, rit = ref_dualsim.solve_partitioned(rops)
    assert np.array_equal(chi.numpy(), np.asarray(want)) and it == int(rit)


@pytest.mark.parametrize("layout", ["flat", "blocked"])
@pytest.mark.parametrize("seed", [0, 1, 2, 5, 11])
def test_churn_patch_keeps_capacity_and_resumes(seed, layout):
    """Across random mutations, patch_operands rebuilds only touched
    operators, keeps each block's capacity (``min_eb``; ``min_g`` of every
    block's segmented-OR layout), re-pads init, and the resumed fixpoint
    equals a cold solve, the reference's resume and the worklist; the
    flat blocks equal the reference's patched arrays."""
    rng = np.random.default_rng(seed)
    n_labels = int(rng.integers(1, 4))
    kw = dict(n_nodes=int(rng.integers(8, 40)), n_labels=n_labels,
              n_edges=int(rng.integers(10, 120)), seed=seed + 1)
    g, rg = synth.random_graph(**kw), ref_synth.random_graph(**kw)
    names, labels = g.node_names, g.label_names
    q = _random_query(rng, n_labels, names)
    s, rs = soi.build_soi(q), ref_soi.build_soi(_ref_query(q))
    c, rc = soi.compile_soi(s, g), ref_soi.compile_soi(rs, rg)
    ops = (dualsim.make_partitioned_operands(c, g, 4, device="cpu")
           if layout == "flat" else _blocked(c, g, 4))
    rops = ref_dualsim.make_partitioned_operands(rc, rg, 4)
    prev, _ = dualsim.solve_partitioned(ops)
    triples = g.triples
    for _ in range(3):
        triples, ins = _mutate(rng, triples, g.n_nodes, g.n_labels)
        g = convert.graph_from_arrays(triples, names, labels)
        rg = RefGraph(rg.n_nodes, rg.n_labels, triples.copy(), names, labels)
        c, rc = soi.compile_soi(s, g), ref_soi.compile_soi(rs, rg)
        touched = set(range(g.n_labels))
        patched = dualsim.patch_operands(ops, c, g, touched)
        rops = ref_dualsim.patch_operands(rops, rc, rg, touched, n_blocks=4)
        if layout == "flat":
            _same_operands(patched, rops)
            for old, new in zip(ops.edge_src_b, patched.edge_src_b):
                assert new.shape[1] >= old.shape[1]
        else:
            for old, new in zip(ops.part_seg, patched.part_seg):
                for (o, _, _), (p, _, _) in zip(old, new):
                    assert p.shape[0] >= o.shape[0]
        chi0 = prev.clone()
        chi0[torch.from_numpy(dualsim.destabilized_rows(c, ins))] = True
        warm, _ = dualsim.solve_partitioned(patched, chi0=chi0)
        cold, _ = dualsim.solve_partitioned(
            dualsim.make_partitioned_operands(c, g, 4, device="cpu"))
        assert torch.equal(warm, cold)
        assert np.array_equal(warm[:, :g.n_nodes].numpy(),
                              dualsim.solve_worklist(c, g)[0])
        ops, prev = patched, warm


# --------------------------------------------------------------------- #
# the node mesh
# --------------------------------------------------------------------- #
def test_node_mesh_on_the_host_simulates_shards():
    mesh = ctx.node_mesh(8, device="cpu")
    assert mesh.size == 8 and mesh.device_type == "cpu"
    assert mesh.axis_name == ctx.NODE_AXIS == "nodes"
    assert mesh.devices == (CPU,) * 8
    assert mesh == ctx.node_mesh(8, device="cpu") != ctx.node_mesh(4, device="cpu")
    assert ctx.node_mesh(device="cpu").size == 1
    ctx.force_host_device_count(3)
    try:
        assert ctx.node_mesh(device="cpu").size == 3
    finally:
        ctx.force_host_device_count(1)
    with pytest.raises(ValueError):
        ctx.node_mesh(0, device="cpu")
    with pytest.raises(ValueError):
        ctx.force_host_device_count(0)


def test_node_mesh_on_cards_raises_without_enough(monkeypatch):
    """No CPU fallback: asking for more cards than are visible raises."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            ctx.node_mesh(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="need 2 CUDA devices, have 1"):
        ctx.node_mesh(2, device="cuda")
    one = ctx.node_mesh(device="cuda")
    assert one.devices == (torch.device("cuda", 0),)


def test_block_placement_is_block_major():
    mesh = ctx.node_mesh(4, device="cpu")
    assert [dualsim._block_shard(b, 8, 4) for b in range(8)] == [
        0, 0, 1, 1, 2, 2, 3, 3]
    shards = dualsim._column_shards(8, 2, mesh)
    assert [(s.start, s.stop) for _, s, _ in shards] == [
        (0, 2), (2, 4), (4, 6), (6, 8)]
    assert [(w.start, w.stop) for _, _, w in shards] == [
        (0, 4), (4, 8), (8, 12), (12, 16)]
    # fewer blocks than devices: the empty positions hold nothing
    assert len(dualsim._column_shards(2, 1, mesh)) == 2
    assert dualsim._block_devices(3, None, CPU) == (CPU,) * 3


def test_engine_refuses_a_mesh_of_another_device_type():
    g = synth.lubm_like(1, seed=0)
    mesh = ctx.NodeMesh((torch.device("cuda", 0),))
    with pytest.raises(ValueError, match="cannot serve"):
        Engine(g, engine="partitioned", device="cpu", mesh=mesh)
    c = soi.compile_soi(soi.build_soi(sparql.parse(QUERIES[0])), g)
    with pytest.raises(ValueError, match="cannot hold"):
        dualsim.make_partitioned_operands(c, g, 1, device="cpu", mesh=mesh)


# --------------------------------------------------------------------- #
# cost model
# --------------------------------------------------------------------- #
def _specs(**kw):
    base = dict(
        backend="cpu", device_kind="cpu", fingerprint="golden-cpu",
        n_devices=1, stream_bytes_per_s=8e9, dense_elems_per_s=5e9,
        packed_words_per_s=2e7, packed_words_per_s_xla=5e8,
        fused_words_per_s=5e8, kernel_launch_s=2e-3, dispatch_s=2e-5,
        trace_s=0.05, collective_bytes_per_s=None,
    )
    base.update(kw)
    return machine.MachineSpec(**base), ref_machine.MachineSpec(**base)


def _big():
    kw = dict(n_nodes=60_000, n_labels=2, n_edges=50_000, seed=0)
    return synth.random_graph(**kw), ref_synth.random_graph(**kw)


def _both(text, g, rg):
    return (soi.compile_soi(soi.build_soi(sparql.parse(text)), g),
            ref_soi.compile_soi(ref_soi.build_soi(ref_sparql.parse(text)), rg))


@pytest.mark.parametrize("backend", ["cpu", "cuda"])
@pytest.mark.parametrize("n_devices", [1, 2, 8])
@pytest.mark.parametrize("calibrated", [None, 1e3, 1e12])
def test_cost_model_with_devices_matches_reference(n_devices, backend,
                                                   calibrated):
    """The six-engine dict, the pick and the resume decision equal the
    reference's at 1, 2 and 8 devices, hand-tuned and calibrated (slow and
    fast collectives), on the 60,000-node graph past the dense tier and on
    a 2,000-node graph inside it; on one device partitioned is never
    selectable.  Under a calibrated card's spec the dense-tier engines
    inside the tier are priced by the port's kernels' work instead, their
    resume decisions by the reference's rule over those prices, and the
    edge engines' prices and decisions stay the reference's."""
    ref_backend = "cpu" if backend == "cpu" else "tpu"
    spec = rspec = None
    if calibrated is not None:
        spec, rspec = _specs(backend=ref_backend,
                             collective_bytes_per_s=calibrated)
    card = spec is not None and backend == "cuda"
    kw = dict(n_nodes=2_000, n_labels=2, n_edges=20_000, seed=1)
    for g, rg in (_big(), (synth.random_graph(**kw), ref_synth.random_graph(**kw))):
        for text in ("{ ?a p0 ?b }", "{ ?a p0 ?b . ?b p1 ?a }"):
            c, rc = _both(text, g, rg)
            got = cost.estimate_costs(g, c, backend=backend, n_devices=n_devices,
                                      spec=spec)
            want = ref_cost.estimate_costs(rg, rc, backend=ref_backend,
                                           n_devices=n_devices, spec=rspec)
            tier = (_card_tier_prices(g, c, spec)
                    if card and cost.dense_tier_feasible(g.n_nodes) else {})
            for engine in cost.ENGINES:
                if engine in tier:
                    assert got[engine] == pytest.approx(tier[engine], rel=1e-12)
                else:
                    assert got[engine] == want[engine], engine
            assert (got["partitioned"] == float("inf")) == (n_devices == 1)
            est = cost.choose_engine(g, c, backend=backend, n_devices=n_devices,
                                     spec=spec)
            rest = ref_cost.choose_engine(rg, rc, backend=ref_backend,
                                          n_devices=n_devices, spec=rspec)
            assert est.costs == got and est.engine == min(got, key=got.get)
            if not tier:
                assert est.engine == rest.engine and est.costs == rest.costs
            for engine in cost.ENGINES:
                a = cost.resume_decision(g, c, engine=engine, delta_edges=10,
                                         last_sweeps=4, backend=backend,
                                         n_devices=n_devices, spec=spec)
                b = ref_cost.resume_decision(rg, rc, engine=engine, delta_edges=10,
                                             last_sweeps=4, backend=ref_backend,
                                             n_devices=n_devices, spec=rspec)
                if engine in tier:
                    b = _resume_on(g, c, tier[engine], spec, 10, 4)
                    assert a.resume == b[0], engine
                    assert (a.est_resume, a.est_cold) == pytest.approx(b[1:], rel=1e-12)
                else:
                    assert (a.resume, a.est_resume, a.est_cold) == (
                        b.resume, b.est_resume, b.est_cold), engine


def test_cost_model_partitioned_needs_a_mesh_and_wins_on_one():
    """The reference's engine tests: one device keeps sparse; 8 devices on
    the 60,000-node graph pick partitioned, and sparse pays its collectives
    there; a small graph stays on dense with a mesh."""
    g, _ = _big()
    c = soi.compile_soi(soi.build_soi(sparql.parse("{ ?a p0 ?b }")), g)
    one = cost.choose_engine(g, c, backend="cpu", n_devices=1)
    assert one.costs["partitioned"] == float("inf") and one.engine == "sparse"
    est = cost.choose_engine(g, c, backend="cpu", n_devices=8)
    assert est.engine == "partitioned" and "W=8" in est.reason
    assert est.costs["partitioned"] < est.costs["sparse"]
    assert est.costs["sparse"] > one.costs["sparse"]
    small = synth.random_graph(n_nodes=48, n_labels=2, n_edges=1500, seed=0)
    cs = soi.compile_soi(soi.build_soi(sparql.parse("{ ?a p0 ?b . ?b p1 ?c }")),
                         small)
    assert cost.choose_engine(small, cs, backend="cpu",
                              n_devices=8).engine == "dense"


def test_single_device_reduces_to_single_shard_model():
    """Collective constants are unread at one device and read on a mesh
    (the reference's calibration test), and c_comm derives as it does."""
    g = synth.random_graph(n_nodes=2_000, n_labels=2, n_edges=10_000, seed=0)
    c = soi.compile_soi(
        soi.build_soi(sparql.parse("{ ?a p0 ?b . ?b p1 ?c }")), g)
    slow, rslow = _specs(collective_bytes_per_s=1e3)
    fast, rfast = _specs(collective_bytes_per_s=1e12)
    a = cost.estimate_costs(g, c, backend="cpu", n_devices=1, spec=slow)
    b = cost.estimate_costs(g, c, backend="cpu", n_devices=1, spec=fast)
    assert a == b and a["partitioned"] == float("inf")
    a8 = cost.estimate_costs(g, c, backend="cpu", n_devices=8, spec=slow)
    b8 = cost.estimate_costs(g, c, backend="cpu", n_devices=8, spec=fast)
    assert a8["sparse"] > b8["sparse"]
    for spec, rspec in ((slow, rslow), _specs()):
        assert (cost.CostModel.from_spec(spec).c_comm
                == ref_cost.CostModel.from_spec(rspec).c_comm)
    assert cost.HAND_TUNED.c_comm == ref_cost.HAND_TUNED.c_comm


@pytest.mark.parametrize("n_devices", [1, 3, 8])
@pytest.mark.parametrize("backend", ["cpu", "cuda"])
def test_no_spec_can_unrefuse_the_dense_tier_on_a_mesh(n_devices, backend):
    rng = np.random.default_rng(n_devices)
    rate = lambda: float(10 ** rng.uniform(3, 15))  # noqa: E731
    g = synth.random_graph(int(cost.DENSE_MAX_BYTES ** 0.5) + 1, 1, 10, seed=0)
    c = soi.compile_soi(soi.build_soi(sparql.parse("{ ?a p0 ?b }")), g)
    spec, _ = _specs(backend=backend, stream_bytes_per_s=rate(),
                     dense_elems_per_s=rate(), collective_bytes_per_s=rate())
    est = cost.choose_engine(g, c, spec=spec, backend=backend,
                             n_devices=n_devices)
    for tier in dualsim.DENSE_TIER_ENGINES:
        assert est.costs[tier] == float("inf"), tier
    assert est.engine in dualsim.EDGE_ENGINES


# --------------------------------------------------------------------- #
# Engine / GraphDB
# --------------------------------------------------------------------- #
def _lubm():
    return synth.lubm_like(3, seed=0), ref_synth.lubm_like(3, seed=0)


def test_partitioned_warm_rebind_builds_no_operands():
    """engine="partitioned" serves constant rebinds with no plan builds and
    no operand builds, with the reference's answers and sweeps."""
    g, rg = _lubm()
    eng = Engine(g, engine="partitioned", device="cpu")
    ref = RefEngine(rg, engine="partitioned")
    assert eng.n_blocks == ref.n_blocks == 4
    q0 = MEMBERS_OF.format(uni="Univ0")
    r0 = eng.execute(q0)
    assert not r0.cache_hit and r0.engine == "partitioned"
    plan, _ = eng.plan_for(canonicalize(sparql.parse(q0)))
    misses = eng.cache.misses
    for uni in ["Univ1", "Univ2", "Univ0"]:
        q = f"{{ ?q subOrganizationOf {uni} . ?m memberOf ?q }}"
        r, want = eng.execute(q), ref.execute(q)
        assert r.cache_hit
        assert np.array_equal(r.survivors, want.survivors)
        assert r.sweeps == want.sweeps
    assert eng.cache.misses == misses
    assert plan.metrics.operand_builds == 1


@pytest.mark.parametrize("shards", [2, 8])
def test_partitioned_engine_on_a_simulated_mesh(shards):
    """The partitioned engine over a simulated mesh (one destination block
    per shard) equals the reference's single-device partitioned engine
    with as many blocks: survivors, bindings, sweeps; warm rebinds build
    nothing and every block of the plan's operands sits on its shard."""
    g, rg = _lubm()
    mesh = ctx.node_mesh(shards, device="cpu")
    eng = Engine(g, engine="partitioned", device="cpu", mesh=mesh)
    assert eng.n_blocks == shards and eng.n_devices == shards
    ref = RefEngine(rg, engine="partitioned", n_blocks=shards)
    qs = [MEMBERS_OF.format(uni=u) for u in ("Univ0", "Univ1", "Univ2")]
    qs += QUERIES[1:4]
    for q in qs:
        r, want = eng.execute(q), ref.execute(q)
        assert r.engine == "partitioned"
        assert np.array_equal(r.survivors, want.survivors)
        assert r.sweeps == want.sweeps
        for var, mask in want.bindings.items():
            assert np.array_equal(r.bindings[var], mask), var
    plan, hit = eng.plan_for(canonicalize(sparql.parse(qs[0])))
    assert hit and plan.metrics.operand_builds == 1
    assert plan.mesh is mesh and plan.operands.n_blocks == shards
    assert len(dualsim._column_shards(shards, 1, mesh)) == shards
    again = eng.execute(qs[0])
    assert again.cache_hit and plan.metrics.operand_builds == 1


def test_auto_picks_partitioned_on_a_mesh_past_the_dense_budget():
    """auto + an 8-shard mesh on the 60,000-node graph serves through
    solve_partitioned; the warm repeat builds nothing; the answer equals
    the reference's single-device partitioned engine at 8 blocks."""
    g, rg = _big()
    mesh = ctx.node_mesh(8, device="cpu")
    eng = Engine(g, engine="auto", device="cpu", mesh=mesh)
    q = "{ ?a p0 ?b . ?b p1 ?a }"
    r0 = eng.execute(q)
    assert r0.engine == "partitioned" and not r0.cache_hit
    plan, _ = eng.plan_for(canonicalize(sparql.parse(q)))
    assert plan.cost is not None and plan.cost.engine == "partitioned"
    r1 = eng.execute(q)
    assert r1.cache_hit and plan.metrics.operand_builds == 1
    assert np.array_equal(r0.survivors, r1.survivors)
    want = RefEngine(rg, engine="partitioned", n_blocks=8).execute(q)
    assert np.array_equal(r0.survivors, want.survivors)
    assert r0.sweeps == want.sweeps


@pytest.mark.parametrize("shards", [None, 4])
def test_graphdb_mutation_resumes_on_a_mesh(shards):
    """Delete + re-insert through GraphDB(engine="partitioned"), with and
    without a simulated mesh: the plan is patched and warm-resumed twice,
    never rebuilt, with the reference's answers and counters."""
    mesh = None if shards is None else ctx.node_mesh(shards, device="cpu")
    db = GraphDB(synth.lubm_like(3, seed=0), engine="partitioned",
                 device="cpu", mesh=mesh)
    from repro.db import GraphDB as RefGraphDB

    ref = RefGraphDB(ref_synth.lubm_like(3, seed=0), engine="partitioned",
                     n_blocks=shards or 4)
    q = MEMBERS_OF.format(uni="Univ0")
    _same_result(db.query(q), ref.query(q))
    plan, _ = db._engine.plan_for(canonicalize(sparql.parse(q)), bucket=1)
    g = db.graph
    row = g.triples[int(np.flatnonzero(
        g.triples[:, 1] == g.label_id("memberOf"))[0])]
    t = (g.node_names[row[0]], g.label_names[row[1]], g.node_names[row[2]])
    for mutate in ("delete", "insert"):
        assert getattr(db, mutate)([t]) == getattr(ref, mutate)([t]) == 1
        _same_result(db.query(q), ref.query(q))
        m, rm = db.metrics(), ref.metrics()
        for name in ("plans_resumable", "plans_resumed", "warm_resume_solves",
                     "resumes_declined"):
            assert getattr(m, name) == getattr(rm, name), name
    assert db.metrics().plans_resumed >= 2
    assert plan.metrics.patches == 2 and plan.metrics.operand_builds == 1


def test_replicas_inherit_the_mesh_and_blocks():
    from repro_torch.serve import ReplicaRouter

    mesh = ctx.node_mesh(2, device="cpu")
    db = GraphDB(synth.lubm_like(2, seed=0), engine="partitioned",
                 device="cpu", mesh=mesh, n_blocks=4)
    router = ReplicaRouter(db, n_replicas=2)
    for rep in router.replicas:
        assert rep.engine.mesh is mesh and rep.engine.n_blocks == 4


def test_launch_counts_one_segor_call_per_block_and_operator():
    """The card's layout, run on the CPU, takes the plain version and
    counts nothing; the number of per-block reduces a solve makes is
    sweeps x operators x blocks."""
    g, _, c, _ = _instance(21, 77)
    ops = _blocked(c, g, 4)
    calls = []
    orig = dualsim.segsum_kernel.segor_blocks

    def spy(*a, **kw):
        calls.append(kw["num_segments"])
        return orig(*a, **kw)

    kernels.reset_launches()
    try:
        dualsim.segsum_kernel.segor_blocks = spy
        _, it = dualsim.solve_partitioned(ops)
    finally:
        dualsim.segsum_kernel.segor_blocks = orig
    assert len(calls) == it * len(c.mats) * 4
    assert set(calls) == {ops.init.shape[-1] // 4}
    assert not any(kernels.launch_counts().values())


# --------------------------------------------------------------------- #
# the serving driver
# --------------------------------------------------------------------- #
def test_launch_serve_partitioned_on_a_simulated_mesh():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch_serve.main(["--device", "cpu", "--engine", "partitioned",
                           "--devices", "4", "--mutate", "--batch", "4",
                           "--requests", "8"])
    text = out.getvalue()
    assert "mesh of 4 devices" in text
    assert "served 16/16 requests" in text
    assert "engines={'partitioned': 4}" in text
    assert "1 patched + resumed" in text


def test_launch_serve_refuses_cards_it_does_not_have():
    more = torch.cuda.device_count() + 1 if torch.cuda.is_available() else 2
    with pytest.raises(RuntimeError):
        launch_serve.main(["--device", "cuda", "--engine", "partitioned",
                           "--devices", str(more)])
