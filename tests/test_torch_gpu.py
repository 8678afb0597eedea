"""Card-only tests of the port (marker ``gpu``): the CUDA kernels (the
segmented OR, the two packed boolean products and the segment sum) against
their plain PyTorch versions, the query path on the card (the edge
engines, the partitioned engine and the dense tier) against the same path
on the CPU, a two-replica ``AsyncServer`` on the card, the LM's train
step, attention, decode and ``launch.train`` on the card against the CPU,
and the MoE LMs' train step and dispatch, the GNNs' ``GNNArch.step`` and the
recsys model's step, EmbeddingBag, retrieval and sharded step on
the card against the CPU, the LM serving steps on DTensor state over a
1x1 mesh of the card against the plain steps, and the machine probe's
``--fast`` sweep on the card.  A CUDA kernel has no CPU mode, so without a
card these skip.  The file imports neither JAX nor the JAX package, so it
runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py
"""
import asyncio
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import bitops, sparql
from repro_torch.data import synth
from repro_torch.db import GraphDB
from repro_torch.kernels.bitmm import kernel as bitmm_kernel
from repro_torch.kernels.bitmm import ref as bitmm_ref
from repro_torch.kernels.segsum import kernel, ops, ref
from repro_torch.serve import AsyncServer

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _operands(device, v, n, e, seed, block_e=256, block_n=256, dst=None,
              fill=None):
    rng = np.random.default_rng(seed)
    frontier = rng.random((v, n)) < 0.4 if fill is None else np.full((v, n), fill)
    src = rng.integers(0, n, e).astype(np.int32)
    if dst is None:
        dst = rng.integers(0, n, e).astype(np.int32)
    idx_b, seg_b, win, _ = kernel.prepare_segor(
        dst, n, block_e=block_e, block_n=block_n
    )
    as_t = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    return (bitops.to_words(bitops.pack_np(frontier), device),
            as_t(src[idx_b] if e else np.zeros(idx_b.shape, np.int32)),
            as_t(seg_b), as_t(win))


# V on both sides of a word of variables (Vw = 1, 2, 3, 7), and the largest
# V whose accumulator fits a block at block_n = 256 (Vw = 227, past the
# 48 KB opt-in)
SEGOR_VARS = [1, 7, 48, 128, 31, 32, 33, 64, 65, 200, 7264]


@pytest.mark.parametrize("v", SEGOR_VARS)
def test_cuda_kernel_matches_plain_version(cuda_device, v):
    kernels.reset_launches()
    args = _operands(cuda_device, v=v, n=1000, e=20_000, seed=v)
    out = kernel.segor_blocks(*args, num_segments=1000)
    torch.cuda.synchronize()
    assert torch.equal(out, ref.segor_blocks_ref(*args, num_segments=1000))
    assert kernels.LAUNCHES["segor_blocks"] == 1


def _runs(lengths):
    """Sorted destinations with the given run lengths, one id a run."""
    return np.repeat(np.arange(len(lengths)), lengths).astype(np.int32)


# name: (V, n, E, destinations or None, fill, block_e, block_n)
SEGOR_BRANCH_CASES = {
    "block_n_32": (9, 50, 900, None, None, 64, 32),
    "block_n_32_two_words": (65, 100, 900, None, None, 64, 32),
    "full_frontier": (48, 1000, 20_000, None, True, 256, 256),
    "empty_frontier": (48, 1000, 20_000, None, False, 256, 256),
    "one_destination": (33, 40, 2000, np.full(2000, 7, np.int32), None, 256, 256),
    "runs_across_warps": (40, 260, 568, _runs([1, 31, 32, 33, 64, 65, 100, 2, 3,
                                                40, 32, 33, 64, 65, 3]),
                          None, 256, 256),
    "window_shared_by_many_blocks": (48, 300, 20_000,
                                     np.arange(20_000, dtype=np.int32) % 200,
                                     None, 256, 256),
    "block_e_not_a_multiple_of_32": (33, 90, 700, None, None, 100, 256),
    "no_edges": (8, 70, 0, None, None, 256, 256),
}


@pytest.mark.parametrize("name", list(SEGOR_BRANCH_CASES))
def test_cuda_kernel_branch_cases(cuda_device, name):
    """Each branch of the kernel pair against the plain version: a word of
    variables and more at block_n = 32, full and empty frontiers, runs of
    one destination as long as a warp and longer (across warps), a window
    that many blocks share, a partial last warp, no edges; two launches
    give the same bits."""
    v, n, e, dst, fill, block_e, block_n = SEGOR_BRANCH_CASES[name]
    args = _operands(cuda_device, v=v, n=n, e=e, seed=e + n, block_e=block_e,
                     block_n=block_n, dst=dst, fill=fill)
    got = [kernel.segor_blocks(*args, num_segments=n, block_n=block_n)
           for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(got[0], got[1])
    assert torch.equal(got[0], ref.segor_blocks_ref(*args, num_segments=n,
                                                     block_n=block_n))
    if fill is False:
        assert not got[0].any()


@pytest.mark.parametrize("n", [1, 31, 32, 1000, 4099])
@pytest.mark.parametrize("v", [1, 32, 33, 100, 7264])
def test_source_major_kernel_matches_plain_version(cuda_device, v, n):
    rng = np.random.default_rng(v + n)
    f = bitops.pack_np(rng.random((v, n)) < 0.5)
    if n % 32:  # dirty pad bits must not reach the copy
        f[:, -1] |= np.uint32(0xFFFFFFFF) << np.uint32(n % 32)
    f = bitops.to_words(f, cuda_device)
    kernels.reset_launches()
    got = kernel.source_major(f, n)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.source_major_ref(f, n))
    assert kernels.LAUNCHES["segor_transpose"] == 1


def test_cuda_kernel_window_revisits_and_empty_edges(cuda_device):
    args = _operands(cuda_device, v=9, n=50, e=900, seed=1, block_e=64,
                     block_n=32)
    out = kernel.segor_blocks(*args, num_segments=50, block_n=32)
    assert torch.equal(
        out, ref.segor_blocks_ref(*args, num_segments=50, block_n=32))
    args = _operands(cuda_device, v=4, n=70, e=0, seed=2)
    out = kernel.segor_blocks(*args, num_segments=70)
    torch.cuda.synchronize()
    assert out.shape == (4, 3) and not out.any()


def test_cuda_kernel_refuses_vars_past_shared_memory(cuda_device):
    args = _operands(cuda_device, v=8000, n=64, e=10, seed=3)
    with pytest.raises(ValueError, match="shared memory"):
        kernel.segor_blocks(*args, num_segments=64)


def test_cuda_kernel_refuses_the_first_v_past_shared_memory(cuda_device):
    """V = 7,265 needs 228 words of accumulator a destination, one past the
    227 KB of a block at block_n = 256: refused before any launch."""
    args = _operands(cuda_device, v=7265, n=64, e=10, seed=3)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="shared memory"):
        kernel.segor_blocks(*args, num_segments=64)
    assert not any(kernels.launch_counts().values())


def test_card_operands_are_blocked_and_never_run_plain(cuda_device):
    """On the card the operands carry the blocked layout only, a flat
    layout is refused, and every solve launches the kernel."""
    from repro_torch.core import dualsim, soi

    g = synth.random_graph(300, 3, 1200, seed=4)
    c = soi.compile_soi(soi.build_soi(sparql.parse(
        "{ ?a p0 ?b . ?b p1 ?c } OPTIONAL { ?c p2 ?d }")), g)
    ops = dualsim.make_sparse_operands(c, g, device=cuda_device)
    assert ops.blocked and ops.edge_src is None
    with pytest.raises(ValueError, match="blocked layout"):
        dataclasses.replace(ops, seg_src_b=None, seg_dst_b=None, seg_win=None,
                            edge_src=ops.seg_src_b, edge_dst=ops.seg_dst_b)
    kernels.reset_launches()
    chi, sweeps = dualsim.solve_sparse(ops)
    assert kernels.LAUNCHES["segor_blocks"] == sweeps * len(c.mats)
    want, _ = dualsim.solve_worklist(c, g)
    assert np.array_equal(chi.cpu().numpy(), want)


def test_query_path_on_card_matches_cpu(cuda_device):
    g = synth.lubm_like(4, seed=0)
    card, cpu = GraphDB(g), GraphDB(g, device="cpu")
    queries = [
        "{ ?d subOrganizationOf Univ%d . ?s memberOf ?d }" % u for u in range(4)
    ] + [sparql.format_query(synth.lubm_l1_like()),
         sparql.format_query(synth.optional_query())]
    kernels.reset_launches()
    got = card.execute_many(queries)
    assert kernels.LAUNCHES["segor_blocks"] > 0
    for a, b in zip(got, cpu.execute_many(queries)):
        assert np.array_equal(a.survivor_mask, b.survivor_mask)
        assert a.sweeps == b.sweeps
        for var in a.variables:
            assert np.array_equal(a.binding_mask(var), b.binding_mask(var))


@pytest.mark.parametrize("n,n_blocks", [(300, 4), (61, 8), (1000, 3),
                                         (5000, 2)])
def test_solve_partitioned_on_card_matches_cpu(cuda_device, n, n_blocks):
    """The partitioned engine on the card (each block's reduce is one K1
    launch over n_local destinations and the whole padded frontier)
    equals the CPU run, chi and sweeps, including block sizes that are not
    a multiple of K1's 256-node window; the card's operands hold the
    per-block layout only, and no launch is made but K1's."""
    from repro_torch.core import dualsim, soi

    g = synth.random_graph(n, 3, 4 * n, seed=n)
    c = soi.compile_soi(soi.build_soi(sparql.parse(
        "{ ?a p0 ?b . ?b p1 ?c } OPTIONAL { ?c p2 ?d }")), g)
    ops = dualsim.make_partitioned_operands(c, g, n_blocks, device=cuda_device)
    assert ops.part_seg is not None and ops.edge_src_b is None
    kernels.reset_launches()
    chi, sweeps = dualsim.solve_partitioned(ops)
    launches = kernels.launch_counts()
    assert launches["segor_blocks"] == sweeps * len(c.mats) * n_blocks
    cpu, cpu_sweeps = dualsim.solve_partitioned(
        dualsim.make_partitioned_operands(c, g, n_blocks, device="cpu"))
    assert torch.equal(chi.cpu(), cpu) and sweeps == cpu_sweeps
    want, _ = dualsim.solve_worklist(c, g)
    assert np.array_equal(chi[:, :n].cpu().numpy(), want)


def test_partitioned_query_path_on_card_matches_cpu(cuda_device):
    """GraphDB(engine="partitioned") on the card, on a mesh of the card,
    and on the CPU give the same answers and sweeps, through a
    delete / re-insert that resumes the plan."""
    from repro_torch.distributed import ctx

    g = synth.lubm_like(4, seed=0)
    dbs = [GraphDB(g, engine="partitioned"),
           GraphDB(g, engine="partitioned", mesh=ctx.node_mesh(1), n_blocks=4),
           GraphDB(g, engine="partitioned", device="cpu")]
    queries = [
        "{ ?d subOrganizationOf Univ%d . ?s memberOf ?d }" % u for u in range(4)
    ] + [sparql.format_query(synth.lubm_l1_like())]
    row = g.triples[int(np.flatnonzero(
        g.triples[:, 1] == g.label_id("memberOf"))[0])]
    t = (g.node_names[row[0]], g.label_names[row[1]], g.node_names[row[2]])
    for step in ("cold", "delete", "insert"):
        if step != "cold":
            for db in dbs:
                assert getattr(db, step)([t]) == 1
        card, mesh, cpu = (db.execute_many(queries) for db in dbs)
        for a, b, c in zip(card, mesh, cpu):
            assert np.array_equal(a.survivor_mask, c.survivor_mask)
            assert np.array_equal(b.survivor_mask, c.survivor_mask)
            assert a.sweeps == b.sweeps == c.sweeps
            assert a.engine == c.engine == "partitioned"
    assert all(db.metrics().plans_resumed >= 2 for db in dbs)


def test_bitmm_ops_on_card_match_cpu(cuda_device):
    """The public packed products launch their kernels on the card and
    equal the CPU's plain versions, the packed frontier's pad bits
    ignored."""
    from repro_torch.kernels.bitmm import ops as bitmm_ops

    chi_p, a_p, flags = _bitmm_case(cuda_device, 48, 1000, 3)
    x = bitops.unpack(chi_p, 1000)
    dirty = chi_p.clone()
    dirty[:, -1] |= -(1 << (1000 % 32))
    kernels.reset_launches()
    got = (bitmm_ops.bitmm(x, a_p), bitmm_ops.bitmm_packed(dirty, a_p),
           bitmm_ops.bitmm_apply(chi_p, a_p, flags))
    launches = kernels.launch_counts()
    assert launches["bitmm_packed"] == 2 and launches["bitmm_apply_packed"] == 1
    cpu = (bitmm_ops.bitmm(x.cpu(), a_p.cpu()),
           bitmm_ops.bitmm_packed(chi_p.cpu(), a_p.cpu()),
           bitmm_ops.bitmm_apply(chi_p.cpu(), a_p.cpu(), flags.cpu()))
    assert torch.equal(got[0].cpu(), cpu[0])
    assert torch.equal(got[1].cpu(), cpu[1])
    assert torch.equal(got[2][0].cpu(), cpu[2][0])
    assert (int(got[2][1]) != 0) == (int(cpu[2][1]) != 0)


# --------------------------------------------------------------------- #
# the packed boolean products (bitmm_apply_packed, bitmm_packed)
# --------------------------------------------------------------------- #
def _bitmm_case(device, v, n, seed, density=0.1):
    rng = np.random.default_rng(seed)
    a = rng.random((n, n)) < density
    chi = rng.random((v, n)) < 0.6
    flags = (rng.random((v, v)) < 0.5).astype(np.int32)
    return (bitops.to_words(bitops.pack_np(chi), device),
            bitops.to_words(bitops.pack_np(a), device),
            torch.as_tensor(flags, device=device))


def _slice_boundary_n(v, where):
    """The first n whose contraction slices hold more than one word and
    that lies one row below, at or one row above a multiple of a slice's
    rows, on this card's grid."""
    offset = {"below": -1, "at": 0, "above": 1}[where]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n in range(1_000, 40_000):
        rows = bitmm_kernel.geometry(v, -(-n // 32), sms).slice_words * 32
        if rows > 32 and n % rows == offset % rows:
            return n
    raise AssertionError(f"no n {where} a slice boundary")


# V x n, then the split boundaries: n around a slice's row count, nw = 132
# (a ragged column tile on the vector path; nw = 129 and n = 100, where
# more slices are asked for than there are contraction words, are in the
# grid), two or three variable groups, and V past 384, where the update
# kernel's [V, 32] words of ~y pass 48 KB of shared memory, up to the
# largest V the wrappers take (29 variable groups)
BITMM_SHAPES = [(v, n) for v in (1, 5, 48, 64)
                for n in (1, 31, 33, 100, 1000, 4099)] + [
    (48, "below"), (48, "at"), (48, "above"), (48, 4200), (65, 1000),
    (130, 4099)] + [(v, n) for v in (385, 1760, bitmm_kernel.MAX_VARS)
                    for n in (100, 4099)]


@pytest.mark.parametrize("v,n", BITMM_SHAPES,
                         ids=[f"{v}-{n}" for v, n in BITMM_SHAPES])
def test_bitmm_kernels_match_plain_versions(cuda_device, v, n):
    if isinstance(n, str):
        n = _slice_boundary_n(v, n)
    kernels.reset_launches()
    chi_p, a_p, flags = _bitmm_case(cuda_device, v, n, seed=n * 100 + v)
    new, ch = bitmm_kernel.bitmm_apply(chi_p, a_p, flags)
    want, want_ch = bitmm_ref.bitmm_apply_ref(chi_p, a_p, flags)
    x = bitops.unpack(chi_p, n)
    out = bitmm_kernel.bitmm_packed(x, a_p)
    torch.cuda.synchronize()
    assert torch.equal(new, want) and int(ch) == int(want_ch)
    assert torch.equal(out, bitmm_ref.bitmm_packed_ref(x, a_p))
    assert kernels.LAUNCHES["bitmm_apply_packed"] == 1
    assert kernels.LAUNCHES["bitmm_packed"] == 1


@pytest.mark.parametrize("fill", ["full", "empty"])
def test_bitmm_kernels_full_and_empty_frontiers_across_slices(cuda_device,
                                                              fill):
    """Every frontier bit set over a full adjacency keeps chi whole and
    fills every product word; an empty frontier gives empty words."""
    n = _slice_boundary_n(48, "at")
    chi = np.full((48, n), fill == "full")
    a = np.ones((n, n), bool)
    chi_p = bitops.to_words(bitops.pack_np(chi), cuda_device)
    a_p = bitops.to_words(bitops.pack_np(a), cuda_device)
    flags = torch.ones((48, 48), dtype=torch.int32, device=cuda_device)
    new, ch = bitmm_kernel.bitmm_apply(chi_p, a_p, flags)
    assert torch.equal(new, chi_p) and int(ch) == 0
    out = bitmm_kernel.bitmm_packed(bitops.unpack(chi_p, n), a_p)
    assert torch.equal(bitops.unpack(out, n).cpu(), torch.as_tensor(chi))


def test_bitmm_kernels_give_the_same_bits_every_launch(cuda_device):
    n = _slice_boundary_n(48, "above")
    # a sparse adjacency, so that chi moves and changed is nonzero
    chi_p, a_p, flags = _bitmm_case(cuda_device, 48, n, seed=11,
                                    density=0.0002)
    (new1, ch1), (new2, ch2) = (bitmm_kernel.bitmm_apply(chi_p, a_p, flags)
                                for _ in range(2))
    assert torch.equal(new1, new2) and int(ch1) == int(ch2) != 0
    x = bitops.unpack(chi_p, n)
    assert torch.equal(bitmm_kernel.bitmm_packed(x, a_p),
                       bitmm_kernel.bitmm_packed(x, a_p))


def test_bitmm_kernels_edge_cases(cuda_device):
    """Empty frontier, all-zero flags, and a chi at its fixpoint."""
    chi_p, a_p, flags = _bitmm_case(cuda_device, 9, 300, seed=7)
    zero = torch.zeros_like(chi_p)
    new, ch = bitmm_kernel.bitmm_apply(zero, a_p, flags)
    assert not new.any() and int(ch) == 0
    assert not bitmm_kernel.bitmm_packed(bitops.unpack(zero, 300), a_p).any()
    new, ch = bitmm_kernel.bitmm_apply(chi_p, a_p, torch.zeros_like(flags))
    assert torch.equal(new, chi_p) and int(ch) == 0
    for _ in range(50):
        nxt, ch = bitmm_kernel.bitmm_apply(chi_p, a_p, flags)
        assert (int(ch) != 0) == (not torch.equal(nxt, chi_p))
        if int(ch) == 0:
            break
        chi_p = nxt
    else:
        raise AssertionError("fused step never converged")


def test_bitmm_kernels_refuse_vars_past_shared_memory(cuda_device):
    v = bitmm_kernel.MAX_VARS + 1
    chi_p, a_p, _ = _bitmm_case(cuda_device, v, 64, seed=3)
    flags = torch.zeros((v, v), dtype=torch.int32, device=cuda_device)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="shared memory"):
        bitmm_kernel.bitmm_apply(chi_p, a_p, flags)
    with pytest.raises(ValueError, match="shared memory"):
        bitmm_kernel.bitmm_packed(bitops.unpack(chi_p, 64), a_p)
    assert not any(kernels.launch_counts().values())


def test_packed_fused_on_card_launches_kernel_never_plain(cuda_device,
                                                          monkeypatch):
    """Packed operands on the card run every sweep through the CUDA
    kernels: the plain versions are never called, and the result equals
    the worklist fixpoint."""
    from repro_torch.core import dualsim, soi

    def refuse(*args, **kwargs):
        raise AssertionError("the plain version ran on the card")

    monkeypatch.setattr(bitmm_ref, "bitmm_apply_ref", refuse)
    monkeypatch.setattr(bitmm_ref, "bitmm_packed_ref", refuse)
    g = synth.random_graph(300, 3, 1200, seed=4)
    c = soi.compile_soi(soi.build_soi(sparql.parse(
        "{ ?a p0 ?b . ?b p1 ?c } OPTIONAL { ?c p2 ?d }")), g)
    ops = dualsim.make_packed_operands(c, g, device=cuda_device)
    want, _ = dualsim.solve_worklist(c, g)
    kernels.reset_launches()
    chi, sweeps = dualsim.solve_packed_fused(ops)
    assert kernels.LAUNCHES["bitmm_apply_packed"] == sweeps * len(c.mats)
    assert np.array_equal(chi.cpu().numpy(), want)
    chi, sweeps = dualsim.solve_packed(ops)
    assert kernels.LAUNCHES["bitmm_packed"] == sweeps * len(c.mats)
    assert np.array_equal(chi.cpu().numpy(), want)


@pytest.mark.parametrize("engine", ["dense", "packed", "packed_fused"])
def test_dense_tier_query_path_on_card_matches_cpu(cuda_device, engine):
    g = synth.lubm_like(4, seed=0)
    card, cpu = GraphDB(g, engine=engine), GraphDB(g, engine=engine,
                                                   device="cpu")
    queries = [
        "{ ?d subOrganizationOf Univ%d . ?s memberOf ?d }" % u for u in range(4)
    ] + [sparql.format_query(synth.lubm_l1_like())]
    for a, b in zip(card.execute_many(queries), cpu.execute_many(queries)):
        assert np.array_equal(a.survivor_mask, b.survivor_mask)
        assert a.sweeps == b.sweeps and a.engine == b.engine == engine


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5), (np.float64, 1e-12)])
@pytest.mark.parametrize("e,n,d", [(100, 64, 8), (37, 513, 3), (5000, 100, 70),
                                   (4000, 700, 128), (3000, 50, 200)])
def test_segsum_kernel_matches_plain_version(cuda_device, e, n, d, dtype, tol):
    rng = np.random.default_rng(e + n + d)
    vals = rng.normal(size=(e, d)).astype(dtype)
    ids = rng.integers(0, n, e).astype(np.int32)
    kernels.reset_launches()
    got = ops.segsum(vals, ids, n)
    assert kernels.LAUNCHES["segsum"] == 1
    want = ref.segsum_ref(torch.as_tensor(vals, device=cuda_device),
                          torch.as_tensor(ids, device=cuda_device), n)
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    assert torch.equal(got, ops.segsum(vals, ids, n))  # same bits every launch


def test_segsum_kernel_edge_cases(cuda_device):
    out = ops.segsum(np.zeros((0, 4), np.float32), np.zeros(0, np.int32), 8)
    assert out.shape == (8, 4) and not out.any()
    assert ops.segsum(np.ones((3, 2), np.float32), np.zeros(3, np.int32), 0).shape == (0, 2)
    out = ops.segsum(np.ones((16, 4), np.float32), np.zeros(16, np.int32), 1)
    assert torch.equal(out.cpu(), torch.full((1, 4), 16.0))
    with pytest.raises(TypeError):
        ops.segsum(np.ones((4, 2), np.float16), np.zeros(4, np.int32), 2)


@pytest.mark.parametrize("v,e,n", [(1, 31, 5), (33, 5000, 300), (65, 700, 2000)])
def test_segor_op_edge_axis_matches_cpu(cuda_device, v, e, n):
    """``ops.segor`` gathers along the edge axis (n_src = E != n)."""
    rng = np.random.default_rng(v + e + n)
    bits = (rng.random((v, e)) < 0.3).astype(np.int8)
    ids = rng.integers(0, n, e).astype(np.int32)
    got = ops.segor(bits, ids, n)
    assert torch.equal(got.cpu(), ops.segor(bits, ids, n, device="cpu"))


def test_segor_op_on_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(4)
    bits = (rng.random((9, 4000)) < 0.3).astype(np.int8)
    ids = rng.integers(0, 1000, 4000).astype(np.int32)
    kernels.reset_launches()
    got = ops.segor(bits, ids, 1000)
    assert kernels.LAUNCHES["segor_blocks"] == 1
    assert torch.equal(got.cpu(), ops.segor(bits, ids, 1000, device="cpu"))


def test_async_server_two_replicas_on_card(cuda_device):
    db = GraphDB(synth.lubm_like(4, seed=0))
    texts = ["{ ?d subOrganizationOf Univ%d . ?s memberOf ?d }" % (i % 4)
             for i in range(16)]

    async def go():
        async with AsyncServer(db, replicas=2, max_batch=4,
                               default_deadline_ms=60_000.0) as server:
            first = await asyncio.gather(*[server.submit(t) for t in texts])
            db.insert([("DeptNew", "subOrganizationOf", "Univ0"),
                       ("StudentNew", "memberOf", "DeptNew")])
            await server.fence()
            return first, await asyncio.gather(*[server.submit(t) for t in texts])

    kernels.reset_launches()
    first, second = asyncio.run(go())
    assert kernels.LAUNCHES["segor_blocks"] > 0
    cpu = GraphDB(synth.lubm_like(4, seed=0), device="cpu")
    for wave in (first, second):
        want = cpu.execute_many(texts)
        for r, w in zip(wave, want):
            assert r.ok, (r.outcome, r.detail)
            assert np.array_equal(r.result.survivor_mask, w.survivor_mask)
        cpu.insert([("DeptNew", "subOrganizationOf", "Univ0"),
                    ("StudentNew", "memberOf", "DeptNew")])


# --------------------------------------------------------------------- #
# the LM training path on the card against the CPU (tiny twins of
# chip_smoke.py's phase 7a), f32 with TF32 off
# --------------------------------------------------------------------- #
def _tiny_lm():
    from repro_torch.models import transformer as tr

    return tr.LMConfig(name="tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                       d_ff=128, vocab=101, head_dim=16, dtype=torch.float32)


@pytest.fixture
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.parametrize("microbatches", [1, 2])
def test_lm_train_step_on_card_matches_cpu(cuda_device, no_tf32, microbatches):
    """One step from the same parameters and batch: loss, grad norm and
    every parameter after the AdamW update within rtol 1e-4, atol 1e-6."""
    import copy

    from repro_torch.launch import train
    from repro_torch.models import steps
    from repro_torch.models import transformer as tr
    from repro_torch.optimizer import adamw

    cfg = _tiny_lm()
    cpu = tr.init_params(cfg, 0, device="cpu")
    card = copy.deepcopy(cpu).to(cuda_device)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (4, 32)).astype(np.int32)
    step = steps.make_train_step(lambda p, b: tr.loss_fn(cfg, p, b), train.OPT_CFG,
                                 microbatches=microbatches)
    out = []
    for model, dev in ((cpu, "cpu"), (card, cuda_device)):
        t = torch.as_tensor(toks, device=dev)
        out.append(step(model, adamw.init(list(model.parameters())),
                        {"tokens": t, "labels": t}))
    for key in ("loss", "grad_norm", "lr"):
        torch.testing.assert_close(out[1][key].cpu(), out[0][key], rtol=1e-4, atol=0)
    for p, q in zip(card.parameters(), cpu.parameters()):
        torch.testing.assert_close(p.detach().cpu(), q.detach(), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("window", [None, 8])
def test_lm_chunked_attention_on_card_matches_one_block(cuda_device, no_tf32, window):
    from repro_torch.models import transformer as tr

    rng = np.random.default_rng(1)
    q, k, v = (torch.as_tensor(rng.standard_normal(s, dtype=np.float32), device=cuda_device)
               for s in ((2, 40, 4, 16), (2, 40, 2, 16), (2, 40, 2, 16)))
    pos = torch.arange(40, dtype=torch.int32, device=cuda_device).expand(2, 40)
    one = tr.gqa_attention(q, k, v, pos, pos, window=window)
    chunked = tr.gqa_attention(q, k, v, pos, pos, window=window, chunk_q=4, chunk_k=8)
    torch.testing.assert_close(chunked, one, rtol=1e-4, atol=1e-6)
    cpu = tr.gqa_attention(q.cpu(), k.cpu(), v.cpu(), pos.cpu(), pos.cpu(), window=window)
    torch.testing.assert_close(one.cpu(), cpu, rtol=1e-4, atol=1e-6)


def test_lm_prefill_decode_on_card_matches_forward(cuda_device, no_tf32):
    from repro_torch.models import transformer as tr

    cfg = _tiny_lm()
    model = tr.init_params(cfg, 0, device=cuda_device)
    toks = torch.as_tensor(np.random.default_rng(2).integers(0, cfg.vocab, (2, 17)),
                           dtype=torch.int32, device=cuda_device)
    with torch.no_grad():
        hidden, _ = tr.forward(cfg, model, toks)
        want = tr.logits_of(cfg, model, hidden)[:, 16]
    _, cache = tr.prefill_step(cfg, model, toks[:, :16])
    got, _ = tr.decode_step(cfg, model, cache, toks[:, 16:])
    torch.testing.assert_close(got[:, 0], want, rtol=1e-3, atol=2e-4)


def test_lm_launch_train_on_card_resumes(cuda_device, tmp_path):
    from repro_torch.checkpoint import ckpt
    from repro_torch.launch import train

    args = ["--reduced", "--steps", "8", "--batch", "4", "--seq", "16",
            "--ckpt-every", "3", "--ckpt-dir", str(tmp_path)]
    first, second = train.main(args + ["--inject-failure-at", "5"])
    assert second.start == 3
    for s in (3, 4):
        np.testing.assert_allclose(second.losses[s], first.losses[s], rtol=1e-3)
    like = {"a": torch.zeros(2, device=cuda_device)}
    ckpt.save(str(tmp_path / "x"), 1, {"a": torch.ones(2, device=cuda_device)})
    restored, _ = ckpt.restore(str(tmp_path / "x"), like)
    assert restored["a"].device.type == "cuda" and bool(restored["a"].eq(1).all())


# --------------------------------------------------------------------- #
# the MoE LMs and the GNN family on the card against the CPU (tiny twins
# of chip_smoke.py's phases 8a and 9a), f32 with TF32 off
# --------------------------------------------------------------------- #
def _held_to_step(card, cpu, before, grads, lr, wd, eps):
    """Parameters after one AdamW step, card against CPU: rtol 1e-4, atol
    1e-6 where the gradient is zero or above 100 x eps; between the two,
    where AdamW's first step ``g / (|g| + eps)`` turns f32 rounding into up
    to ``lr``, within the step's bound ``lr (1 + wd |p|)``."""
    for (name, p), q, p0, g in zip(card.named_parameters(), cpu.parameters(), before, grads):
        p, q = p.detach().cpu(), q.detach()
        well = (g.abs() > 100 * eps) | (g == 0)
        torch.testing.assert_close(p[well], q[well], rtol=1e-4, atol=1e-6, msg=name)
        bound = lr * (1 + wd * p0[~well].abs()) * (1 + 1e-4)
        assert bool(((p[~well] - p0[~well]).abs() <= bound).all()), name


def _moe_cfg(arch):
    from repro_torch import configs

    cfg = configs.get(arch).reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=1.0))


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mixtral-8x7b"])
def test_moe_train_step_on_card_matches_cpu(cuda_device, no_tf32, arch):
    import copy

    from repro_torch.launch import train
    from repro_torch.models import steps
    from repro_torch.models import transformer as tr
    from repro_torch.optimizer import adamw

    cfg = _moe_cfg(arch)
    cpu = tr.init_params(cfg, 0, device="cpu")
    card = copy.deepcopy(cpu).to(cuda_device)
    before = [p.detach().clone() for p in cpu.parameters()]
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, (4, 32)),
                           dtype=torch.int32)
    grads = torch.autograd.grad(tr.loss_fn(cfg, cpu, {"tokens": toks, "labels": toks}),
                                list(cpu.parameters()))
    step = steps.make_train_step(lambda p, b: tr.loss_fn(cfg, p, b), train.OPT_CFG)
    out = []
    for model, dev in ((card, cuda_device), (cpu, "cpu")):
        t = toks.to(dev)
        out.append(step(model, adamw.init(list(model.parameters())),
                        {"tokens": t, "labels": t}))
    for key in ("loss", "grad_norm", "lr"):
        torch.testing.assert_close(out[0][key].cpu(), out[1][key], rtol=1e-4, atol=0)
    _held_to_step(card, cpu, before, grads, float(out[1]["lr"]),
                  train.OPT_CFG.weight_decay, train.OPT_CFG.eps)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mixtral-8x7b"])
def test_moe_dispatch_on_card_matches_cpu(cuda_device, no_tf32, arch):
    from repro_torch.models import transformer as tr

    cfg = _moe_cfg(arch)
    moe = tr.init_params(cfg, 1, device="cpu").layers[0].moe
    x = torch.as_tensor(np.random.default_rng(3).standard_normal((2, 64, cfg.d_model),
                                                                 dtype=np.float32))
    want = tr.route(cfg, moe.router, x.reshape(1, 128, -1))[1]
    got = tr.route(cfg, moe.router.to(cuda_device), x.reshape(1, 128, -1).to(cuda_device))[1]
    for f in ("expert", "token", "pos", "counts", "kept"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    assert not bool(want.kept.all())  # capacity 1.0 drops slots here
    y_cpu, aux_cpu = tr.moe_block(cfg, moe, x)
    y, aux = tr.moe_block(cfg, moe.to(cuda_device), x.to(cuda_device))
    torch.testing.assert_close(y.detach().cpu(), y_cpu.detach(), rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(aux.detach().cpu(), aux_cpu.detach(), rtol=1e-4, atol=0)


@pytest.mark.parametrize("arch_id", ["gatedgcn", "gat-cora", "pna", "schnet"])
@pytest.mark.parametrize("cell_name", ["full_graph_sm", "molecule"])
def test_gnn_step_on_card_matches_cpu(cuda_device, no_tf32, arch_id, cell_name):
    import copy

    from repro_torch import configs
    from repro_torch.configs import base
    from repro_torch.models import gnn
    from repro_torch.optimizer import adamw

    arch = base.GNNArch(arch_id, configs.get(arch_id).reduced())
    cell = arch.cells()[cell_name]
    cfg = arch.cell_cfg(cell)
    rng = np.random.default_rng(0)
    ex = cell.extras
    if cell_name == "molecule":
        g, per = ex["n_graphs"], 3
        n, e = g * per, g * 4
        base_ = np.repeat(np.arange(g) * per, 4)
        edges = np.stack([rng.integers(0, per, e) + base_, rng.integers(0, per, e) + base_], 1)
        feat = (rng.integers(1, 10, n).astype(np.int32) if arch_id == "schnet"
                else rng.standard_normal((n, ex["d_feat"]), dtype=np.float32))
        b = {"feat": feat, "labels": rng.standard_normal(g, dtype=np.float32),
             "node_graph": (np.arange(n) // per).astype(np.int32),
             "positions": rng.standard_normal((n, 3), dtype=np.float32)}
    else:
        n, e = 80, 300
        edges = rng.integers(0, n, (e, 2))
        b = {"feat": rng.standard_normal((n, ex["d_feat"]), dtype=np.float32),
             "labels": rng.integers(0, ex["n_out"], n).astype(np.int32),
             "node_graph": np.zeros(n, np.int32)}
    b.update(edges=edges.astype(np.int32), edge_mask=rng.random(e) > 0.1)
    b = {k: torch.as_tensor(v) for k, v in b.items()}
    cpu = gnn.init_params(cfg, 0, device="cpu")
    card = copy.deepcopy(cpu).to(cuda_device)
    before = [p.detach().clone() for p in cpu.parameters()]
    lb = dict(b, n_graphs=ex["n_graphs"])
    lb.setdefault("positions", torch.zeros((n, 3)))
    grads = torch.autograd.grad(gnn.loss_fn(cfg, cpu, lb), list(cpu.parameters()))
    out = []
    for model, dev in ((card, cuda_device), (cpu, "cpu")):
        state = {"params": model, "opt": adamw.init(list(model.parameters()))}
        out.append(arch.step(cell)(state, {k: v.to(dev) for k, v in b.items()})[1])
    for key in ("loss", "grad_norm", "lr"):
        torch.testing.assert_close(out[0][key].cpu(), out[1][key], rtol=1e-4, atol=0)
    _held_to_step(card, cpu, before, grads, float(out[1]["lr"]), arch.opt.weight_decay,
                  arch.opt.eps)


def _rec_case(seed=0, b=64):
    from repro_torch import configs
    from repro_torch.data import pipeline

    cfg = configs.get("dcn-v2").reduced()
    batch = next(pipeline.recsys_batches(batch=b, n_dense=cfg.n_dense,
                                         vocab_sizes=cfg.vocab_sizes, seed=seed,
                                         shard=pipeline.ShardSpec(0, 1)))
    return cfg, {k: torch.as_tensor(v) for k, v in batch.items()}


@pytest.mark.parametrize("microbatches", [1, 2])
def test_recsys_step_on_card_matches_cpu(cuda_device, no_tf32, microbatches):
    """dcn-v2 ``reduced()``: forward, loss and one ``RecsysArch.step`` on
    the card against the CPU from the same parameters and batch."""
    import copy

    from repro_torch.configs import base
    from repro_torch.models import recsys
    from repro_torch.optimizer import adamw

    cfg, b = _rec_case()
    arch = base.RecsysArch(cfg)
    cell = dataclasses.replace(arch.cells()["train_batch"], batch=64,
                               microbatches=microbatches)
    cpu = recsys.init_params(cfg, 0, device="cpu")
    card = copy.deepcopy(cpu).to(cuda_device)
    bc = {k: v.to(cuda_device) for k, v in b.items()}
    torch.testing.assert_close(recsys.forward(cfg, card, bc).detach().cpu(),
                               recsys.forward(cfg, cpu, b).detach(), rtol=1e-4, atol=1e-6)
    before = [p.detach().clone() for p in cpu.parameters()]
    grads = torch.autograd.grad(recsys.loss_fn(cfg, cpu, b), list(cpu.parameters()))
    out = []
    for model, batch in ((card, bc), (cpu, b)):
        state = {"params": model, "opt": adamw.init(list(model.parameters()))}
        out.append(arch.step(cell)(state, batch)[1])
    for key in ("loss", "grad_norm", "lr"):
        torch.testing.assert_close(out[0][key].cpu(), out[1][key], rtol=1e-4, atol=0)
    _held_to_step(card, cpu, before, grads, float(out[1]["lr"]), arch.opt.weight_decay,
                  arch.opt.eps)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_recsys_embedding_bag_and_retrieval_on_card_match_cpu(cuda_device, no_tf32, mode):
    from repro_torch.models import recsys

    cfg, b = _rec_case()
    model = recsys.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(1)
    vals = torch.as_tensor(rng.integers(0, cfg.total_vocab, 300), dtype=torch.int32)
    segs = torch.as_tensor(np.sort(rng.integers(0, 40, 300)), dtype=torch.int32)
    t = model.table.detach()
    torch.testing.assert_close(
        recsys.embedding_bag(t.to(cuda_device), vals.to(cuda_device), segs.to(cuda_device),
                             50, mode=mode).cpu(),
        recsys.embedding_bag(t, vals, segs, 50, mode=mode), rtol=1e-5, atol=1e-6)
    cands = torch.as_tensor(rng.standard_normal((2000, cfg.mlp[-1]), dtype=np.float32))
    q = {k: v[:2] for k, v in b.items() if k != "labels"}
    with torch.no_grad():
        s_cpu, _ = recsys.retrieval_score(cfg, model, {**q, "candidates": cands})
        card = model.to(cuda_device)
        s, top = recsys.retrieval_score(cfg, card, {**{k: v.to(cuda_device) for k, v in q.items()},
                                                    "candidates": cands.to(cuda_device)})
    torch.testing.assert_close(s.cpu(), s_cpu, rtol=1e-4, atol=1e-6)
    want = torch.topk(s.cpu(), 100).values
    torch.testing.assert_close(torch.sort(torch.gather(s.cpu(), 1, top.cpu())).values,
                               torch.sort(want).values, rtol=0, atol=0)


def test_recsys_sharded_step_on_host_mesh_is_bit_equal(cuda_device):
    """The 1x1 mesh over the card: the state placed by ``state_shardings``
    takes one step under the rules equal bit for bit to the plain step,
    and holds the bytes the dry-run's accounting gives."""
    import copy

    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import base
    from repro_torch.distributed import shard as sh
    from repro_torch.distributed.ctx import logical_axis_rules
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import recsys
    from repro_torch.optimizer import adamw

    cfg, b = _rec_case()
    arch = base.RecsysArch(cfg)
    cell = dataclasses.replace(arch.cells()["train_batch"], batch=64, microbatches=2)
    plain = recsys.init_params(cfg, 0, device=cuda_device)
    state = {"params": plain, "opt": adamw.init(list(plain.parameters()))}
    batch = {k: v.to(cuda_device) for k, v in b.items()}
    try:
        mesh = mesh_mod.make_host_mesh()
        shs = arch.state_shardings(mesh, cell)

        def place(t, ns):
            return distribute_tensor(t.detach().clone(), mesh, ns.placements)

        model = copy.deepcopy(plain)
        placed = sh.place({"params": model, "opt": adamw.init(list(model.parameters()))},
                          shs, place)
        held = sum(t.to_local().untyped_storage().nbytes()
                   for _, t in sh.leaves_with_path(placed) if isinstance(t, DTensor))
        assert held == dryrun.shard_bytes(arch.abstract_state(cell), shs)
        pb = sh.place(batch, arch.input_shardings(mesh, cell), place)
        _, m = arch.step(cell)(state, batch)
        with logical_axis_rules(mesh), implicit_replication():
            _, ms = arch.step(cell)(placed, pb)
        assert torch.equal(ms["loss"].full_tensor() if isinstance(ms["loss"], DTensor)
                           else ms["loss"], m["loss"])
        for p, q in zip(model.parameters(), plain.parameters()):
            assert torch.equal(p.full_tensor(), q)
    finally:
        mesh_mod.release()


@pytest.mark.parametrize("arch_id,batch", [("internlm2-1.8b", 4), ("mixtral-8x7b", 1)])
def test_lm_sharded_serving_on_card_matches_plain(cuda_device, no_tf32, arch_id, batch):
    """The serving steps on the 1x1 mesh over the card: the ``reduced()``
    f32 parameters placed by ``state_shardings``, prefill ``batch`` x 16
    (mixtral's 8-position window full) and three decode steps under the
    rules, equal to the plain steps on the card within rtol 1e-5 (atol 1e-5
    times the largest magnitude), ``pos`` exactly, the cache and ``pos``
    in ``lm_cache_spec``'s placements after every step, on the card."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import configs
    from repro_torch.configs import base
    from repro_torch.distributed import shard as sh
    from repro_torch.distributed.ctx import logical_axis_rules
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import transformer as tr

    cfg = configs.get(arch_id).reduced()
    arch = base.LMArch(cfg)
    seq, steps = 16, 3
    cells = ([base.Cell("prefill", "prefill", batch=batch, seq=seq)]
             + [base.Cell("decode", "decode", batch=batch, seq=seq)] * steps)
    rng = np.random.default_rng(0)
    toks = [torch.as_tensor(rng.integers(0, cfg.vocab, (batch, seq if i == 0 else 1),
                                         dtype=np.int32), device=cuda_device)
            for i in range(len(cells))]

    def run(params, place=None):
        out, cache = [], None
        for cell, t in zip(cells, toks):
            if place is not None:
                t = place(t, arch.input_shardings(mesh, cell)["tokens"])
            logits, cache = (tr.prefill_step(cfg, params, t) if cell.kind == "prefill"
                             else tr.decode_step(cfg, params, cache, t))
            out.append((logits, cache))
        return out

    def full(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    try:
        mesh = mesh_mod.make_host_mesh()
        want = run(tr.init_params(cfg, 0, device=cuda_device))
        s_cache = min(seq, cfg.sliding_window or seq)
        specs = sh.lm_cache_spec(mesh, cfg, batch, s_cache)
        kv = (cfg.n_layers, batch, s_cache, cfg.n_kv_heads, cfg.head_dim)
        want_pl = {k: sh.named(mesh, (batch,) if k == "pos" else kv, specs[k]).placements
                   for k in ("k", "v", "pos")}

        def place(t, ns):
            return distribute_tensor(t, mesh, ns.placements)

        params = sh.place(tr.init_params(cfg, 0, device=cuda_device),
                          arch.state_shardings(mesh, cells[1])["params"], place)
        with logical_axis_rules(mesh), implicit_replication():
            got = run(params, place)
        for i, ((gl, gc), (wl, wc)) in enumerate(zip(got, want)):
            assert {k: gc[k].placements for k in want_pl} == want_pl, i
            assert gc["k"].to_local().device.type == "cuda"
            assert torch.equal(full(gc["pos"]), wc["pos"])
            for a, b in ((gl, wl), (gc["k"], wc["k"]), (gc["v"], wc["v"])):
                torch.testing.assert_close(full(a), b, rtol=1e-5,
                                           atol=1e-5 * float(b.abs().max()))
    finally:
        mesh_mod.release()


def test_roofline_probe_on_card(cuda_device, tmp_path):
    """The machine probe's ``--fast`` sweep on the card: finite, positive
    rates, the card's own name and count, the fused rate and the launch
    K2's fit (launch not negative, every row's residual printed), the
    packed rate its step's fit, no collective rate on one card, the kernel
    launched, and a spec that saves and loads back equal."""
    import math

    from repro_torch.engine import machine
    from repro_torch.launch import roofline

    kernels.reset_launches()
    spec, detail = roofline.probe(fast=True)
    assert kernels.launch_counts().get("bitmm_apply_packed", 0) > 0
    assert spec.backend == "cuda"
    assert spec.device_kind == torch.cuda.get_device_name(0)
    assert spec.n_devices == torch.cuda.device_count()
    for name in ("stream_bytes_per_s", "dense_elems_per_s", "packed_words_per_s",
                 "packed_words_per_s_xla", "fused_words_per_s", "dispatch_s"):
        value = getattr(spec, name)
        assert math.isfinite(value) and value > 0, name
    assert math.isfinite(spec.trace_s) and spec.trace_s >= 0
    fused, packed = detail["bitop"]["shipping"], detail["bitop"]["packed"]
    assert math.isfinite(spec.kernel_launch_s) and spec.kernel_launch_s >= 0
    assert spec.kernel_launch_s == fused["launch_s"] >= 0
    assert spec.fused_words_per_s == fused["words_per_s"]
    assert spec.packed_words_per_s == packed["words_per_s"] and packed["launch_s"] >= 0
    for key, fit in (("K2", fused), ("packed step", packed)):
        for r in fit["rows"]:
            print(f"{key} n={r['n']} V={r['v']} density={r['density']} "
                  f"work={r['work']}: {r['seconds'] * 1e3:.4f} ms, fit "
                  f"{r['fit_seconds'] * 1e3:.4f} ms, residual "
                  f"{(r['seconds'] - r['fit_seconds']) * 1e3:+.4f} ms")
    assert (spec.collective_bytes_per_s is None) == (torch.cuda.device_count() < 2)
    path = machine.save_spec(spec, str(tmp_path / "spec.json"))
    assert machine.load_spec(path) == spec
