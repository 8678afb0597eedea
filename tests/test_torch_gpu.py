"""Card-only tests of the port (marker ``gpu``): the CUDA kernels (the
segmented OR, the two packed boolean products and the segment sum) against
their plain PyTorch versions, the query path on the card against the same
path on the CPU, and a two-replica ``AsyncServer`` on the card.  A CUDA
kernel has no CPU mode, so without a card
these skip.  The file imports neither JAX nor the JAX package, so it runs
where JAX is not installed:

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


def _operands(device, v, n, e, seed, block_e=256, block_n=256, dst=None):
    rng = np.random.default_rng(seed)
    frontier = rng.random((v, n)) < 0.4
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


@pytest.mark.parametrize("v", [1, 7, 48, 128])
def test_cuda_kernel_matches_plain_version(cuda_device, v):
    kernels.reset_launches()
    args = _operands(cuda_device, v=v, n=1000, e=20_000, seed=v)
    out = kernel.segor_blocks(*args, num_segments=1000)
    torch.cuda.synchronize()
    assert torch.equal(out, ref.segor_blocks_ref(*args, num_segments=1000))
    assert kernels.LAUNCHES["segor_blocks"] == 1


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


@pytest.mark.parametrize("n", [1, 31, 33, 100, 1000, 4099])
@pytest.mark.parametrize("v", [1, 5, 48, 64])
def test_bitmm_kernels_match_plain_versions(cuda_device, v, n):
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
    chi_p, a_p, _ = _bitmm_case(cuda_device, 1761, 64, seed=3)
    flags = torch.zeros((1761, 1761), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        bitmm_kernel.bitmm_apply(chi_p, a_p, flags)


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
