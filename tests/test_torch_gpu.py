"""Card-only tests of the port (marker ``gpu``): the CUDA kernels against
their plain PyTorch versions, and the query path on the card against the
same path on the CPU.  A CUDA kernel has no CPU mode, so without a card
these skip.  The file imports neither JAX nor the JAX package, so it runs
where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import bitops, sparql
from repro_torch.data import synth
from repro_torch.db import GraphDB
from repro_torch.kernels.segsum import kernel, ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the segor kernel has no CPU mode")
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
