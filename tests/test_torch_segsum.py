"""The port's public segment ops against the JAX package's: ``ops.segsum``
on the CPU (the wrapper's plain version over the sorted layout) equals the
interpret-mode Pallas ``segsum`` on every case of the reference's kernel
tests, and ``ops.segor`` equals the interpret-mode Pallas ``segor`` bit for
bit.  The CUDA kernels are held against the plain versions on the card in
``test_torch_gpu.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segsum import ops as ref_ops
from repro.kernels.segsum import ref as ref_ref
from repro_torch import kernels
from repro_torch.core import bitops
from repro_torch.kernels.segsum import kernel, ops, ref

TOL = 1e-5  # the reference's kernel tests: f32 sums in another order


def _segsum(vals, ids, n, **kw):
    return ops.segsum(vals, ids, n, device="cpu", **kw).numpy()


@pytest.mark.parametrize("e,n,d", [(100, 64, 8), (1000, 300, 16),
                                   (37, 513, 3), (5000, 100, 70),
                                   (2000, 400, 128)])
def test_segsum_shape_sweep_matches_pallas(e, n, d):
    rng = np.random.default_rng(e + n + d)
    vals = rng.normal(size=(e, d)).astype(np.float32)
    ids = rng.integers(0, n, e).astype(np.int32)
    want = ref_ops.segsum(vals, ids, n, interpret=True)
    got = _segsum(vals, ids, n)
    assert got.shape == (n, d) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)
    exact = ref_ref.segsum_ref(jnp.asarray(vals[np.argsort(ids, kind="stable")]),
                               jnp.asarray(np.sort(ids)), n)
    np.testing.assert_allclose(got, np.asarray(exact), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_segsum_dtypes_match_pallas(dtype):
    rng = np.random.default_rng(9)
    vals = rng.normal(size=(200, 5)).astype(dtype)
    ids = rng.integers(0, 40, 200).astype(np.int32)
    got = _segsum(vals, ids, 40)
    assert got.dtype == dtype
    np.testing.assert_allclose(
        got, np.asarray(ref_ops.segsum(vals, ids, 40, interpret=True)),
        rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        got, np.asarray(ref_ops.segsum(vals, ids, 40, use_ref=True)),
        rtol=TOL, atol=TOL)


def test_segsum_empty_and_single_segment():
    out = _segsum(np.zeros((0, 4), np.float32), np.zeros(0, np.int32), 8)
    want = ref_ops.segsum(np.zeros((0, 4), np.float32), np.zeros(0, np.int32),
                          8, interpret=True)
    assert out.shape == (8, 4) == want.shape and not out.any()
    vals = np.ones((16, 4), np.float32)
    out = _segsum(vals, np.zeros(16, np.int32), 1)
    np.testing.assert_allclose(out, [[16.0] * 4])
    np.testing.assert_allclose(
        out, np.asarray(ref_ops.segsum(vals, np.zeros(16, np.int32), 1,
                                       interpret=True)))


def test_segsum_block_boundary_ids_match_pallas():
    n, bn = 600, 256
    ids = np.asarray([0, 255, 256, 257, 511, 512, 599] * 10, np.int32)
    vals = np.ones((len(ids), 2), np.float32)
    want = ref_ops.segsum(vals, ids, n, block_n=bn, interpret=True)
    np.testing.assert_allclose(_segsum(vals, ids, n, block_n=bn), np.asarray(want))


def test_segsum_ids_outside_belong_to_no_segment():
    """Ids past the last segment are dropped, as the reference's blocked
    layout drops them; negative ids are dropped too."""
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 120, 600).astype(np.int32)
    vals = rng.normal(size=(600, 3)).astype(np.float32)
    want = ref_ops.segsum(vals, ids, 100, interpret=True)
    np.testing.assert_allclose(_segsum(vals, ids, 100), np.asarray(want),
                               rtol=TOL, atol=TOL)
    ids[::7] = -3
    keep = ids >= 0
    want = ref_ops.segsum(vals[keep], ids[keep], 100, interpret=True)
    np.testing.assert_allclose(_segsum(vals, ids, 100), np.asarray(want),
                               rtol=TOL, atol=TOL)


def test_segsum_no_segments_and_no_columns():
    assert _segsum(np.ones((5, 3), np.float32), np.zeros(5, np.int32), 0).shape == (0, 3)
    assert _segsum(np.ones((5, 0), np.float64), np.zeros(5, np.int32), 4).shape == (4, 0)


@pytest.mark.parametrize("dtype", [np.float16, np.int32, np.int64])
def test_segsum_rejects_other_dtypes(dtype):
    with pytest.raises(TypeError):
        ops.segsum(np.ones((4, 2), dtype), np.zeros(4, np.int32), 2, device="cpu")
    with pytest.raises(TypeError):
        kernel.segsum_csr(torch.ones((4, 2), dtype=torch.float16),
                          torch.tensor([0, 4], dtype=torch.int32))


def test_prepare_csr_sorts_stably_and_points_rows():
    ids = np.asarray([3, 1, 3, 0, 7, 1, -1, 3], np.int32)
    order, row_ptr = kernel.prepare_csr(ids, 5)
    assert order.tolist() == [3, 1, 5, 0, 2, 7]  # id 7 and -1: no segment
    assert row_ptr.tolist() == [0, 1, 3, 3, 6, 6]
    assert row_ptr.dtype == np.int32


def test_segsum_plain_version_is_the_wrappers_cpu_path():
    """On the CPU the wrapper runs the plain version (no launch counted),
    and the plain version over the sorted layout equals index_add_ over the
    unsorted rows."""
    rng = np.random.default_rng(5)
    vals = rng.normal(size=(300, 6)).astype(np.float32)
    ids = rng.integers(0, 50, 300).astype(np.int32)
    order, row_ptr = kernel.prepare_csr(ids, 50)
    vals_s, rp = torch.from_numpy(vals[order]), torch.from_numpy(row_ptr)
    kernels.reset_launches()
    got = kernel.segsum_csr(vals_s, rp)
    assert kernels.launch_counts().get("segsum", 0) == 0
    assert torch.equal(got, ref.segsum_csr_ref(vals_s, rp))
    want = ref.segsum_ref(torch.from_numpy(vals), torch.from_numpy(ids), 50)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    with pytest.raises(ValueError):
        kernel.segsum_csr(vals_s[:, :1].t(), rp)  # [1, E] is not contiguous
    with pytest.raises(TypeError):
        kernel.segsum_csr(vals_s, rp.long())


def test_segsum_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="cuda"):
        ops.segsum(np.ones((2, 2), np.float32), np.zeros(2, np.int32), 1)


# --------------------------------------------------------------------- #
# segor
# --------------------------------------------------------------------- #
def _segor_case(seed, v, e, n, density=0.4):
    rng = np.random.default_rng(seed)
    bits = (rng.random((v, e)) < density).astype(np.int8)
    ids = rng.integers(0, n, e).astype(np.int32) if e else np.zeros(0, np.int32)
    return bits, ids


def _segor_both(bits, ids, n, **kw):
    want = np.asarray(ref_ops.segor(bits, ids, n, impl="kernel",
                                    interpret=True, **kw))
    got = bitops.words_np(ops.segor(bits, ids, n, device="cpu", **kw))
    return want, got


@pytest.mark.parametrize("n", [1, 32, 33, 300, 1000])
@pytest.mark.parametrize("v", [1, 9])
def test_segor_matches_pallas_bit_for_bit(n, v):
    bits, ids = _segor_case(n * 100 + v, v, 4 * n, n)
    want, got = _segor_both(bits, ids, n)
    assert got.dtype == np.uint32 and np.array_equal(got, want)
    if n % 32:  # trailing pad bits never turn on
        assert not (got[:, -1] >> np.uint32(n % 32)).any()


def test_segor_empty_edges_and_duplicates():
    want, got = _segor_both(np.zeros((3, 0), np.int8), np.zeros(0, np.int32), 70)
    assert got.shape == (3, 3) and np.array_equal(got, want) and not got.any()
    want, got = _segor_both(np.ones((2, 200), np.int8), np.full(200, 7, np.int32), 40)
    assert np.array_equal(got, want)


def test_segor_block_boundaries_and_small_blocks():
    ids = np.asarray([0, 255, 256, 257, 511, 512, 599] * 10, np.int32)
    bits = (np.arange(2 * len(ids)).reshape(2, -1) % 3 == 0).astype(np.int8)
    want, got = _segor_both(bits, ids, 600, block_n=256)
    assert np.array_equal(got, want)
    bits, ids = _segor_case(11, 4, 900, 50, density=0.2)
    want, got = _segor_both(bits, ids, 50, block_e=64, block_n=32)
    assert np.array_equal(got, want)


# --------------------------------------------------------------------- #
# the source-major copy of a packed frontier (segor's first kernel)
# --------------------------------------------------------------------- #
def _frontier(v, n, seed, dirty_pads=False):
    f = bitops.pack_np(np.random.default_rng(seed).random((v, n)) < 0.5)
    if dirty_pads and n % 32:
        f[:, -1] |= np.uint32(0xFFFFFFFF) << np.uint32(n % 32)
    return f


@pytest.mark.parametrize("n", [1, 31, 32, 1000])
@pytest.mark.parametrize("v", [1, 32, 33, 100])
def test_source_major_is_a_bit_transposition(v, n):
    """Equal to a numpy transposition of the unpacked bits, its own inverse
    up to row padding, and zero in every bit of a variable past V or a
    source past n, even where the frontier's pad bits are set."""
    f = _frontier(v, n, seed=v * 1000 + n, dirty_pads=True)
    t = ref.source_major_ref(torch.from_numpy(f.view(np.int32)), n)
    nw, vw = -(-n // 32), -(-v // 32)
    assert t.shape == (32 * nw, vw) and t.dtype == torch.int32
    bits = bitops.unpack_np(f, n)  # [V, n], pad bits dropped
    want = np.zeros((32 * nw, 32 * vw), bool)
    want[:n, :v] = bits.T
    assert np.array_equal(bitops.unpack_np(bitops.words_np(t), 32 * vw), want)
    back = ref.source_major_ref(t, v)
    assert back.shape == (32 * vw, nw)
    assert np.array_equal(bitops.words_np(back[:v]), bitops.pack_np(bits))
    assert not back[v:].any()


def test_source_major_wrapper_runs_the_plain_version_on_the_cpu():
    f = torch.from_numpy(_frontier(9, 77, seed=1).view(np.int32))
    kernels.reset_launches()
    assert torch.equal(kernel.source_major(f, 77), ref.source_major_ref(f, 77))
    assert kernels.launch_counts().get("segor_transpose", 0) == 0
    assert kernel.source_major(f[:, :0], 0).shape == (0, 1)
    with pytest.raises(ValueError, match="frontier must be"):
        kernel.source_major(f, 100)
    with pytest.raises(TypeError):
        kernel.source_major(f.long(), 77)
