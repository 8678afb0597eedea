"""The segmented OR: the port's blocked layout is byte-identical to the JAX
package's, and its plain version (what the kernel wrapper runs on the CPU)
equals the interpret-mode Pallas ``segor_blocks`` after ``_edge_bits``, on
the cases of the reference's own kernel tests.  The CUDA kernel itself is
held against the plain version on the card in ``test_torch_gpu.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dualsim as ref_dualsim
from repro.kernels.segsum import kernel as ref_kernel
from repro_torch import kernels
from repro_torch.core import bitops
from repro_torch.kernels.segsum import kernel, ref


def _case(seed, v, e, n, density=0.4):
    rng = np.random.default_rng(seed)
    frontier = rng.random((v, n)) < density
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    return frontier, src, dst


def _truth(frontier, src, dst, n):
    y = np.zeros((frontier.shape[0], n), bool)
    for s, t in zip(src, dst):
        y[:, t] |= frontier[:, s]
    return y


def _both(frontier, src, dst, n, block_e=256, block_n=256):
    """(reference words, port words as uint32) on one blocked layout."""
    idx_b, seg_b, win, _ = ref_kernel.prepare_segor(
        dst, n, block_e=block_e, block_n=block_n
    )
    src_b = src[idx_b] if len(src) else np.zeros(idx_b.shape, np.int32)
    f_u32 = bitops.pack_np(frontier)
    bits = ref_dualsim._edge_bits(jnp.asarray(f_u32), jnp.asarray(src_b))
    want = ref_kernel.segor_blocks(
        bits.transpose(1, 2, 0), jnp.asarray(seg_b), jnp.asarray(win),
        num_segments=n, block_n=block_n, interpret=True,
    )
    got = kernel.segor_blocks(
        bitops.to_words(f_u32, "cpu"), torch.from_numpy(src_b),
        torch.from_numpy(seg_b), torch.from_numpy(win),
        num_segments=n, block_n=block_n,
    )
    return np.asarray(want), bitops.words_np(got)


@pytest.mark.parametrize("n", [1, 33, 257, 1000])
@pytest.mark.parametrize("v", [1, 9])
def test_plain_segor_matches_pallas_shape_sweep(n, v):
    frontier, src, dst = _case(n * 100 + v, v, 4 * n, n)
    want, got = _both(frontier, src, dst, n)
    assert np.array_equal(got, want)
    assert np.array_equal(bitops.unpack_np(got, n), _truth(frontier, src, dst, n))
    if n % 32:  # trailing pad bits never turn on
        assert not (got[:, -1] & (np.uint32(0xFFFFFFFF) << np.uint32(n % 32))).any()


def test_plain_segor_empty_edges():
    frontier = np.ones((3, 70), bool)
    want, got = _both(frontier, np.zeros(0, np.int32), np.zeros(0, np.int32), 70)
    assert got.shape == (3, 3) and not got.any()
    assert np.array_equal(got, want)


def test_plain_segor_duplicate_destinations():
    n, e = 40, 200
    frontier = np.ones((2, n), bool)
    src = np.arange(e, dtype=np.int32) % n
    want, got = _both(frontier, src, np.full(e, 7, np.int32), n)
    assert np.array_equal(got, want)
    assert np.array_equal(bitops.unpack_np(got, n)[:, 7], [True, True])
    assert bitops.unpack_np(got, n).sum() == 2


def test_plain_segor_window_boundary_ids():
    n, bn = 600, 256
    dst = np.asarray([0, 255, 256, 257, 511, 512, 599] * 10, np.int32)
    src = (np.arange(len(dst), dtype=np.int32) * 37) % n
    frontier = (np.arange(2 * n).reshape(2, n) % 3 == 0)
    want, got = _both(frontier, src, dst, n, block_n=bn)
    assert np.array_equal(got, want)


def test_plain_segor_windows_revisited_by_many_blocks():
    """block_e below the per-window edge count: several blocks OR into one
    window (the case the CUDA kernel merges with global atomics)."""
    frontier, src, dst = _case(11, 4, 900, 50, density=0.2)
    want, got = _both(frontier, src, dst, 50, block_e=64, block_n=32)
    assert np.array_equal(got, want)
    assert np.array_equal(bitops.unpack_np(got, 50), _truth(frontier, src, dst, 50))


def test_segor_words_matches_truth():
    frontier, src, dst = _case(5, 3, 300, 77)
    f = bitops.to_words(bitops.pack_np(frontier), "cpu")
    pad_src = np.concatenate([src, np.zeros(20, np.int32)])
    pad_dst = np.concatenate([dst, np.full(20, 77, np.int32)])  # flat pad id n
    msgs = ref.edge_bits(f, torch.from_numpy(pad_src))
    got = ref.segor_words(msgs, torch.from_numpy(pad_dst), 77)
    assert np.array_equal(bitops.unpack_np(got.numpy(), 77),
                          _truth(frontier, src, dst, 77))


# --------------------------------------------------------------------- #
# host layout: byte-identical to the reference's loop
# --------------------------------------------------------------------- #
def _layout_cases():
    rng = np.random.default_rng(123)
    cases = [
        (np.zeros(0, np.int32), 1, 256, 256, 0),
        (np.zeros(0, np.int32), 70, 256, 256, 0),
        (np.zeros(0, np.int32), 600, 64, 32, 13),
        (np.asarray([0, 255, 256, 257, 511, 512, 599] * 50, np.int32), 600,
         256, 256, 0),
        (np.full(1000, 31, np.int32), 33, 256, 32, 0),
    ]
    for _ in range(20):
        n = int(rng.integers(1, 3000))
        e = int(rng.integers(0, 5000))
        ids = rng.integers(0, n, e).astype(np.int32)
        cases.append((ids, n, int(rng.choice([32, 64, 256])),
                      int(rng.choice([32, 64, 256])), int(rng.integers(0, 60))))
    return cases


@pytest.mark.parametrize("case", range(len(_layout_cases())))
def test_prepare_segor_byte_identical(case):
    ids, n, block_e, block_n, min_g = _layout_cases()[case]
    want = ref_kernel.prepare_segor(ids, n, block_e=block_e, block_n=block_n,
                                    min_g=min_g)
    got = kernel.prepare_segor(ids, n, block_e=block_e, block_n=block_n,
                               min_g=min_g)
    assert got[3] == want[3]
    for x, y in zip(got[:3], want[:3]):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def test_prepare_segor_rejects_out_of_range_ids():
    with pytest.raises(ValueError, match="seg_ids"):
        kernel.prepare_segor(np.asarray([0, 5, 8], np.int32), 8)
    with pytest.raises(ValueError, match="seg_ids"):
        kernel.prepare_segor(np.asarray([-1, 5], np.int32), 8)


# --------------------------------------------------------------------- #
# the wrapper
# --------------------------------------------------------------------- #
def _operands(device, v=3, n=100, e=400, seed=0):
    frontier, src, dst = _case(seed, v, e, n)
    idx_b, seg_b, win, _ = kernel.prepare_segor(dst, n)
    as_t = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    return (bitops.to_words(bitops.pack_np(frontier), device),
            as_t(src[idx_b]), as_t(seg_b), as_t(win))


def test_wrapper_takes_plain_version_on_cpu_and_counts_nothing():
    kernels.reset_launches()
    args = _operands("cpu")
    out = kernel.segor_blocks(*args, num_segments=100)
    assert torch.equal(out, ref.segor_blocks_ref(*args, num_segments=100))
    assert kernels.LAUNCHES.get("segor_blocks", 0) == 0


def test_wrapper_checks_its_inputs():
    f, s, d, w = _operands("cpu")
    with pytest.raises(TypeError):
        kernel.segor_blocks(f, s.long(), d, w, num_segments=100)
    with pytest.raises(ValueError, match="frontier"):
        kernel.segor_blocks(f, s, d, w, num_segments=200)
    with pytest.raises(ValueError, match="seg_win"):
        kernel.segor_blocks(f, s, d, w[:-1], num_segments=100)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.segor_blocks(f, s.t(), d.t(), w, num_segments=100)


# --------------------------------------------------------------------- #
# the build: libraries are named by their source's hash
# --------------------------------------------------------------------- #
def test_build_names_libraries_by_source_hash(tmp_path, monkeypatch):
    from repro_torch.kernels import _build

    src = tmp_path / "k.cu"
    src.write_text("// v1\n")
    monkeypatch.setitem(_build.SOURCES, "k", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    first = _build.library_path("k")
    assert first.parent == tmp_path / "build" and first.name.startswith("k-")
    src.write_text("// v2\n")
    assert _build.library_path("k") != first  # an edited source builds anew
    # an existing library is loaded as it is: no compiler is needed
    (tmp_path / "build").mkdir()
    _build.library_path("k").touch()
    assert _build.build(["k"]) == {"k": 0.0}


def test_every_kernel_source_is_in_the_package():
    from repro_torch.kernels import _build

    for name, path in _build.SOURCES.items():
        assert path.is_file(), name
        assert _build.PACKAGE in path.parents
