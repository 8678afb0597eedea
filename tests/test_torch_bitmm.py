"""The plain versions of the packed boolean products against the JAX
package's Pallas kernels (interpret mode), its jnp oracles and a boolean
ground truth, and the kernels' wrappers on the CPU.  Words compare as
``uint32`` views; no tolerance anywhere: the products are exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bitmm import kernel as kmod
from repro.kernels.bitmm import ops as kops
from repro.kernels.bitmm import ref as kref
from repro_torch import kernels
from repro_torch.core import bitops
from repro_torch.kernels import _build
from repro_torch.kernels.bitmm import kernel, ref

CHUNKS = [None, 1, 7, 32]  # rows per chunk of the plain versions' planes


@pytest.fixture
def rows_per_chunk(monkeypatch):
    """Set the plain versions' plane so that it holds ``rows`` rows of a
    ``[V, rows, nw]`` plane (``None``: the default plane)."""
    default = ref.PLANE_WORDS

    def set_rows(rows, v, nw):
        words = default if rows is None else rows * v * nw
        monkeypatch.setattr(ref, "PLANE_WORDS", words)

    return set_rows


def _words(x) -> torch.Tensor:
    return bitops.to_words(np.asarray(x), "cpu")


def _u32(t: torch.Tensor) -> np.ndarray:
    return bitops.words_np(t)


def _fused_case(seed, n, v, density=0.1, flag_density=0.5):
    rng = np.random.default_rng(seed)
    a = rng.random((n, n)) < density
    chi = rng.random((v, n)) < 0.6
    flags = (rng.random((v, v)) < flag_density).astype(np.uint32)
    return chi, a, flags


def _fused_truth(chi, a, flags):
    v, n = chi.shape
    y = np.zeros((v, n), bool)
    for q in range(v):
        if chi[q].any():
            y[q] = a[chi[q]].any(axis=0)
    new = chi.copy()
    for l in range(v):
        for r in range(v):
            if flags[l, r]:
                new[l] &= y[r]
    return new


def _plain_apply(chi, a, flags):
    """The port's plain step: (words, changed)."""
    return ref.bitmm_apply_ref(
        _words(bitops.pack_np(chi)), _words(bitops.pack_np(a)),
        torch.as_tensor(flags.astype(np.int32)),
    )


def _pallas_apply(chi, a, flags):
    """The interpret-mode Pallas kernel: (uint32 words, changed word)."""
    want, ch = kmod.bitmm_apply_packed(
        jnp.asarray(bitops.pack_np(chi)), jnp.asarray(bitops.pack_np(a)),
        jnp.asarray(flags), interpret=True,
    )
    return np.asarray(want), int(ch)


def _apply_both(chi, a, flags):
    """(port words, port changed, pallas words, pallas changed)."""
    return (*_plain_apply(chi, a, flags), *_pallas_apply(chi, a, flags))


# --------------------------------------------------------------------- #
# K2: bitmm_apply_packed
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("n", [1, 31, 33, 100, 257, 520])
@pytest.mark.parametrize("v", [1, 5, 9])
def test_plain_apply_matches_pallas_shape_sweep(n, v, rows_per_chunk):
    """Words and the changed word equal the interpret-mode Pallas kernel's
    (and the jnp oracles' and the boolean truth) at every chunk size."""
    chi, a, flags = _fused_case(n * 100 + v, n, v)
    cp, ap, fj = (jnp.asarray(bitops.pack_np(chi)),
                  jnp.asarray(bitops.pack_np(a)), jnp.asarray(flags))
    out_r, ch_r = kref.bitmm_apply_ref(cp, ap, fj, n)
    out_w, ch_w = kref.bitmm_apply_words(cp, ap, fj)
    truth = _fused_truth(chi, a, flags)
    moved = bool((truth != chi).any())
    want, ch_k = _pallas_apply(chi, a, flags)
    for chunk in CHUNKS:
        rows_per_chunk(chunk, v, bitops.packed_width(n))
        got, ch = _plain_apply(chi, a, flags)
        assert np.array_equal(_u32(got), want), chunk
        assert np.array_equal(_u32(got), np.asarray(out_r))
        assert np.array_equal(_u32(got), np.asarray(out_w))
        assert np.array_equal(bitops.unpack_np(_u32(got), n), truth)
        assert (int(ch) & 0xFFFFFFFF) == ch_k  # the same changed word
        assert (int(ch) != 0) == (int(ch_r) != 0) == (int(ch_w) != 0) == moved
        if n % 32:  # trailing pad bits of the last word never turn on
            pad = np.uint32(0xFFFFFFFF) << np.uint32(n % 32)
            assert not (_u32(got)[:, -1] & pad).any()


@pytest.mark.parametrize("v", [1, 16])
def test_plain_apply_chunk_boundaries_across_the_combine(v, rows_per_chunk):
    """Chunks that split both the contraction and the combine's lhs rows
    (including a chunk past V) give the same words."""
    chi, a, flags = _fused_case(40 + v, 300, v, density=0.05)
    want, ch_k = _pallas_apply(chi, a, flags)
    for chunk in (2, 3, 15, 16, 17, 299, 300, 301):
        rows_per_chunk(chunk, v, bitops.packed_width(300))
        got, ch = _plain_apply(chi, a, flags)
        assert np.array_equal(_u32(got), want), chunk
        assert (int(ch) & 0xFFFFFFFF) == ch_k


def test_plain_apply_all_zero_flags_is_identity():
    """An operator with no inequalities leaves chi untouched, changed 0."""
    chi, a, _ = _fused_case(7, 100, 3)
    flags = np.zeros((3, 3), np.uint32)
    got, ch, want, ch_k = _apply_both(chi, a, flags)
    assert np.array_equal(_u32(got), bitops.pack_np(chi))
    assert np.array_equal(_u32(got), want)
    assert int(ch) == ch_k == 0


def test_plain_apply_empty_frontier_clears_flagged_rows():
    """An empty chi row selects no adjacency row: every lhs flagged against
    it empties, the others keep their words."""
    chi, a, _ = _fused_case(11, 70, 4)
    chi[2] = False
    flags = np.zeros((4, 4), np.uint32)
    flags[0, 2] = flags[3, 2] = 1
    got, ch, want, ch_k = _apply_both(chi, a, flags)
    assert np.array_equal(_u32(got), want)
    assert not bitops.unpack_np(_u32(got), 70)[[0, 3]].any()
    assert np.array_equal(bitops.unpack_np(_u32(got), 70)[1], chi[1])
    assert (int(ch) & 0xFFFFFFFF) == ch_k != 0


def test_plain_apply_at_its_fixpoint_reports_no_change():
    """Iterating the plain step goes quiet exactly where chi stops moving,
    step for step with the Pallas kernel."""
    chi, a, flags = _fused_case(2, 130, 4, density=0.2)
    cp = bitops.pack_np(chi)
    for _ in range(20):
        got, ch = ref.bitmm_apply_ref(_words(cp), _words(bitops.pack_np(a)),
                                      torch.as_tensor(flags.astype(np.int32)))
        want, ch_k = kops.bitmm_apply(jnp.asarray(cp),
                                      jnp.asarray(bitops.pack_np(a)),
                                      jnp.asarray(flags), interpret=True)
        assert np.array_equal(_u32(got), np.asarray(want))
        assert (int(ch) != 0) == (int(ch_k) != 0)
        if not int(ch):
            assert np.array_equal(_u32(got), cp)
            break
        cp = _u32(got)
    else:
        raise AssertionError("plain fused step never converged")


def test_plain_apply_with_all_bits_set_and_a_full_adjacency():
    """Every frontier bit set, every adjacency bit set: chi keeps every
    real bit, so nothing moves, and the sign bit (lane 31) survives."""
    n, v = 64, 3
    chi = np.ones((v, n), bool)
    a = np.ones((n, n), bool)
    flags = np.ones((v, v), np.uint32)
    got, ch, want, ch_k = _apply_both(chi, a, flags)
    assert np.array_equal(_u32(got), want)
    assert (_u32(got) == 0xFFFFFFFF).all() and int(ch) == ch_k == 0


# --------------------------------------------------------------------- #
# K3: bitmm_packed
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("n", [1, 31, 32, 33, 100, 257, 300])
@pytest.mark.parametrize("v", [1, 5, 9])
def test_plain_product_matches_pallas_shape_sweep(n, v, rows_per_chunk):
    rng = np.random.default_rng(n * 100 + v)
    a = rng.random((n, n)) < 0.1
    x = rng.random((v, n)) < 0.4
    ap = bitops.pack_np(a)
    want = kmod.bitmm_packed(jnp.asarray(x, jnp.uint32), jnp.asarray(ap),
                             interpret=True)
    oracle = kref.bitmm_packed_ref(jnp.asarray(x), jnp.asarray(ap), n)
    for chunk in CHUNKS:
        rows_per_chunk(chunk, v, bitops.packed_width(n))
        got = ref.bitmm_packed_ref(torch.as_tensor(x), _words(ap))
        assert np.array_equal(_u32(got), np.asarray(want)), chunk
        assert np.array_equal(_u32(got), np.asarray(oracle))


@pytest.mark.parametrize("density", [0.0, 0.01, 0.5, 1.0])
def test_plain_product_density_sweep(density):
    rng = np.random.default_rng(17)
    n = 130
    a = rng.random((n, n)) < density
    x = rng.random((4, n)) < 0.5
    ap = bitops.pack_np(a)
    want = kops.bitmm(jnp.asarray(x), jnp.asarray(ap), interpret=True)
    got = kernel.bitmm(torch.as_tensor(x), _words(ap))
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_plain_product_empty_frontier_and_byte_flags():
    n = 64
    ap = bitops.pack_np(np.eye(n, dtype=bool))
    x = np.zeros((2, n), bool)
    assert not kernel.bitmm(torch.as_tensor(x), _words(ap)).any()
    rng = np.random.default_rng(5)
    x = rng.random((3, n)) < 0.4
    with pytest.raises(TypeError):  # the frontier is bool, never bytes
        kernel.bitmm_packed(torch.as_tensor(x.astype(np.uint8)), _words(ap))
    assert torch.equal(kernel.bitmm(torch.as_tensor(x), _words(ap)),
                       torch.as_tensor(x))  # the identity adjacency


def test_or_reduce_matches_numpy():
    rng = np.random.default_rng(3)
    for k in (0, 1, 2, 3, 5, 8, 33):
        x = rng.integers(0, 2**32, size=(4, k, 6), dtype=np.uint64)
        x = x.astype(np.uint32)
        got = ref.or_reduce(_words(x), 1)
        want = np.bitwise_or.reduce(x, axis=1) if k else np.zeros((4, 6),
                                                                   np.uint32)
        assert np.array_equal(_u32(got), want), k


# --------------------------------------------------------------------- #
# the wrappers on the CPU
# --------------------------------------------------------------------- #
def _small(v=3, n=100):
    chi, a, flags = _fused_case(1, n, v)
    return (_words(bitops.pack_np(chi)), _words(bitops.pack_np(a)),
            torch.as_tensor(flags.astype(np.int32)))


def test_wrappers_take_plain_versions_on_cpu_and_count_nothing():
    kernels.reset_launches()
    chi_p, a_p, flags = _small()
    new, ch = kernel.bitmm_apply(chi_p, a_p, flags)
    want, want_ch = ref.bitmm_apply_ref(chi_p, a_p, flags)
    assert torch.equal(new, want) and torch.equal(ch, want_ch)
    assert ch.dim() == 0 and ch.dtype == torch.int32
    x = bitops.unpack(chi_p, 100)
    assert torch.equal(kernel.bitmm_packed(x, a_p),
                       ref.bitmm_packed_ref(x, a_p))
    assert kernels.LAUNCHES.get("bitmm_apply_packed", 0) == 0
    assert kernels.LAUNCHES.get("bitmm_packed", 0) == 0


def test_wrappers_check_their_inputs():
    chi_p, a_p, flags = _small()
    x = bitops.unpack(chi_p, 100)
    with pytest.raises(TypeError):
        kernel.bitmm_apply(chi_p.long(), a_p, flags)
    with pytest.raises(TypeError):
        kernel.bitmm_packed(x.int(), a_p)
    with pytest.raises(ValueError, match="square"):
        kernel.bitmm_apply(chi_p, a_p[:50], flags)
    with pytest.raises(ValueError, match="chi must be"):
        kernel.bitmm_apply(chi_p[:, :2].contiguous(), a_p, flags)
    with pytest.raises(ValueError, match="lhs_flags"):
        kernel.bitmm_apply(chi_p, a_p, flags[:2])
    with pytest.raises(ValueError, match="frontier"):
        kernel.bitmm_packed(x[:, :50].contiguous(), a_p)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.bitmm_packed(x.t().contiguous().t(), a_p)
    with pytest.raises(ValueError, match="cuda or cpu"):
        kernel.bitmm_apply(chi_p.to("meta"), a_p.to("meta"),
                           flags.to("meta"))


def test_shared_memory_limit_refuses_vars_past_it():
    """The update stage's ``[V, 32]`` words of ~y bound V: 1, 48 and 1,760
    fit, the first V past the limit is refused before any launch."""
    for v in (1, 48, 1760, kernel.MAX_VARS):
        g = kernel.geometry(v, 1444)
        assert v * kernel.UPDATE_BYTES_PER_VAR <= kernel.SMEM_LIMIT
        assert g.var_groups == -(-v // kernel.GROUP)
    assert kernel.MAX_VARS == 1816
    with pytest.raises(ValueError, match="shared memory"):
        kernel.geometry(kernel.MAX_VARS + 1, 1444)
    with pytest.raises(ValueError, match="shared memory"):
        kernel.geometry(kernel.MAX_VARS + 1, 0)


def test_geometry_fills_the_card_at_the_main_path_shape():
    """V = 48 over nw = 1,444 (the 46,200-node dense-tier corpus): at
    least two blocks per SM, every contraction word in exactly one slice."""
    g = kernel.geometry(48, 1444)
    assert g.blocks >= 2 * kernel.SMS == 264
    assert g == (12, 22, 66, 1)  # column tiles, slices, slice words, groups
    assert g.blocks == 264  # two blocks on every SM, none in a second wave
    assert (g.slices - 1) * g.slice_words < 1444 <= g.slices * g.slice_words


@pytest.mark.parametrize("sms", [1, 66, 114, 132])
@pytest.mark.parametrize("v", [1, 48, 65, 1760])
def test_geometry_slices_never_exceed_contraction_words(v, sms):
    """Slices cover the contraction words without an empty one, never
    outnumber them (also where more blocks are asked for than there are
    words) or the slices asked for, and keep more than half of those; they
    stay within MAX_SLICE_WORDS, and the tiles and variable groups cover
    every column and variable."""
    for nw in (1, 2, 3, 4, 5, 31, 32, 33, 100, 129, 132, 625, 1444, 1449,
               5000):
        g = kernel.geometry(v, nw, sms)
        assert 1 <= g.slices <= nw
        assert 1 <= g.slice_words <= kernel.MAX_SLICE_WORDS
        assert (g.slices - 1) * g.slice_words < nw <= g.slices * g.slice_words
        tile = kernel.TILE
        assert (g.col_tiles - 1) * tile < nw <= g.col_tiles * tile
        group = kernel.GROUP
        assert (g.var_groups - 1) * group < v <= g.var_groups * group
        per_slice = g.col_tiles * g.var_groups
        asked = min(nw, max(-(-kernel.BLOCKS_PER_SM * sms // per_slice),
                            -(-nw // kernel.MAX_SLICE_WORDS)))
        assert asked / 2 < g.slices <= asked


def test_geometry_follows_the_card_sm_count():
    """The slices follow the SM count the wrapper reads from the card: an
    H100 PCIe's 114 SMs get two blocks each at the main-path shape, with
    none left over for a second wave."""
    g = kernel.geometry(48, 1444, 114)
    assert g.blocks <= 2 * 114 and g.blocks > 114
    assert g.slices == 19 and g.slice_words == 76
    assert kernel.geometry(48, 1444) == kernel.geometry(48, 1444, kernel.SMS)


def test_tiling_limits_match_the_source():
    text = _build.SOURCES["bitmm"].read_text()
    assert kernel.TILE == 32 * kernel.WORDS_PER_LANE
    assert kernel.GROUP == kernel.WARPS * kernel.VARS_PER_WARP
    for name, value in (("kWordsPerLane", kernel.WORDS_PER_LANE),
                        ("kWarps", kernel.WARPS),
                        ("kVarsPerWarp", kernel.VARS_PER_WARP)):
        assert f"constexpr int {name} = {value};" in text
    assert "int update_smem = n_vars * 32 * 4;" in text
    assert kernel.UPDATE_BYTES_PER_VAR == 32 * 4


def test_bitmm_source_is_built_beside_segor():
    assert set(_build.SOURCES) >= {"segor", "bitmm"}
    src = _build.SOURCES["bitmm"]
    assert src.is_file() and src.suffix == ".cu"
    text = src.read_text()
    for entry in ("bitmm_packed_launch", "bitmm_apply_launch"):
        assert f'extern "C" int {entry}(' in text
