"""The port's word layout against the JAX package: ``int32`` words viewed as
``uint32`` equal the reference's packing bit for bit, at ``n % 32 != 0``
included, and the pad bits stay zero."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitops as ref_bitops
from repro_torch.core import bitops


def _unaligned_widths():
    return [1, 5, 31, 33, 63, 70, 100, 257, 1000]


@pytest.mark.parametrize("n", _unaligned_widths() + [32, 64])
def test_pack_matches_reference_pack_np(n):
    rng = np.random.default_rng(n)
    bits = rng.random((4, n)) < 0.4
    bits[0, -1] = True  # lane 31 of the last full word, where it exists
    ref = ref_bitops.pack_np(bits)
    got = bitops.pack(torch.from_numpy(bits))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), ref)
    assert np.array_equal(np.asarray(ref_bitops.pack(jnp.asarray(bits))), ref)
    assert np.array_equal(bitops.pack_np(bits), ref)
    assert np.array_equal(bitops.unpack(got, n).numpy(), bits)
    assert np.array_equal(bitops.unpack_np(ref, n), bits)
    assert np.array_equal(bitops.unpack_np(got.numpy(), n), bits)


def test_sign_bit_lane_round_trips():
    """Bit 31 is the int32 sign bit: it packs to INT_MIN and extracts with
    the ``& 1`` mask after an arithmetic shift."""
    bits = np.zeros((1, 64), bool)
    bits[0, 31] = bits[0, 63] = True
    got = bitops.pack(torch.from_numpy(bits))
    assert got.tolist() == [[-(2**31), -(2**31)]]
    assert np.array_equal(bitops.unpack(got, 64).numpy(), bits)


@pytest.mark.parametrize("n", _unaligned_widths())
def test_popcount_any_leq_match_reference(n):
    rng = np.random.default_rng(n + 1)
    a = rng.random((3, n)) < 0.3
    b = a | (rng.random((3, n)) < 0.2)
    pa, pb = bitops.pack(torch.from_numpy(a)), bitops.pack(torch.from_numpy(b))
    ra, rb = jnp.asarray(ref_bitops.pack_np(a)), jnp.asarray(ref_bitops.pack_np(b))
    assert np.array_equal(bitops.popcount(pa).numpy(),
                          np.asarray(ref_bitops.popcount(ra)))
    assert np.array_equal(bitops.any_set(pa).numpy(),
                          np.asarray(ref_bitops.any_set(ra)))
    assert np.array_equal(bitops.leq(pa, pb).numpy(),
                          np.asarray(ref_bitops.leq(ra, rb)))
    assert np.array_equal(bitops.leq(pb, pa).numpy(),
                          np.asarray(ref_bitops.leq(rb, ra)))


@pytest.mark.parametrize("n", _unaligned_widths())
def test_ones_mask_and_pad_bits(n):
    assert np.array_equal(bitops.ones_mask(n), ref_bitops.ones_mask(n))
    words = bitops.to_words(bitops.ones_mask(n), "cpu")
    assert int(bitops.popcount(words)) == n
    assert np.array_equal(bitops.words_np(words), ref_bitops.ones_mask(n))
    packed = bitops.pack(torch.ones((2, n), dtype=torch.bool))
    rem = n % bitops.WORD
    if rem:
        pad = np.uint32(0xFFFFFFFF) << np.uint32(rem)
        assert not (packed.numpy().view(np.uint32)[:, -1] & pad).any()
