"""The port's public packed products (``repro_torch.kernels.bitmm.ops``)
against the JAX package's ops, replaying the bitmm cases of its kernel
tests: bool product, packed-frontier product and fused sweep step, bit for
bit (words compared as ``uint32``), beside the Pallas kernels in interpret
mode at the reference's block shapes and a boolean ground truth."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitops as ref_bitops
from repro.kernels.bitmm import kernel as kmod
from repro.kernels.bitmm import ops as kops
from repro.kernels.bitmm import ref as kref
from repro_torch import kernels
from repro_torch.core import bitops
from repro_torch.kernels.bitmm import ops


def _port(x) -> torch.Tensor:
    """A numpy bool plane or uint32 words as the port's tensor."""
    x = np.asarray(x)
    if x.dtype == np.uint32:
        return bitops.to_words(x, "cpu")
    return torch.from_numpy(x.copy())


def _u32(t: torch.Tensor) -> np.ndarray:
    return bitops.words_np(t)


def _product_case(seed, n, v, density=0.1, x_density=0.4):
    rng = np.random.default_rng(seed)
    a = rng.random((n, n)) < density
    x = rng.random((v, n)) < x_density
    return a, x, ref_bitops.pack_np(a)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 100, 257, 300])
@pytest.mark.parametrize("v", [1, 5, 9])
def test_bitmm_shape_sweep(n, v):
    a, x, ap = _product_case(n * 100 + v, n, v)
    got = ops.bitmm(_port(x), _port(ap))
    want = kops.bitmm(jnp.asarray(x), jnp.asarray(ap), interpret=True)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    truth = np.stack([a[r].any(axis=0) for r in x])
    np.testing.assert_array_equal(got.numpy(), truth)


@pytest.mark.parametrize("density", [0.0, 0.01, 0.5, 1.0])
def test_bitmm_density_sweep(density):
    rng = np.random.default_rng(17)
    n = 130
    a = rng.random((n, n)) < density
    x = rng.random((4, n)) < 0.5
    ap = ref_bitops.pack_np(a)
    got = ops.bitmm(_port(x), _port(ap))
    want = kops.bitmm(jnp.asarray(x), jnp.asarray(ap), interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("blocks", [(64, 128), (128, 256), (256, 128)])
def test_bitmm_packed_against_kernel_block_shapes(blocks):
    """The packed op equals the reference kernel at each of its block
    shapes (the port's kernel has one tiling, fixed in its source)."""
    bi, bjw = blocks
    a, x, ap = _product_case(3, 520, 3, density=0.05, x_density=0.3)
    want = kmod.bitmm_packed(jnp.asarray(x, jnp.uint32), jnp.asarray(ap),
                             block_i=bi, block_jw=bjw, interpret=True)
    got = ops.bitmm_packed(_port(ref_bitops.pack_np(x)), _port(ap))
    np.testing.assert_array_equal(_u32(got), np.asarray(want)[:, : ap.shape[1]])


@pytest.mark.parametrize("n", [31, 200, 257])
def test_bitmm_packed_frontier_variant(n):
    a, x, ap = _product_case(5, n, 2)
    xp = ref_bitops.pack_np(x)
    got = ops.bitmm_packed(_port(xp), _port(ap))
    want = kops.bitmm_packed(jnp.asarray(xp), jnp.asarray(ap), interpret=True)
    np.testing.assert_array_equal(_u32(got), np.asarray(want))
    exp = kref.bitmm_packed_ref(jnp.asarray(x), jnp.asarray(ap), n)
    np.testing.assert_array_equal(_u32(got), np.asarray(exp))
    assert torch.equal(ops.bitmm_packed(_port(xp), _port(ap), n), got)


def test_bitmm_packed_ignores_frontier_pad_bits():
    """Bits of the frontier's last word past the adjacency's n rows do not
    select rows (the reference unpacks only n bits)."""
    a, x, ap = _product_case(8, 70, 3)
    xp = ref_bitops.pack_np(x)
    dirty = xp.copy()
    dirty[:, -1] |= np.uint32(0xFFFFFFFF) << np.uint32(70 % 32)
    clean = ops.bitmm_packed(_port(xp), _port(ap))
    assert torch.equal(ops.bitmm_packed(_port(dirty), _port(ap)), clean)
    want = kops.bitmm_packed(jnp.asarray(dirty), jnp.asarray(ap), interpret=True)
    np.testing.assert_array_equal(_u32(clean), np.asarray(want))


def test_bitmm_packed_refuses_bad_frontiers():
    _, x, ap = _product_case(1, 64, 2)
    xp = _port(ref_bitops.pack_np(x))
    with pytest.raises(ValueError, match="n=63"):
        ops.bitmm_packed(xp, _port(ap), 63)
    with pytest.raises(ValueError, match="frontier must be"):
        ops.bitmm_packed(xp[:, :1], _port(ap))
    with pytest.raises(TypeError):
        ops.bitmm_packed(xp.to(torch.int64), _port(ap))


def test_bitmm_empty_frontier():
    n = 64
    ap = _port(ref_bitops.pack_np(np.eye(n, dtype=bool)))
    assert not ops.bitmm(torch.zeros((2, n), dtype=torch.bool), ap).any()
    assert not ops.bitmm_packed(torch.zeros((2, 2), dtype=torch.int32), ap).any()


# --------------------------------------------------------------------- #
# bitmm_apply: the fused packed sweep step
# --------------------------------------------------------------------- #
def _fused_case(seed, n, v, density=0.1):
    rng = np.random.default_rng(seed)
    a = rng.random((n, n)) < density
    chi = rng.random((v, n)) < 0.6
    flags = (rng.random((v, v)) < 0.5).astype(np.uint32)
    return ref_bitops.pack_np(chi), ref_bitops.pack_np(a), flags, chi, a


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


@pytest.mark.parametrize("n", [1, 31, 32, 33, 100, 257, 300, 520])
@pytest.mark.parametrize("v", [1, 5, 9])
def test_bitmm_apply_shape_sweep(n, v):
    cp, ap, fj, chi, a = _fused_case(n * 100 + v, n, v)
    out, ch = ops.bitmm_apply(_port(cp), _port(ap), _port(fj))
    want, rch = kops.bitmm_apply(jnp.asarray(cp), jnp.asarray(ap),
                                 jnp.asarray(fj), interpret=True)
    np.testing.assert_array_equal(_u32(out), np.asarray(want))
    truth = _fused_truth(chi, a, fj)
    np.testing.assert_array_equal(bitops.unpack(out, n).numpy(), truth)
    moved = bool((truth != chi).any())
    assert (int(ch) != 0) == (int(rch) != 0) == moved
    if n % 32:  # trailing pad bits of the last word never turn on
        mask = np.uint32(0xFFFFFFFF) << np.uint32(n % 32)
        assert not (_u32(out)[:, -1] & mask).any()


@pytest.mark.parametrize("blocks", [(64, 128), (256, 128), (128, 64)])
def test_bitmm_apply_against_kernel_block_shapes(blocks):
    bi, bjw = blocks
    cp, ap, fj, _, _ = _fused_case(9, 520, 3, density=0.05)
    want, _ = kmod.bitmm_apply_packed(jnp.asarray(cp), jnp.asarray(ap),
                                      jnp.asarray(fj), block_i=bi,
                                      block_jw=bjw, interpret=True)
    out, _ = ops.bitmm_apply(_port(cp), _port(ap), _port(fj))
    np.testing.assert_array_equal(_u32(out), np.asarray(want))


def test_bitmm_apply_fixpoint_changed_goes_quiet():
    """Iterating the fused step reports changed = 0 exactly when chi stops
    moving, after as many steps as the reference's op takes."""
    cp, ap, fj, _, _ = _fused_case(2, 130, 4, density=0.2)
    got, want = _port(cp), jnp.asarray(cp)
    for step in range(20):
        new, ch = ops.bitmm_apply(got, _port(ap), _port(fj))
        rnew, rch = kops.bitmm_apply(want, jnp.asarray(ap), jnp.asarray(fj),
                                     interpret=True)
        np.testing.assert_array_equal(_u32(new), np.asarray(rnew))
        assert (int(ch) != 0) == (int(rch) != 0)
        if not int(ch):
            assert torch.equal(new, got)
            break
        assert not torch.equal(new, got)
        got, want = new, rnew
    else:
        raise AssertionError("fused step never converged")


def test_bitmm_apply_no_flags_is_identity():
    cp, ap, _, _, _ = _fused_case(7, 100, 3)
    fz = torch.zeros((3, 3), dtype=torch.int32)
    out, ch = ops.bitmm_apply(_port(cp), _port(ap), fz)
    assert torch.equal(out, _port(cp)) and int(ch) == 0


def test_ops_on_the_cpu_launch_nothing():
    cp, ap, fj, chi, _ = _fused_case(4, 64, 2)
    kernels.reset_launches()
    ops.bitmm(_port(chi), _port(ap))
    ops.bitmm_packed(_port(cp), _port(ap))
    ops.bitmm_apply(_port(cp), _port(ap), _port(fj))
    assert not any(kernels.launch_counts().values())
