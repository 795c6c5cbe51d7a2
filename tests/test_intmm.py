"""The plain XLA route (``ops/intmm.py``) every GEMM takes: digit dots,
the offset-signed plane, N-side slicing, the int32 bound and the
requantizer, each against the NumPy golden model."""

import numpy as np
import jax.numpy as jnp
import pytest

from qgtc_ppopp22.ops.digits import digit_pack
from qgtc_ppopp22.ops.intmm import (
    DIGIT_PAD,
    SIGNED_OFFSET,
    check_accumulator,
    levels_to_digits,
    pad_width,
    plain_mm,
    requant_digits,
    requant_levels,
)
from qgtc_ppopp22.ops.packmm import pack_rows, to_digit_planes
from tests.golden import bitmm_np, effective_levels, requantize_np


@pytest.mark.parametrize(
    "a_bits,b_bits", [(1, 2), (2, 2), (4, 4), (8, 8), (3, 5), (1, 8)]
)
def test_plain_mm_digit_pairs_exact(rng, a_bits, b_bits):
    """Operands with different padded K (A packed to 256, B digits to
    16): the contraction runs over the common extent, exactly."""
    M, K, N = 90, 200, 24
    qa = rng.integers(0, 1 << a_bits, (M, K))
    qb = rng.integers(0, 1 << b_bits, (K, N))
    a = digit_pack(jnp.asarray(qa), a_bits)
    a_digits = jnp.pad(a.digits, ((0, 0), (0, 0), (0, 256 - a.digits.shape[2])))
    b = digit_pack(jnp.asarray(qb), b_bits)
    acc = plain_mm(a_digits, b.digits, M, K, N)
    assert acc.shape == (pad_width(M), pad_width(N))
    np.testing.assert_array_equal(
        np.asarray(acc)[:M, :N], bitmm_np(qa, qb, a_bits, b_bits, None)
    )


@pytest.mark.parametrize("bits", [5, 6, 7, 8])
def test_plain_mm_signed_plane_exact(rng, bits):
    """One offset-signed plane (byte = level - 128) plus the rank-1
    128 * colsum(B) correction == the unsigned product; padding rows
    and columns (level 0 = byte -128) cancel."""
    M, K, N = 70, 130, 20
    qa = rng.integers(0, 1 << bits, (M, K))
    qb = rng.integers(0, 1 << bits, (K, N))
    a = pack_rows(jnp.asarray(qa), bits)
    plane = to_digit_planes(a)
    assert plane.shape[0] == 1 and plane.dtype == jnp.int8
    assert int(plane[0, M, 0]) == -SIGNED_OFFSET  # a padding row
    acc = plain_mm(plane, digit_pack(jnp.asarray(qb), bits).digits,
                   M, K, N, signed_a=True)
    want = bitmm_np(qa, qb, bits, bits, None)
    np.testing.assert_array_equal(np.asarray(acc)[:M, :N], want)
    assert not np.asarray(acc)[M:].any()


@pytest.mark.parametrize("n", [1, 15, 16, 17, 40, 64, 100])
def test_n_side_is_logical_width_rounded_to_16(rng, n):
    """The dot runs at the logical width rounded up to 16, however wide
    the storage padding of B is."""
    K = 64
    qa = rng.integers(0, 2, (32, K))
    qb = rng.integers(0, 4, (K, n))
    b = digit_pack(jnp.asarray(qb), 2).digits
    b_wide = jnp.pad(b, ((0, 0), (0, 0), (0, 256 - b.shape[2])))
    acc = plain_mm(digit_pack(jnp.asarray(qa), 1).digits, b_wide, 32, K, n)
    assert acc.shape[1] == -(-n // DIGIT_PAD) * DIGIT_PAD
    np.testing.assert_array_equal(
        np.asarray(acc)[:, :n], bitmm_np(qa, qb, 1, 2, None)
    )
    assert not np.asarray(acc)[:, n:].any()


@pytest.mark.parametrize(
    "nd_a,nd_b,k,signed,ok",
    [
        (1, 1, 1 << 20, False, True),
        (2, 2, 1 << 16, False, False),  # 8-bit x 8-bit past ~33k
        (2, 2, 8192, False, True),
        (1, 2, 1 << 16, True, False),
    ],
)
def test_accumulator_bound(nd_a, nd_b, k, signed, ok):
    if ok:
        check_accumulator(nd_a, nd_b, k, signed)
    else:
        with pytest.raises(ValueError):
            check_accumulator(nd_a, nd_b, k, signed)


def test_plain_mm_rejects_short_operands(rng):
    a = digit_pack(jnp.ones((32, 48), jnp.int32), 1).digits
    b = digit_pack(jnp.ones((48, 16), jnp.int32), 1).digits
    with pytest.raises(ValueError):
        plain_mm(a, b, 32, 64, 16)  # logical K beyond both paddings
    with pytest.raises(ValueError):
        plain_mm(a, b, 32, 48, 40)  # N beyond B


@pytest.mark.parametrize("out_bits", range(1, 9))
def test_requant_and_digit_split_match_golden(rng, out_bits):
    """Reference epilogue: clamp, wrap, shift, then base-16 digits."""
    acc = rng.integers(-50, 4 << out_bits, (64, 16))
    for shift in (0, 1, 3):
        lv = np.asarray(requant_levels(jnp.asarray(acc, jnp.int32),
                                       out_bits, shift))
        want = effective_levels(requantize_np(acc, out_bits, shift),
                                out_bits)
        np.testing.assert_array_equal(lv, want)
        dig = np.asarray(requant_digits(jnp.asarray(acc, jnp.int32),
                                        out_bits, shift))
        back = sum(dig[d].astype(np.int64) << (4 * d)
                   for d in range(dig.shape[0]))
        np.testing.assert_array_equal(back, want)
        assert dig.dtype == np.int8 and dig.max() < 16
    np.testing.assert_array_equal(
        np.asarray(levels_to_digits(jnp.asarray(want), out_bits)), dig
    )
