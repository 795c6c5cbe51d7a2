"""Digit-domain compute path: conversions and the digit GEMM kernel."""

import numpy as np
import jax.numpy as jnp
import pytest

from qgtc_ppopp22.ops.bitpack import pack_bits
from qgtc_ppopp22.ops.digits import (
    DigitTensor,
    digit_pack,
    digit_unpack,
    to_digit_tensor,
)
from qgtc_ppopp22.ops.digitmm import digitmm_to_digits, digitmm_to_f32
from tests.golden import bitmm_np, effective_levels


@pytest.mark.parametrize("bits", [1, 2, 4, 5, 8])
def test_digit_pack_roundtrip(rng, bits):
    q = rng.integers(0, 1 << bits, (77, 45)).astype(np.int32)
    dt = digit_pack(jnp.asarray(q), bits)
    assert dt.padded_rows % 16 == 0 and dt.padded_cols % 16 == 0
    assert dt.padded_rows < 77 + 16 and dt.padded_cols < 45 + 16
    np.testing.assert_array_equal(np.asarray(digit_unpack(dt)), q)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_to_digit_tensor_matches_direct_pack(rng, bits):
    q = rng.integers(0, 1 << bits, (100, 140)).astype(np.int32)
    via_planes = to_digit_tensor(pack_bits(jnp.asarray(q), bits))
    direct = digit_pack(jnp.asarray(q), bits)
    # compare the logical region after unpack
    np.testing.assert_array_equal(
        np.asarray(digit_unpack(via_planes)), np.asarray(digit_unpack(direct))
    )


@pytest.mark.parametrize(
    "a_bits,b_bits,out_bits",
    [(1, 1, 1), (1, 2, 2), (2, 2, 2), (4, 4, 4), (8, 8, 8), (3, 5, 4)],
)
def test_digitmm_to_digits_exact(rng, a_bits, b_bits, out_bits):
    M, K, N = 160, 200, 70
    qa = rng.integers(0, 1 << a_bits, (M, K)).astype(np.int32)
    qb = rng.integers(0, 1 << b_bits, (K, N)).astype(np.int32)
    a = digit_pack(jnp.asarray(qa), a_bits)
    b = digit_pack(jnp.asarray(qb), b_bits)
    c = digitmm_to_digits(a, b, out_bits)
    got = np.asarray(digit_unpack(c))
    want = bitmm_np(qa, qb, a_bits, b_bits, out_bits)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("a_bits,b_bits", [(1, 1), (2, 4), (8, 8)])
def test_digitmm_to_f32_exact(rng, a_bits, b_bits):
    M, K, N = 130, 150, 90
    qa = rng.integers(0, 1 << a_bits, (M, K)).astype(np.int32)
    qb = rng.integers(0, 1 << b_bits, (K, N)).astype(np.int32)
    a = digit_pack(jnp.asarray(qa), a_bits)
    b = digit_pack(jnp.asarray(qb), b_bits)
    got = np.asarray(digitmm_to_f32(a, b))
    want = bitmm_np(qa, qb, a_bits, b_bits, None)
    np.testing.assert_array_equal(got, want.astype(np.float32))


def test_digitmm_sparse_matches_dense(rng):
    M = K = 1024
    N = 64
    qa = rng.integers(0, 2, (M, K)).astype(np.int32)
    qa[:, :512] = 0  # whole K-tiles of zeros
    qa[512:] = 0
    qb = rng.integers(0, 4, (K, N)).astype(np.int32)
    a = digit_pack(jnp.asarray(qa), 1)
    b = digit_pack(jnp.asarray(qb), 2)
    np.testing.assert_array_equal(
        np.asarray(digit_unpack(digitmm_to_digits(a, b, 2))),
        bitmm_np(qa, qb, 1, 2, 2),
    )
    np.testing.assert_array_equal(
        np.asarray(digitmm_to_f32(a, b)),
        bitmm_np(qa, qb, 1, 2, None).astype(np.float32),
    )


@pytest.mark.parametrize("N", [13, 16, 64])
@pytest.mark.parametrize("a_bits,b_bits", [(1, 8), (8, 8), (8, 6)])
def test_digitmm_lane_stacked_rhs_exact(rng, a_bits, b_bits, N):
    """A 2-digit-plane RHS at the model's narrow widths (<= 64): all
    output flavors (requantized digits incl. shift, f32, raw int32)
    stay bit-exact vs the golden, and the padding beyond N is zero."""
    from qgtc_ppopp22.ops.digitmm import digitmm_to_i32

    M, K = 256, 300
    qa = rng.integers(0, 1 << a_bits, (M, K)).astype(np.int32)
    qa[128:] = 0  # zero M/K tiles so the sparse map really skips
    qb = rng.integers(0, 1 << b_bits, (K, N)).astype(np.int32)
    a = digit_pack(jnp.asarray(qa), a_bits)
    b = digit_pack(jnp.asarray(qb), b_bits)
    assert b.digits.shape[0] == 2  # two digit planes

    out = digitmm_to_digits(a, b, 4, shift=1)
    assert out.digits.shape[2] == -(-N // 16) * 16  # N side not widened
    got = np.asarray(digit_unpack(out))
    want = bitmm_np(qa, qb, a_bits, b_bits, 4, shift=1)
    np.testing.assert_array_equal(got, want)

    gotf = np.asarray(digitmm_to_f32(a, b))
    goti = np.asarray(digitmm_to_i32(a, b))
    wantf = bitmm_np(qa, qb, a_bits, b_bits, None)
    np.testing.assert_array_equal(gotf, wantf.astype(np.float32))
    np.testing.assert_array_equal(goti[:M, :N], wantf)
    assert not goti[:, N:].any()


def test_digit_chain_composes(rng):
    """Output of digitmm composes as either operand of the next GEMM."""
    bits = 2
    qa = rng.integers(0, 2, (256, 256)).astype(np.int32)
    qx = rng.integers(0, 4, (256, 128)).astype(np.int32)
    qw = rng.integers(0, 4, (128, 128)).astype(np.int32)
    a = digit_pack(jnp.asarray(qa), 1)
    x = digit_pack(jnp.asarray(qx), bits)
    w = digit_pack(jnp.asarray(qw), bits)
    xw = digitmm_to_digits(x, w, bits)  # as lhs next
    axw = digitmm_to_digits(a, xw, bits)  # as rhs next
    got = np.asarray(digit_unpack(axw))
    want = bitmm_np(
        qa, bitmm_np(qx, qw, bits, bits, bits), 1, bits, bits
    )
    np.testing.assert_array_equal(got, want)
