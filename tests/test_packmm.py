"""Packed-operand GEMM: container round-trips and exactness.

Validates the packed-A GEMM (``ops/packmm.py``), the equivalent of the
reference's packed-consuming BMMA kernels (``kernel.h:245-391``), by
exact integer equality vs the NumPy golden model.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from qgtc_ppopp22.ops.digits import digit_pack, digit_unpack
from qgtc_ppopp22.ops.packmm import (
    PackedTensor,
    build_tile_map_packed_np,
    pack_digit_tensor,
    pack_rows,
    pack_rows_np,
    packmm_to_digits,
    packmm_to_f32,
    packmm_to_packed,
    unpack_rows,
)
from tests.golden import bitmm_np, effective_levels


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 5, 8])
def test_pack_rows_roundtrip(rng, bits):
    q = rng.integers(0, 1 << bits, (300, 150)).astype(np.int32)
    pt = pack_rows(jnp.asarray(q), bits)
    assert pt.padded_rows % 256 == 0 and pt.padded_cols % 128 == 0
    np.testing.assert_array_equal(np.asarray(unpack_rows(pt)), q)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_pack_rows_np_matches_device(rng, bits):
    q = rng.integers(0, 1 << bits, (270, 140)).astype(np.int32)
    host = pack_rows_np(q, bits)
    dev = pack_rows(jnp.asarray(q), bits)
    np.testing.assert_array_equal(host, np.asarray(dev.words))


def test_pack_digit_tensor_roundtrip(rng):
    q = rng.integers(0, 16, (130, 200)).astype(np.int32)
    dt = digit_pack(jnp.asarray(q), 4)
    pt = pack_digit_tensor(dt)
    np.testing.assert_array_equal(np.asarray(unpack_rows(pt)), q)


@pytest.mark.parametrize(
    "a_bits,b_bits,out_bits",
    [(1, 1, 1), (1, 2, 2), (2, 2, 2), (4, 4, 4), (8, 8, 8), (3, 5, 4)],
)
def test_packmm_to_digits_exact(rng, a_bits, b_bits, out_bits):
    M, K, N = 300, 200, 70
    qa = rng.integers(0, 1 << a_bits, (M, K)).astype(np.int32)
    qb = rng.integers(0, 1 << b_bits, (K, N)).astype(np.int32)
    a = pack_rows(jnp.asarray(qa), a_bits)
    b = digit_pack(jnp.asarray(qb), b_bits)
    c = packmm_to_digits(a, b, out_bits)
    got = np.asarray(digit_unpack(c))
    want = bitmm_np(qa, qb, a_bits, b_bits, out_bits)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("a_bits,b_bits", [(1, 1), (2, 4), (8, 8)])
def test_packmm_to_f32_exact(rng, a_bits, b_bits):
    M, K, N = 290, 150, 90
    qa = rng.integers(0, 1 << a_bits, (M, K)).astype(np.int32)
    qb = rng.integers(0, 1 << b_bits, (K, N)).astype(np.int32)
    a = pack_rows(jnp.asarray(qa), a_bits)
    b = digit_pack(jnp.asarray(qb), b_bits)
    got = np.asarray(packmm_to_f32(a, b))
    want = bitmm_np(qa, qb, a_bits, b_bits, None)
    np.testing.assert_array_equal(got, want.astype(np.float32))


@pytest.mark.parametrize("a_bits,out_bits", [(1, 1), (2, 2), (4, 4), (8, 8)])
def test_packmm_to_packed_exact(rng, a_bits, out_bits):
    """Bit-in bit-out: the reference ``bitMM2Bit_profile`` shape."""
    M, K, N = 256, 256, 16
    qa = rng.integers(0, 1 << a_bits, (M, K)).astype(np.int32)
    qb = rng.integers(0, 1 << a_bits, (K, N)).astype(np.int32)
    a = pack_rows(jnp.asarray(qa), a_bits)
    b = digit_pack(jnp.asarray(qb), a_bits)
    c = packmm_to_packed(a, b, out_bits)
    assert isinstance(c, PackedTensor)
    got = np.asarray(unpack_rows(c))
    want = bitmm_np(qa, qb, a_bits, a_bits, out_bits)
    np.testing.assert_array_equal(got, want)


def test_packmm_shift_matches_golden(rng):
    M, K, N = 256, 256, 64
    qa = rng.integers(0, 4, (M, K)).astype(np.int32)
    qb = rng.integers(0, 4, (K, N)).astype(np.int32)
    a = pack_rows(jnp.asarray(qa), 2)
    b = digit_pack(jnp.asarray(qb), 2)
    c = packmm_to_digits(a, b, 2, shift=3)
    want = bitmm_np(qa, qb, 2, 2, 2, shift=3)
    np.testing.assert_array_equal(np.asarray(digit_unpack(c)), want)


def test_packmm_sparse_matches_dense(rng):
    M = K = 1024
    N = 64
    qa = rng.integers(0, 2, (M, K)).astype(np.int32)
    qa[:, :512] = 0
    qa[512:] = 0
    qb = rng.integers(0, 4, (K, N)).astype(np.int32)
    a = pack_rows(jnp.asarray(qa), 1)
    b = digit_pack(jnp.asarray(qb), 2)
    kidx, kcnt = build_tile_map_packed_np(np.asarray(a.words), 1)
    # row tiles 0-1 hold columns 512.. (2 of 4 K tiles); 2-3 are empty
    assert kcnt.tolist() == [2, 2, 0, 0]
    assert kidx[0].tolist() == [2, 3, 3, 3]
    np.testing.assert_array_equal(
        np.asarray(digit_unpack(packmm_to_digits(a, b, 2))),
        bitmm_np(qa, qb, 1, 2, 2),
    )
    np.testing.assert_array_equal(
        np.asarray(packmm_to_f32(a, b)),
        bitmm_np(qa, qb, 1, 2, None).astype(np.float32),
    )


@pytest.mark.parametrize("N", [13, 16, 64])
def test_packmm_lane_stacked_rhs_exact(rng, N):
    """8-bit (two-digit-plane) B at the model's narrow widths against
    a signed 8-bit A: digits, f32 and packed output all stay bit-exact
    vs golden."""
    M, K = 512, 512
    qa = rng.integers(0, 1 << 8, (M, K)).astype(np.int32)
    qa[256:] = 0
    qa[:, 256:] = 0  # zero tiles so the sparse map skips
    qb = rng.integers(0, 1 << 8, (K, N)).astype(np.int32)
    a = pack_rows(jnp.asarray(qa), 8)
    b = digit_pack(jnp.asarray(qb), 8)
    assert b.digits.shape[0] == 2  # two digit planes

    got = np.asarray(digit_unpack(packmm_to_digits(a, b, 4, shift=2)))
    want = bitmm_np(qa, qb, 8, 8, 4, shift=2)
    np.testing.assert_array_equal(got, want)

    gotf = np.asarray(packmm_to_f32(a, b))
    np.testing.assert_array_equal(
        gotf, bitmm_np(qa, qb, 8, 8, None).astype(np.float32)
    )

    gotp = np.asarray(unpack_rows(packmm_to_packed(a, b, 8)))
    np.testing.assert_array_equal(gotp, bitmm_np(qa, qb, 8, 8, 8))


def test_packmm_chain_composes(rng):
    """packed-out feeds the next GEMM's A; digit-out feeds its B."""
    bits = 2
    qa = rng.integers(0, 2, (256, 256)).astype(np.int32)
    qx = rng.integers(0, 4, (256, 128)).astype(np.int32)
    qw = rng.integers(0, 4, (128, 128)).astype(np.int32)
    a = pack_rows(jnp.asarray(qa), 1)
    x = pack_rows(jnp.asarray(qx), bits)
    w = digit_pack(jnp.asarray(qw), bits)
    xw_digits = packmm_to_digits(x, w, bits)  # rhs of the next GEMM
    axw = packmm_to_digits(a, xw_digits, bits)
    want = bitmm_np(qa, bitmm_np(qx, qw, bits, bits, bits), 1, bits, bits)
    np.testing.assert_array_equal(np.asarray(digit_unpack(axw)), want)
    # and packed output as the next lhs
    xw_packed = packmm_to_packed(x, w, bits)
    np.testing.assert_array_equal(
        np.asarray(unpack_rows(xw_packed))[:256, :128],
        bitmm_np(qx, qw, bits, bits, bits),
    )


def test_packmm_vs_digitmm_same_results(rng):
    from qgtc_ppopp22.ops.digitmm import digitmm_to_digits

    qa = rng.integers(0, 2, (512, 512)).astype(np.int32)
    qb = rng.integers(0, 4, (512, 64)).astype(np.int32)
    pa = pack_rows(jnp.asarray(qa), 1)
    da = digit_pack(jnp.asarray(qa), 1)
    b = digit_pack(jnp.asarray(qb), 2)
    via_pack = np.asarray(digit_unpack(packmm_to_digits(pa, b, 2)))
    via_digit = np.asarray(digit_unpack(digitmm_to_digits(da, b, 2)))
    np.testing.assert_array_equal(via_pack, via_digit)


def test_packed_signed_layout_single_plane(rng):
    """Bits 5-8 pack ONE offset-signed byte plane (level ^ 0x80):
    half the bytes of two nibble planes, one int8 pass per B digit
    (``ops/packmm.field_width`` docstring)."""
    from qgtc_ppopp22.ops.packmm import packed_signed

    assert packed_signed(8) and packed_signed(5)
    assert not packed_signed(4) and not packed_signed(1)
    q = rng.integers(0, 256, (256, 128)).astype(np.int32)
    pt = pack_rows(jnp.asarray(q), 8)
    assert pt.words.shape[0] == 1  # single plane
    assert pt.words.dtype == jnp.int8  # plain bytes, no word packing
    assert pt.values_per_word == 1
    np.testing.assert_array_equal(np.asarray(unpack_rows(pt)), q)


def test_packed_signed_sparse_occupancy(rng):
    """Zero LEVELS are 0x80 bytes in the signed layout; the tile map
    must treat them as empty, and the GEMM's rank-1 correction must
    cancel them exactly."""
    M = K = 512
    N = 32
    qa = rng.integers(0, 256, (M, K)).astype(np.int32)
    qa[:, 256:] = 0  # right half of K is empty for every row
    qb = rng.integers(0, 256, (K, N)).astype(np.int32)
    a = pack_rows(jnp.asarray(qa), 8)
    b = digit_pack(jnp.asarray(qb), 8)
    _, kcnt = build_tile_map_packed_np(np.asarray(a.words), 8)
    assert kcnt.tolist() == [1, 1]  # half of K empty
    want = bitmm_np(qa, qb, 8, 8, 8)
    got = packmm_to_digits(a, b, 8)
    np.testing.assert_array_equal(np.asarray(digit_unpack(got)), want)
    got_f = packmm_to_f32(a, b)
    np.testing.assert_array_equal(
        np.asarray(got_f), bitmm_np(qa, qb, 8, 8, None).astype(np.float32)
    )


def test_packed_signed_chain_composes(rng):
    """packmm_to_packed 8-bit output (signed plane) feeds the next
    GEMM's A operand bit-exactly, including its zero padding rows
    (level 0 = 0x80 bytes must still requantize/compose to 0)."""
    qx = rng.integers(0, 256, (200, 256)).astype(np.int32)
    qw = rng.integers(0, 256, (256, 60)).astype(np.int32)
    qw2 = rng.integers(0, 256, (64, 40)).astype(np.int32)
    x = pack_rows(jnp.asarray(qx), 8)
    w = digit_pack(jnp.asarray(qw), 8)
    xw = packmm_to_packed(x, w, 8)
    assert xw.words.shape[0] == 1
    want1 = bitmm_np(qx, qw, 8, 8, 8)
    np.testing.assert_array_equal(np.asarray(unpack_rows(xw)), want1)
    # padded output columns are level 0 -> next contraction sees zeros
    xw2 = PackedTensor(words=xw.words, shape=(200, 64), bits=8)
    want1p = np.zeros((200, 64), np.int32)
    want1p[:, :60] = want1
    got2 = packmm_to_f32(xw2, digit_pack(jnp.asarray(qw2), 8))
    want2 = bitmm_np(want1p, qw2, 8, 8, None).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(got2), want2)


def test_packmm_out_cols_slices_store(rng):
    """Terminal outputs carry only the real N columns: f32 is [M, N]
    (the reference emits dense M x N, ``kernel.h:920-930``), and a
    packed output holds N columns of fields in its 128-column pad."""
    qa = rng.integers(0, 256, (256, 256)).astype(np.int32)
    qb = rng.integers(0, 256, (256, 16)).astype(np.int32)
    a = pack_rows(jnp.asarray(qa), 8)
    b = digit_pack(jnp.asarray(qb), 8)
    c = packmm_to_packed(a, b, 8)
    assert c.shape == (256, 16) and c.padded_cols == 128
    np.testing.assert_array_equal(
        np.asarray(unpack_rows(c)), bitmm_np(qa, qb, 8, 8, 8)
    )
    f = packmm_to_f32(a, b)
    assert f.shape == (256, 16)
    np.testing.assert_array_equal(
        np.asarray(f), bitmm_np(qa, qb, 8, 8, None).astype(np.float32)
    )
    # low-bit packed output too
    qa2 = rng.integers(0, 4, (256, 256)).astype(np.int32)
    a2 = pack_rows(jnp.asarray(qa2), 2)
    qb2 = rng.integers(0, 4, (256, 16)).astype(np.int32)
    b2 = digit_pack(jnp.asarray(qb2), 2)
    c2 = packmm_to_packed(a2, b2, 2)
    assert c2.words.shape[2] == 128 // 16
    np.testing.assert_array_equal(
        np.asarray(unpack_rows(c2)), bitmm_np(qa2, qb2, 2, 2, 2)
    )


def test_prepared_rhs_stream_exact(rng):
    """The signed-plane GEMM (rank-1 ``128 * colsum(B)`` correction)
    is bit-exact vs golden for every output form, including padding
    rows/lanes (level 0)."""
    M, K, N = 700, 300, 60
    qa = rng.integers(0, 256, (M, K)).astype(np.int32)
    qb = rng.integers(0, 256, (K, N)).astype(np.int32)
    a = pack_rows(jnp.asarray(qa), 8)
    bp = digit_pack(jnp.asarray(qb), 8)

    got = np.asarray(packmm_to_f32(a, bp))
    np.testing.assert_array_equal(
        got, bitmm_np(qa, qb, 8, 8, None).astype(np.float32)
    )

    c = packmm_to_packed(a, bp, 8)
    np.testing.assert_array_equal(
        np.asarray(unpack_rows(c)), bitmm_np(qa, qb, 8, 8, 8)
    )
    # padded rows/lanes of the signed output must be level 0 (0x80)
    w = np.asarray(c.words)[0]
    assert (w[M:, :] == -128).all() and (w[:, N:] == -128).all()

    cd = packmm_to_digits(a, bp, 4, shift=2)
    np.testing.assert_array_equal(
        np.asarray(digit_unpack(cd)), bitmm_np(qa, qb, 8, 8, 4, shift=2)
    )
    # digit-output pads stay level 0 for chain safety
    dg = np.asarray(cd.digits)
    assert (dg[:, M:, :] == 0).all() and (dg[:, :, N:] == 0).all()

    # low-bit packed output from a signed A
    c2 = packmm_to_packed(a, bp, 2)
    np.testing.assert_array_equal(
        np.asarray(unpack_rows(c2)), bitmm_np(qa, qb, 8, 8, 2)
    )


@pytest.mark.parametrize("N", [512, 300])
def test_packmm_wide_n_multi_tile(rng, N):
    """N wider than one 128-column group — regression for
    the out_cols refactor slicing a tn-wide block at np_ width."""
    qa = rng.integers(0, 2, (512, 512)).astype(np.int32)
    qb = rng.integers(0, 4, (512, N)).astype(np.int32)
    a = pack_rows(jnp.asarray(qa), 1)
    b = digit_pack(jnp.asarray(qb), 2)
    c = packmm_to_packed(a, b, 2)
    np.testing.assert_array_equal(
        np.asarray(unpack_rows(c)), bitmm_np(qa, qb, 1, 2, 2)
    )
    f = packmm_to_f32(a, b)
    np.testing.assert_array_equal(
        np.asarray(f), bitmm_np(qa, qb, 1, 2, None).astype(np.float32)
    )


@pytest.mark.parametrize("bits", [1, 2, 3, 4])
def test_packed_layout_contract(rng, bits):
    """Word (m, w) holds column ``w * (32 // f) + j`` of row m in bits
    ``[f*j, f*(j+1))`` (f = field width): 32 K-values per word at
    1 bit, like the reference's packers (``kernel.h:204-242``)."""
    from qgtc_ppopp22.ops.packmm import field_width

    f = field_width(bits)
    vpw = 32 // f
    q = rng.integers(0, 1 << bits, (40, 3 * vpw + 5))
    words = pack_rows_np(q, bits)[0].view(np.uint32)
    for m, k in ((0, 0), (7, vpw - 1), (39, vpw + 1), (13, 3 * vpw + 4)):
        w, j = divmod(k, vpw)
        assert (int(words[m, w]) >> (f * j)) & ((1 << f) - 1) == q[m, k]


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_tile_counts_match_brute_force(rng, bits):
    """Pack-time zero-tile counts == a direct scan of the levels."""
    q = rng.integers(0, 1 << bits, (512, 768)) * (
        rng.random((2, 1, 3, 1)) < 0.5
    ).repeat(256, 1).repeat(256, 3).reshape(512, 768)
    kidx, kcnt = build_tile_map_packed_np(pack_rows_np(q, bits), bits)
    tiles = q.reshape(2, 256, 3, 256).any(axis=(1, 3))
    np.testing.assert_array_equal(kcnt, tiles.sum(axis=1))
    for i in range(2):
        np.testing.assert_array_equal(
            kidx[i, : kcnt[i]], np.nonzero(tiles[i])[0]
        )
