import numpy as np
import jax
import jax.numpy as jnp
import pytest

from qgtc_ppopp22.ops.bitpack import pack_bits, unpack_bits
from qgtc_ppopp22.ops.bitgemm import bitmm_to_bits, bitmm_to_int
from qgtc_ppopp22.ops.packmm import build_tile_map_packed_np, pack_rows_np
from tests.golden import bitmm_np


def _rand_levels(rng, shape, bits):
    return rng.integers(0, 1 << bits, size=shape).astype(np.int32)


@pytest.mark.parametrize(
    "a_bits,b_bits,out_bits",
    [(1, 2, 2), (1, 1, 1), (2, 2, 2), (3, 5, 4), (4, 4, 4), (8, 8, 8)],
)
def test_bitmm_to_bits_exact(rng, a_bits, b_bits, out_bits):
    M, K, N = 300, 520, 40
    qa = _rand_levels(rng, (M, K), a_bits)
    qb = _rand_levels(rng, (K, N), b_bits)
    a = pack_bits(jnp.asarray(qa), a_bits)
    b = pack_bits(jnp.asarray(qb), b_bits)
    out = bitmm_to_bits(a, b, out_bits)
    got = np.asarray(unpack_bits(out))
    want = bitmm_np(qa, qb, a_bits, b_bits, out_bits)
    assert (got == want).all()


@pytest.mark.parametrize("a_bits,b_bits", [(1, 2), (2, 2), (8, 8)])
def test_bitmm_to_int_exact(rng, a_bits, b_bits):
    M, K, N = 130, 260, 20
    qa = _rand_levels(rng, (M, K), a_bits)
    qb = _rand_levels(rng, (K, N), b_bits)
    a = pack_bits(jnp.asarray(qa), a_bits)
    b = pack_bits(jnp.asarray(qb), b_bits)
    got = np.asarray(bitmm_to_int(a, b))
    want = bitmm_np(qa, qb, a_bits, b_bits, out_bits=None)
    assert got.shape == (M, N)
    assert (got == want).all()


def test_bitmm_chains_as_either_operand(rng):
    # The output of bitmm_to_bits must compose as lhs AND rhs of a
    # following multiply (the reference needed two separate kernels and
    # layouts for this, QGTC_device.cu:211-266 vs :441-489).
    M, K, N, H = 64, 96, 48, 32
    qa = _rand_levels(rng, (M, K), 2)
    qb = _rand_levels(rng, (K, N), 2)
    qw = _rand_levels(rng, (N, H), 2)
    qs = _rand_levels(rng, (M, M), 1)
    a = pack_bits(jnp.asarray(qa), 2)
    b = pack_bits(jnp.asarray(qb), 2)
    w = pack_bits(jnp.asarray(qw), 2)
    s = pack_bits(jnp.asarray(qs), 1)

    ab = bitmm_to_bits(a, b, 2)
    got_rhs = np.asarray(unpack_bits(bitmm_to_bits(s, ab, 2)))  # ab as rhs
    got_lhs = np.asarray(unpack_bits(bitmm_to_bits(ab, w, 2)))  # ab as lhs

    ab_np = bitmm_np(qa, qb, 2, 2, 2)
    assert (got_rhs == bitmm_np(qs, ab_np, 1, 2, 2)).all()
    assert (got_lhs == bitmm_np(ab_np, qw, 2, 2, 2)).all()


def test_bitmm_sparse_matches_dense(rng):
    # Block-diagonal sparse lhs (the cluster-batch structure): exact.
    M = K = 1024
    N = 16
    qa = np.zeros((M, K), np.int32)
    for blk in range(4):
        s = blk * 256
        qa[s : s + 256, s : s + 256] = rng.integers(0, 2, size=(256, 256))
    qb = _rand_levels(rng, (K, N), 2)
    a = pack_bits(jnp.asarray(qa), 1)
    b = pack_bits(jnp.asarray(qb), 2)

    dense = np.asarray(unpack_bits(bitmm_to_bits(a, b, 2)))
    assert (dense == bitmm_np(qa, qb, 1, 2, 2)).all()

    got_f = np.asarray(bitmm_to_int(a, b))
    assert (got_f == bitmm_np(qa, qb, 1, 2, None)).all()


def test_zero_tile_stats(rng):
    """Pack-time tile counters (reference Fig. 8b study): one occupied
    256x512 tile out of 4 row tiles x 2 K tiles."""
    M = K = 1024
    qa = np.zeros((M, K), np.int32)
    qa[:256, :512] = 1  # one 256x512 tile row occupied
    kidx, kcnt = build_tile_map_packed_np(
        pack_rows_np(qa, 1), 1, tile_m=256, tile_k=512
    )
    assert kidx.size == 8  # 4 row-tiles x 2 k-tiles
    assert int(kcnt.sum()) == 1
    assert kcnt.sum() / kidx.size == pytest.approx(1 / 8)


def test_bitmm_under_jit(rng):
    qa = _rand_levels(rng, (100, 200), 1)
    qb = _rand_levels(rng, (200, 30), 2)
    a = pack_bits(jnp.asarray(qa), 1)
    b = pack_bits(jnp.asarray(qb), 2)

    @jax.jit
    def f(a, b):
        return bitmm_to_int(bitmm_to_bits(a, b, 2), b_w)

    qw = _rand_levels(rng, (30, 8), 2)
    b_w = pack_bits(jnp.asarray(qw), 2)
    got = np.asarray(f(a, b))
    want = bitmm_np(bitmm_np(qa, qb, 1, 2, 2), qw, 2, 2, None)
    assert (got == want).all()
