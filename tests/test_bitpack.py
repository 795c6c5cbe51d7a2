import numpy as np
import jax.numpy as jnp
import pytest

from qgtc_ppopp22.ops.bitpack import (
    ROW_PAD,
    COL_PAD,
    BitTensor,
    pack_bits,
    unpack_bits,
    val2bit,
    bit2val,
    to_digits,
)
from tests.golden import effective_levels, quantize_np


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("shape", [(1, 1), (32, 128), (300, 70), (257, 513)])
def test_pack_unpack_roundtrip(rng, bits, shape):
    q = rng.integers(0, 1 << bits, size=shape).astype(np.int32)
    bt = pack_bits(jnp.asarray(q), bits)
    assert bt.planes.dtype == jnp.uint32
    assert bt.planes.shape[0] == bits
    assert bt.planes.shape[1] % 8 == 0
    assert bt.planes.shape[2] % COL_PAD == 0
    got = np.asarray(unpack_bits(bt))
    assert got.shape == shape
    assert (got == q).all()


def test_pack_wraps_high_levels():
    # Level 2^bits wraps to 0 (only low planes kept), kernel.h:226-229.
    q = jnp.asarray([[4, 3, 7, 8]], jnp.int32)
    bt = pack_bits(q, 2)
    assert np.asarray(unpack_bits(bt)).tolist() == [[0, 3, 3, 0]]


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_val2bit_bit2val(rng, bits):
    x = rng.normal(0.0, (1 << bits), size=(100, 40)).astype(np.float32)
    bt = val2bit(jnp.asarray(x), bits)
    got = np.asarray(bit2val(bt))
    want = effective_levels(quantize_np(x, bits), bits).astype(np.float32)
    assert (got == want).all()


@pytest.mark.parametrize("bits,nd", [(1, 1), (4, 1), (5, 2), (8, 2)])
def test_to_digits(rng, bits, nd):
    q = rng.integers(0, 1 << bits, size=(64, 32)).astype(np.int32)
    bt = pack_bits(jnp.asarray(q), bits)
    digits = np.asarray(to_digits(bt))
    assert digits.shape[0] == nd
    assert digits.dtype == np.int8
    recon = sum(
        digits[d].astype(np.int64) << (4 * d) for d in range(nd)
    )
    M, K = q.shape
    assert (recon[:M, :K] == q).all()
    assert (digits >= 0).all() and (digits < 16).all()


def test_bittensor_is_pytree():
    import jax

    bt = pack_bits(jnp.ones((8, 8), jnp.int32), 2)
    leaves, treedef = jax.tree_util.tree_flatten(bt)
    assert len(leaves) == 1
    bt2 = jax.tree_util.tree_unflatten(treedef, leaves)
    assert bt2.shape == bt.shape and bt2.bits == bt.bits

    # must be able to pass through jit
    @jax.jit
    def f(t: BitTensor):
        return unpack_bits(t)

    assert f(bt).shape == (8, 8)
