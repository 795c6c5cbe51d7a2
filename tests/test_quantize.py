import numpy as np
import jax.numpy as jnp
import pytest

from qgtc_ppopp22.ops.quantize import quantize, requantize
from tests.golden import quantize_np, requantize_np


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_quantize_matches_golden(rng, bits):
    x = rng.normal(0.0, (1 << bits), size=(64, 33)).astype(np.float32)
    got = np.asarray(quantize(jnp.asarray(x), bits))
    assert (got == quantize_np(x, bits)).all()


def test_quantize_edge_rules():
    # kernel.h:39-44: below lb -> lb+1 (=1), above ub -> ub-1.
    x = jnp.asarray([-5.0, -0.001, 0.0, 4.0, 4.001, 100.0])
    got = np.asarray(quantize(x, 2))
    assert got.tolist() == [1, 1, 0, 4, 3, 3]


def test_quantize_round_half_even():
    x = jnp.asarray([0.5, 1.5, 2.5, 3.5])
    assert np.asarray(quantize(x, 3)).tolist() == [0, 2, 2, 4]


@pytest.mark.parametrize("out_bits", [1, 2, 4, 8])
def test_requantize_matches_golden(rng, out_bits):
    acc = rng.integers(-10, 5000, size=(32, 16)).astype(np.int32)
    got = np.asarray(requantize(jnp.asarray(acc), out_bits))
    assert (got == requantize_np(acc, out_bits)).all()


def test_requantize_edges():
    # exactly 2^ob passes through (wraps to 0 at pack), above clamps.
    acc = jnp.asarray([-1, 0, 3, 4, 5, 1000])
    assert np.asarray(requantize(acc, 2)).tolist() == [1, 0, 3, 4, 3, 3]
