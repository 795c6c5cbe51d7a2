"""Arbitrary-bit GEMM on int8 digit planes.

Equivalent of the reference's BMMA GEMM family (``QGTC_layer_hidden``
/ ``_col`` / ``QGTC_layer_output_*``, ``kernel.h:245-391, 651-1054``)
on the :class:`~qgtc_ppopp22.ops.digits.DigitTensor` compute format,
through the plain XLA route (``ops/intmm.py``):

* ``C = sum_{d<nd_a, e<nd_b} dot(A_d, B_e) << 4*(d+e)``, int8 passes
  with int32 accumulation, exact integer math.
* The reference's fused epilogue (``kernel.h:347-389``): requantize the
  accumulator to ``out_bits`` and split back into digit planes, or
  emit raw float32 for the output layer (``bitMM2Int`` semantics,
  ``kernel.h:920-930``).

Both operands use one orientation (``[nd, rows, cols]``, contraction =
lhs cols x rhs rows), so any output composes as either operand of a
following multiply: the reference's row/col-major split (``bitMM2Bit``
vs ``bitMM2Bit_col``, ``QGTC_device.cu:223, 456``) exists only because
BMMA demands a col-major B fragment.
"""

from __future__ import annotations

import jax.numpy as jnp

from qgtc_ppopp22.ops.digits import DigitTensor
from qgtc_ppopp22.ops.intmm import plain_mm, requant_digits

__all__ = ["digitmm_to_digits", "digitmm_to_f32", "digitmm_to_i32"]


def _acc(a: DigitTensor, b: DigitTensor) -> jnp.ndarray:
    M, Ka = a.shape
    Kb, N = b.shape
    if Ka != Kb:
        raise ValueError(f"contraction mismatch: {a.shape} @ {b.shape}")
    return plain_mm(a.digits, b.digits, M, Ka, N)


def digitmm_to_digits(
    a: DigitTensor, b: DigitTensor, out_bits: int, shift: int = 0
) -> DigitTensor:
    """Digit-domain GEMM, digit-domain output (``bitMM2Bit`` role).

    ``C_levels = requantize(A_levels @ B_levels >> shift, out_bits)``,
    returned as digit planes (``shift=0`` is the exact reference
    semantics).
    """
    digits = requant_digits(_acc(a, b), out_bits, shift)
    return DigitTensor(
        digits=digits, shape=(a.shape[0], b.shape[1]), bits=out_bits
    )


def digitmm_to_f32(a: DigitTensor, b: DigitTensor) -> jnp.ndarray:
    """Digit-domain GEMM, float32 output (``bitMM2Int`` role)."""
    return _acc(a, b)[: a.shape[0], : b.shape[1]].astype(jnp.float32)


def digitmm_to_i32(a: DigitTensor, b: DigitTensor) -> jnp.ndarray:
    """Digit-domain GEMM, raw int32 accumulator, zero-padded to the
    digit-plane extents (``ops/intmm.pad_width``).

    For partial sums combined *outside* the GEMM (ring aggregation
    shards, ``parallel/sharded.py``): int32 end to end, so exactness
    never depends on the f32 24-bit mantissa bound.
    """
    return _acc(a, b)
