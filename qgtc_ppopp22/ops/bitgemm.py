"""Arbitrary-bit GEMM on packed bit-planes (reference ``bitMM2Bit`` /
``bitMM2Int`` binding role, ``QGTC_device.cu:211-266, 441-489``).

The reference computes ``C = sum_{i<a_bit, j<w_bit} (A_i AND B_j) <<
(i+j)`` as ``a_bit*w_bit`` 1-bit BMMA passes (``kernel.h:245-391``).
Here both :class:`BitTensor` operands are regrouped into base-16 digit
planes and run through the plain XLA route (``ops/intmm.py``): at most
4 int8 passes for 8-bit x 8-bit, exact integer math. The requantized
output is repacked into bit-planes, as the reference repacks in its
epilogue (``kernel.h:347-389``). There is no row/col layout split: the
container composes as either operand of a following multiply.
"""

from __future__ import annotations

import jax.numpy as jnp

from qgtc_ppopp22.ops.bitpack import BitTensor, pack_bits
from qgtc_ppopp22.ops.digits import to_digit_tensor
from qgtc_ppopp22.ops.intmm import plain_mm, requant_levels

__all__ = ["bitmm_to_bits", "bitmm_to_int", "flops_convention"]


def flops_convention(m: int, n: int, k: int) -> int:
    """Logical FLOPs of a bit-GEMM, reference convention.

    The reference reports ``2*M*N*K`` regardless of bit width
    (``QGTC_device.cu:420-422``); kept for comparability.
    """
    return 2 * m * n * k


def _acc(a: BitTensor, b: BitTensor) -> jnp.ndarray:
    M, Ka = a.shape
    Kb, N = b.shape
    if Ka != Kb:
        raise ValueError(f"contraction mismatch: {a.shape} @ {b.shape}")
    da, db = to_digit_tensor(a), to_digit_tensor(b)
    return plain_mm(da.digits, db.digits, M, Ka, N)


def bitmm_to_bits(a: BitTensor, b: BitTensor, out_bits: int) -> BitTensor:
    """Bit-domain GEMM, bit-domain output (reference ``bitMM2Bit``).

    ``C_levels = requantize(A_levels @ B_levels, out_bits)``, returned
    packed. Unifies the reference's row-major-out ``bitMM2Bit``
    (``QGTC_device.cu:211-266``) and col-major-out ``bitMM2Bit_col``
    (``QGTC_device.cu:441-489``).
    """
    M, N = a.shape[0], b.shape[1]
    levels = requant_levels(_acc(a, b), out_bits)[:M, :N]
    return pack_bits(levels, out_bits)


def bitmm_to_int(a: BitTensor, b: BitTensor) -> jnp.ndarray:
    """Bit-domain GEMM, float32 output (reference ``bitMM2Int``).

    Raw integer accumulator cast to float32, no requantization
    (reference ``kernel.h:920-930``). Used for the output layer.
    """
    return _acc(a, b)[: a.shape[0], : b.shape[1]].astype(jnp.float32)
