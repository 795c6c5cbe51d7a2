"""NumPy golden model of the reference's integer semantics.

Independent re-statement of the CUDA reference's math used to validate
the GEMM routes by exact integer equality:

* ``quantize_np``   -- ``Quantize_val`` + ``clip`` (``kernel.h:31-71``)
* ``requantize_np`` -- epilogue ``quantize(val, ob, 1<<ob, 0)``
  reduction (``kernel.h:347-351``)
* ``effective_levels`` -- the pack step keeps only the low ``bits``
  planes (``kernel.h:226-229``), wrapping level ``2^bits`` to 0
* ``bitmm_np``      -- the bit-plane GEMM is algebraically an integer
  matmul of effective levels (``kernel.h:292-342``)
"""

import numpy as np


def quantize_np(x, bits):
    ub = float(1 << bits)
    x = np.asarray(x, np.float32)
    clipped = np.where(x < 0.0, 1.0, np.where(x > ub, ub - 1.0, x))
    # np.round is round-half-to-even, same as CUDA __float2int_rn.
    return np.round(clipped).astype(np.int32)


def effective_levels(q, bits):
    return np.asarray(q, np.int64) & ((1 << bits) - 1)


def requantize_np(acc, out_bits, shift=0):
    ub = 1 << out_bits
    acc = np.asarray(acc, np.int64)
    if shift:
        acc = acc >> shift
    return np.where(acc > ub, ub - 1, np.where(acc < 0, 1, acc))


def bitmm_np(qa, qb, a_bits, b_bits, out_bits=None, shift=0):
    """Integer matmul of effective levels; requantized+wrapped if out_bits."""
    ea = effective_levels(qa, a_bits)
    eb = effective_levels(qb, b_bits)
    acc = ea @ eb
    if out_bits is None:
        return acc.astype(np.float32)
    return effective_levels(requantize_np(acc, out_bits, shift), out_bits)
