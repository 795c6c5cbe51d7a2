"""Digit-domain working format: int8 base-16 digit planes.

Two formats, after the reference's packed layouts:

* **Storage / transfer format**: packed uint32 bit-planes
  (:class:`~qgtc_ppopp22.ops.bitpack.BitTensor`, 8-32x smaller than
  int8 values). This matches the reference's packed layouts
  (``kernel.h:75-242``) and its epoch-timing boundary, which transfers
  packed tensors per step (``main_qgtc.py:115``).
* **Compute format**: int8 *digit* planes (this module). ``digits[d]``
  holds base-16 digit ``d`` of the quantized levels, so a w-bit x
  a-bit GEMM is ``ceil(w/4) * ceil(a/4)`` int8 tensor-core passes:
  ``C = sum_{d,e} dot(A_d, B_e) << 4*(d+e)`` (``ops/intmm.py``), exact
  integer arithmetic (digit values < 16, products < 256, int32
  accumulation).

The reference computes straight from packed bits because Ampere's
``bmma_sync`` consumes b1 fragments (``kernel.h:301-335``); here the
packed adjacency is unpacked to int8 0/1 before its dot
(``ops/packmm.py``), and every other operand is converted to digits
once and reused across its GEMMs.

Digit tensors are zero-padded to multiples of 16 in both dimensions
(``ops/intmm.DIGIT_PAD``); zero padding is exact (level-0 rows/cols
contribute nothing and requantize to 0).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from qgtc_ppopp22.ops.bitpack import (
    DIGIT_BITS,
    BitTensor,
    num_digits,
    unpack_plane_words,
)
from qgtc_ppopp22.ops.intmm import levels_to_digits, pad_width

__all__ = [
    "DigitTensor",
    "to_digit_tensor",
    "digit_pack",
    "digit_unpack",
]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DigitTensor:
    """A logically (M, K) integer-level matrix as int8 digit planes.

    ``digits``: int8[ndigits, Mp, Kp] with Mp/Kp = next multiple of
    16; digit ``d`` holds bits ``4d .. 4d+3`` of each level.
    """

    digits: jax.Array
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    bits: int = dataclasses.field(metadata=dict(static=True))

    @property
    def ndigits(self) -> int:
        return self.digits.shape[0]

    @property
    def padded_rows(self) -> int:
        return self.digits.shape[1]

    @property
    def padded_cols(self) -> int:
        return self.digits.shape[2]

    def nbytes(self) -> int:
        return self.digits.size


def to_digit_tensor(bt: BitTensor) -> DigitTensor:
    """Packed bit-planes -> digit planes (one elementwise pass).

    The padded 256-multiple extents of the packed container are
    trimmed to 16 multiples (the trimmed region is zero padding).
    """
    M, K = bt.shape
    Mp, Kp = pad_width(M), pad_width(K)
    ones = unpack_plane_words(bt.planes)  # [bits, Mw*32, Kp256]
    nd = num_digits(bt.bits)
    out = []
    for d in range(nd):
        lo = d * DIGIT_BITS
        hi = min(lo + DIGIT_BITS, bt.bits)
        acc = ones[lo]
        for b in range(lo + 1, hi):
            acc = acc | (ones[b] << jnp.uint32(b - lo))
        out.append(acc[:Mp, :Kp].astype(jnp.int8))
    return DigitTensor(digits=jnp.stack(out), shape=(M, K), bits=bt.bits)


def digit_pack(q: jnp.ndarray, bits: int) -> DigitTensor:
    """Integer levels (M, K) -> digit planes directly (no bit packing).

    Like the packers (``kernel.h:204-242``), only the low ``bits``
    bits of each level are kept (level ``2^bits`` wraps to 0).
    """
    M, K = q.shape
    Mp, Kp = pad_width(M), pad_width(K)
    q = jnp.pad(
        q.astype(jnp.int32) & ((1 << bits) - 1),
        ((0, Mp - M), (0, Kp - K)),
    )
    return DigitTensor(
        digits=levels_to_digits(q, bits), shape=(M, K), bits=bits
    )


def digit_unpack(dt: DigitTensor) -> jnp.ndarray:
    """Digit planes -> int32 levels (M, K)."""
    M, K = dt.shape
    vals = jnp.zeros(dt.digits.shape[1:], jnp.int32)
    for d in range(dt.ndigits):
        vals = vals + (
            dt.digits[d].astype(jnp.int32) << (d * DIGIT_BITS)
        )
    return vals[:M, :K]
