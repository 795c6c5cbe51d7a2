"""Bit-plane storage container and pack/unpack ops.

The reference keeps three packed uint32 layouts, all packing 32
*K-elements* per word via warp ballots (row-major activation layout
``kernel.h:204-242``, col-major weight layouts ``kernel.h:75-106``,
decoders ``kernel.h:109-201``); the row/col asymmetry exists only
because Ampere BMMA requires a col-major B fragment.

Here one canonical form serves both GEMM operands:

    planes : uint32[bits, Mw, Kp]      Mw = ceil(M/32), Kp = pad256(K)

Word ``planes[b, w, k]`` packs bit-plane ``b`` of logical elements
``(32*w + j, k)`` for ``j in [0, 32)``, little-endian (bit ``j`` of the
word = row ``32*w + j``). The left operand packs its M rows, the right
operand its K rows, so any tensor composes as either operand.

Padding: both M and K are padded to multiples of 256 with zeros, so a
tensor's columns line up with the packed rows of the next GEMM's right
operand without re-padding. Zero rows/columns are exact no-ops in the
GEMM (0-level rows produce 0 accumulators, and ``requantize(0) == 0``),
so padded regions are sliced off at unpack.

Thin wrappers ``val2bit`` / ``bit2val`` keep the reference's call shape
for parity (reference ``QGTC_host.cpp:259-271``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from qgtc_ppopp22.ops.quantize import quantize

ROWS_PER_WORD = 32  # logical rows packed per uint32 word
ROW_PAD = 256  # rows padded to whole 256-row tiles
# K is padded to ROW_PAD too: a tensor's columns must line up with the
# packed *rows* of the next GEMM's right operand, so both dimensions
# share the 256 padding and every BitTensor composes as either operand
# without re-padding.
COL_PAD = ROW_PAD  # 256
DIGIT_BITS = 4  # base-16 digit decomposition for the int8 GEMM path


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def num_digits(bits: int) -> int:
    """Number of base-16 digits covering ``bits`` bit-planes."""
    return -(-bits // DIGIT_BITS)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BitTensor:
    """A logically (M, K) integer matrix stored as packed bit-planes."""

    planes: jax.Array = dataclasses.field()  # uint32[bits, Mw, Kp]
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    bits: int = dataclasses.field(metadata=dict(static=True))

    def __post_init__(self):
        if isinstance(self.planes, jax.Array) or hasattr(self.planes, "shape"):
            b, mw, kp = self.planes.shape
            assert b == self.bits, (b, self.bits)

    @property
    def padded_rows(self) -> int:
        return self.planes.shape[1] * ROWS_PER_WORD

    @property
    def padded_cols(self) -> int:
        return self.planes.shape[2]

    def nbytes(self) -> int:
        return self.planes.size * 4


def pack_bits(q: jnp.ndarray, bits: int) -> BitTensor:
    """int levels (M, K) -> packed bit-planes.

    Keeps only the low ``bits`` bit-planes, exactly like the reference
    packer (``kernel.h:226-229``) -- a level of ``2^bits`` wraps to 0.
    """
    M, K = q.shape
    Mp = round_up(max(M, 1), ROW_PAD)
    Kp = round_up(max(K, 1), COL_PAD)
    q = jnp.pad(q.astype(jnp.uint32), ((0, Mp - M), (0, Kp - K)))
    # [bits, Mp, Kp] bit-planes.
    b_idx = jnp.arange(bits, dtype=jnp.uint32)[:, None, None]
    planes = (q[None] >> b_idx) & jnp.uint32(1)
    # Pack 32 rows per word.
    planes = planes.reshape(bits, Mp // ROWS_PER_WORD, ROWS_PER_WORD, Kp)
    j_idx = jnp.arange(ROWS_PER_WORD, dtype=jnp.uint32)[None, None, :, None]
    words = jnp.sum(planes << j_idx, axis=2, dtype=jnp.uint32)
    return BitTensor(planes=words, shape=(M, K), bits=bits)


def unpack_plane_words(words: jnp.ndarray) -> jnp.ndarray:
    """uint32[..., Mw, Kp] -> uint32[..., Mw*32, Kp] of 0/1 bits
    (the inverse of the row-packing above)."""
    *lead, mw, kp = words.shape
    j_idx = jnp.arange(ROWS_PER_WORD, dtype=jnp.uint32).reshape(
        (1,) * len(lead) + (1, ROWS_PER_WORD, 1)
    )
    bits = (words[..., :, None, :] >> j_idx) & jnp.uint32(1)
    return bits.reshape(*lead, mw * ROWS_PER_WORD, kp)


def unpack_bits(bt: BitTensor) -> jnp.ndarray:
    """Packed bit-planes -> int32 levels (M, K).

    Equivalent of the reference decoders ``UnPackFcOutput128`` /
    ``UnPackFcWeight128`` (``kernel.h:109-201``): accumulate
    ``plane_b << b``.
    """
    M, K = bt.shape
    ones = unpack_plane_words(bt.planes)  # [bits, Mp, Kp]
    b_idx = jnp.arange(bt.bits, dtype=jnp.uint32)[:, None, None]
    vals = jnp.sum(ones << b_idx, axis=0, dtype=jnp.uint32).astype(jnp.int32)
    return vals[:M, :K]


def to_digits(bt: BitTensor) -> jnp.ndarray:
    """Packed bit-planes -> int8 base-16 digits [ndigits, Mp, Kp].

    Digit ``d`` gathers planes ``4d .. 4d+3``. Values per digit are
    < 16, so the int8 GEMM path is exact.
    """
    nd = num_digits(bt.bits)
    ones = unpack_plane_words(bt.planes)  # [bits, Mp, Kp]
    digits = []
    for d in range(nd):
        lo = d * DIGIT_BITS
        hi = min(lo + DIGIT_BITS, bt.bits)
        acc = jnp.zeros(ones.shape[1:], jnp.uint32)
        for b in range(lo, hi):
            acc = acc | (ones[b] << jnp.uint32(b - lo))
        digits.append(acc.astype(jnp.int8))
    return jnp.stack(digits)


def pack_bits_np(q, bits: int) -> BitTensor:
    """Host-side (NumPy) packer producing the same container as
    :func:`pack_bits`, without touching a device.

    The data pipeline pre-quantizes and pre-packs every cluster batch
    at init (like the reference's ``ClusterIter.__init__`` pre-packing,
    ``sampler.py:76-106``) and parks the packed planes host-side; the
    per-step host->device transfer of the *packed* form is the timed
    H2D boundary, mirroring the reference's epoch-timing boundary
    (``main_qgtc.py:115``).
    """
    import numpy as np

    q = np.asarray(q)
    M, K = q.shape
    Mp = round_up(max(M, 1), ROW_PAD)
    Kp = round_up(max(K, 1), COL_PAD)
    qq = np.zeros((Mp, Kp), np.uint32)
    qq[:M, :K] = q.astype(np.int64) & np.int64((1 << bits) - 1)
    b_idx = np.arange(bits, dtype=np.uint32)[:, None, None]
    planes = (qq[None] >> b_idx) & np.uint32(1)
    planes = planes.reshape(bits, Mp // ROWS_PER_WORD, ROWS_PER_WORD, Kp)
    j_idx = np.arange(ROWS_PER_WORD, dtype=np.uint32)[None, None, :, None]
    words = np.bitwise_or.reduce(
        (planes << j_idx).astype(np.uint32), axis=2
    )
    return BitTensor(planes=words, shape=(M, K), bits=bits)


def val2bit(x: jnp.ndarray, bits: int) -> BitTensor:
    """float (M, K) -> quantize -> packed bit-planes.

    Parity wrapper for the reference op ``QGTC.val2bit``
    (``QGTC_host.cpp:229-238`` -> ``QGTC_device.cu:44-130``). The
    reference's ``col_major`` / ``output_layer`` layout flags are
    unnecessary here: the container has one canonical layout.
    """
    return pack_bits(quantize(x, bits), bits)


def bit2val(bt: BitTensor) -> jnp.ndarray:
    """Packed bit-planes -> float32 levels (reference ``QGTC.bit2val``)."""
    return unpack_bits(bt).astype(jnp.float32)
