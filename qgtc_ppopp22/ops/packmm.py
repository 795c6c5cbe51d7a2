"""Packed-operand GEMM: a bit-packed left operand, unpacked for the dot.

Equivalent of the reference's packed-operand BMMA kernels
(``QGTC_layer_hidden`` family, ``kernel.h:245-391``). Ampere's
``bmma_sync`` consumes packed 1-bit fragments; the tensor cores here
take int8, so the left operand travels packed (8/field-bits x fewer
bytes than int8) and is unpacked to int8 digit planes for the dot.

Layout (:class:`PackedTensor`): values are packed along K, ``32 // f``
values per int32 word (f = field bits: 1 for 1-bit, 2 for 2-bit, 4 for
3-4 bits), like the reference's 32 K-values per uint32
(``kernel.h:204-242``): word ``words[0, m, w]`` holds column
``w * (32 // f) + j`` of row ``m`` in bits ``[f*j, f*(j+1))``. Bits
5-8 store ONE offset-signed byte plane instead (``packed_signed``).

Every GEMM here takes the plain XLA route (``ops/intmm.py``). XLA fuses
the unpack into one elementwise pass and, inside a jitted forward,
unpacks the adjacency once for all of its aggregations.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from qgtc_ppopp22.ops.bitpack import DIGIT_BITS, ROW_PAD, round_up
from qgtc_ppopp22.ops.digits import DigitTensor
from qgtc_ppopp22.ops.intmm import (
    SIGNED_OFFSET,
    plain_mm,
    requant_digits,
    requant_levels,
)

__all__ = [
    "PackedTensor",
    "field_width",
    "packed_signed",
    "pack_rows",
    "pack_rows_np",
    "pack_digit_tensor",
    "unpack_rows",
    "to_digit_planes",
    "packmm_to_f32",
    "packmm_to_i32",
    "packmm_to_digits",
    "packmm_to_packed",
    "build_tile_map_packed_np",
]

COL_ALIGN = 128  # packed K is padded to whole 128-column groups
TILE = 256  # zero-tile statistics granularity (rows and columns)


def field_width(bits: int) -> int:
    """Packed field bits per value.

    Bits 5-8 use ONE full-byte *signed* plane (``packed_signed``):
    stored byte = ``level ^ 0x80`` = two's-complement ``level - 128``.
    A GEMM against it is a single int8 pass plus an exact rank-1
    correction ``+ 128 * colsum(B_levels)`` (``ops/intmm.plain_mm``),
    instead of the 2 x nd_b passes of two base-16 digit planes.
    """
    if bits <= 2:
        return bits
    if bits <= DIGIT_BITS:
        return DIGIT_BITS
    return 8


def packed_signed(bits: int) -> bool:
    """True when the packed layout for ``bits`` is the single
    offset-signed byte plane (bits 5-8)."""
    return field_width(bits) == 8


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PackedTensor:
    """(M, K) integer levels, bit-packed along K.

    ``words``: int32[1, Mp, Kp // (32 // f)]; Mp = round_up(M, 256),
    Kp = round_up(K, 128), f = field_width(bits). Bits 5-8
    (``packed_signed``) store **int8[1, Mp, Kp]** offset-signed bytes
    (``level ^ 0x80`` = ``level - 128``): at a byte per value there is
    nothing left to pack.
    """

    words: jax.Array
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    bits: int = dataclasses.field(metadata=dict(static=True))

    @property
    def values_per_word(self) -> int:
        return 1 if packed_signed(self.bits) else 32 // field_width(self.bits)

    @property
    def padded_rows(self) -> int:
        return self.words.shape[1]

    @property
    def padded_cols(self) -> int:
        return self.words.shape[2] * self.values_per_word

    def nbytes(self) -> int:
        return self.words.size * self.words.dtype.itemsize


def _padded(M: int, K: int) -> Tuple[int, int]:
    return round_up(max(M, 1), ROW_PAD), round_up(max(K, 1), COL_ALIGN)


def pack_rows_np(q: np.ndarray, bits: int) -> np.ndarray:
    """Host-side packer: int levels (M, K) -> the :class:`PackedTensor`
    payload (int32 words, or int8 bytes for bits 5-8)."""
    M, K = q.shape
    Mp, Kp = _padded(M, K)
    lv = np.zeros((Mp, Kp), np.uint32)
    lv[:M, :K] = q.astype(np.int64) & np.int64((1 << bits) - 1)
    if packed_signed(bits):
        return (lv ^ np.uint32(SIGNED_OFFSET)).astype(np.uint8).view(
            np.int8
        )[None]
    f = field_width(bits)
    vpw = 32 // f
    shifts = (f * np.arange(vpw, dtype=np.uint32))[None, None, :]
    words = np.bitwise_or.reduce(
        lv.reshape(Mp, Kp // vpw, vpw) << shifts, axis=2
    ).astype(np.uint32)
    return words.view(np.int32)[None]


def pack_rows(q: jnp.ndarray, bits: int) -> PackedTensor:
    """Device packer: int levels (M, K) -> :class:`PackedTensor`."""
    M, K = q.shape
    Mp, Kp = _padded(M, K)
    lv = jnp.pad(
        q.astype(jnp.uint32) & jnp.uint32((1 << bits) - 1),
        ((0, Mp - M), (0, Kp - K)),
    )
    if packed_signed(bits):
        sb = (lv ^ jnp.uint32(SIGNED_OFFSET)).astype(jnp.uint8)
        words = jax.lax.bitcast_convert_type(sb, jnp.int8)
    else:
        f = field_width(bits)
        vpw = 32 // f
        shifts = f * jnp.arange(vpw, dtype=jnp.uint32)
        # distinct bit positions: the sum is the bitwise or
        words = jnp.sum(
            lv.reshape(Mp, Kp // vpw, vpw) << shifts, axis=2,
            dtype=jnp.uint32,
        )
        words = jax.lax.bitcast_convert_type(words, jnp.int32)
    return PackedTensor(words=words[None], shape=(M, K), bits=bits)


def to_digit_planes(pt: PackedTensor) -> jnp.ndarray:
    """PackedTensor -> int8[1, Mp, Kp]: the single digit plane for bits
    1-4, or the offset-signed byte plane itself for bits 5-8."""
    if packed_signed(pt.bits):
        return pt.words
    f = field_width(pt.bits)
    vpw = 32 // f
    _, mp, kw = pt.words.shape
    shifts = f * jnp.arange(vpw, dtype=jnp.int32)
    vals = (pt.words[..., None] >> shifts) & ((1 << f) - 1)
    return vals.reshape(1, mp, kw * vpw).astype(jnp.int8)


def pack_digit_tensor(dt: DigitTensor) -> PackedTensor:
    """DigitTensor -> PackedTensor (device op)."""
    from qgtc_ppopp22.ops.digits import digit_unpack

    return pack_rows(digit_unpack(dt), dt.bits)


def unpack_rows(pt: PackedTensor) -> jnp.ndarray:
    """PackedTensor -> int32 levels (M, K)."""
    M, K = pt.shape
    plane = to_digit_planes(pt)[0]
    if packed_signed(pt.bits):
        plane = jax.lax.bitcast_convert_type(plane, jnp.uint8) ^ jnp.uint8(
            SIGNED_OFFSET
        )
    return plane.astype(jnp.int32)[:M, :K]


def build_tile_map_packed_np(
    words: np.ndarray, bits: int, tile_m: int = TILE, tile_k: int = TILE
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side (NumPy) zero-tile schedule ``(kidx, kcnt)`` over a
    packed payload, built once at pack time: ``kidx[i, :kcnt[i]]``
    lists the K tiles of row tile ``i`` that hold a nonzero (the tail
    repeats the last valid index). ``kcnt`` feeds the zero-tile
    counters (the reference's Fig. 8b study, ``kernel.h:394-648``)."""
    vpw = 1 if packed_signed(bits) else 32 // field_width(bits)
    nd, mp, kw = words.shape
    kp = kw * vpw
    if mp % tile_m or kp % tile_k or tile_k % vpw:
        raise ValueError((tile_m, tile_k, mp, kp))
    nm, nk = mp // tile_m, kp // tile_k
    tiles = words.reshape(nd, nm, tile_m, nk, tile_k // vpw)
    # signed planes encode level 0 as byte -128 (0x80)
    zw = np.int8(-128) if packed_signed(bits) else np.int32(0)
    occ = np.any(tiles != zw, axis=(0, 2, 4))
    kcnt = np.sum(occ, axis=1).astype(np.int32)
    order = np.argsort(~occ, axis=1, kind="stable").astype(np.int32)
    t = np.arange(nk, dtype=np.int32)[None, :]
    clamp = np.minimum(t, np.maximum(kcnt - 1, 0)[:, None])
    kidx = np.take_along_axis(order, clamp, axis=1)
    return kidx, kcnt


# ---------------------------------------------------------------------------
# GEMM
# ---------------------------------------------------------------------------


def _acc(a: PackedTensor, b: DigitTensor) -> jnp.ndarray:
    M, Ka = a.shape
    Kb, N = b.shape
    if Ka != Kb:
        raise ValueError(f"contraction mismatch: {a.shape} @ {b.shape}")
    return plain_mm(
        to_digit_planes(a), b.digits, M, Ka, N,
        signed_a=packed_signed(a.bits),
    )


def packmm_to_f32(a: PackedTensor, b: DigitTensor) -> jnp.ndarray:
    """Packed-A GEMM, float32 output [M, N] (``bitMM2Int`` role,
    ``kernel.h:816-1054``)."""
    return _acc(a, b)[: a.shape[0], : b.shape[1]].astype(jnp.float32)


def packmm_to_i32(a: PackedTensor, b: DigitTensor) -> jnp.ndarray:
    """Packed-A GEMM, raw int32 accumulator padded to the digit-plane
    extents. For partial sums combined *outside* the GEMM (the packed
    ring aggregation shards, ``parallel/packed.py``): int32 end to end,
    so exactness never depends on the f32 24-bit mantissa bound."""
    return _acc(a, b)


def packmm_to_digits(
    a: PackedTensor, b: DigitTensor, out_bits: int, shift: int = 0
) -> DigitTensor:
    """Packed-A GEMM, digit-plane output (``bitMM2Bit`` role with the
    requant epilogue, ``kernel.h:347-389``)."""
    return DigitTensor(
        digits=requant_digits(_acc(a, b), out_bits, shift),
        shape=(a.shape[0], b.shape[1]),
        bits=out_bits,
    )


def packmm_to_packed(
    a: PackedTensor, b: DigitTensor, out_bits: int, shift: int = 0
) -> PackedTensor:
    """Packed-A GEMM, packed output: bit in, bit out, the shape of the
    reference's ``bitMM2Bit_profile`` benchmark op
    (``QGTC_device.cu:379-434``): requantize, then repack."""
    M, N = a.shape[0], b.shape[1]
    levels = requant_levels(_acc(a, b), out_bits, shift)[:M, :N]
    return pack_rows(levels, out_bits)
