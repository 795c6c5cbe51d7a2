"""The plain XLA route that every quantized GEMM takes.

A w-bit x a-bit GEMM on quantized levels is split into base-16 digit
planes (values < 16, exact in int8) and computed as

    C = sum_{d,e} dot(A_d, B_e) << 4*(d+e)

with one int8 x int8 -> int32 ``lax.dot_general`` per digit pair (at
most 4 passes for 8-bit x 8-bit, against the reference's 64 1-bit BMMA
passes, ``kernel.h:292-342``). The epilogue is the reference's
requantizer and the digit split (``kernel.h:347-389``) written in
``jnp``; XLA fuses it with the GEMM's consumers. Everything here is
exact integer arithmetic.

The operand containers (``ops/digits.py``, ``ops/packmm.py``,
``ops/bitpack.py``) unpack themselves to int8 digit planes and call
:func:`plain_mm`. It slices the N side (features, hidden, classes) to
its logical width rounded up to :data:`DIGIT_PAD` before the dot, so a
16-wide hidden GEMM stays 16 wide whatever the storage padding is.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from qgtc_ppopp22.ops.bitpack import DIGIT_BITS, num_digits, round_up

__all__ = [
    "DIGIT_PAD",
    "SIGNED_OFFSET",
    "pad_width",
    "check_accumulator",
    "digit_dot",
    "requant_levels",
    "levels_to_digits",
    "requant_digits",
    "plain_mm",
]

DIGIT_PAD = 16  # digit-plane extents are padded to multiples of 16
SIGNED_OFFSET = 128  # offset-signed byte plane: stored byte = level - 128

_DOT = (((1,), (0,)), ((), ()))


def pad_width(n: int) -> int:
    """Logical extent rounded up to the digit-plane padding."""
    return round_up(max(int(n), 1), DIGIT_PAD)


def check_accumulator(nd_a: int, nd_b: int, k: int, signed_a=False):
    """Refuse contractions whose int32 accumulator could overflow.

    The worst-case shifted digit product is ``sum_{d,e} 15*15*k <<
    4(d+e)``; an offset-signed A plane pairs ``|a| <= 128`` with B
    levels ``<= 255`` plus a rank-1 correction of the same size. Past
    2^31 the exact-integer contract would silently break (reachable
    only for wide operands once K exceeds ~33k).
    """
    if signed_a:
        worst = 2 * 128 * 255
    else:
        worst = sum(
            225 * (1 << (DIGIT_BITS * (d + e)))
            for d in range(nd_a)
            for e in range(nd_b)
        )
    if worst * k >= (1 << 31):
        raise ValueError(
            f"K={k} at {nd_a}x{nd_b} digit planes can overflow the "
            "int32 accumulator; split the contraction"
        )


def digit_dot(a_digits, b_digits) -> jnp.ndarray:
    """sum_{d,e} dot(a_d, b_e) << 4(d+e) with int32 accumulation."""
    acc = None
    for d, ad in enumerate(a_digits):
        for e, bd in enumerate(b_digits):
            part = jax.lax.dot_general(
                ad, bd, _DOT, preferred_element_type=jnp.int32
            )
            shift = DIGIT_BITS * (d + e)
            part = part << shift if shift else part
            acc = part if acc is None else acc + part
    return acc


def requant_levels(acc, out_bits: int, shift: int = 0) -> jnp.ndarray:
    """Reference requantizer (``kernel.h:347-351``) plus the pack-time
    wrap (``kernel.h:226-229``) -> int32 levels. ``shift``: optional
    power-of-two pre-scale (see ``ops/quantize.py``)."""
    ub = 1 << out_bits
    if shift:
        acc = acc >> shift
    r = jnp.where(acc > ub, ub - 1, jnp.where(acc < 0, 1, acc))
    return r & (ub - 1)


def levels_to_digits(levels, bits: int) -> jnp.ndarray:
    """int levels -> int8 base-16 digit planes stacked on axis 0."""
    out = []
    for d in range(num_digits(bits)):
        width = min(DIGIT_BITS, bits - d * DIGIT_BITS)
        out.append(
            ((levels >> (d * DIGIT_BITS)) & ((1 << width) - 1)).astype(
                jnp.int8
            )
        )
    return jnp.stack(out)


def requant_digits(acc, out_bits: int, shift: int = 0) -> jnp.ndarray:
    """Reference epilogue (``kernel.h:347-389``): requantize, then split
    into int8 digit planes [ndigits, ...]."""
    return levels_to_digits(requant_levels(acc, out_bits, shift), out_bits)


def plain_mm(
    a_digits: jnp.ndarray,
    b_digits: jnp.ndarray,
    m: int,
    k: int,
    n: int,
    signed_a: bool = False,
) -> jnp.ndarray:
    """int32 accumulator [pad_width(m), pad_width(n)] of ``A @ B``.

    ``a_digits``: int8[nd_a, >=m, >=k] digit planes of A, or with
    ``signed_a`` ONE offset-signed plane (byte = level - 128, bits
    5-8). ``b_digits``: int8[nd_b, >=k, >=n] digit planes of B. Both
    may carry zero padding of any extent; the contraction runs over the
    common padded K, where the padding of either side is zero.

    A signed A plane is exact through ``A @ B = (A - 128) @ B + 128 *
    colsum(B)``: padding entries of A are level 0 (byte -128) and cancel
    against the correction.
    """
    kk = min(a_digits.shape[2], b_digits.shape[1])
    if kk < k:
        raise ValueError(f"padded K {kk} is below the logical K {k}")
    mm_, nn = pad_width(m), pad_width(n)
    if a_digits.shape[1] < mm_ or b_digits.shape[2] < nn:
        raise ValueError(
            f"operands {a_digits.shape} @ {b_digits.shape} do not cover "
            f"the logical ({m}, {k}) @ ({k}, {n})"
        )
    nd_a, nd_b = a_digits.shape[0], b_digits.shape[0]
    check_accumulator(nd_a, nd_b, kk, signed_a)
    a = a_digits[:, :mm_, :kk]
    b = b_digits[:, :kk, :nn]
    acc = digit_dot(list(a), list(b))
    if signed_a:
        colsum = None
        for e in range(nd_b):
            p = jnp.sum(b[e].astype(jnp.int32), axis=0, keepdims=True)
            p = p << (DIGIT_BITS * e) if e else p
            colsum = p if colsum is None else colsum + p
        acc = acc + colsum * SIGNED_OFFSET
    return acc
