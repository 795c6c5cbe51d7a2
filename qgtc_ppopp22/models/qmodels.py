"""Quantized GNN models in the bit-plane domain (QGCN / QGIN).

Model dataflows exactly as the reference executes them
(``main_qgtc.py:127-154``; SURVEY §3), but using the numerically
*correct* composition everywhere — the reference's timed loop feeds a
row-major packed output as the B operand of the next multiply
(``main_qgtc.py:147-148``), which violates its own layout contract and
is only harmless because its weights are all-ones and outputs are
discarded; the correct composition appears in its unit tests
(``unitest.py:86-121``). The containers here are layout-free, so every
intermediate composes legally by construction.

* QGCN (update-then-aggregate, hidden=16 default): per hidden layer
  ``H <- A @ (H @ Wl)`` in the bit domain; output layer
  ``bitmm_to_int(A, H @ W3)``... precisely:
  ``XW1 -> A(XW1) -> (.)W2 -> A(.) -> (.)W3 -> bitmm_to_int(A, .)``
  (``main_qgtc.py:146-154``).
* QGIN (aggregate-then-update, hidden=64 default):
  ``AX -> (AX)W1 -> A(.) -> (.)W2 -> A(.) -> bitmm_to_int(., W3)``
  (``main_qgtc.py:131-138``).

Weights are real (not the reference's ``torch.ones``,
``main_qgtc.py:100-102``): floats quantized to ``bit_width`` levels and
packed once, amortized across batches exactly as the reference packs
weights once outside the epoch loop (``main_qgtc.py:108-110``).

"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from qgtc_ppopp22.ops.bitgemm import bitmm_to_bits, bitmm_to_int
from qgtc_ppopp22.ops.bitpack import BitTensor
from qgtc_ppopp22.ops.digits import DigitTensor
from qgtc_ppopp22.ops.digitmm import digitmm_to_digits, digitmm_to_f32
from qgtc_ppopp22.ops.packmm import (
    PackedTensor,
    packmm_to_digits,
    packmm_to_f32,
)


def _mm_to_bits(a, b, out_bits, shift=0):
    """Container-dispatching requantizing GEMM (packed-word, digit, or
    bit-plane left operand)."""
    if isinstance(a, PackedTensor):
        return packmm_to_digits(a, b, out_bits, shift=shift)
    if isinstance(a, DigitTensor):
        return digitmm_to_digits(a, b, out_bits, shift=shift)
    if shift:
        raise NotImplementedError(
            "scaled requant is only on the digit path; the bit-plane "
            "path keeps exact reference semantics (shift=0)"
        )
    return bitmm_to_bits(a, b, out_bits)


def _mm_to_f32(a, b):
    if isinstance(a, PackedTensor):
        return packmm_to_f32(a, b)
    if isinstance(a, DigitTensor):
        return digitmm_to_f32(a, b)
    return bitmm_to_int(a, b)


@dataclasses.dataclass(frozen=True)
class QModelConfig:
    in_dim: int
    hidden: int
    out_dim: int
    bit_width: int = 2
    num_layers: int = 3  # reference models are 3-layer (modules.py)

    def weight_shapes(self) -> List[tuple]:
        dims = (
            [self.in_dim]
            + [self.hidden] * (self.num_layers - 1)
            + [self.out_dim]
        )
        return [(dims[i], dims[i + 1]) for i in range(self.num_layers)]


def init_weights(
    key: jax.Array, cfg: QModelConfig, scale: float = 1.0
) -> List[jnp.ndarray]:
    """Float weight init sized so quantized levels spread over the range.

    The reference quantization maps floats by clip-to-[0, 2^bits] +
    round (no learned scale), so useful weights live in [0, 2^bits];
    uniform init over that range exercises every level.
    """
    ws = []
    for i, (fi, fo) in enumerate(cfg.weight_shapes()):
        key, sub = jax.random.split(key)
        ub = float(1 << cfg.bit_width)
        ws.append(jax.random.uniform(sub, (fi, fo), jnp.float32, 0.0, ub * scale))
    return ws


def pack_weights(
    weights: Sequence[jnp.ndarray],
    bit_width: int,
    fmt: str = "bits",
    quant_bits: Optional[int] = None,
) -> List:
    """Quantize + pack weights once (reference ``main_qgtc.py:108-110``).

    ``fmt='bits'`` returns packed ``BitTensor``s (storage
    format), ``fmt='digits'`` int8 ``DigitTensor``s (compute
    format, the fast path). ``quant_bits`` (default
    ``bit_width``) sets the quantization grid independently of the
    datapath decomposition width: quantizing at a narrower grid but
    packing at ``bit_width`` leaves the upper planes/digits zero, so a
    wide engine can run a narrow model's exact weights (see
    ``models/train.qat_ladder``).
    """
    from qgtc_ppopp22.ops.digits import digit_pack
    from qgtc_ppopp22.ops.quantize import quantize

    qb = quant_bits or bit_width
    if qb > bit_width:
        raise ValueError(f"quant_bits ({qb}) must be <= bit_width")

    def q(w):
        v = quantize(w, qb).astype(jnp.int32)
        if qb < bit_width:
            # The native-width deployment packs into qb planes, which
            # keeps only the low qb bits (reference kernel.h:204-242;
            # the quantizer's upper edge 2^qb wraps to 0). A wider
            # container would keep 2^qb verbatim — wrap explicitly so
            # emulation is bit-exact to the narrow deployment.
            v = v % (1 << qb)
        return v

    if fmt == "bits":
        from qgtc_ppopp22.ops.bitpack import pack_bits

        return [pack_bits(q(w), bit_width) for w in weights]
    if fmt == "digits":
        return [digit_pack(q(w), bit_width) for w in weights]
    raise ValueError(f"unknown weight format {fmt!r}")


def qgcn_forward(
    bit_a: BitTensor,
    bit_x: BitTensor,
    bit_ws: Sequence[BitTensor],
    out_bits: int,
    shifts: Optional[Sequence[int]] = None,
) -> jnp.ndarray:
    """Cluster-GCN forward in the bit domain -> float32 logits.

    Update-then-aggregate: features shrink to ``hidden`` before the
    N x N aggregation (``main_qgtc.py:146-154``). ``shifts`` gives the
    optional per-GEMM power-of-two requant scales (2 entries per
    hidden layer + 1 for the last update; None = reference semantics).
    """
    h = bit_x
    n_layers = len(bit_ws)
    sh = list(shifts) if shifts is not None else [0] * (2 * n_layers - 1)
    si = 0
    for l, w in enumerate(bit_ws):
        h = _mm_to_bits(h, w, out_bits, shift=sh[si])
        si += 1
        if l < n_layers - 1:
            h = _mm_to_bits(bit_a, h, out_bits, shift=sh[si])
            si += 1
    return _mm_to_f32(bit_a, h)


def qgin_forward(
    bit_a: BitTensor,
    bit_x: BitTensor,
    bit_ws: Sequence[BitTensor],
    out_bits: int,
    shifts: Optional[Sequence[int]] = None,
) -> jnp.ndarray:
    """Batched-GIN forward in the bit domain -> float32 logits.

    Aggregate-then-update (``main_qgtc.py:131-138``): the final
    multiply is by the output weight, not the adjacency. ``shifts`` as
    in :func:`qgcn_forward`.
    """
    n_layers = len(bit_ws)
    sh = list(shifts) if shifts is not None else [0] * (2 * n_layers - 1)
    si = 0
    h = _mm_to_bits(bit_a, bit_x, out_bits, shift=sh[si])
    si += 1
    for w in bit_ws[:-1]:
        h = _mm_to_bits(h, w, out_bits, shift=sh[si])
        si += 1
        h = _mm_to_bits(bit_a, h, out_bits, shift=sh[si])
        si += 1
    return _mm_to_f32(h, bit_ws[-1])


# ---------------------------------------------------------------------------
# NumPy golden forwards (integer semantics) for parity testing
# ---------------------------------------------------------------------------


def _golden_mm_bits(a, b, a_bits, b_bits, out_bits):
    from tests.golden import bitmm_np  # local import: test-only dependency

    return bitmm_np(a, b, a_bits, b_bits, out_bits)


def qgcn_golden(
    qa, qx, qws, bit_width: int, out_bits: int, shifts=None
) -> np.ndarray:
    """Integer-exact NumPy model of :func:`qgcn_forward`."""
    from tests.golden import bitmm_np

    n_layers = len(qws)
    sh = list(shifts) if shifts is not None else [0] * (2 * n_layers - 1)
    si = 0
    h, hb = qx, bit_width
    for l, w in enumerate(qws):
        h, hb = bitmm_np(h, w, hb, bit_width, out_bits, sh[si]), out_bits
        si += 1
        if l < n_layers - 1:
            h = bitmm_np(qa, h, 1, hb, out_bits, sh[si])
            si += 1
    return bitmm_np(qa, h, 1, hb, None)


def qgin_golden(
    qa, qx, qws, bit_width: int, out_bits: int, shifts=None
) -> np.ndarray:
    """Integer-exact NumPy model of :func:`qgin_forward`."""
    from tests.golden import bitmm_np

    n_layers = len(qws)
    sh = list(shifts) if shifts is not None else [0] * (2 * n_layers - 1)
    si = 0
    h, hb = bitmm_np(qa, qx, 1, bit_width, out_bits, sh[si]), out_bits
    si += 1
    for w in qws[:-1]:
        h = bitmm_np(h, w, hb, bit_width, out_bits, sh[si])
        si += 1
        h = bitmm_np(qa, h, 1, out_bits, out_bits, sh[si])
        si += 1
        hb = out_bits
    return bitmm_np(h, qws[-1], hb, bit_width, None)
