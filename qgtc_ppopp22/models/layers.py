"""Layer-level API (reference ``QGTC_conv.py`` role, but alive).

The reference ships layer classes (``GCNConv_Qnt`` /
``Aggregation_Qnt``, ``QGTC_conv.py:9-78``) that the benchmark never
instantiates — and cannot: ``GCNConv_Qnt.__init__`` raises NameError
(SURVEY quirk 5), and the backward stubs return ``None``
(``QGTC_conv.py:24-27``). This module provides the working
equivalents: composable, functional layer objects over the digit/bit
GEMMs, usable to build models of any depth, with the same two
primitive operations the reference exposes:

* :class:`QAggregation` — ``A @ H`` in the bit domain
  (``Aggregation_Qnt.forward``: ``bitMM2Bit(A, .)`` or
  ``bitMM2Int(A, .)``).
* :class:`QLinear` — ``H @ W`` with the weight quantized+packed once
  (``GCNConv_Qnt``'s ``bit_W`` buffer role).

Inference-only by design, like the reference (backward passes do not
exist rather than silently returning ``None``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import jax.numpy as jnp

from qgtc_ppopp22.models.qmodels import _mm_to_bits, _mm_to_f32
from qgtc_ppopp22.ops.bitpack import BitTensor, val2bit
from qgtc_ppopp22.ops.digits import DigitTensor, digit_pack
from qgtc_ppopp22.ops.packmm import PackedTensor
from qgtc_ppopp22.ops.quantize import quantize

Packed = Union[BitTensor, DigitTensor, PackedTensor]


@dataclasses.dataclass(frozen=True)
class QLinear:
    """Quantized linear layer: weight packed once at construction
    (reference packs weights outside the epoch loop,
    ``main_qgtc.py:108-110``)."""

    weight: Packed
    out_bits: int

    @classmethod
    def create(
        cls,
        w: jnp.ndarray,
        bit_width: int,
        out_bits: Optional[int] = None,
        fmt: str = "digits",
    ) -> "QLinear":
        if fmt == "digits":
            packed: Packed = digit_pack(quantize(w, bit_width), bit_width)
        else:
            packed = val2bit(w, bit_width)
        return cls(weight=packed, out_bits=out_bits or bit_width)

    def __call__(self, h: Packed) -> Packed:
        return _mm_to_bits(h, self.weight, self.out_bits)

    def to_float(self, h: Packed) -> jnp.ndarray:
        """Output-layer variant (``bitMM2Int(., W)``, GIN's last op)."""
        return _mm_to_f32(h, self.weight)


@dataclasses.dataclass(frozen=True)
class QAggregation:
    """Bit-domain neighborhood aggregation ``A @ H``
    (``Aggregation_Qnt.forward``, ``QGTC_conv.py:15-22``)."""

    out_bits: int

    def __call__(self, bit_a: Packed, h: Packed) -> Packed:
        return _mm_to_bits(bit_a, h, self.out_bits)

    def to_float(self, bit_a: Packed, h: Packed) -> jnp.ndarray:
        """Final aggregation to float logits (``bitMM2Int(A, .)``)."""
        return _mm_to_f32(bit_a, h)


@dataclasses.dataclass(frozen=True)
class QGCNConv:
    """One GCN layer: update-then-aggregate
    (``GCNConv_Qnt`` intent, ``main_qgtc.py:146-154`` execution)."""

    linear: QLinear
    agg: QAggregation

    @classmethod
    def create(
        cls,
        w: jnp.ndarray,
        bit_width: int,
        fmt: str = "digits",
    ) -> "QGCNConv":
        return cls(
            linear=QLinear.create(w, bit_width, fmt=fmt),
            agg=QAggregation(out_bits=bit_width),
        )

    def __call__(self, bit_a: Packed, h: Packed, final: bool = False):
        h = self.linear(h)
        if final:
            return self.agg.to_float(bit_a, h)
        return self.agg(bit_a, h)


@dataclasses.dataclass(frozen=True)
class QGINConv:
    """One GIN layer: aggregate-then-update
    (``main_qgtc.py:131-138`` execution)."""

    linear: QLinear
    agg: QAggregation

    @classmethod
    def create(
        cls,
        w: jnp.ndarray,
        bit_width: int,
        fmt: str = "digits",
    ) -> "QGINConv":
        return cls(
            linear=QLinear.create(w, bit_width, fmt=fmt),
            agg=QAggregation(out_bits=bit_width),
        )

    def __call__(self, bit_a: Packed, h: Packed, final: bool = False):
        h = self.agg(bit_a, h)
        if final:
            return self.linear.to_float(h)
        return self.linear(h)
