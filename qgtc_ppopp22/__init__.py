"""QGTC: arbitrary-bit quantized GNN inference in JAX, on NVIDIA GPUs.

A JAX re-design of the capabilities of QGTC (PPoPP'22,
YukeWang96/QGTC_PPoPP22): 1-8 bit quantized GNN inference where
matrices live in a packed bit domain and arbitrary-bit GEMMs are
computed exactly on int8 tensor cores, with requantize fused into the
GEMM epilogue, zero-tile jumping over all-zero adjacency tiles,
METIS-style cluster batching (Cluster-GCN / batched-GIN dataflow), and
multi-device scaling over a `jax.sharding.Mesh`.

Design stance (vs. the CUDA reference):

* The reference decomposes a w-bit x a-bit integer GEMM into ``w*a``
  1-bit Ampere BMMA GEMMs (reference ``QGTC_module/kernel.h:245-391``).
  Here operands are split into base-16 *digits* instead: at most
  ``ceil(w/4) * ceil(a/4)`` int8 GEMMs (1 for <=4-bit operands, 4 for
  8-bit) through XLA's ``dot_general`` (``ops/intmm.py``) -- exact
  integer arithmetic, identical results, far fewer passes.
* The 1-bit adjacency travels packed, 32 K-values per word like the
  reference's packers (``kernel.h:204-242``), and is unpacked to int8
  for the dot; one Pallas kernel (Triton route,
  ``ops/aggregate.py``) does that unpack, the dot and the requantize
  epilogue in registers.
* Zero-tile jumping: that kernel walks only the K tiles a pack-time
  tile map lists; in the reference the production kernels compile the
  dense path and the skip logic lives only in an instrumented counter
  kernel (``kernel.h:304``, ``kernel.h:572-592``).
"""

__version__ = "0.1.0"

from qgtc_ppopp22.ops.quantize import quantize, requantize
from qgtc_ppopp22.ops.bitpack import (
    BitTensor,
    pack_bits,
    unpack_bits,
    val2bit,
    bit2val,
)
from qgtc_ppopp22.ops.bitgemm import bitmm_to_bits, bitmm_to_int
from qgtc_ppopp22.ops.digits import DigitTensor, to_digit_tensor, digit_pack
from qgtc_ppopp22.ops.digitmm import digitmm_to_digits, digitmm_to_f32

__all__ = [
    "quantize",
    "requantize",
    "BitTensor",
    "pack_bits",
    "unpack_bits",
    "val2bit",
    "bit2val",
    "bitmm_to_bits",
    "bitmm_to_int",
    "DigitTensor",
    "to_digit_tensor",
    "digit_pack",
    "digitmm_to_digits",
    "digitmm_to_f32",
]
