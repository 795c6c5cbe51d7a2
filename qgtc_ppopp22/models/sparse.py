"""Full-graph sparse quantized inference (beyond the reference).

The reference's thesis is densified cluster batches on tensor cores;
its comparison baseline (DGL) aggregates sparsely with cuSPARSE SpMM
(``modules.py:16-24``). This module provides the quantized engine's
own sparse mode: the SAME integer semantics (quantize levels,
requantize-with-optional-shift between layers, ``kernel.h:31-71,
347-351``) computed over the CSR graph with gather + ``segment_sum``
— no clustering, no densification, no padding. Exact-integer
equivalent of the dense path on the whole graph; preferable when the
graph is too sparse/large for dense cluster tiles to win.

Aggregation is 1-bit (binary adjacency, reference convention): the
neighbor sum of integer levels IS the bit-GEMM result.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp

from qgtc_ppopp22.ops.quantize import requantize_wrapped as _requant

__all__ = ["sparse_q_forward", "sparse_aggregate_levels"]


def sparse_aggregate_levels(
    indptr: jnp.ndarray,
    indices: jnp.ndarray,
    h: jnp.ndarray,
    num_nodes: int,
) -> jnp.ndarray:
    """``(A @ H)`` for binary in-adjacency CSR, integer levels."""
    deg = jnp.diff(indptr)
    row = jnp.repeat(
        jnp.arange(num_nodes), deg, total_repeat_length=indices.shape[0]
    )
    return jax.ops.segment_sum(
        h[indices], row, num_segments=num_nodes
    )


def sparse_q_forward(
    indptr: jnp.ndarray,
    indices: jnp.ndarray,
    qx: jnp.ndarray,  # int32 levels [N, d] (already quantized+wrapped)
    qws: Sequence[jnp.ndarray],  # int32 level matrices
    out_bits: int,
    model: str = "gcn",
    shifts: Optional[Sequence[int]] = None,
) -> jnp.ndarray:
    """Quantized GCN/GIN forward over the full CSR graph -> f32 logits.

    Bit-exact with the dense engines' semantics (same requantizer,
    same dataflow order, ``main_qgtc.py:127-154``).
    """
    n = indptr.shape[0] - 1
    n_layers = len(qws)
    sh = list(shifts) if shifts is not None else [0] * (2 * n_layers - 1)
    si = 0
    mask = (1 << out_bits) - 1

    def mm(h, w):
        # pack-time wrap: only the low ``out_bits`` bits of a level
        # survive packing (kernel.h:226-229), so level 2^bits -> 0
        return jax.lax.dot_general(
            h, w.astype(jnp.int32) & mask, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32,
        )

    h = qx.astype(jnp.int32) & mask
    if model == "gcn":
        for l, w in enumerate(qws):
            h = _requant(mm(h, w), out_bits, sh[si]); si += 1
            if l < n_layers - 1:
                h = _requant(
                    sparse_aggregate_levels(indptr, indices, h, n),
                    out_bits, sh[si],
                ); si += 1
        return sparse_aggregate_levels(indptr, indices, h, n).astype(
            jnp.float32
        )
    if model != "gin":
        raise ValueError(model)
    h = _requant(
        sparse_aggregate_levels(indptr, indices, h, n), out_bits, sh[si]
    ); si += 1
    for w in qws[:-1]:
        h = _requant(mm(h, w), out_bits, sh[si]); si += 1
        h = _requant(
            sparse_aggregate_levels(indptr, indices, h, n),
            out_bits, sh[si],
        ); si += 1
    return mm(h, qws[-1]).astype(jnp.float32)
