"""Full-precision baseline models (the reference's DGL-baseline role).

The reference benchmarks QGTC against DGL GraphSAGE / GIN
(``modules.py:26-45, 65-99``, drivers ``cluster_gcn_dgl.py`` /
``batched_gin_dgl.py``). Here the full-precision baseline over the same
densified cluster batches is a jitted dense model: aggregation is
``A @ H`` in bfloat16 on the tensor cores with float32 accumulation
(XLA fuses the epilogue).

Also provides a CSR segment-sum aggregation path (``sparse_aggregate``)
as a numerically identical alternative for very sparse full-graph use.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp


def init_mlp_weights(
    key: jax.Array, dims: Sequence[int], scale: float = 0.1
) -> List[jnp.ndarray]:
    ws = []
    for i in range(len(dims) - 1):
        key, sub = jax.random.split(key)
        ws.append(
            jax.random.normal(sub, (dims[i], dims[i + 1]), jnp.float32) * scale
        )
    return ws


def sage_forward(
    a: jnp.ndarray, x: jnp.ndarray, ws: Sequence[jnp.ndarray]
) -> jnp.ndarray:
    """3-layer GraphSAGE-style (copy-src/sum + Linear + ReLU).

    Mirrors the reference baseline layer ``update_all(copy_src, sum)
    -> Linear -> ReLU`` (``modules.py:16-24,41-45``); sum-aggregation
    over dense A is ``A @ H``. Matmuls take bfloat16 operands and
    accumulate in float32.
    """
    h = x
    n = len(ws)
    for i, w in enumerate(ws):
        agg = _bf16_mm(a, h)
        h = _bf16_mm(agg, w)
        if i < n - 1:
            h = jax.nn.relu(h)
    return h


def gin_forward(
    a: jnp.ndarray, x: jnp.ndarray, ws: Sequence[jnp.ndarray]
) -> jnp.ndarray:
    """3-layer GIN-style baseline (sum-aggregate then MLP update).

    Mirrors ``GINConv`` with sum aggregation + ``ApplyNodeFunc`` MLP
    (``modules.py:55-99``), simplified to one Linear+ReLU per layer to
    match the quantized model's per-layer cost shape.
    """
    h = x
    n = len(ws)
    for i, w in enumerate(ws):
        h = _bf16_mm(a, h)
        h = _bf16_mm(h, w)
        if i < n - 1:
            h = jax.nn.relu(h)
    return h


def _bf16_mm(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.dot(
        a.astype(jnp.bfloat16),
        b.astype(jnp.bfloat16),
        preferred_element_type=jnp.float32,
    )


def int8_mm(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """XLA-native int8 GEMM (the cuBLAS ``GemmEx`` INT8 baseline role).

    Reference baseline: ``cublasGemmEx`` with ``CUDA_R_8I`` inputs and
    float accumulate (``cuBLASGemmEX/cublas_main.cu:132-154``); here a
    plain int8 ``dot_general`` with int32 accumulation.
    """
    return jax.lax.dot_general(
        a.astype(jnp.int8),
        b.astype(jnp.int8),
        (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )


def sparse_aggregate(
    indptr: jnp.ndarray,
    indices: jnp.ndarray,
    x: jnp.ndarray,
    num_nodes: Optional[int] = None,
) -> jnp.ndarray:
    """CSR sum-aggregation via segment_sum (full-graph sparse path)."""
    num_nodes = num_nodes or (indptr.shape[0] - 1)
    deg = jnp.diff(indptr)
    row = jnp.repeat(
        jnp.arange(num_nodes), deg, total_repeat_length=indices.shape[0]
    )
    return jax.ops.segment_sum(x[indices], row, num_segments=num_nodes)
