"""Model-level parity: bit-domain QGCN/QGIN vs integer golden model.

The math is exact integer arithmetic end-to-end, so model outputs must
match the NumPy golden forward *exactly* at every bit width — the test
standard the reference lacks (its weights are all-ones and outputs
discarded, ``main_qgtc.py:100-102``).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from qgtc_ppopp22.graph import ClusterBatcher, synthesize, batch_labels
from qgtc_ppopp22.models import (
    QModelConfig,
    init_weights,
    pack_weights,
    qgcn_forward,
    qgin_forward,
    qgcn_golden,
    qgin_golden,
)
from qgtc_ppopp22.ops.bitpack import pack_bits, unpack_bits
from qgtc_ppopp22.ops.digits import digit_pack
from qgtc_ppopp22.ops.packmm import build_tile_map_packed_np, pack_rows
from tests.golden import quantize_np


def make_inputs(rng, n, dim, bits):
    a = (rng.random((n, n)) < 0.02).astype(np.int32)
    x = rng.standard_normal((n, dim)).astype(np.float32) * 2 + 1
    qx = quantize_np(x, bits)
    return a, qx


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_qgcn_matches_golden(rng, bits):
    n, dim, hid, out = 256, 32, 16, 8
    a, qx = make_inputs(rng, n, dim, bits)
    cfg = QModelConfig(dim, hid, out, bit_width=bits)
    ws = init_weights(jax.random.PRNGKey(0), cfg)
    qws = [quantize_np(np.asarray(w), bits) for w in ws]

    bit_a = pack_bits(jnp.asarray(a), 1)
    bit_x = pack_bits(jnp.asarray(qx), bits)
    bit_ws = [pack_bits(jnp.asarray(qw), bits) for qw in qws]

    got = np.asarray(qgcn_forward(bit_a, bit_x, bit_ws, out_bits=bits))
    want = qgcn_golden(a, qx, qws, bits, bits)
    np.testing.assert_array_equal(got, want.astype(np.float32))


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_qgin_matches_golden(rng, bits):
    n, dim, hid, out = 256, 32, 16, 8
    a, qx = make_inputs(rng, n, dim, bits)
    cfg = QModelConfig(dim, hid, out, bit_width=bits)
    ws = init_weights(jax.random.PRNGKey(1), cfg)
    qws = [quantize_np(np.asarray(w), bits) for w in ws]

    bit_a = pack_bits(jnp.asarray(a), 1)
    bit_x = pack_bits(jnp.asarray(qx), bits)
    bit_ws = [pack_bits(jnp.asarray(qw), bits) for qw in qws]

    got = np.asarray(qgin_forward(bit_a, bit_x, bit_ws, out_bits=bits))
    want = qgin_golden(a, qx, qws, bits, bits)
    np.testing.assert_array_equal(got, want.astype(np.float32))


def test_qgcn_with_tile_map_identical(rng):
    """Packed adjacency with all-zero 256x256 tiles (counted by the
    pack-time tile map) through the model == golden."""
    bits = 2
    n, dim = 512, 32
    a, qx = make_inputs(rng, n, dim, bits)
    a[: n // 2, n // 2:] = 0  # guarantee zero tiles
    cfg = QModelConfig(dim, 16, 8, bit_width=bits)
    ws = init_weights(jax.random.PRNGKey(2), cfg)
    qws = [quantize_np(np.asarray(w), bits) for w in ws]

    pa = pack_rows(jnp.asarray(a), 1)
    dx = digit_pack(jnp.asarray(qx), bits)
    dws = [digit_pack(jnp.asarray(qw), bits) for qw in qws]
    kidx, kcnt = build_tile_map_packed_np(np.asarray(pa.words), 1)
    assert kcnt.tolist() == [1, 2] and kidx.size == 4

    got = np.asarray(qgcn_forward(pa, dx, dws, out_bits=bits))
    np.testing.assert_array_equal(
        got, qgcn_golden(a, qx, qws, bits, bits).astype(np.float32)
    )


def test_end_to_end_cluster_batch_pipeline(rng):
    """Full slice: dataset -> partition -> batch -> packed forward."""
    bits = 2
    ds = synthesize("Proteins", scale=0.02, seed=5)
    it = ClusterBatcher(
        ds, 4, 2, bit_width=bits, bucket_rows=256, shuffle=False
    )
    cfg = QModelConfig(it.feat_dim, 16, ds.num_classes, bit_width=bits)
    ws = init_weights(jax.random.PRNGKey(3), cfg)
    qws = [quantize_np(np.asarray(w), bits) for w in ws]
    bit_ws = pack_weights(ws, bits)

    batch = it.batches[0]
    bit_a = jax.tree.map(jnp.asarray, batch.bit_A)
    bit_x = jax.tree.map(jnp.asarray, batch.bit_X)
    got = np.asarray(qgcn_forward(bit_a, bit_x, bit_ws, out_bits=bits))
    assert got.shape == (batch.padded_nodes, ds.num_classes)

    qa = np.asarray(unpack_bits(batch.bit_A))
    qx = np.asarray(unpack_bits(batch.bit_X))
    want = qgcn_golden(qa, qx, qws, bits, bits)
    np.testing.assert_array_equal(got, want.astype(np.float32))

    labels, mask = batch_labels(ds, batch)
    assert labels.shape == (batch.padded_nodes,)
    assert mask.sum() == batch.num_nodes


def test_qgcn_digit_path_matches_golden(rng):
    """Same model through the DigitTensor compute format."""
    bits = 2
    n, dim = 256, 32
    a, qx = make_inputs(rng, n, dim, bits)
    cfg = QModelConfig(dim, 16, 8, bit_width=bits)
    ws = init_weights(jax.random.PRNGKey(7), cfg)
    qws = [quantize_np(np.asarray(w), bits) for w in ws]

    da = digit_pack(jnp.asarray(a), 1)
    dx = digit_pack(jnp.asarray(qx), bits)
    dws = [digit_pack(jnp.asarray(qw), bits) for qw in qws]

    got = np.asarray(qgcn_forward(da, dx, dws, out_bits=bits))
    want = qgcn_golden(a, qx, qws, bits, bits)
    np.testing.assert_array_equal(got, want.astype(np.float32))

    got_gin = np.asarray(qgin_forward(da, dx, dws, out_bits=bits))
    want_gin = qgin_golden(a, qx, qws, bits, bits)
    np.testing.assert_array_equal(got_gin, want_gin.astype(np.float32))


def test_layer_api_composes_to_model(rng):
    """QGCNConv/QGINConv layer objects reproduce the model forwards."""
    from qgtc_ppopp22.models.layers import QGCNConv, QGINConv

    bits = 2
    n, dim = 256, 32
    a, qx = make_inputs(rng, n, dim, bits)
    cfg = QModelConfig(dim, 16, 8, bit_width=bits)
    ws = init_weights(jax.random.PRNGKey(9), cfg)
    qws = [quantize_np(np.asarray(w), bits) for w in ws]

    da = digit_pack(jnp.asarray(a), 1)
    dx = digit_pack(jnp.asarray(qx), bits)

    layers = [QGCNConv.create(w, bits) for w in ws]
    h = dx
    for lay in layers[:-1]:
        h = lay(da, h)
    got = np.asarray(layers[-1](da, h, final=True))
    want = qgcn_golden(a, qx, qws, bits, bits)
    np.testing.assert_array_equal(got, want.astype(np.float32))

    glayers = [QGINConv.create(w, bits) for w in ws]
    h = dx
    for lay in glayers[:-1]:
        h = lay(da, h)
    got = np.asarray(glayers[-1](da, h, final=True))
    want = qgin_golden(a, qx, qws, bits, bits)
    np.testing.assert_array_equal(got, want.astype(np.float32))


def test_sparse_full_graph_matches_golden(rng):
    """Sparse CSR engine == dense golden on the full graph, both models."""
    from qgtc_ppopp22.graph import synthesize
    from qgtc_ppopp22.models.sparse import sparse_q_forward

    bits = 2
    ds = synthesize("Proteins", scale=0.02, seed=11)
    g = ds.graph
    n = g.num_nodes
    qx = quantize_np(ds.features, bits) & 0b11
    cfg = QModelConfig(ds.feat_dim, 16, ds.num_classes, bit_width=bits)
    ws = init_weights(jax.random.PRNGKey(13), cfg)
    qws = [quantize_np(np.asarray(w), bits) for w in ws]

    dense_a = g.subgraph_dense(np.arange(n)).astype(np.int32)
    shifts = [1, 2, 1, 2, 1]
    for model, golden in (("gcn", qgcn_golden), ("gin", qgin_golden)):
        got = np.asarray(
            sparse_q_forward(
                jnp.asarray(g.indptr),
                jnp.asarray(g.indices),
                jnp.asarray(qx),
                [jnp.asarray(q) for q in qws],
                out_bits=bits,
                model=model,
                shifts=shifts,
            )
        )
        want = golden(dense_a, qx, qws, bits, bits, shifts=shifts)
        np.testing.assert_array_equal(got, want.astype(np.float32))
