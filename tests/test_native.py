"""Native C++ host library vs NumPy reference implementations."""

import numpy as np
import pytest

from qgtc_ppopp22.graph import from_edges, edge_cut_fraction, synthesize
from qgtc_ppopp22.graph.batching import quantize_np
from qgtc_ppopp22.graph.partition import _partition_bfs
from qgtc_ppopp22.ops.bitpack import pack_bits_np, round_up, ROW_PAD

native = pytest.importorskip("qgtc_ppopp22.native")

if not native.available():
    pytest.skip("native toolchain unavailable", allow_module_level=True)


def test_csr_from_edges_matches(rng):
    n, m = 300, 2000
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    ref = from_edges(src, dst, n)
    indptr, indices = native.csr_from_edges_native(src, dst, n)
    np.testing.assert_array_equal(indptr, ref.indptr)
    np.testing.assert_array_equal(indices, ref.indices)


def test_partition_native_quality(rng):
    ds = synthesize("Proteins", scale=0.05, seed=1)
    g = ds.graph
    psize = 16
    parts = native.partition_native(g, psize)
    allnodes = np.concatenate(parts)
    assert len(allnodes) == g.num_nodes
    assert len(np.unique(allnodes)) == g.num_nodes
    # quality: at least as good as the greedy BFS fallback (with slack)
    cut_native = edge_cut_fraction(g, parts)
    cut_bfs = edge_cut_fraction(
        g, _partition_bfs(g.undirected_scipy(), psize)
    )
    assert cut_native <= cut_bfs * 1.15, (cut_native, cut_bfs)
    # balance: no partition over 2x average
    sizes = [len(p) for p in parts]
    assert max(sizes) <= 2 * g.num_nodes // psize + 1


def test_subgraph_dense_matches(rng):
    ds = synthesize("Proteins", scale=0.03, seed=2)
    g = ds.graph
    nodes = np.sort(rng.choice(g.num_nodes, 200, replace=False))
    pn = 256
    got = native.subgraph_dense_native(g.indptr, g.indices, nodes, pn)
    want = np.zeros((pn, pn), np.uint8)
    want[:200, :200] = g.subgraph_dense(nodes)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_quantize_native_matches(rng, bits):
    x = (rng.standard_normal(5000) * 3 + 1).astype(np.float32)
    got = native.quantize_native(x, bits)
    np.testing.assert_array_equal(got, quantize_np(x, bits))


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_pack_native_matches(rng, bits):
    M, K = 300, 200
    q = rng.integers(0, 1 << bits, (M, K)).astype(np.int32)
    Mp, Kp = round_up(M, ROW_PAD), round_up(K, ROW_PAD)
    got = native.pack_bits_native(q, bits, Mp, Kp)
    want = np.asarray(pack_bits_np(q, bits).planes)
    np.testing.assert_array_equal(got, want)
