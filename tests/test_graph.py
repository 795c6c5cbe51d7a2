"""Graph layer tests: CSR, partitioning, cluster batching."""

import numpy as np
import pytest

from qgtc_ppopp22.graph import (
    ClusterBatcher,
    from_edges,
    get_partition_list,
    edge_cut_fraction,
    synthesize,
)
from qgtc_ppopp22.graph.batching import quantize_np
from qgtc_ppopp22.ops.bitpack import pack_bits, pack_bits_np, unpack_bits


def small_graph(rng, n=200, m=800):
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    g = from_edges(
        np.concatenate([src, dst]), np.concatenate([dst, src]), n
    )
    return g, src, dst


def test_from_edges_in_adjacency(rng):
    g, src, dst = small_graph(rng)
    dense = g.subgraph_dense(np.arange(g.num_nodes))
    # in-adjacency: dense[dst, src] == 1 for every edge (both dirs added)
    assert np.all(dense[dst, src] == 1)
    assert np.all(dense[src, dst] == 1)
    assert dense.max() <= 1


def test_subgraph_dense_induced(rng):
    g, _, _ = small_graph(rng)
    nodes = np.sort(rng.choice(g.num_nodes, 50, replace=False))
    sub = g.subgraph_dense(nodes)
    full = g.subgraph_dense(np.arange(g.num_nodes))
    np.testing.assert_array_equal(sub, full[np.ix_(nodes, nodes)])


@pytest.mark.parametrize("method", ["rcm", "bfs"])
def test_partition_covers_disjointly(rng, method):
    g, _, _ = small_graph(rng)
    parts = get_partition_list(g, 8, method=method)
    allnodes = np.concatenate(parts)
    assert len(allnodes) == g.num_nodes
    assert len(np.unique(allnodes)) == g.num_nodes
    sizes = [len(p) for p in parts]
    assert max(sizes) <= 2 * (g.num_nodes // 8) + 1


def test_partition_locality_beats_random(rng):
    ds = synthesize("Proteins", scale=0.05, seed=1)
    g = ds.graph
    parts = get_partition_list(g, 16, method="bfs")
    rand_order = rng.permutation(g.num_nodes)
    rand_parts = [np.sort(c) for c in np.array_split(rand_order, 16)]
    assert edge_cut_fraction(g, parts) < 0.8 * edge_cut_fraction(
        g, rand_parts
    )


def test_pack_np_matches_device(rng):
    q = rng.integers(0, 16, (70, 33)).astype(np.int32)
    a = pack_bits_np(q, 4)
    b = pack_bits(q, 4)
    np.testing.assert_array_equal(np.asarray(a.planes), np.asarray(b.planes))
    assert a.shape == b.shape


def test_cluster_batcher_shapes_and_content(rng):
    ds = synthesize("Proteins", scale=0.03, seed=2)
    psize, bs = 8, 2
    it = ClusterBatcher(
        ds, psize, bs, bit_width=2, seed=0, bucket_rows=256, shuffle=False
    )
    assert len(it) == psize // bs
    total = 0
    for b in it.batches:
        total += b.num_nodes
        assert b.padded_nodes % 256 == 0
        assert b.bit_A.shape == (b.padded_nodes, b.padded_nodes)
        assert b.bit_X.shape == (b.padded_nodes, ds.feat_dim)
        # packed A decodes to the induced subgraph (padded region zero)
        dec = np.asarray(unpack_bits(b.bit_A))
        ref = ds.graph.subgraph_dense(b.nodes)
        np.testing.assert_array_equal(dec[: b.num_nodes, : b.num_nodes], ref)
        assert dec[b.num_nodes :].sum() == 0
        # packed X decodes to quantized features
        decx = np.asarray(unpack_bits(b.bit_X))
        refx = quantize_np(ds.features[b.nodes], 2) & 0b11
        np.testing.assert_array_equal(decx[: b.num_nodes], refx)
    assert total == ds.num_nodes


@pytest.mark.parametrize("bits,qbits", [(1, None), (4, None), (8, None), (4, 2)])
def test_rebit_matches_fresh_batcher(bits, qbits):
    # rebit(b) must be bit-identical to building a fresh batcher at b:
    # same structural artifacts (shared), same re-packed X planes.
    ds = synthesize("Proteins", scale=0.03, seed=2)
    base = ClusterBatcher(
        ds, 8, 2, bit_width=2, seed=0, bucket_rows=256, shuffle=False
    )
    fresh = ClusterBatcher(
        ds, 8, 2, bit_width=bits, quant_bits=qbits, seed=0,
        bucket_rows=256, shuffle=False,
    )
    re = base.rebit(bits, quant_bits=qbits)
    assert re.bit_width == bits and re.quant_bits == (qbits or bits)
    assert len(re.batches) == len(fresh.batches)
    for br, bf in zip(re.batches, fresh.batches):
        np.testing.assert_array_equal(br.nodes, bf.nodes)
        np.testing.assert_array_equal(br.bit_A.planes, bf.bit_A.planes)
        np.testing.assert_array_equal(br.bit_X.planes, bf.bit_X.planes)
        np.testing.assert_array_equal(br.a_words, bf.a_words)
        np.testing.assert_array_equal(br.tile_kidx, bf.tile_kidx)
    # the base batcher itself is untouched
    assert base.bit_width == 2


def test_precalc_doubles_feat_dim():
    ds = synthesize("Proteins", scale=0.02, seed=3)
    it = ClusterBatcher(ds, 4, 2, bit_width=2, precalc=True, shuffle=False)
    assert it.feat_dim == 2 * ds.feat_dim


def test_load_npz_reference_format(tmp_path, rng):
    """P1: reference-format npz (src_li/dst_li) loads like dataset.py."""
    from qgtc_ppopp22.graph import load_npz
    from qgtc_ppopp22.graph.datasets import load_dataset

    src = rng.integers(0, 100, 400)
    dst = rng.integers(0, 100, 400)
    p = tmp_path / "toy.npz"
    np.savez(p, src_li=src, dst_li=dst)
    ds = load_npz(str(p), dim=29, num_classes=2, name="toy")
    assert ds.num_nodes == int(max(src.max(), dst.max())) + 1
    assert ds.features.shape == (ds.num_nodes, 29)
    # undirected insertion: both directions present
    dense = ds.graph.subgraph_dense(np.arange(ds.num_nodes))
    assert np.array_equal(dense, dense.T)
    # masks follow the reference's prefix fractions (dataset.py:23-32)
    assert ds.train_mask.all()
    assert ds.val_mask.sum() == int(ds.num_nodes * 0.3)

    # load_dataset prefers an on-disk npz over synthesis
    np.savez(tmp_path / "Proteins.npz", src_li=src, dst_li=dst)
    ds2 = load_dataset("Proteins", data_dir=str(tmp_path))
    assert ds2.num_nodes == ds.num_nodes  # loaded, not synthesized


def test_synth_csr_disk_cache(tmp_path, monkeypatch):
    """Large synthetic topologies round-trip through the CSR disk
    cache byte-identically (node data regenerates from the seed)."""
    from qgtc_ppopp22.graph import datasets as dsmod

    monkeypatch.setattr(dsmod, "_CSR_CACHE_MIN_EDGES", 0)
    ds1 = dsmod.load_dataset(
        "Proteins", scale=0.02, cache_dir=str(tmp_path)
    )
    cached = [f for f in tmp_path.iterdir() if "_csr" in f.name]
    assert len(cached) == 1
    ds2 = dsmod.load_dataset(
        "Proteins", scale=0.02, cache_dir=str(tmp_path)
    )
    assert np.array_equal(ds1.graph.indptr, ds2.graph.indptr)
    assert np.array_equal(ds1.graph.indices, ds2.graph.indices)
    assert np.array_equal(ds1.features, ds2.features)
    assert np.array_equal(ds1.labels, ds2.labels)
