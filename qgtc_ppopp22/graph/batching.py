"""Cluster batching: partition, densify, quantize, pre-pack, bucket-pad.

Equivalent of the reference's ``ClusterIter`` (``sampler.py:21-149``):
at init, every batch of ``batch_size`` partitions is merged into a
subgraph whose dense binary adjacency and quantized features are
bit-packed once and parked host-side (reference parks on CPU,
``sampler.py:104``); iteration yields packed batches, and the per-step
host->device transfer is what epoch timing includes
(``main_qgtc.py:115``, SURVEY quirk 8).

Redesign for XLA — **shape bucketing**: the reference lets every
batch have its own node count (``A_size_0`` varies per batch,
``main_qgtc.py:123-126``), which is hostile to XLA (a recompile per
distinct shape). Here each batch's node count is padded up to a
multiple of ``bucket_rows`` (default 512), so all batches of a dataset
land in a handful of shape buckets and jit compiles once per bucket.
Zero rows/columns are exact no-ops through the bit-GEMM chain
(zero adjacency rows aggregate nothing; zero feature rows quantize to
level 0), so padding changes no real output row.
"""

from __future__ import annotations

import copy
import dataclasses
import random
from typing import List, Optional, Tuple

import numpy as np
import scipy.sparse as sp

from qgtc_ppopp22.graph.csr import CSRGraph
from qgtc_ppopp22.graph.datasets import GraphDataset
from qgtc_ppopp22.graph.partition import get_partition_list
from qgtc_ppopp22.ops.bitpack import BitTensor, pack_bits_np, round_up

DEFAULT_BUCKET_ROWS = 512


def _native_or_none():
    """The native host library, or None (NumPy fallback paths)."""
    try:
        from qgtc_ppopp22 import native

        if native.available():
            return native
    except Exception:
        pass
    return None


def quantize_np(x: np.ndarray, bits: int) -> np.ndarray:
    """NumPy mirror of :func:`qgtc_ppopp22.ops.quantize.quantize`."""
    ub = float(1 << bits)
    x = np.asarray(x, np.float32)
    clipped = np.where(x < 0.0, 1.0, np.where(x > ub, ub - 1.0, x))
    return np.round(clipped).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class ClusterBatch:
    """One pre-packed cluster batch (host-side NumPy planes).

    ``num_nodes`` is the real (unpadded) node count; ``padded_nodes``
    the bucket size both A and X rows were padded to. ``bit_A`` is
    (padded_nodes, padded_nodes) 1-bit; ``bit_X`` is
    (padded_nodes, feat_dim) ``bit_width``-bit. ``a_words`` is the
    adjacency in the K-packed word layout the aggregation GEMMs
    consume (``ops/packmm.pack_rows_np``, int32[1, pn, pn//32]) —
    same byte count as ``bit_A``, packed along the other axis.
    ``tile_kidx``/``tile_kcnt`` is the zero-tile occupancy schedule
    over ``a_words``'s (256 x 256) tiles, built once at pack time
    (reference Fig. 8b mechanism, ``kernel.h:572-592``).
    """

    nodes: np.ndarray  # int64[num_nodes] global node ids
    bit_A: BitTensor
    bit_X: BitTensor
    num_nodes: int
    padded_nodes: int
    a_words: Optional[np.ndarray] = None
    tile_kidx: Optional[np.ndarray] = None  # int32[nm, nk]
    tile_kcnt: Optional[np.ndarray] = None  # int32[nm]

    def nbytes(self) -> int:
        return self.bit_A.nbytes() + self.bit_X.nbytes()


class ClusterBatcher:
    """Pre-packed cluster-batch producer (reference ``ClusterIter``).

    Parameters mirror the reference driver's
    (``main_qgtc.py:25-33``): ``psize`` partitions, ``batch_size``
    partitions merged per step, ``bit_width``-bit features, 1-bit
    adjacency. ``precalc`` reproduces the optional GraphSAGE-style
    feature pre-aggregation (``sampler.py:108-126``): features become
    ``concat([X, (A @ X) * 1/in_degree])``, doubling ``feat_dim``.
    """

    def __init__(
        self,
        dataset: GraphDataset,
        psize: int,
        batch_size: int,
        bit_width: int = 2,
        seed: int = 0,
        bucket_rows: int = DEFAULT_BUCKET_ROWS,
        precalc: bool = False,
        partition_method: str = "auto",
        cache_dir: Optional[str] = None,
        shuffle: bool = True,
        feature_scale: float = 1.0,
        reorder: str = "rcm",
        quant_bits: Optional[int] = None,
    ):
        if reorder not in ("none", "rcm"):
            raise ValueError(f"reorder must be 'none' or 'rcm': {reorder}")
        if quant_bits is not None and quant_bits > bit_width:
            raise ValueError(
                f"quant_bits ({quant_bits}) must be <= bit_width "
                f"({bit_width}): values wider than the datapath "
                "decomposition cannot be represented"
            )
        self.dataset = dataset
        self.psize = psize
        self.batch_size = batch_size
        self.bit_width = bit_width
        # Feature quantization grid width. Defaults to the datapath
        # width; a NARROWER grid (quant_bits < bit_width) makes the
        # wider engine consume a lower-bit model's exact inputs — the
        # upper bit planes / digits are simply zero — which is what
        # lets a b-bit deployment reproduce a b'-bit solution
        # bit-exactly at b-bit cost (see models/train.qat_ladder).
        self.quant_bits = quant_bits or bit_width
        self.bucket_rows = bucket_rows
        self.feature_scale = feature_scale
        self.reorder = reorder
        self._rng = random.Random(seed)

        g = dataset.graph
        feats = dataset.features
        if feature_scale != 1.0:
            # Host-side input preprocessing: scale features BEFORE the
            # reference quantizer (clip to [0, 2^bits] + round,
            # kernel.h:31-71) so wide bit widths actually use their
            # level range — raw N(0,1)-ish features occupy only the
            # bottom ~4 levels of an 8-bit grid otherwise. The engine
            # semantics are unchanged (the scale is data prep, like
            # normalization).
            feats = feats * np.float32(feature_scale)
        if precalc:
            deg = g.degrees().astype(np.float32)
            norm = np.where(deg > 0, 1.0 / np.maximum(deg, 1), 0.0)
            agg = (g.to_scipy().astype(np.float32) @ feats) * norm[:, None]
            feats = np.concatenate([feats, agg], axis=1)
        self.features = feats
        self.feat_dim = int(feats.shape[1])

        # Hoist the CSR arrays to the contiguous int64 the native
        # extractor takes ONCE: the disk cache stores indices as
        # int32 (datasets.py), and converting 61-114M edges inside
        # every per-batch native call was a ~0.7 s/batch hidden copy
        # (the whole batcher build cost at ogbn-products scale).
        self._native = _native_or_none()
        self._indptr64 = np.ascontiguousarray(g.indptr, np.int64)
        self._indices64 = np.ascontiguousarray(g.indices, np.int64)

        self.par_li: List[np.ndarray] = get_partition_list(
            g,
            psize,
            method=partition_method,
            cache_dir=cache_dir,
            cache_name=dataset.name,
        )
        if shuffle:
            self._rng.shuffle(self.par_li)
        self.max = psize // batch_size

        self.batches: List[ClusterBatch] = [
            self._build_batch(g, i) for i in range(self.max)
        ]

    def _build_batch(self, g: CSRGraph, i: int) -> ClusterBatch:
        parts = self.par_li[i * self.batch_size : (i + 1) * self.batch_size]
        nonempty = [p for p in parts if len(p)]
        nodes = (
            np.sort(np.concatenate(nonempty))
            if nonempty
            else np.empty(0, np.int64)
        )
        n = len(nodes)
        pn = round_up(max(n, 1), self.bucket_rows)

        # Densify with the SORTED node list first — the native
        # extractor binary-searches ``nodes`` (qgtc_native.cpp:283)
        # and requires ascending order — then apply any reordering as
        # a row/col permutation of the dense block.
        native = self._native
        if native is not None:
            dense_a = native.subgraph_dense_native(
                self._indptr64, self._indices64, nodes, pn
            )
        else:
            dense_a = np.zeros((pn, pn), np.uint8)
            dense_a[:n, :n] = g.subgraph_dense(nodes)

        if self.reorder == "rcm" and n > 2:
            # Reverse-Cuthill-McKee on the batch union: a pure host-
            # side row/col relabeling (outputs, labels and masks all
            # key off ``nodes``, so exactness is untouched) that
            # concentrates the adjacency into a band. Measured on
            # ogbn-arxiv batches, 512x512 all-zero blocks go from
            # 3.5% to 47% — this is what makes zero-tile jumping
            # (reference Fig. 8b, ``kernel.h:572-592``) find holes at
            # 256-512 block granularities. Computed from
            # the already-dense block so the full-graph scipy matrix
            # is never rebuilt per batch.
            from scipy.sparse.csgraph import reverse_cuthill_mckee

            sub = sp.csr_matrix(dense_a[:n, :n])
            perm = np.asarray(
                reverse_cuthill_mckee(sub, symmetric_mode=False),
                np.int64,
            )
            nodes = nodes[perm]
            dense_a[:n, :n] = dense_a[:n, :n][np.ix_(perm, perm)]

        if native is not None:
            from qgtc_ppopp22.ops.bitpack import BitTensor

            a_planes = native.pack_bits_u32_2d(dense_a, 1, pn, pn)
            bit_a = BitTensor(planes=a_planes, shape=(pn, pn), bits=1)
        else:
            bit_a = pack_bits_np(dense_a.astype(np.int32), 1)
        bit_x = self._pack_x(
            nodes, n, pn, self.bit_width, self.quant_bits
        )
        from qgtc_ppopp22.ops.packmm import (
            build_tile_map_packed_np,
            pack_rows_np,
        )

        a_words = pack_rows_np(np.asarray(dense_a, np.int32), 1)
        kidx, kcnt = build_tile_map_packed_np(a_words, 1)
        return ClusterBatch(
            nodes=nodes,
            bit_A=bit_a,
            bit_X=bit_x,
            num_nodes=n,
            padded_nodes=pn,
            a_words=a_words,
            tile_kidx=kidx,
            tile_kcnt=kcnt,
        )

    def _pack_x(
        self,
        nodes: np.ndarray,
        n: int,
        pn: int,
        bit_width: int,
        quant_bits: int,
    ) -> "BitTensor":
        """Quantize + bit-pack the batch features at ``bit_width``.

        ``nodes`` is the (already reorder-permuted) global-id list the
        batch stores, so this is exactly the feature work of
        ``_build_batch`` — the only per-batch cost that depends on the
        bit width (reference ``val2bit(X, bit_width)``,
        ``sampler.py:98-106`` role)."""
        x = np.zeros((pn, self.feat_dim), np.float32)
        x[:n] = self.features[nodes]
        native = self._native
        if native is not None:
            from qgtc_ppopp22.ops.bitpack import (
                COL_PAD,
                ROW_PAD,
                BitTensor,
            )

            qx = native.quantize_native(x, quant_bits)
            if quant_bits < bit_width:
                # Narrow-grid wrap: the quant_bits-wide deployment
                # packs into quant_bits planes, keeping only the low
                # bits (2^qb wraps to 0, kernel.h:204-242); apply it
                # here so the wider container is bit-exact to it.
                qx = qx % (1 << quant_bits)
            xp = round_up(self.feat_dim, COL_PAD)
            x_planes = native.pack_bits_u32_2d(
                qx, bit_width, round_up(pn, ROW_PAD), xp
            )
            return BitTensor(
                planes=x_planes,
                shape=(pn, self.feat_dim),
                bits=bit_width,
            )
        qx = quantize_np(x, quant_bits)
        if quant_bits < bit_width:
            qx = qx % (1 << quant_bits)  # narrow-grid wrap
        return pack_bits_np(qx, bit_width)

    def rebit(
        self, bit_width: int, quant_bits: Optional[int] = None
    ) -> "ClusterBatcher":
        """A batcher at a different feature bit width, reusing every
        bit-independent artifact of this one.

        The structural per-batch work — subgraph densification, RCM
        reordering, 1-bit adjacency planes, packed ``a_words`` and the
        zero-tile occupancy schedule — does not depend on the feature
        bit width; only the X quantize+pack does (and it is ~1000x
        cheaper, milliseconds per batch). Sweeping bit widths with
        fresh ``ClusterBatcher`` builds re-did all of it per width,
        which at ogbn-products scale was ~13 min per width."""
        qb = quant_bits or bit_width
        if qb > bit_width:
            raise ValueError(
                f"quant_bits ({qb}) must be <= bit_width ({bit_width})"
            )
        nb = copy.copy(self)
        nb.bit_width = bit_width
        nb.quant_bits = qb
        nb.batches = [
            dataclasses.replace(
                b,
                bit_X=self._pack_x(
                    b.nodes, b.num_nodes, b.padded_nodes, bit_width, qb
                ),
            )
            for b in self.batches
        ]
        return nb

    def buckets(self) -> List[int]:
        """Distinct padded node counts (one jit compilation each)."""
        return sorted({b.padded_nodes for b in self.batches})

    def __len__(self) -> int:
        return self.max

    def __iter__(self):
        order = list(range(self.max))
        self._rng.shuffle(order)
        for i in order:
            yield self.batches[i]


def batch_labels(
    dataset: GraphDataset, batch: ClusterBatch
) -> Tuple[np.ndarray, np.ndarray]:
    """(labels, valid_mask) aligned to the batch's padded rows."""
    lab = np.zeros(batch.padded_nodes, np.int64)
    lab[: batch.num_nodes] = dataset.labels[batch.nodes]
    mask = np.zeros(batch.padded_nodes, bool)
    mask[: batch.num_nodes] = True
    return lab, mask
