"""Partition-quality study: multilevel (native C++) vs BFS vs RCM.

Cluster quality drives the zero-tile skip ratios, dense-tile
efficiency, and the synthetic accuracy signal. Per dataset x
partitioner this emits (all host-side counts):

* ``edge_cut``     — fraction of edges crossing cluster boundaries
  (the reference's METIS quality axis, ``partition_utils.py:11-18``);
* ``batch_density``— nnz fraction of the batched dense adjacencies
  (higher = more edges kept per batch = more useful GEMM work);
* ``skip_ratio``   — fraction of all-zero (512-row x ``_colblock(pn)``)
  adjacency blocks under the RCM batch reorder;
* ``partition_s``  — host wall seconds to partition (cache bypassed).

Usage::

    python benchmarks/partition_quality.py --csv results/partition_quality.csv
"""

import argparse
import csv
import os
import sys
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import numpy as np


def _colblock(pn: int) -> int:
    """Smallest divisor of ``pn`` that is a multiple of 256 and >= 512
    (``pn`` itself when there is none)."""
    for w in range(512, pn, 256):
        if pn % w == 0:
            return w
    return pn


def _block_occ(words: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """1 where a (rows x cols) block of a packed 1-bit adjacency
    (``ops/packmm.PackedTensor`` words, 32 columns per word) holds an
    edge."""
    nd, pn, kw = words.shape
    blocks = words.reshape(nd, pn // rows, rows, pn // cols, cols // 32)
    return (blocks != 0).any(axis=(0, 2, 4)).astype(np.int32)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument(
        "--datasets",
        nargs="+",
        default=["Proteins", "artist", "soc-BlogCatalog", "ppi",
                 "ogbn-arxiv", "reddit", "ogbn-products"],
    )
    p.add_argument("--methods", nargs="+",
                   default=["native", "bfs", "rcm"])
    p.add_argument("--batch-size", type=int, default=20)
    p.add_argument("--csv", default=None)
    args = p.parse_args()

    from qgtc_ppopp22.graph import ClusterBatcher, load_dataset
    from qgtc_ppopp22.graph.datasets import DEFAULT_PSIZE
    from qgtc_ppopp22.graph.partition import (
        edge_cut_fraction,
        get_partition_list,
    )

    rows = []
    for name in args.datasets:
        ds = load_dataset(name)
        psize = DEFAULT_PSIZE.get(name, 1500)
        for method in args.methods:
            t0 = time.perf_counter()
            parts = get_partition_list(ds.graph, psize, method=method)
            part_s = time.perf_counter() - t0
            cut = edge_cut_fraction(ds.graph, parts)
            # batch-level metrics through the production batcher (RCM
            # reorder, shape buckets) — exactly what the kernels see
            it = ClusterBatcher(
                ds, psize=psize, batch_size=args.batch_size,
                bit_width=1, partition_method=method,
            )
            nnz = tot = 0
            skip_blocks = all_blocks = 0
            for b in it.batches:
                pn = b.padded_nodes
                w = np.asarray(b.a_words)
                nnz += int(
                    np.unpackbits(w.view(np.uint8)).sum()
                )
                tot += b.num_nodes * b.num_nodes
                occ = _block_occ(w, 512, _colblock(pn))
                skip_blocks += int((occ == 0).sum())
                all_blocks += occ.size
            rows.append(dict(
                dataset=name,
                method=method,
                psize=psize,
                edge_cut=round(cut, 4),
                batch_density=round(nnz / max(tot, 1), 5),
                skip_ratio=round(skip_blocks / max(all_blocks, 1), 4),
                partition_s=round(part_s, 2),
            ))
            print(rows[-1], flush=True)

    if args.csv and rows:
        with open(args.csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
        print(f"wrote {args.csv}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
