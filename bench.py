"""Headline benchmark: 2-bit Cluster-GCN epoch time on ogbn-arxiv.

Reference target (BASELINE.md / ``README.md:84-89``): 208.616 ms per
epoch on an sm_86 GPU at psize=1500, batch_size=20, hidden=16,
3 layers, 2-bit. Prints ONE JSON line:
``{"metric", "value", "unit", "vs_baseline", "device", "detail"}``
where ``vs_baseline`` is the speedup over the reference (>1 = faster)
and ``device`` names what ran it.

Timing follows the reference (``main_qgtc.py:112-159``): packed batches
are built before the timed region (its ``ClusterIter.__init__``
pre-packing), every shape is warmed up, then a host clock runs around
``n_epochs`` epochs ending in ``block_until_ready``. The default
``--mode fused`` keeps the packed batches in device memory and runs one
scanned dispatch per shape bucket; ``--mode step`` dispatches per batch
and ships each packed batch host->device inside the timed loop, the
reference's own boundary (``main_qgtc.py:115``).

Needs a GPU: with none, it exits non-zero without a number.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from qgtc_ppopp22.utils.cache import setup_compile_cache  # noqa: E402

BASELINE_MS = 208.616  # reference avg epoch, ogbn-arxiv (README.md:84-89)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mode", choices=("fused", "step"), default="fused")
    p.add_argument("--n-epochs", type=int, default=20)
    args = p.parse_args(argv)

    setup_compile_cache()
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {platform}", file=sys.stderr)
        return 1

    from qgtc_ppopp22.graph import ClusterBatcher, load_dataset
    from qgtc_ppopp22.runtime import QGTCEngine

    ds = load_dataset("ogbn-arxiv", data_dir="qgtc_graphs")
    batcher = ClusterBatcher(
        ds, psize=1500, batch_size=20, bit_width=2, seed=3,
        cache_dir="./datasets",
    )
    eng = QGTCEngine(
        feat_dim=batcher.feat_dim, num_classes=ds.num_classes,
        model="gcn", bit_width=2, seed=3,
    )
    if args.mode == "fused":
        stats = eng.run_epochs_fused(batcher, n_epochs=args.n_epochs)
    else:
        stats = eng.run_epochs(batcher, n_epochs=args.n_epochs)
    value = stats.avg_ms
    print(json.dumps({
        "metric": "ogbn-arxiv_cluster_gcn_2bit_epoch_ms",
        "value": value,
        "unit": "ms",
        "vs_baseline": BASELINE_MS / value,
        "device": stats.device,
        "detail": {
            "baseline_ms": BASELINE_MS,
            "mode": args.mode,
            "n_epochs": args.n_epochs,
            "batches_per_epoch": stats.n_batches,
            "compiles_in_window": stats.compiles,
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
