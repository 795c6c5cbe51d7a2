"""End-to-end epoch benchmark harness (reference ``0_7a`` / ``0_7b`` /
``1_7a`` / ``1_7b`` script family in one driver).

Loops datasets x engines (QGTC quantized vs full-precision baseline) x
models (Cluster-GCN / batched-GIN), invoking the same code path as
``qgtc_ppopp22.cli``, and writes a structured CSV — replacing the
reference's ``os.system`` + log-scrape pipeline
(``0_7a_eval_QGTC_cluster_GCN.py:20-47``, ``parse_time.py``).

Usage::

    python benchmarks/run_all.py --datasets Proteins artist ppi \
        [--gin] [--bits 1 2 4 8] [--csv results/epochs.csv]

Every row names the device it ran on; with no GPU the script stops.
"""

import argparse
import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

from qgtc_ppopp22.utils.cache import setup_compile_cache  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument(
        "--datasets",
        nargs="+",
        default=["Proteins", "artist", "soc-BlogCatalog", "ppi",
                 "ogbn-arxiv"],
    )
    p.add_argument("--bits", nargs="+", type=int, default=[2])
    p.add_argument("--gin", action="store_true")
    p.add_argument("--baseline", action="store_true",
                   help="also run the full-precision baseline engine")
    p.add_argument("--psize", type=int, default=None,
                   help="partition count (default: 1500, or the "
                        "per-dataset override for very large graphs)")
    p.add_argument("--batch-size", type=int, default=20)
    p.add_argument("--n-epochs", type=int, default=10)
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--mode", choices=("step", "fused"), default="fused")
    p.add_argument("--csv", type=str, default="results/epochs.csv")
    args = p.parse_args()

    setup_compile_cache()
    import jax

    if jax.devices()[0].platform != "gpu":
        print("run_all.py times the GPU; JAX found "
              f"{jax.devices()[0].platform}", file=sys.stderr)
        return 1

    from qgtc_ppopp22.graph import ClusterBatcher, load_dataset
    from qgtc_ppopp22.runtime import BaselineEngine, QGTCEngine

    model = "gin" if args.gin else "gcn"
    rows = []
    from qgtc_ppopp22.graph.datasets import DEFAULT_PSIZE
    from qgtc_ppopp22.utils.metrics import write_csv

    def flush():
        # Incremental write: a long multi-dataset sweep keeps its
        # finished rows even if a later config dies or is killed.
        if args.csv and rows:
            write_csv(args.csv, rows, list(rows[0].keys()))

    for name in args.datasets:
        ds = load_dataset(name, scale=args.scale)
        psize = args.psize or DEFAULT_PSIZE.get(name, 1500)
        # The structural batch work (densify, RCM, 1-bit A planes,
        # a_words, zero-tile schedule) is bit-width independent;
        # build it once and re-pack only X per width (rebit).
        base_it = ClusterBatcher(
            ds,
            psize=psize,
            batch_size=args.batch_size,
            bit_width=args.bits[0],
            cache_dir="./datasets",
        )
        for bits in args.bits:
            it = (
                base_it
                if bits == args.bits[0]
                else base_it.rebit(bits)
            )
            eng = QGTCEngine(
                feat_dim=it.feat_dim,
                num_classes=ds.num_classes,
                model=model,
                bit_width=bits,
            )
            if args.mode == "fused":
                st = eng.run_epochs_fused(it, n_epochs=args.n_epochs)
            else:
                st = eng.run_epochs(
                    it, n_epochs=args.n_epochs, resident=True
                )
            row = dict(
                dataset=name,
                model=model,
                engine="qgtc",
                bits=bits,
                mode=args.mode,
                epoch_ms=st.avg_ms,
                compiles_in_window=st.compiles,
                device=st.device["kind"],
                device_count=st.device["count"],
            )
            rows.append(row)
            print(row, flush=True)
            flush()

        if args.baseline:
            it = base_it if base_it.bit_width == 2 else base_it.rebit(2)
            beng = BaselineEngine(
                feat_dim=it.feat_dim,
                num_classes=ds.num_classes,
                model="gin" if args.gin else "sage",
            )
            if args.mode == "step":
                st = beng.run_epochs(it, ds, n_epochs=args.n_epochs)
            else:
                st = beng.run_epochs_fused(it, ds, n_epochs=args.n_epochs)
            row = dict(
                dataset=name,
                model=model,
                engine="fp-baseline",
                bits=32,
                mode=args.mode,
                epoch_ms=st.avg_ms,
                compiles_in_window=st.compiles,
                device=st.device["kind"],
                device_count=st.device["count"],
            )
            rows.append(row)
            print(row, flush=True)
            flush()

    if args.csv and rows:
        print(f"wrote {args.csv}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
