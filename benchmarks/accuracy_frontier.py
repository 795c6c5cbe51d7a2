"""Accuracy-vs-bit-width frontier (BASELINE.json config 4).

Trains the quantization-aware float twin per bit width (QAT:
smooth pretrain -> shift calibration -> STE fine-tune, see
``models/train.py``) and reports the DEPLOYED quantized engine's
node-classification accuracy at 1/2/4/8 bits — something the
reference could never measure (ones-weights, no backward). The STE
forward is integer-exact to the engine, so train accuracy == deployed
accuracy by construction (asserted in tests).

Usage::

    python benchmarks/accuracy_frontier.py --datasets Proteins artist \
        --scale 0.05 --csv results/accuracy_frontier.csv
"""

import argparse
import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import numpy as np


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--datasets", nargs="+", default=["Proteins"])
    p.add_argument("--bits", nargs="+", type=int, default=[1, 2, 4, 8])
    p.add_argument("--psize", type=int, default=8)
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--scale", type=float, default=0.05)
    p.add_argument("--hidden", type=int, default=None)
    p.add_argument("--gin", action="store_true")
    p.add_argument("--both-models", action="store_true")
    p.add_argument("--seeds", nargs="+", type=int, default=[0, 1, 2])
    p.add_argument("--f1", action="store_true",
                   help="multilabel micro/macro F1 frontier (ppi; "
                        "reference calc_f1 role, utils.py:43-50)")
    p.add_argument("--lrs", nargs="+", type=float, default=[1e-2],
                   help="base lrs for the fresh-QAT candidate pool "
                        "(high-width GIN needs 2e-2; see "
                        "results/artist_gin_probe.csv)")
    p.add_argument("--cpu", action="store_true",
                   help="force CPU (QAT is small)")
    p.add_argument("--csv", type=str, default=None)
    args = p.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from qgtc_ppopp22.utils.cache import setup_compile_cache

    setup_compile_cache()

    from qgtc_ppopp22.graph import ClusterBatcher, load_dataset
    from qgtc_ppopp22.models.train import qat_ladder

    models = ["gin"] if args.gin else ["gcn"]
    if args.both_models:
        models = ["gcn", "gin"]
    rows = []
    for name in args.datasets:
        ds = load_dataset(name, scale=args.scale)

        def make_batcher(bits, feature_scale=1.0, quant_bits=None):
            return ClusterBatcher(
                ds,
                psize=args.psize,
                batch_size=args.batch_size,
                bit_width=bits,
                shuffle=False,
                feature_scale=feature_scale,
                quant_bits=quant_bits,
            )

        for model in models:
            hidden = args.hidden or (16 if model == "gcn" else 64)
            got = qat_ladder(
                ds, make_batcher, args.bits, model=model,
                hidden=hidden, seeds=args.seeds, verbose=False,
                metric="f1" if args.f1 else "accuracy",
                lrs=args.lrs,
            )
            for row in got:
                row = dict(dataset=name, **row)
                rows.append(row)
                print(row, flush=True)

    if args.csv and rows:
        from qgtc_ppopp22.utils.metrics import write_csv

        write_csv(args.csv, rows, list(rows[0].keys()))
        print(f"wrote {args.csv}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
