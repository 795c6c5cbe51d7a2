"""Why is the artist GIN frontier flat?

The committed frontier rides the 1-bit floor (0.1457) at every width:
no fresh 4/8-bit GIN training on artist ever beat the carried 1-bit
solution. This grid probes the knobs the ladder holds fixed —
feature-scale multiplier, base lr, seed — at 4/8 bits, within
reference semantics (the engine is untouched; only training inputs
and optimizer vary). Every cell reports the DEPLOYED quantized
accuracy. If some cell beats the floor, its recipe becomes a ladder
candidate; if none does, this grid is the committed evidence that the
unsigned clip-to-[0, 2^b] lattice caps artist GIN.

Runs on the CPU (the training twins are small)::

    python benchmarks/artist_gin_probe.py --csv results/artist_gin_probe.csv
"""

import argparse
import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--bits", nargs="+", type=int, default=[4, 8])
    p.add_argument("--scale", type=float, default=0.05)
    p.add_argument("--seeds", nargs="+", type=int, default=[0, 1, 2, 3])
    p.add_argument("--csv", default=None)
    args = p.parse_args()

    from qgtc_ppopp22.graph import ClusterBatcher, load_dataset
    from qgtc_ppopp22.models.qmodels import QModelConfig
    from qgtc_ppopp22.models.train import (
        ladder_feature_scale,
        qat_train,
        quantized_accuracy,
    )

    ds = load_dataset("artist", scale=args.scale)
    rows = []
    floor = 0.1457  # committed 1-bit artist GIN frontier value
    for bits in args.bits:
        for fs_mult in (0.25, 1.0, 4.0):
            fs = ladder_feature_scale(bits) * fs_mult
            it = ClusterBatcher(
                ds, psize=8, batch_size=2, bit_width=bits,
                shuffle=False, feature_scale=fs,
            )
            cfg = QModelConfig(
                it.feat_dim, 64, ds.num_classes, bit_width=bits
            )
            for lr0 in (5e-3, 2e-2):
                for seed in args.seeds:
                    ws, sh, acc = qat_train(
                        ds, it, cfg, model="gin", seed=seed, lr=lr0,
                    )
                    dep = quantized_accuracy(
                        ds, it, ws, bits, "gin", shifts=sh
                    )
                    rows.append(dict(
                        bits=bits, fs_mult=fs_mult, lr=lr0, seed=seed,
                        train_acc=round(float(acc), 4),
                        deployed_acc=round(float(dep), 4),
                        beats_floor=dep > floor + 1e-4,
                    ))
                    print(rows[-1], flush=True)

    best = max(rows, key=lambda r: r["deployed_acc"])
    print(f"best: {best}")
    if args.csv and rows:
        import csv

        with open(args.csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
        print(f"wrote {args.csv}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
