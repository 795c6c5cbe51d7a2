"""Diagnose the accuracy-frontier dead cells.

Two probes, committed to ``results/frontier_probe.csv``:

1. **ppi GIN 1-bit F1 = 0.0** — the frontier reports a deployed
   micro-F1 BELOW the all-negative trivial predictor. Hypothesis: the
   1-bit aggregate-first chain saturates the logits to a per-class
   CONSTANT, and the calibrated-threshold rule (``centered = logits -
   per-class mean; pred = centered > 0``) then predicts nothing.
   The probe retrains the winner config and records per-class logit
   variance, the fraction of constant classes, and what the
   trivial-tie-break alternatives would score — establishing the 0.0
   is a threshold artifact of a degenerate chain, not an engine bug.

2. **soc-BlogCatalog GIN flat at the 1-bit floor for 2/4/8 bits** —
   hypothesis: GIN aggregates FIRST (``main_qgtc.py:131-138``), and
   on a dense graph the unsigned requant clamp saturates the first
   aggregation before any weight can shape it; the calibrated shift
   cannot rescue it because dividing by 2^s also destroys the 2-bit
   feature levels. The probe sweeps the first-aggregation shift
   around the calibrated value at 2 bits and records per-stage
   saturation fractions + deployed accuracy — showing whether ANY
   shift choice escapes the floor within reference semantics.

Run on CPU (the training twins are small)::

    python benchmarks/frontier_probe.py --csv results/frontier_probe.csv
"""

import argparse
import csv
import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--scale", type=float, default=0.05)
    p.add_argument("--csv", default=None)
    args = p.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.extend.backend

    jax.extend.backend.clear_backends()

    from qgtc_ppopp22.graph import ClusterBatcher, load_dataset
    from qgtc_ppopp22.graph.batching import quantize_np
    from qgtc_ppopp22.models.qmodels import QModelConfig
    from qgtc_ppopp22.models.train import (
        qat_train,
        quantized_accuracy,
    )
    from qgtc_ppopp22.runtime import QGTCEngine
    from qgtc_ppopp22.models.qmodels import pack_weights
    from qgtc_ppopp22.utils.metrics import multilabel_f1
    from tests.golden import bitmm_np

    rows = []

    # ---- probe 1: ppi GIN 1-bit ------------------------------------
    ds = load_dataset("ppi", scale=args.scale)
    it = ClusterBatcher(
        ds, psize=8, batch_size=2, bit_width=1, shuffle=False,
    )
    cfg = QModelConfig(
        in_dim=it.feat_dim, hidden=64,
        out_dim=ds.multilabels.shape[1], bit_width=1,
    )
    ws, shifts, _ = qat_train(
        ds, it, cfg, model="gin", seed=0, lr=1e-2, multilabel=True,
    )
    eng = QGTCEngine(
        feat_dim=it.feat_dim, num_classes=ds.multilabels.shape[1],
        model="gin", bit_width=1, hidden=64, shifts=shifts,
    )
    eng.float_weights = list(ws)
    eng.weights = pack_weights(ws, 1, fmt="digits")
    logit_rows = []
    lab_rows = []
    for b, lg in zip(it.batches, eng.forward_all(it)):
        logit_rows.append(lg[: b.num_nodes, : ds.multilabels.shape[1]])
        lab_rows.append(ds.multilabels[b.nodes])
    L = np.concatenate(logit_rows)
    Y = np.concatenate(lab_rows)
    var = L.var(axis=0)
    centered = L - L.mean(axis=0, keepdims=True)
    f1_cal = multilabel_f1(centered, Y)
    f1_allpos = multilabel_f1(np.ones_like(L), Y)
    f1_raw = multilabel_f1(L, Y)  # reference rule on raw (unsigned!)
    rows.append(dict(
        probe="ppi_gin_1bit", config="winner(seed0,lr0.01)",
        value=round(float(f1_cal), 4),
        const_class_frac=round(float((var == 0).mean()), 4),
        mean_logit_var=round(float(var.mean()), 4),
        f1_allpos_trivial=round(float(f1_allpos), 4),
        f1_raw_unsigned=round(float(f1_raw), 4),
        note=(
            "per-class-constant logits -> calibrated threshold "
            "predicts nothing; raw>0 on unsigned logits predicts "
            "everything (=trivial). Degenerate 1-bit chain, not an "
            "engine bug."
        ),
    ))
    print(rows[-1], flush=True)

    # ---- probe 2: soc GIN 2-bit shift sweep ------------------------
    ds2 = load_dataset("soc-BlogCatalog", scale=args.scale)
    it2 = ClusterBatcher(
        ds2, psize=8, batch_size=2, bit_width=2, shuffle=False,
    )
    cfg2 = QModelConfig(
        in_dim=it2.feat_dim, hidden=64,
        out_dim=ds2.num_classes, bit_width=2,
    )
    ws2, sh2, acc_base = qat_train(
        ds2, it2, cfg2, model="gin", seed=2, lr=1e-2,
    )
    q2 = [quantize_np(np.asarray(w), 2) for w in ws2]
    # per-stage saturation under the calibrated shifts on batch 0
    from qgtc_ppopp22.ops.bitpack import bit2val

    b0 = it2.batches[0]
    n0 = b0.num_nodes
    qa = np.asarray(bit2val(b0.bit_A))[:n0, :n0]
    qx = quantize_np(
        np.asarray(ds2.features[b0.nodes], np.float32), 2
    )
    rail = 3
    for ds0 in (-2, -1, 0, 1, 2):
        sh_t = list(sh2)
        sh_t[0] = max(0, sh_t[0] + ds0)
        h = bitmm_np(qa, qx, 1, 2, 2, sh_t[0])
        sat0 = float((h == rail).mean())
        acc = quantized_accuracy(
            ds2, it2, ws2, 2, "gin", shifts=sh_t
        )
        rows.append(dict(
            probe="soc_gin_2bit_shift0", config=f"shift0={sh_t[0]}",
            value=round(float(acc), 4),
            const_class_frac=None,
            mean_logit_var=None,
            f1_allpos_trivial=None,
            f1_raw_unsigned=None,
            note=(
                f"first-agg saturation {sat0:.3f}; baseline acc "
                f"{acc_base:.4f}; 1-bit floor 0.039"
            ),
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
