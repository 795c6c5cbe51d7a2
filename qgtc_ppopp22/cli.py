"""Command-line driver (reference ``main_qgtc.py`` /
``cluster_gcn_dgl.py`` equivalents in one entry point).

Usage mirrors the reference (``main_qgtc.py:21-41``)::

    python -m qgtc_ppopp22.cli --dataset ogbn-arxiv --bit_width 2 \
        --use_QGTC [--run_GIN] [--regular]

``--use_QGTC`` runs the quantized engine; ``--regular`` runs the
full-precision baseline (the DGL-driver role); ``--run_GIN`` switches
the dataflow GCN -> GIN (hidden 16 -> 64, matching
``0_7a…py:6`` / ``0_7b…py:6``). Prints ``Avg. Epoch: <ms> ms`` exactly
like the reference (``main_qgtc.py:157-159``) so its log parsers would
work unchanged, plus a structured JSON record.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time

import numpy as np

import jax

from qgtc_ppopp22.graph import ClusterBatcher, load_dataset
from qgtc_ppopp22.runtime import BaselineEngine, QGTCEngine
from qgtc_ppopp22.utils.cache import setup_compile_cache


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="QGTC quantized GNN driver")
    p.add_argument("--dataset", type=str, default="ppi")
    p.add_argument("--data-dir", type=str, default="qgtc_graphs")
    p.add_argument("--dataset-scale", type=float, default=1.0,
                   help="shrink factor for synthetic stand-in datasets")
    p.add_argument("--n-epochs", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=20)
    p.add_argument("--psize", type=int, default=None,
                   help="partition count (default: 1500, or a "
                        "per-dataset override for very large graphs)")
    p.add_argument("--hidden", type=int, default=None)
    p.add_argument("--num-layers", type=int, default=3)
    p.add_argument("--bit_width", type=int, default=2)
    p.add_argument("--use_QGTC", action="store_true")
    p.add_argument("--run_GIN", action="store_true")
    p.add_argument("--regular", action="store_true",
                   help="full-precision baseline (DGL-driver role)")
    p.add_argument("--sparse", action="store_true",
                   help="full-graph sparse quantized engine (CSR "
                        "segment-sum; no clustering/densification)")
    p.add_argument("--use-pp", action="store_true",
                   help="precompute feature aggregation (sampler precalc)")
    p.add_argument("--fmt", choices=("digits", "bits"), default="digits")
    p.add_argument("--resident", action="store_true",
                   help="park packed batches in device memory; time "
                        "compute only")
    p.add_argument("--mode", choices=("step", "fused"), default="step",
                   help="epoch execution: one dispatch per batch, or "
                        "one scanned dispatch per shape bucket")
    p.add_argument("--mesh", type=str, default=None, metavar="DP,SP",
                   help="run the packed engine over a (dp, sp) device "
                        "mesh (parallel/engine.py): batches shard over "
                        "dp (each device scans its shard), adjacency "
                        "rows over sp (packed ring aggregation). Needs "
                        "dp*sp <= len(jax.devices()).")
    p.add_argument("--sync-every-epoch", action="store_true",
                   help="per-epoch wall times instead of the "
                        "reference's one-sync-at-end methodology")
    p.add_argument("--bucket-rows", type=int, default=512)
    p.add_argument("--partition-method", type=str, default="auto")
    p.add_argument("--cache-dir", type=str, default="./datasets")
    p.add_argument("--rnd_seed", type=int, default=3)
    p.add_argument("--eval-accuracy", action="store_true")
    p.add_argument("--timing-split", action="store_true",
                   help="report transfer vs compute split (reference "
                        "cluster_gcn.py per-phase timers) for the "
                        "engine selected by --mode")
    p.add_argument("--quant-in-loop", action="store_true",
                   help="quantize + bit-pack features ON DEVICE inside "
                        "the timed epochs (reference cluster_gcn.py "
                        "in-loop val2bit variant, :181-206) instead of "
                        "pre-packing at batcher build")
    p.add_argument("--json-out", type=str, default=None)
    p.add_argument("--weights", type=str, default=None,
                   help="load a QAT checkpoint (models/train.py "
                        "save_checkpoint) instead of random weights")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="capture a jax.profiler trace of the timed "
                        "epochs into this directory")
    return p


def main(argv=None) -> int:
    return run(argv)[0]


def run(argv=None):
    """:func:`main`, returning ``(rc, record, engine, batcher, dataset)``
    so a caller can check the logits of the engine it timed
    (``batcher`` is None for ``--sparse``)."""
    args = build_parser().parse_args(argv)
    setup_compile_cache()
    random.seed(args.rnd_seed)
    np.random.seed(args.rnd_seed)

    t0 = time.perf_counter()
    ds = load_dataset(
        args.dataset, data_dir=args.data_dir, scale=args.dataset_scale
    )
    print(f"[t] dataset load/synth: {time.perf_counter()-t0:.1f}s")
    print(
        f"dataset {ds.name}: {ds.num_nodes} nodes, "
        f"{ds.graph.num_edges} edges, dim {ds.feat_dim}, "
        f"{ds.num_classes} classes"
    )

    t0 = time.perf_counter()
    if args.sparse:
        from qgtc_ppopp22.runtime import SparseEngine

        for flag, name in (
            (args.use_pp, "--use-pp"),
            (args.regular, "--regular"),
            (args.resident, "--resident"),
            (args.mode != "step", "--mode"),
        ):
            if flag:
                print(
                    f"warning: {name} has no effect with --sparse "
                    "(full-graph CSR engine)", file=sys.stderr
                )
        model = "gin" if args.run_GIN else "gcn"
        bit_width, hidden, num_layers = (
            args.bit_width, args.hidden, args.num_layers
        )
        shifts = float_ws = None
        if args.weights:
            from qgtc_ppopp22.models.train import load_checkpoint

            float_ws, shifts, ck_cfg, model = load_checkpoint(args.weights)
            bit_width, hidden, num_layers = (
                ck_cfg.bit_width, ck_cfg.hidden, ck_cfg.num_layers
            )
            print(
                f"loaded checkpoint: {model}, {bit_width}-bit, "
                f"hidden={hidden}, layers={num_layers}, shifts={shifts}"
            )
        eng = SparseEngine(
            ds, model=model, bit_width=bit_width, hidden=hidden,
            num_layers=num_layers, seed=args.rnd_seed, shifts=shifts,
            float_weights=float_ws,
        )
        stats = eng.run_epochs(
            args.n_epochs, sync_every_epoch=args.sync_every_epoch
        )
        record = dict(
            dataset=ds.name,
            bit_width=bit_width,
            model=model,
            engine="sparse-full-graph",
            n_epochs=args.n_epochs,
        )
        if args.eval_accuracy:
            acc = eng.evaluate(ds.labels)
            record["accuracy"] = acc
            print(f"accuracy: {acc:.4f}")
            if ds.multilabels is not None:
                f1 = eng.evaluate_f1(ds.multilabels)
                record.update(f1)
                print(
                    f"F1-mic: {f1['f1_micro']:.4f}, "
                    f"F1-mac: {f1['f1_macro']:.4f}"
                )
        return _emit(record, stats, args), record, eng, None, ds


    from qgtc_ppopp22.graph.datasets import DEFAULT_PSIZE

    mesh_dp = mesh_sp = None
    bucket_rows = args.bucket_rows
    if args.mesh:
        try:
            mesh_dp, mesh_sp = (int(v) for v in args.mesh.split(","))
        except ValueError:
            print(f"bad --mesh {args.mesh!r}; expected DP,SP",
                  file=sys.stderr)
            return 2, None, None, None, ds
        if mesh_sp > 1:
            # each sp shard must hold whole 256-row pack groups
            need = 256 * mesh_sp
            bucket_rows = -(-bucket_rows // need) * need

    psize = args.psize or DEFAULT_PSIZE.get(ds.name, 1500)
    batcher = ClusterBatcher(
        ds,
        psize=psize,
        batch_size=args.batch_size,
        bit_width=args.bit_width,
        seed=args.rnd_seed,
        bucket_rows=bucket_rows,
        precalc=args.use_pp,
        partition_method=args.partition_method,
        cache_dir=args.cache_dir,
    )
    print(
        f"[t] partition+pack: {time.perf_counter()-t0:.1f}s; "
        f"{len(batcher)} batches/epoch, shape buckets {batcher.buckets()}"
    )

    record = dict(
        dataset=ds.name,
        bit_width=args.bit_width,
        model="gin" if args.run_GIN else "gcn",
        engine="regular" if args.regular else "qgtc",
        psize=psize,
        batch_size=args.batch_size,
        n_epochs=args.n_epochs,
        resident=args.resident,
        mode=args.mode,
        mesh=args.mesh,
    )

    if args.mesh and not args.regular:
        from qgtc_ppopp22.parallel import MeshEngine

        for flag, name in (
            (args.resident, "--resident"),
            (args.mode != "step", "--mode"),
            (args.fmt != "digits", "--fmt"),
            (args.timing_split, "--timing-split"),
        ):
            if flag:
                print(
                    f"warning: {name} has no effect with --mesh (the "
                    "mesh engine always scans resident batches)",
                    file=sys.stderr,
                )
        shifts = None
        model_name = "gin" if args.run_GIN else "gcn"
        bit_width, hidden, num_layers = (
            args.bit_width, args.hidden, args.num_layers
        )
        if args.weights:
            from qgtc_ppopp22.models.train import load_checkpoint

            ck_ws, shifts, ck_cfg, model_name = load_checkpoint(args.weights)
            bit_width, hidden, num_layers = (
                ck_cfg.bit_width, ck_cfg.hidden, ck_cfg.num_layers
            )
            print(
                f"loaded checkpoint: {model_name}, {bit_width}-bit, "
                f"hidden={hidden}, layers={num_layers}, shifts={shifts}"
            )
        eng = MeshEngine(
            feat_dim=batcher.feat_dim,
            num_classes=ds.num_classes,
            dp=mesh_dp,
            sp=mesh_sp,
            model=model_name,
            bit_width=bit_width,
            hidden=hidden,
            num_layers=num_layers,
            seed=args.rnd_seed,
            shifts=shifts,
        )
        if args.weights:
            from qgtc_ppopp22.models.qmodels import pack_weights

            eng.float_weights = list(ck_ws)
            eng.weights = pack_weights(ck_ws, bit_width, fmt="digits")
        record["engine"] = f"qgtc-mesh-dp{mesh_dp}-sp{mesh_sp}"
        stats = eng.run_epochs(
            batcher, n_epochs=args.n_epochs,
            sync_every_epoch=args.sync_every_epoch,
        )
        if args.eval_accuracy:
            acc = eng.evaluate(batcher, ds.labels)
            record["accuracy"] = acc
            print(f"accuracy: {acc:.4f}")
    elif args.regular:
        eng = BaselineEngine(
            feat_dim=batcher.feat_dim,
            num_classes=ds.num_classes,
            model="gin" if args.run_GIN else "sage",
            hidden=args.hidden,
            num_layers=args.num_layers,
            seed=args.rnd_seed,
        )
        if args.mode == "fused":
            stats = eng.run_epochs_fused(batcher, ds, n_epochs=args.n_epochs)
        else:
            stats = eng.run_epochs(batcher, ds, n_epochs=args.n_epochs)
        if args.eval_accuracy:
            acc = eng.evaluate(batcher, ds, ds.labels)
            record["accuracy"] = acc
            print(f"accuracy: {acc:.4f}")
            if ds.multilabels is not None:
                f1 = eng.evaluate_f1(batcher, ds, ds.multilabels)
                record.update(f1)
                print(
                    f"F1-mic: {f1['f1_micro']:.4f}, "
                    f"F1-mac: {f1['f1_macro']:.4f}"
                )
    else:
        shifts = None
        model_name = "gin" if args.run_GIN else "gcn"
        bit_width, hidden, num_layers = (
            args.bit_width, args.hidden, args.num_layers
        )
        if args.weights:
            # The checkpoint is authoritative for the model geometry
            # and quantization config it was trained with.
            from qgtc_ppopp22.models.train import load_checkpoint

            ck_ws, shifts, ck_cfg, ck_model = load_checkpoint(args.weights)
            model_name = ck_model
            bit_width = ck_cfg.bit_width
            hidden = ck_cfg.hidden
            num_layers = ck_cfg.num_layers
            print(
                f"loaded checkpoint: {ck_model}, {bit_width}-bit, "
                f"hidden={hidden}, layers={num_layers}, shifts={shifts}"
            )
        eng = QGTCEngine(
            feat_dim=batcher.feat_dim,
            num_classes=ds.num_classes,
            model=model_name,
            bit_width=bit_width,
            hidden=hidden,
            num_layers=num_layers,
            fmt=args.fmt,
            seed=args.rnd_seed,
            shifts=shifts,
        )
        if args.weights:
            from qgtc_ppopp22.models.qmodels import pack_weights

            eng.float_weights = list(ck_ws)
            eng.weights = pack_weights(
                ck_ws, bit_width,
                fmt="digits" if args.fmt == "digits" else "bits",
            )
        if args.mode == "step" and not args.quant_in_loop:
            t0 = time.perf_counter()
            eng.warmup(batcher)
            print(f"[t] warmup/compile: {time.perf_counter()-t0:.1f}s")
        prof = None
        if args.profile_dir:
            prof = jax.profiler.trace(args.profile_dir)
            prof.__enter__()
        if args.quant_in_loop:
            # reference cluster_gcn.py in-loop val2bit variant
            record["quant_in_loop"] = True
            stats = eng.run_epochs_quant_in_loop(
                batcher, n_epochs=args.n_epochs,
                sync_every_epoch=args.sync_every_epoch,
            )
        elif args.mode == "fused":
            stats = eng.run_epochs_fused(
                batcher, n_epochs=args.n_epochs,
                sync_every_epoch=args.sync_every_epoch,
            )
        else:
            stats = eng.run_epochs(
                batcher, n_epochs=args.n_epochs, resident=args.resident,
                sync_every_epoch=args.sync_every_epoch,
            )
        if args.profile_dir and prof is not None:
            prof.__exit__(None, None, None)
        # Zero-tile counters (reference print_counter role,
        # kernel.h:17-28 / parse_counter.py): the 256x256 occupancy
        # maps are built at pack time, so counting is a host-side sum.
        total = processed = 0
        for b in batcher.batches:
            total += int(b.tile_kidx.size)
            processed += int(np.sum(b.tile_kcnt))
        record["tiles_total"] = total
        record["tiles_processed"] = processed
        print(
            f"zero-tile: {processed}/{total} tiles nonzero "
            f"({1 - processed / max(total, 1):.1%} skippable)"
        )
        if args.timing_split:
            # Split the engine ACTUALLY reported by --mode (round-2
            # always split the step engine, so the printed split did
            # not describe the headline next to it).
            if args.mode == "step" and not args.quant_in_loop:
                # transfer+compute (reference boundary) vs compute-only
                both = eng.run_epochs(
                    batcher, n_epochs=max(args.n_epochs // 2, 2),
                    resident=False,
                ).avg_ms
                comp = eng.run_epochs(
                    batcher, n_epochs=max(args.n_epochs // 2, 2),
                    resident=True,
                ).avg_ms
                transfer = max(both - comp, 0.0)
            else:
                # fused/quant-in-loop epochs are resident by
                # construction: their headline IS compute; transfer is
                # the measured packed-payload H2D wall per epoch.
                comp = stats.avg_ms
                transfer = eng.measure_transfer_ms(batcher)
            record["transfer_ms"] = round(transfer, 3)
            record["compute_ms"] = round(comp, 3)
            print(
                f"timing split ({args.mode}): transfer "
                f"{record['transfer_ms']:.2f} ms, compute "
                f"{record['compute_ms']:.2f} ms per epoch"
            )
        if args.eval_accuracy:
            acc = eng.evaluate(batcher, ds.labels)
            record["accuracy"] = acc
            print(f"accuracy: {acc:.4f}")
            if ds.multilabels is not None:
                f1 = eng.evaluate_f1(batcher, ds.multilabels)
                record.update(f1)
                print(
                    f"F1-mic: {f1['f1_micro']:.4f}, "
                    f"F1-mac: {f1['f1_macro']:.4f}"
                )

    return _emit(record, stats, args), record, eng, batcher, ds


def _emit(record: dict, stats, args) -> int:
    """The ONE record/print/JSON tail every engine shares (reference
    print format ``main_qgtc.py:157-159`` + structured record naming
    the device it ran on)."""
    print(f"Avg. Epoch: {stats.avg_ms:.3f} ms")
    record["avg_epoch_ms"] = stats.avg_ms
    record["epoch_ms"] = stats.epoch_ms
    record["compiles_in_window"] = stats.compiles
    record["device"] = stats.device
    line = json.dumps(record)
    print(line)
    if args.json_out:
        with open(args.json_out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
