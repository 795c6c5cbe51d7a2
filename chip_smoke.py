"""Bring-up check: the quantized GNN engine on one NVIDIA GPU.

    python chip_smoke.py           # phases 0-2 on one card
    python chip_smoke.py --four    # phases 0 and 3 on four cards

* Phase 0 prints the card's name and power limit (``nvidia-smi``, in a
  child process that does not use JAX) and ``jax.devices()``, and stops
  unless JAX's device is a GPU.
* Phase 1 checks every GEMM of the main path against ``tests/golden.py``
  at real widths, compiled for the card: packed 1-bit A (pn=2560) @
  hidden of width 16 and 64 at bits 1/2/4/8, to digits and to f32, and
  the update X (2560x128) @ W (128x16). Exact equality: the dots are
  int8 with int32 accumulation, and f32 outputs are integers below
  2^24.
* Phase 2 runs ``qgtc_ppopp22.cli`` on ogbn-arxiv at the reference's
  configuration (psize 1500, batch 20, 3 layers): GCN 2-bit hidden 16,
  GIN 2-bit hidden 64 and GCN 8-bit, each in ``--mode fused`` and
  ``--mode step``, then checks the logits of the first batch of every
  shape bucket against ``qgcn_golden``/``qgin_golden`` bit for bit; and
  ``--regular`` (the bf16 baseline) against a float32 reference.
* Phase 3 (``--four`` only) runs the mesh engine at dp=4,sp=1 and
  dp=2,sp=2 on arxiv 2-bit, bit-exact against one device.

Every phase raises on failure. The last line of stdout is one JSON
object: ``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from qgtc_ppopp22.utils.cache import setup_compile_cache  # noqa: E402

setup_compile_cache()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from qgtc_ppopp22 import cli  # noqa: E402
from qgtc_ppopp22.models.qmodels import qgcn_golden, qgin_golden  # noqa: E402
from qgtc_ppopp22.ops.bitpack import unpack_bits  # noqa: E402
from qgtc_ppopp22.ops.digitmm import digitmm_to_digits  # noqa: E402
from qgtc_ppopp22.ops.digits import digit_pack, digit_unpack  # noqa: E402
from qgtc_ppopp22.ops.packmm import (  # noqa: E402
    PackedTensor,
    pack_rows_np,
    packmm_to_digits,
    packmm_to_f32,
)
from qgtc_ppopp22.utils.timing import device_info  # noqa: E402
from tests.golden import bitmm_np, quantize_np  # noqa: E402

# (tag, model, bits, hidden): the reference's two dataflows
# (main_qgtc.py:127-154) and the multi-digit 8-bit chain
CONFIGS = (
    ("gcn-2bit", "gcn", 2, 16),
    ("gin-2bit", "gin", 2, 64),
    ("gcn-8bit", "gcn", 8, 16),
)
ARXIV = dict(dataset="ogbn-arxiv", psize=1500, batch=20, scale=None)
# bf16 operands (8-bit mantissa, rounding error <= 2^-9) are rounded
# six times through three layers; the float32 reference rounds none.
REGULAR_RTOL = 2e-2


def card() -> str:
    """``name, power.limit`` of the card, read by nvidia-smi."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def phase0(require_gpu: bool = True) -> str:
    print(f"jax.devices(): {jax.devices()}")
    platform = jax.devices()[0].platform
    if require_gpu and platform != "gpu":
        raise SystemExit(f"phase 0: JAX found {platform}, not a GPU")
    line = card() if require_gpu else "no GPU (not measured)"
    print(f"card: {line}")
    return line


def _adjacency(rng, pn: int) -> np.ndarray:
    """A banded 0/1 adjacency (the structure of a reordered cluster
    batch)."""
    qa = (rng.random((pn, pn)) < 0.02).astype(np.int32)
    i = np.arange(pn)
    qa[np.abs(i[:, None] - i[None, :]) >= 512] = 0
    return qa


def phase1(pn=2560, widths=(16, 64), bit_list=(1, 2, 4, 8),
           x_shape=(2560, 128), w_cols=16, seed=0) -> int:
    """Each GEMM of the main path against the golden model; returns the
    number of exact checks."""
    rng = np.random.default_rng(seed)
    qa = _adjacency(rng, pn)
    a = PackedTensor(words=jnp.asarray(pack_rows_np(qa, 1)),
                     shape=(pn, pn), bits=1)
    checks = 0
    for n in widths:
        for bits in bit_list:
            qh = rng.integers(0, 1 << bits, (pn, n))
            h = digit_pack(jnp.asarray(qh), bits)
            dig = jax.jit(
                lambda a_, h_, b=bits: packmm_to_digits(a_, h_, b)
            )(a, h)
            f32 = jax.jit(packmm_to_f32)(a, h)
            ok_d = np.array_equal(
                np.asarray(digit_unpack(dig)),
                bitmm_np(qa, qh, 1, bits, bits),
            )
            ok_f = np.array_equal(
                np.asarray(f32),
                bitmm_np(qa, qh, 1, bits, None).astype(np.float32),
            )
            print(f"phase1 agg pn={pn} n={n} bits={bits}: "
                  f"digits {'exact' if ok_d else 'MISMATCH'}, "
                  f"f32 {'exact' if ok_f else 'MISMATCH'}")
            if not (ok_d and ok_f):
                raise AssertionError("phase 1: aggregation mismatch")
            checks += 2
    for bits in bit_list:
        qx = rng.integers(0, 1 << bits, x_shape)
        qw = rng.integers(0, 1 << bits, (x_shape[1], w_cols))
        out = jax.jit(
            lambda x_, w_, b=bits: digitmm_to_digits(x_, w_, b)
        )(digit_pack(jnp.asarray(qx), bits), digit_pack(jnp.asarray(qw), bits))
        ok = np.array_equal(
            np.asarray(digit_unpack(out)), bitmm_np(qx, qw, bits, bits, bits)
        )
        print(f"phase1 update {x_shape}@{(x_shape[1], w_cols)} "
              f"bits={bits}: {'exact' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError("phase 1: update mismatch")
        checks += 1
    return checks


def _argv(data: dict, n_epochs: int) -> list:
    argv = ["--dataset", data["dataset"], "--psize", str(data["psize"]),
            "--batch-size", str(data["batch"]), "--n-epochs",
            str(n_epochs), "--rnd_seed", "3", "--cache-dir",
            os.path.join(ROOT, "datasets")]
    if data.get("scale"):
        argv += ["--dataset-scale", str(data["scale"])]
    return argv


def _first_per_bucket(batcher):
    seen = {}
    for b in batcher.batches:
        seen.setdefault(b.padded_nodes, b)
    return list(seen.values())


def _peak_bytes():
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use", "not measured")


def phase2(data=ARXIV, configs=CONFIGS, modes=("fused", "step"),
           n_epochs=3, card_line="") -> int:
    """The CLI's main path end to end; returns the number of batches
    checked bit-exact against the golden model."""
    checked = 0
    for tag, model, bits, hidden in configs:
        for mode in modes:
            argv = _argv(data, n_epochs) + [
                "--use_QGTC", "--bit_width", str(bits), "--hidden",
                str(hidden), "--mode", mode,
            ] + (["--run_GIN"] if model == "gin" else [])
            rc, record, eng, batcher, ds = cli.run(argv)
            if rc != 0:
                raise AssertionError(f"phase 2: {tag} {mode} rc={rc}")
            print(f"phase2 {tag} mode={mode}: epoch "
                  f"{record['avg_epoch_ms']} ms, compiles in window "
                  f"{record['compiles_in_window']}, peak_bytes_in_use "
                  f"{_peak_bytes()}, {len(batcher)} batches, card "
                  f"{card_line}")
            firsts = _first_per_bucket(batcher)
            if mode == "fused":
                every = dict(zip(map(id, batcher.batches),
                                 eng.forward_all(batcher)))
                logits = [every[id(b)] for b in firsts]
            else:
                logits = [np.asarray(eng.forward_batch(b)) for b in firsts]
            qws = [quantize_np(np.asarray(w), bits)
                   for w in eng.float_weights]
            gold = qgcn_golden if model == "gcn" else qgin_golden
            for b, got in zip(firsts, logits):
                want = gold(np.asarray(unpack_bits(b.bit_A)),
                            np.asarray(unpack_bits(b.bit_X)), qws, bits,
                            bits)
                if not np.array_equal(got, want.astype(np.float32)):
                    raise AssertionError(
                        f"phase 2: {tag} {mode} pn={b.padded_nodes} "
                        "differs from the golden model"
                    )
                checked += 1
            print(f"phase2 {tag} mode={mode}: {len(firsts)} buckets "
                  "bit-exact vs golden")
    checked += _regular(data, n_epochs, card_line)
    return checked


def _regular(data, n_epochs, card_line) -> int:
    """``--regular``: bf16 baseline vs a float32 reference computed
    with ``jax.default_matmul_precision("highest")``."""
    rc, record, eng, batcher, ds = cli.run(
        _argv(data, n_epochs) + ["--regular", "--mode", "fused"]
    )
    if rc != 0:
        raise AssertionError(f"phase 2: regular rc={rc}")
    print(f"phase2 regular-bf16 mode=fused: epoch {record['avg_epoch_ms']}"
          f" ms, compiles in window {record['compiles_in_window']}, "
          f"peak_bytes_in_use {_peak_bytes()}, card {card_line}")

    @jax.jit
    def ref(a, x, ws):
        h = x
        for i, w in enumerate(ws):
            h = (a @ h) @ w
            if i < len(ws) - 1:
                h = jax.nn.relu(h)
        return h

    firsts = _first_per_bucket(batcher)
    worst = 0.0
    for b in firsts:
        got = np.asarray(eng.forward_batch(b, ds, batcher.features))
        a, x = eng._dense_cache[
            (b.padded_nodes, b.num_nodes, hash(b.nodes.tobytes()))
        ]
        with jax.default_matmul_precision("highest"):
            want = np.asarray(ref(jnp.asarray(a, jnp.float32),
                                  jnp.asarray(x), tuple(eng.weights)))
        err = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        worst = max(worst, err)
    print(f"phase2 regular-bf16: worst relative error {worst:.3e} over "
          f"{len(firsts)} buckets (limit {REGULAR_RTOL})")
    if not worst <= REGULAR_RTOL:
        raise AssertionError("phase 2: bf16 baseline off its reference")
    return len(firsts)


def phase3(data=ARXIV, meshes=((4, 1), (2, 2)), n_epochs=3,
           card_line="") -> int:
    """Mesh engine on four devices vs one device, bit-exact."""
    checked = 0
    for dp, sp in meshes:
        rc, record, eng, batcher, ds = cli.run(
            _argv(data, n_epochs) + ["--use_QGTC", "--bit_width", "2",
                                     "--mesh", f"{dp},{sp}"]
        )
        if rc != 0:
            raise AssertionError(f"phase 3: dp={dp} sp={sp} rc={rc}")
        print(f"phase3 dp={dp} sp={sp}: epoch {record['avg_epoch_ms']} ms"
              f", compiles in window {record['compiles_in_window']}, "
              f"devices {record['device']}, card {card_line}")
        refs = eng.single.forward_all(batcher)
        for b, r, o in zip(batcher.batches, refs,
                           eng.forward_batches(batcher)):
            if not np.array_equal(r[: b.num_nodes, : o.shape[1]], o):
                raise AssertionError(
                    f"phase 3: dp={dp} sp={sp} differs from one device"
                )
            checked += 1
        print(f"phase3 dp={dp} sp={sp}: {len(batcher)} batches bit-exact "
              "vs one device")
    return checked


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-card mesh phase")
    args = p.parse_args(argv)
    t0 = time.perf_counter()
    card_line = phase0()
    if args.four:
        if len(jax.devices()) < 4:
            raise SystemExit(f"--four needs 4 GPUs, found {jax.devices()}")
        phase3(card_line=card_line)
    else:
        phase1()
        phase2(card_line=card_line)
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s, card {card_line}")
    print(json.dumps({"ok": True, "device": device_info()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
