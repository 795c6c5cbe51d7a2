"""Quantization-aware fp32 training for the quantized inference engine.

The reference never trains: its benchmark weights are ``torch.ones``
(``main_qgtc.py:100-102``) and its quantized layers' backward passes
return ``None`` (``QGTC_conv.py:24-27``), so accuracy at a given bit
width was never measurable. This module closes that gap: it trains a
float32 *twin* of the quantized dataflow whose activation function is
the quantizer's clamp (``clip(h, 0, 2^bits)`` — exactly what the fused
requantize epilogue applies, ``kernel.h:347-351``), with weights
projected into the quantizer's representable range after each step.
The trained weights drop straight into :class:`QGTCEngine` /
``pack_weights`` for 1/2/4/8-bit inference, giving a real
accuracy-vs-bit-width frontier on the same graphs the throughput
benchmarks use.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from qgtc_ppopp22.graph.batching import ClusterBatcher, batch_labels
from qgtc_ppopp22.graph.datasets import GraphDataset
from qgtc_ppopp22.models.qmodels import QModelConfig


def _ste(exact: jnp.ndarray, smooth: jnp.ndarray) -> jnp.ndarray:
    """Straight-through: forward value ``exact``, gradient of ``smooth``."""
    return smooth + jax.lax.stop_gradient(exact - smooth)


def _quantize_ste(x: jnp.ndarray, bit_width: int) -> jnp.ndarray:
    """Input quantizer with STE (reference ``Quantize_val`` semantics,
    including the level-``2^bits``-wraps-to-0 pack behavior)."""
    ub = float(1 << bit_width)
    clipped = jnp.where(x < 0.0, 1.0, jnp.where(x > ub, ub - 1.0, x))
    r = jnp.round(clipped)
    r = jnp.where(r == ub, 0.0, r)
    return _ste(r, jnp.clip(x, 0.0, ub))


def _requant_ste(acc: jnp.ndarray, bit_width: int, s: int) -> jnp.ndarray:
    """Requantize with STE: forward is the EXACT integer epilogue
    (floor-shift, clamp, 2^bits wrap — ``kernel.h:347-351`` + pack
    wrap), gradient is the smooth ``clip(acc / 2^s, 0, 2^bits)``."""
    ub = float(1 << bit_width)
    scaled = acc / float(1 << s)
    r = jnp.floor(scaled)
    r = jnp.where(r > ub, ub - 1.0, jnp.where(r < 0.0, 1.0, r))
    r = jnp.where(r == ub, 0.0, r)  # pack keeps low bits: 2^b wraps
    return _ste(r, jnp.clip(scaled, 0.0, ub))


def _weights_ste(ws, bit_width: int):
    """Weight quantizer with STE (same semantics as the inputs')."""
    return [_quantize_ste(w, bit_width) for w in ws]


def float_twin_forward(
    a: jnp.ndarray,
    x: jnp.ndarray,
    ws: Sequence[jnp.ndarray],
    bit_width: int,
    model: str = "gcn",
    shifts: Optional[Sequence[int]] = None,
    ste: bool = True,
) -> jnp.ndarray:
    """Trainable forward of the quantized dataflow.

    With ``ste=True`` (default) the forward pass computes the *exact*
    integer semantics of the deployed engine (weights and inputs
    rounded to levels, accumulators floor-shifted/clamped/wrapped as
    in the fused epilogue) while gradients flow through smooth
    surrogates — so training accuracy IS deployed quantized accuracy.
    ``ste=False`` gives the fully-smooth relaxation.
    """
    ub = float(1 << bit_width)
    n_layers = len(ws)
    sh = list(shifts) if shifts is not None else [0] * (2 * n_layers - 1)
    si = [0]

    def rq(hacc):
        s = sh[si[0]]
        si[0] += 1
        if ste:
            return _requant_ste(hacc, bit_width, s)
        return jnp.clip(hacc / float(1 << s), 0.0, ub)

    if ste:
        ws = _weights_ste(ws, bit_width)
        x = _quantize_ste(x, bit_width)
    h = x
    if model == "gcn":
        for l, w in enumerate(ws):
            h = rq(h @ w)
            if l < n_layers - 1:
                h = rq(a @ h)
        return a @ h
    h = rq(a @ x)
    for w in ws[:-1]:
        h = rq(h @ w)
        h = rq(a @ h)
    return h @ ws[-1]


def calibrate_shifts(
    dataset: GraphDataset,
    batcher: ClusterBatcher,
    qws: Sequence[np.ndarray],
    bit_width: int,
    model: str = "gcn",
    percentile: float = 99.0,
    max_batches: int = 2,
) -> List[int]:
    """Power-of-two requant scales from integer-forward statistics.

    Runs the exact integer dataflow on a few batches; at each requant
    point picks ``s = max(0, round(log2(p99(acc) / 2^bits)))`` so the
    clamp range is actually exercised instead of saturated. Returns
    the ``shifts`` list consumed by the quantized forwards.
    """
    ub = 1 << bit_width
    n_layers = len(qws)
    n_pts = 2 * n_layers - 1
    shifts = [0] * n_pts
    mask_lv = (1 << bit_width) - 1

    def requant(acc, s):
        r = acc >> s
        r = np.where(r > ub, ub - 1, np.where(r < 0, 1, r))
        return r & mask_lv

    batches = batcher.batches[:max_batches]
    for b in batches:
        n = b.num_nodes
        qa = dataset.graph.subgraph_dense(b.nodes).astype(np.int64)
        from qgtc_ppopp22.graph.batching import quantize_np

        qx = (
            quantize_np(batcher.features[b.nodes], bit_width).astype(
                np.int64
            )
            & mask_lv
        )
        si = 0

        def point(acc):
            nonlocal si
            q = float(np.percentile(acc, percentile))
            s = max(0, int(round(np.log2(max(q, 1) / ub)))) if q > ub else 0
            shifts[si] = max(shifts[si], s)
            out = requant(acc, shifts[si])
            si += 1
            return out

        h = qx
        if model == "gcn":
            for l, w in enumerate(qws):
                h = point(h @ (np.asarray(w, np.int64) & mask_lv))
                if l < n_layers - 1:
                    h = point(qa @ h)
        else:
            h = point(qa @ qx)
            for w in qws[:-1]:
                h = point(h @ (np.asarray(w, np.int64) & mask_lv))
                h = point(qa @ h)
        del n
    return shifts


def _dense_batches(dataset: GraphDataset, batcher: ClusterBatcher):
    out = []
    for b in batcher.batches:
        n, pn = b.num_nodes, b.padded_nodes
        a = np.zeros((pn, pn), np.float32)
        a[:n, :n] = dataset.graph.subgraph_dense(b.nodes)
        x = np.zeros((pn, batcher.feat_dim), np.float32)
        x[:n] = batcher.features[b.nodes]
        labels, mask = batch_labels(dataset, b)
        out.append((a, x, labels, mask))
    return out


def _grouped_stacks(
    dataset: GraphDataset,
    batcher: ClusterBatcher,
    multilabel: bool = False,
):
    """Dense batches stacked per shape bucket for scanned epochs.

    Adjacencies stay uint8 on device (cast in-graph): a whole epoch's
    dense A at f32 would be GBs at large buckets; uint8 is 4x smaller
    and the cast fuses into the matmul's operand read. With
    ``multilabel`` the label stack is the (pn, C) multilabel matrix
    (ppi's ``calc_f1`` task, reference ``utils.py:43-60``)."""
    groups: dict = {}
    for b in batcher.batches:
        groups.setdefault(b.padded_nodes, []).append(b)
    out = []
    for pn, bs in groups.items():
        A = np.zeros((len(bs), pn, pn), np.uint8)
        X = np.zeros((len(bs), pn, batcher.feat_dim), np.float32)
        if multilabel:
            C = dataset.multilabels.shape[1]
            L = np.zeros((len(bs), pn, C), np.float32)
        else:
            L = np.zeros((len(bs), pn), np.int32)
        M = np.zeros((len(bs), pn), np.float32)
        for i, b in enumerate(bs):
            n = b.num_nodes
            A[i, :n, :n] = dataset.graph.subgraph_dense(b.nodes)
            X[i, :n] = batcher.features[b.nodes]
            labels, mask = batch_labels(dataset, b)
            if multilabel:
                L[i, :n] = dataset.multilabels[b.nodes]
            else:
                L[i] = labels
            M[i] = mask.astype(np.float32)
        out.append(
            (jnp.asarray(A), jnp.asarray(X), jnp.asarray(L), jnp.asarray(M))
        )
    return out


def train_float_twin(
    dataset: GraphDataset,
    batcher: ClusterBatcher,
    cfg: QModelConfig,
    model: str = "gcn",
    epochs: int = 30,
    lr: float = 5e-3,
    seed: int = 0,
    shifts: Optional[Sequence[int]] = None,
    ste: bool = True,
    init_ws: Optional[Sequence[jnp.ndarray]] = None,
    verbose: bool = False,
    multilabel: bool = False,
) -> Tuple[List[jnp.ndarray], float]:
    """Train the fp32 twin; returns (weights, final train metric).

    With ``ste=True`` the reported metric is the deployed quantized
    one (forward is integer-exact). ``init_ws`` warm-starts. With
    ``multilabel`` the loss is per-class sigmoid BCE on centered
    logits and the metric is micro-F1 at the per-class-mean threshold
    (the deployment threshold ``runtime.evaluate_f1`` calibrates —
    the unsigned weight lattice cannot express a bias, so a
    0-threshold like the reference's ``calc_f1`` would label
    everything positive).
    """
    from qgtc_ppopp22.models.qmodels import init_weights

    ws = (
        [jnp.asarray(w) for w in init_ws]
        if init_ws is not None
        else init_weights(jax.random.PRNGKey(seed), cfg, scale=0.25)
    )
    ub = float(1 << cfg.bit_width)
    opt = optax.adam(lr)
    opt_state = opt.init(ws)
    bit_width, mname = cfg.bit_width, model

    shifts_t = tuple(shifts) if shifts is not None else None

    def _class_mean(logits, mask):
        # masked per-class mean logit — the deployment threshold
        # (see runtime.evaluate_f1)
        return jax.lax.stop_gradient(
            jnp.sum(logits * mask[:, None], axis=0)
            / jnp.maximum(jnp.sum(mask), 1.0)
        )

    def batch_loss(ws, a, x, labels, mask):
        logits = float_twin_forward(
            a, x, ws, bit_width, mname, shifts_t, ste=ste
        )
        # Temperature-normalize for the loss only (argmax/threshold
        # and the deployed engine are unaffected): integer-domain
        # logits reach thousands and saturate softmax/sigmoid grads.
        tau = jnp.maximum(jax.lax.stop_gradient(jnp.std(logits)), 1.0)
        if multilabel:
            z = (logits - _class_mean(logits, mask)[None, :]) / tau
            bce = optax.sigmoid_binary_cross_entropy(z, labels)
            return jnp.sum(
                jnp.mean(bce, axis=-1) * mask
            ) / jnp.maximum(jnp.sum(mask), 1)
        logp = jax.nn.log_softmax(logits / tau, axis=-1)
        nll = -jnp.take_along_axis(logp, labels[:, None], axis=1)[:, 0]
        return jnp.sum(nll * mask) / jnp.maximum(jnp.sum(mask), 1)

    # One dispatch per EPOCH: the per-batch SGD steps run inside a
    # lax.scan per shape bucket with (ws, opt_state) as carry, instead
    # of one dispatch per batch (75/epoch x dozens of epochs x 8 seeds
    # x 4 widths across the ladder).
    @jax.jit
    def epoch_fn(ws, opt_state, groups):
        total = jnp.zeros(())

        def body(carry, batch):
            ws, opt_state, tot = carry
            a8, x, labels, mask = batch
            loss, grads = jax.value_and_grad(batch_loss)(
                ws, a8.astype(jnp.float32), x, labels, mask
            )
            updates, opt_state = opt.update(grads, opt_state)
            ws = optax.apply_updates(ws, updates)
            # Project to [0, 2^bits - 0.51]: a weight that rounds to
            # the level 2^bits would WRAP TO 0 at pack time
            # (kernel.h:226-229) -- catastrophic under STE rounding.
            ws = [jnp.clip(w, 0.0, ub - 0.51) for w in ws]
            return (ws, opt_state, tot + loss), None

        for g in groups:
            (ws, opt_state, total), _ = jax.lax.scan(
                body, (ws, opt_state, total), g
            )
        return ws, opt_state, total

    @jax.jit
    def acc_all(ws, groups):
        c = t = jnp.zeros(())

        def body(carry, batch):
            c, t = carry
            a8, x, labels, mask = batch
            logits = float_twin_forward(
                a8.astype(jnp.float32), x, ws, bit_width, mname,
                shifts_t, ste=ste,
            )
            pred = jnp.argmax(logits, axis=-1)
            return (
                c + jnp.sum((pred == labels) * mask), t + jnp.sum(mask)
            ), None

        for g in groups:
            (c, t), _ = jax.lax.scan(body, (c, t), g)
        return c, t

    @jax.jit
    def f1_all(ws, groups):
        # micro-F1 counters at the per-class-mean threshold
        tp = fp = fn = jnp.zeros(())

        def body(carry, batch):
            tp, fp, fn = carry
            a8, x, labels, mask = batch
            logits = float_twin_forward(
                a8.astype(jnp.float32), x, ws, bit_width, mname,
                shifts_t, ste=ste,
            )
            thr = _class_mean(logits, mask)
            pred = (logits > thr[None, :]).astype(jnp.float32)
            m = mask[:, None]
            tp = tp + jnp.sum(pred * labels * m)
            fp = fp + jnp.sum(pred * (1 - labels) * m)
            fn = fn + jnp.sum((1 - pred) * labels * m)
            return (tp, fp, fn), None

        for g in groups:
            (tp, fp, fn), _ = jax.lax.scan(body, (tp, fp, fn), g)
        return tp, fp, fn

    groups = tuple(_grouped_stacks(dataset, batcher, multilabel))
    n_batches = sum(int(g[0].shape[0]) for g in groups)
    for ep in range(epochs):
        ws, opt_state, total_loss = epoch_fn(ws, opt_state, groups)
        if verbose:
            print(
                f"epoch {ep}: loss {float(total_loss) / n_batches:.4f}"
            )

    if multilabel:
        tp, fp, fn = f1_all(ws, groups)
        tp, fp, fn = float(tp), float(fp), float(fn)
        metric = 2 * tp / max(2 * tp + fp + fn, 1e-9)
    else:
        c, t = acc_all(ws, groups)
        metric = float(c) / max(float(t), 1.0)
    return [jnp.asarray(w) for w in ws], metric


def quantized_accuracy(
    dataset: GraphDataset,
    batcher: ClusterBatcher,
    ws: Sequence[jnp.ndarray],
    bit_width: int,
    model: str = "gcn",
    shifts: Optional[Sequence[int]] = None,
    clamp_bits: Optional[int] = None,
    quant_bits: Optional[int] = None,
) -> float:
    """Accuracy of the real quantized engine with the given weights.

    ``clamp_bits``/``quant_bits`` (default ``bit_width``) narrow the
    requant clamp and the weight quantization grid below the datapath
    width — the exact-emulation deployment of a lower-bit model on a
    wider engine (see :func:`qat_ladder`).
    """
    from qgtc_ppopp22.models.qmodels import pack_weights
    from qgtc_ppopp22.runtime import QGTCEngine

    eng = QGTCEngine(
        feat_dim=batcher.feat_dim,
        num_classes=dataset.num_classes,
        model=model,
        bit_width=bit_width,
        hidden=ws[0].shape[1] if len(ws) > 1 else 16,
        num_layers=len(ws),
        shifts=shifts,
        clamp_bits=clamp_bits,
    )
    eng.float_weights = list(ws)
    eng.weights = pack_weights(
        ws, bit_width, fmt="digits", quant_bits=quant_bits
    )
    return eng.evaluate(batcher, dataset.labels)


def quantized_f1(
    dataset: GraphDataset,
    batcher: ClusterBatcher,
    ws: Sequence[jnp.ndarray],
    bit_width: int,
    model: str = "gcn",
    shifts: Optional[Sequence[int]] = None,
    clamp_bits: Optional[int] = None,
    quant_bits: Optional[int] = None,
) -> dict:
    """Deployed multilabel micro/macro F1 of the real quantized engine
    (reference ``calc_f1`` role, ``utils.py:43-50``; ppi)."""
    from qgtc_ppopp22.models.qmodels import pack_weights
    from qgtc_ppopp22.runtime import QGTCEngine

    eng = QGTCEngine(
        feat_dim=batcher.feat_dim,
        num_classes=dataset.multilabels.shape[1],
        model=model,
        bit_width=bit_width,
        hidden=ws[0].shape[1] if len(ws) > 1 else 16,
        num_layers=len(ws),
        shifts=shifts,
        clamp_bits=clamp_bits,
    )
    eng.float_weights = list(ws)
    eng.weights = pack_weights(
        ws, bit_width, fmt="digits", quant_bits=quant_bits
    )
    return eng.evaluate_f1(batcher, dataset.multilabels)


def _spread_weights(ws, shifts, bit_width: int, model: str):
    """Rescale each weight matrix by a power of two (compensated in
    the requant shift that follows its multiply) so the representable
    levels are exercised — e.g. 1-bit weights trained smoothly tend to
    sit below the 0.5 rounding threshold and would all quantize to 0.
    Neutral for the smooth model; argmax-neutral when the multiply
    feeds the float output directly."""
    ub = (1 << bit_width) - 0.51
    ws2, sh2 = list(ws), list(shifts)
    if bit_width > 2:
        # At >=3 bits the level grid is fine enough that rounding-to-
        # zero is not a failure mode, and inflating the shifts costs
        # accuracy; spreading only pays at 1-2 bits.
        return ws2, sh2
    n = len(ws2)
    for l, w in enumerate(ws2):
        wmax = float(jnp.max(w)) + 1e-9
        k = int(np.floor(np.log2(max(ub * 0.75 / wmax, 1.0))))
        if k <= 0:
            continue
        if model == "gcn":
            pt = 2 * l
        else:  # gin: agg first; last weight feeds f32 logits directly
            pt = 2 * l + 1 if l < n - 1 else None
        ws2[l] = jnp.clip(w * float(2 ** k), 0.0, ub)
        if pt is not None:
            sh2[pt] += k
    return ws2, sh2


def qat_train(
    dataset: GraphDataset,
    batcher: ClusterBatcher,
    cfg: QModelConfig,
    model: str = "gcn",
    smooth_epochs: int = 25,
    ste_epochs: int = 20,
    lr: float = 1e-2,
    seed: int = 0,
    verbose: bool = False,
    multilabel: bool = False,
) -> Tuple[List[jnp.ndarray], List[int], float]:
    """Full QAT recipe -> (weights, shifts, deployed metric).

    1. smooth pretrain (continuous clamp surrogate),
    2. calibrate power-of-two requant shifts on the quantized weights,
    3. STE fine-tune (integer-exact forward),
    4. recalibrate + short STE fine-tune if the shifts moved.
    """
    from qgtc_ppopp22.graph.batching import quantize_np

    from qgtc_ppopp22.models.qmodels import init_weights

    def q(ws):
        return [quantize_np(np.asarray(w), cfg.bit_width) for w in ws]

    # Shifts are calibrated BEFORE any training — an uncalibrated
    # smooth phase saturates and learns nothing to warm-start from.
    # (Init scale 0.25 empirically beats wider inits: large shifts
    # calibrated against wide weights destroy first-layer signal.)
    ws0 = init_weights(jax.random.PRNGKey(seed), cfg, scale=0.25)
    # Adam's step size is absolute; the representable weight range is
    # [0, 2^bits], so scale the lr with the level range or high-bit
    # weights effectively never move.
    lr = lr * max(1.0, (1 << cfg.bit_width) / 8.0)
    shifts = calibrate_shifts(
        dataset, batcher, q(ws0), cfg.bit_width, model
    )
    ws, _ = train_float_twin(
        dataset, batcher, cfg, model, epochs=smooth_epochs, lr=lr,
        seed=seed, shifts=shifts, ste=False, init_ws=ws0,
        verbose=verbose, multilabel=multilabel,
    )
    # Spread weights across the representable levels (shift-
    # compensated), recalibrate on the trained scale, and give the
    # smooth phase one more round with honest shifts before STE
    # hardening.
    ws, shifts = _spread_weights(ws, shifts, cfg.bit_width, model)
    ws, _ = train_float_twin(
        dataset, batcher, cfg, model, epochs=smooth_epochs // 2, lr=lr,
        seed=seed, shifts=shifts, ste=False, init_ws=ws, verbose=verbose,
        multilabel=multilabel,
    )
    ws, shifts = _spread_weights(ws, shifts, cfg.bit_width, model)
    ws, acc = train_float_twin(
        dataset, batcher, cfg, model, epochs=ste_epochs, lr=lr / 2,
        seed=seed, shifts=shifts, ste=True, init_ws=ws, verbose=verbose,
        multilabel=multilabel,
    )
    shifts2 = calibrate_shifts(dataset, batcher, q(ws), cfg.bit_width, model)
    if shifts2 != shifts:
        ws, acc = train_float_twin(
            dataset, batcher, cfg, model, epochs=ste_epochs // 2,
            lr=lr / 4, seed=seed, shifts=shifts2, ste=True, init_ws=ws,
            verbose=verbose, multilabel=multilabel,
        )
        shifts = shifts2
    return ws, shifts, acc


def ladder_feature_scale(bits: int) -> float:
    """Per-bit-width input pre-scale used by :func:`qat_ladder`.

    The reference quantizer's level grid is the integers with range
    [0, 2^bits] (``kernel.h:31-71``); unscaled ~N(0,1)-ish features
    occupy only the bottom few levels at wide bit widths. Scaling by
    ``2^(bits-2)`` (identity at <=2 bits) spreads the same signal over
    the full grid — plain input preprocessing, engine semantics
    untouched — and makes a carried lower-bit solution exactly
    shift-compensable (its first requant shift grows by the log2 of
    the scale ratio).
    """
    return float(1 << max(bits - 2, 0))


def qat_ladder(
    dataset: GraphDataset,
    make_batcher,
    bits_list: Sequence[int],
    model: str = "gcn",
    hidden: int = 16,
    num_layers: int = 3,
    seeds: Sequence[int] = (0, 1, 2),
    ste_epochs: int = 10,
    verbose: bool = False,
    metric: str = "accuracy",
    lrs: Sequence[float] = (1e-2,),
) -> List[dict]:
    """Monotone accuracy frontier: QAT with bit-width laddering.

    In the reference quantization scheme the level grid is always the
    integers and only the *range* grows with bits
    (``round(clip(x, 0, 2^b))``, ``kernel.h:31-71``) — so a higher-bit
    engine can run a lower-bit solution verbatim and only gains
    headroom (the requant clamp saturates later). Round 1's frontier
    was non-monotone because each bit width trained from scratch and
    recalibrated shifts against its own (worse) optimum. Here each bit
    width considers three candidates and keeps the best deployed
    accuracy:

    1. fresh QAT per seed (:func:`qat_train`),
    2. the previous (lower-bit) winner's weights + shifts evaluated
       in this bit width's engine — carrying the SHIFTS matters:
       recalibrating against the carried weights saturates
       (measured: 0.75 recalibrated vs 0.96 carried at 4-bit),
    3. candidate 2 STE-fine-tuned at this bit width,
    4. EXACT EMULATION of the previous winner: operands quantized on
       the winner's native grid (upper digit planes zero) and the
       requant clamp narrowed to the native width
       (``QGTCEngine(clamp_bits=...)``), reproducing its logits
       bit-for-bit on this width's datapath. A wider datapath can
       always run a narrower solution at its own cost, so the
       reported frontier is monotone BY CONSTRUCTION (asserted), not
       by training luck.

    ``make_batcher(bits, feature_scale, quant_bits=None)`` builds the
    bit-width-specific batcher; the ladder passes
    :func:`ladder_feature_scale` so the quantizer's full level grid is
    exercised at every width, and ``quant_bits`` for candidate 4.
    Returns one row dict per bit width (ascending).

    ``metric='f1'`` selects deployed multilabel micro-F1 (ppi's
    ``calc_f1`` task): candidates train with the BCE twin
    (``train_float_twin(multilabel=True)``) and are compared/reported
    by the REAL engine's micro-F1 (``quantized_f1``), with macro-F1
    recorded alongside.
    """
    ml = metric == "f1"

    def _eval(it_, ws_, sh_, clamp_bits=None, quant_bits=None):
        if ml:
            return quantized_f1(
                dataset, it_, ws_, it_.bit_width, model, shifts=sh_,
                clamp_bits=clamp_bits, quant_bits=quant_bits,
            )["f1_micro"]
        return quantized_accuracy(
            dataset, it_, ws_, it_.bit_width, model, shifts=sh_,
            clamp_bits=clamp_bits, quant_bits=quant_bits,
        )

    rows = []
    prev = None  # (bits, ws, shifts, acc, native_bits)
    for bits in sorted(bits_list):
        it = make_batcher(bits, ladder_feature_scale(bits))
        cfg = QModelConfig(
            it.feat_dim, hidden, dataset.num_classes,
            bit_width=bits, num_layers=num_layers,
        )
        candidates = []  # (acc, ws, shifts, how, native_bits)
        # Fresh QAT is high-variance at wide bit widths (the artist
        # GIN probe: only 2/48 grid cells beat the carried floor, both
        # at 4x the default base lr — results/artist_gin_probe.csv),
        # so the fresh pool sweeps lr x seed and the ladder keeps the
        # best deployed metric.
        for lr0 in lrs:
            for seed in seeds:
                ws, sh, acc = qat_train(
                    dataset, it, cfg, model=model, seed=seed,
                    verbose=verbose, multilabel=ml, lr=lr0,
                )
                if ml:  # compare by the DEPLOYED engine's micro-F1
                    acc = _eval(it, ws, sh)
                tag = (
                    f"fresh(seed={seed})"
                    if len(lrs) == 1
                    else f"fresh(seed={seed},lr={lr0:g})"
                )
                candidates.append((acc, ws, sh, tag, bits))
        if prev is not None:
            p_bits, p_ws, p_sh, p_acc, p_native = prev
            # Two carry schedules for the lower-bit winner:
            # * SAME shifts ("carried"): with the ladder's 2^delta
            #   feature scale, every intermediate runs at 2^delta
            #   times the lower-bit value against a 2^delta-wider
            #   clamp — identical *relative* saturation, finer
            #   resolution, argmax-invariant output scale. This is the
            #   scale-invariant emulation that preserves
            #   saturation-reliant models (high-degree graphs).
            # * +delta on the first shift ("collapsed"): maps
            #   intermediates back onto the lower-bit value range, so
            #   the wider clamp never saturates — better when the
            #   lower-bit model was clamp-limited rather than
            #   clamp-reliant.
            delta = int(
                np.log2(
                    ladder_feature_scale(bits)
                    / ladder_feature_scale(p_bits)
                )
            )
            carry_schedules = [(list(p_sh), "carried")]
            if delta:
                carry_schedules.append(
                    ([p_sh[0] + delta] + list(p_sh[1:]), "collapsed")
                )
            for c_sh, tag in carry_schedules:
                acc_carry = _eval(it, p_ws, c_sh)
                candidates.append((acc_carry, p_ws, c_sh, tag, bits))
                ws_ft, acc_ft = train_float_twin(
                    dataset, it, cfg, model, epochs=ste_epochs, lr=5e-3,
                    shifts=c_sh, ste=True, init_ws=p_ws, verbose=verbose,
                    multilabel=ml,
                )
                if ml:
                    acc_ft = _eval(it, ws_ft, list(c_sh))
                candidates.append(
                    (acc_ft, ws_ft, list(c_sh), f"{tag}+ste", bits)
                )
            # Exact emulation: the wider datapath runs the previous
            # winner VERBATIM — inputs and weights quantized on the
            # native (lower-bit) grid so their upper digit planes are
            # zero, intermediates clamped at the native width
            # (clamp_bits). Bit-exact to the previous row's deployment
            # at full bit_width datapath cost, so acc == previous acc
            # by construction and the frontier is monotone by
            # guarantee, not by training luck.
            try:
                it_emu = make_batcher(
                    bits,
                    ladder_feature_scale(p_native),
                    quant_bits=p_native,
                )
            except TypeError:
                it_emu = None  # factory without quant_bits support
            if it_emu is not None:
                acc_emu = _eval(
                    it_emu, p_ws, list(p_sh),
                    clamp_bits=p_native, quant_bits=p_native,
                )
                if acc_emu < p_acc - 1e-9:
                    raise AssertionError(
                        f"exact emulation broke: {acc_emu} < {p_acc} "
                        f"(native {p_native}b on a {bits}b datapath)"
                    )
                candidates.append(
                    (acc_emu, p_ws, list(p_sh),
                     f"emulated({p_native}b)", p_native)
                )
        acc, ws, sh, how, native = max(candidates, key=lambda c: c[0])
        if prev is not None and acc < prev[3] - 1e-6:
            # Dip rescue: re-adapt the best carry schedule with a
            # smooth phase before STE hardening.
            c_sh = list(p_sh)
            ws_s, _ = train_float_twin(
                dataset, it, cfg, model, epochs=ste_epochs, lr=5e-3,
                shifts=c_sh, ste=False, init_ws=p_ws, verbose=verbose,
                multilabel=ml,
            )
            ws_r, acc_r = train_float_twin(
                dataset, it, cfg, model, epochs=ste_epochs + 5, lr=2e-3,
                shifts=c_sh, ste=True, init_ws=ws_s, verbose=verbose,
                multilabel=ml,
            )
            if ml:
                acc_r = _eval(it, ws_r, list(c_sh))
            candidates.append(
                (acc_r, ws_r, list(c_sh), "carried+smooth+ste", bits)
            )
            acc, ws, sh, how, native = max(candidates, key=lambda c: c[0])
        prev = (bits, ws, sh, acc, native)
        row = dict(
            model=model,
            bits=bits,
            accuracy=round(float(acc), 4),
            chance=round(1.0 / dataset.num_classes, 4),
            shifts="/".join(map(str, sh)),
            winner=how,
        )
        if ml:
            full = quantized_f1(
                dataset,
                make_batcher(
                    bits, ladder_feature_scale(native),
                    quant_bits=(native if native != bits else None),
                ),
                ws, bits, model, shifts=list(sh),
                clamp_bits=(native if native != bits else None),
                quant_bits=(native if native != bits else None),
            )
            row["metric"] = "deployed micro-F1 (accuracy col)"
            row["f1_micro"] = round(full["f1_micro"], 4)
            row["f1_macro"] = round(full["f1_macro"], 4)
        rows.append(row)
        if verbose:
            print(rows[-1], flush=True)
    return rows


def save_checkpoint(
    path: str,
    ws: Sequence[jnp.ndarray],
    shifts: Sequence[int],
    cfg: QModelConfig,
    model: str = "gcn",
) -> None:
    """Persist trained float weights + requant shifts + config (npz).

    The reference has no model persistence at all (inference-only,
    ones-weights); this closes the train->deploy loop.
    """
    import os

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(
        path,
        n_weights=len(ws),
        shifts=np.asarray(shifts, np.int64),
        model=model,
        bit_width=cfg.bit_width,
        in_dim=cfg.in_dim,
        hidden=cfg.hidden,
        out_dim=cfg.out_dim,
        num_layers=cfg.num_layers,
        **{f"w{i}": np.asarray(w) for i, w in enumerate(ws)},
    )


def load_checkpoint(path: str):
    """-> (ws, shifts, cfg, model) from :func:`save_checkpoint`."""
    with np.load(path, allow_pickle=False) as z:
        n = int(z["n_weights"])
        ws = [z[f"w{i}"] for i in range(n)]
        shifts = [int(x) for x in z["shifts"]]
        cfg = QModelConfig(
            in_dim=int(z["in_dim"]),
            hidden=int(z["hidden"]),
            out_dim=int(z["out_dim"]),
            bit_width=int(z["bit_width"]),
            num_layers=int(z["num_layers"]),
        )
        model = str(z["model"])
    return ws, shifts, cfg, model
