"""Single-host inference engine: jitted per-bucket steps + epoch loop.

Equivalent of the reference driver's epoch machinery
(``main_qgtc.py:112-159``): iterate pre-packed cluster batches, run the
quantized forward chain, and report the average epoch time over
``n_epochs``.

* One jitted step function; XLA recompiles per *shape bucket* (the
  batcher pads node counts to a few buckets so this stays a handful of
  compilations, vs the reference's shape-per-batch).
* The step consumes the packed **storage format** (8-32x smaller than
  dense) and converts features to the int8 digit **compute format**
  on-device; the packed adjacency feeds the aggregation GEMMs directly.
* ``mode='step'`` dispatches once per batch (the reference's loop);
  ``mode='fused'`` stacks each bucket's batches and runs them in one
  jitted ``lax.scan``: one dispatch per bucket per epoch.
* Timing (:func:`_timed_epochs`): warm-up, then a host clock around the
  epochs ending in ``jax.block_until_ready``; every result names the
  device it ran on.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from qgtc_ppopp22.graph.batching import ClusterBatch, ClusterBatcher
from qgtc_ppopp22.models.baselines import (
    gin_forward,
    init_mlp_weights,
    sage_forward,
)
from qgtc_ppopp22.models.qmodels import (
    QModelConfig,
    init_weights,
    pack_weights,
    qgcn_forward,
    qgin_forward,
)
from qgtc_ppopp22.ops.bitpack import BitTensor
from qgtc_ppopp22.ops.digits import to_digit_tensor
from qgtc_ppopp22.ops.packmm import PackedTensor
from qgtc_ppopp22.utils.timing import CompileCounter, device_info


@dataclasses.dataclass
class EpochStats:
    """``epoch_ms`` holds per-epoch wall times when ``sync_every_epoch``
    was requested, else one average over the window (see
    ``_timed_epochs``). ``compiles`` counts backend compilations inside
    the timed window (0 when every shape was warmed up); ``device``
    names what ran it (platform, kind, count)."""

    epoch_ms: List[float]
    n_batches: int
    compiles: int = 0
    device: dict = dataclasses.field(default_factory=dict)

    @property
    def avg_ms(self) -> float:
        return float(np.mean(self.epoch_ms)) if self.epoch_ms else 0.0


class QGTCEngine:
    """Quantized GNN inference engine (reference ``main_qgtc.py`` role).

    ``model``: ``'gcn'`` (update-then-aggregate, hidden=16 default) or
    ``'gin'`` (aggregate-then-update, hidden=64 default) —
    ``main_qgtc.py:127-154``. ``fmt='digits'`` is the fast path (packed
    adjacency, digit features and weights); ``fmt='bits'`` computes
    from packed bit-planes (kept for parity).
    """

    def __init__(
        self,
        feat_dim: int,
        num_classes: int,
        model: str = "gcn",
        bit_width: int = 2,
        hidden: Optional[int] = None,
        num_layers: int = 3,
        fmt: str = "digits",
        seed: int = 0,
        shifts: Optional[Sequence[int]] = None,
        clamp_bits: Optional[int] = None,
    ):
        if model not in ("gcn", "gin"):
            raise ValueError(f"unknown model {model!r}")
        if hidden is None:
            hidden = 16 if model == "gcn" else 64  # 0_7a…py:6 / 0_7b…py:6
        if clamp_bits is not None and clamp_bits > bit_width:
            raise ValueError("clamp_bits must be <= bit_width")
        self.model = model
        self.bit_width = bit_width
        # Requant clamp width for intermediates. Defaults to the
        # datapath width (reference semantics: clamp to (0, 2^b),
        # kernel.h:347-351). A NARROWER clamp makes this engine
        # reproduce a clamp_bits-wide model bit-exactly while paying
        # full bit_width datapath cost — the deployment form of the
        # accuracy ladder's exact-emulation candidate
        # (models/train.qat_ladder).
        self.clamp_bits = clamp_bits or bit_width
        self.fmt = fmt
        self.cfg = QModelConfig(
            in_dim=feat_dim,
            hidden=hidden,
            out_dim=num_classes,
            bit_width=bit_width,
            num_layers=num_layers,
        )
        self.float_weights = init_weights(jax.random.PRNGKey(seed), self.cfg)
        self.weights = pack_weights(
            self.float_weights,
            bit_width,
            fmt="digits" if fmt == "digits" else "bits",
        )
        fwd = qgcn_forward if model == "gcn" else qgin_forward
        self.shifts = tuple(shifts) if shifts is not None else None
        shifts_t = self.shifts
        out_bits = self.clamp_bits

        def step(a, bit_x: BitTensor, ws):
            # ``a`` is a PackedTensor on the fast path (packed words
            # straight off the host link, unpacked by the aggregation
            # GEMM); a BitTensor on the parity path (fmt='bits').
            x = to_digit_tensor(bit_x) if fmt == "digits" else bit_x
            return fwd(a, x, ws, out_bits=out_bits, shifts=shifts_t)

        self._step = jax.jit(step)
        self._epoch_fn_cache: dict = {}

    # -- single batch ---------------------------------------------------

    def put_batch(self, batch: ClusterBatch):
        """Host->device transfer of the packed storage format."""
        if self.fmt == "digits":
            pn = batch.padded_nodes
            a = PackedTensor(
                words=jax.device_put(batch.a_words), shape=(pn, pn), bits=1
            )
        else:
            a = jax.device_put(batch.bit_A)
        return a, jax.device_put(batch.bit_X)

    def forward_batch(self, batch: ClusterBatch) -> jnp.ndarray:
        a, bit_x = self.put_batch(batch)
        return self._step(a, bit_x, tuple(self.weights))

    # -- epoch loop (reference timing semantics) ------------------------

    def warmup(self, batcher: ClusterBatcher) -> None:
        """Compile every shape bucket outside the timed region."""
        seen = set()
        for b in batcher.batches:
            key = (b.padded_nodes, b.bit_X.shape[1])
            if key not in seen:
                seen.add(key)
                jax.block_until_ready(self.forward_batch(b))

    def run_epochs(
        self,
        batcher: ClusterBatcher,
        n_epochs: int = 20,
        resident: bool = False,
        sync_every_epoch: bool = False,
    ) -> EpochStats:
        """Timed epochs over all cluster batches, one dispatch per batch.

        ``resident=False`` matches the reference's measured region
        (``main_qgtc.py:112-159``): pre-packing excluded, per-step
        host->device transfer of the packed tensors included.
        ``resident=True`` parks the packed batches in device memory
        once (8-32x compressed; a whole epoch's batches fit easily) and
        times compute only.
        """
        staged = None
        if resident:
            staged = [self.put_batch(b) for b in batcher.batches]
        ws = tuple(self.weights)

        def one_epoch():
            if resident:
                return [self._step(a, x, ws) for a, x in staged]
            return [self.forward_batch(b) for b in batcher]

        return _timed_epochs(
            one_epoch, n_epochs, len(batcher), sync_every_epoch
        )

    # -- fused epoch: all batches in one dispatch -----------------------

    def _fused_groups(self, batcher: ClusterBatcher):
        """Stack batches by shape bucket -> [(key, batches, a_stack,
        x_stack)]. ``a_stack`` is the packed word form the aggregation
        GEMMs consume directly."""
        groups: dict = {}
        for b in batcher.batches:
            key = (b.padded_nodes, b.bit_X.shape[1])
            groups.setdefault(key, []).append(b)
        out = []
        for key, bs in groups.items():
            a_stack = np.stack([b.a_words for b in bs])
            x_stack = np.stack([np.asarray(b.bit_X.planes) for b in bs])
            out.append((key, bs, a_stack, x_stack))
        return out

    def _fused_epoch_fn(self, pn: int, xshape) -> "jax.stages.Wrapped":
        """jitted scan over a stacked batch group: one dispatch per
        bucket per epoch instead of one per batch. Cached per
        (pn, xshape) so repeated eval sweeps retrace nothing."""
        key = (pn, tuple(xshape))
        cached = self._epoch_fn_cache.get(key)
        if cached is not None:
            return cached
        fn = jax.jit(self.scan_epoch(pn, xshape))
        self._epoch_fn_cache[key] = fn
        return fn

    def scan_epoch(self, pn: int, xshape):
        """``epoch(stacks, ws) -> logits[B, pn, classes]``: the forward
        of every stacked batch of one bucket under ``lax.scan``
        (unjitted, so the mesh engine can run it per shard)."""
        bit_width = self.bit_width
        out_bits = self.clamp_bits
        fwd = qgcn_forward if self.model == "gcn" else qgin_forward
        shifts_t = self.shifts

        def one(scanned, ws):
            aw, xp = scanned
            a = PackedTensor(words=aw, shape=(pn, pn), bits=1)
            x = to_digit_tensor(
                BitTensor(planes=xp, shape=xshape, bits=bit_width)
            )
            return fwd(a, x, ws, out_bits=out_bits, shifts=shifts_t)

        def epoch(stacks, ws):
            def body(carry, scanned):
                return carry, one(scanned, ws)

            _, outs = jax.lax.scan(body, 0, stacks)
            return outs

        return epoch

    def run_epochs_fused(
        self,
        batcher: ClusterBatcher,
        n_epochs: int = 20,
        sync_every_epoch: bool = False,
    ) -> EpochStats:
        """Resident batches, one scanned dispatch per bucket per epoch."""
        if self.fmt != "digits":
            raise ValueError("fused mode requires fmt='digits'")
        ws = tuple(self.weights)
        staged = []
        for key, bs, a_stack, x_stack in self._fused_groups(batcher):
            fn = self._fused_epoch_fn(key[0], bs[0].bit_X.shape)
            stacks = (jax.device_put(a_stack), jax.device_put(x_stack))
            staged.append((fn, stacks))

        def one_epoch():
            # every bucket's logits are returned and waited on
            return [fn(st, ws) for fn, st in staged]

        return _timed_epochs(
            one_epoch, n_epochs, len(batcher), sync_every_epoch
        )

    # -- in-loop quantization epochs (cluster_gcn.py:181-206 role) ------

    def run_epochs_quant_in_loop(
        self,
        batcher: ClusterBatcher,
        n_epochs: int = 20,
        sync_every_epoch: bool = False,
    ) -> EpochStats:
        """Epochs that quantize + bit-pack X ON DEVICE inside the timed
        region — the reference's variant driver boundary
        (``cluster_gcn.py:181-182,205-206``: ``val2bit`` per batch in
        the loop, quantization NOT pre-packed). Float features enter
        the scan; each step pays quantize -> bit-pack -> digit convert
        before its forward chain. One dispatch per epoch (scan), so the
        measured delta vs :meth:`run_epochs_fused` is exactly the
        in-loop quantization cost."""
        if self.fmt != "digits":
            raise ValueError("quant-in-loop mode requires fmt='digits'")
        from qgtc_ppopp22.ops.bitpack import pack_bits
        from qgtc_ppopp22.ops.quantize import quantize

        ws = tuple(self.weights)
        bit_width = self.bit_width
        out_bits = self.clamp_bits
        fwd = qgcn_forward if self.model == "gcn" else qgin_forward
        shifts_t = self.shifts
        feats = batcher.features
        staged = []
        for key, bs, a_stack, _x in self._fused_groups(batcher):
            pn = key[0]
            xf = np.zeros((len(bs), pn, batcher.feat_dim), np.float32)
            for i, b in enumerate(bs):
                xf[i, : b.num_nodes] = feats[b.nodes]

            def one(scanned, w_):
                aw, x_float = scanned
                a = PackedTensor(words=aw, shape=(pn, pn), bits=1)
                x = to_digit_tensor(pack_bits(
                    quantize(x_float, bit_width), bit_width
                ))
                return fwd(a, x, w_, out_bits=out_bits, shifts=shifts_t)

            @jax.jit
            def epoch(stacks, w_):
                def body(carry, scanned):
                    return carry, one(scanned, w_)

                _, outs = jax.lax.scan(body, 0, stacks)
                return outs

            stacks = (jax.device_put(a_stack), jax.device_put(xf))
            staged.append((epoch, stacks))

        def one_epoch():
            return [fn(st, ws) for fn, st in staged]

        return _timed_epochs(
            one_epoch, n_epochs, len(batcher), sync_every_epoch
        )

    def measure_transfer_ms(
        self, batcher: ClusterBatcher, n_rounds: int = 3
    ) -> float:
        """Wall time to ship one epoch's packed payload host->device
        (the reference's per-step ``cluster.cuda()`` boundary,
        ``main_qgtc.py:115``, measured in isolation). Minimum over
        ``n_rounds`` (transfer is deterministic; min rejects scheduler
        noise)."""
        times = []
        for _ in range(n_rounds):
            t0 = time.perf_counter()
            last = None
            for b in batcher.batches:
                last = self.put_batch(b)
            jax.block_until_ready(last)
            times.append((time.perf_counter() - t0) * 1e3)
        return min(times)

    # -- accuracy -------------------------------------------------------

    def forward_all(self, batcher: ClusterBatcher) -> List[np.ndarray]:
        """Logits for EVERY batch with one dispatch per shape bucket
        (the scanned epoch function), not one per batch. Requires
        ``fmt='digits'``."""
        ws = tuple(self.weights)
        out: dict = {}
        for key, bs, a_stack, x_stack in self._fused_groups(batcher):
            fn = self._fused_epoch_fn(key[0], bs[0].bit_X.shape)
            stacks = (jax.device_put(a_stack), jax.device_put(x_stack))
            res = np.asarray(jax.device_get(fn(stacks, ws)))
            for i, b in enumerate(bs):
                out[id(b)] = res[i]
        return [out[id(b)] for b in batcher.batches]

    def evaluate(self, batcher: ClusterBatcher, labels: np.ndarray) -> float:
        """Masked node-classification accuracy over all batches."""
        correct = total = 0
        if self.fmt == "digits":
            logits_list = self.forward_all(batcher)
        else:
            logits_list = [
                np.asarray(self.forward_batch(b)) for b in batcher.batches
            ]
        for batch, logits in zip(batcher.batches, logits_list):
            pred = logits[: batch.num_nodes].argmax(axis=1)
            lab = labels[batch.nodes]
            correct += int((pred == lab).sum())
            total += batch.num_nodes
        return correct / max(total, 1)

    def evaluate_f1(
        self, batcher: ClusterBatcher, multilabels: np.ndarray
    ) -> dict:
        """Multilabel micro/macro F1 (reference ``calc_f1``/``evaluate``
        role, ``utils.py:43-60``, used for ppi).

        The reference thresholds logits at 0; this engine's integer
        domain is unsigned (levels >= 0, ``kernel.h:31-71``), so raw
        logits are all nonnegative and the threshold is calibrated as
        the per-class mean logit instead (a bias the unsigned weight
        lattice cannot express).
        """
        logit_rows, label_rows = [], []
        if self.fmt == "digits":
            logits_list = self.forward_all(batcher)
        else:
            logits_list = [
                np.asarray(self.forward_batch(b)) for b in batcher.batches
            ]
        for batch, logits in zip(batcher.batches, logits_list):
            logit_rows.append(logits[: batch.num_nodes])
            label_rows.append(multilabels[batch.nodes])
        return _threshold_f1(
            np.concatenate(logit_rows), np.concatenate(label_rows)
        )


class SparseEngine:
    """Full-graph sparse quantized engine (``models/sparse.py`` over
    the whole CSR graph — no clustering, no densification).

    Same run/record interface as :class:`QGTCEngine` so the CLI treats
    every engine uniformly. Supports QAT checkpoints (float weights +
    requant shifts) and accuracy evaluation; exact-integer equivalent
    of the dense engines on the full graph.
    """

    def __init__(
        self,
        dataset,
        model: str = "gcn",
        bit_width: int = 2,
        hidden: Optional[int] = None,
        num_layers: int = 3,
        seed: int = 0,
        shifts: Optional[Sequence[int]] = None,
        float_weights: Optional[Sequence] = None,
    ):
        from qgtc_ppopp22.graph.batching import quantize_np
        from qgtc_ppopp22.models.qmodels import QModelConfig, init_weights
        from qgtc_ppopp22.models.sparse import sparse_q_forward

        if model not in ("gcn", "gin"):
            raise ValueError(model)
        if hidden is None:
            hidden = 16 if model == "gcn" else 64
        self.model = model
        self.bit_width = bit_width
        self.dataset = dataset
        self.cfg = QModelConfig(
            in_dim=dataset.feat_dim,
            hidden=hidden,
            out_dim=dataset.num_classes,
            bit_width=bit_width,
            num_layers=num_layers,
        )
        ws = (
            list(float_weights)
            if float_weights is not None
            else init_weights(jax.random.PRNGKey(seed), self.cfg)
        )
        self.float_weights = ws
        self.shifts = tuple(shifts) if shifts is not None else None
        self._qws = tuple(
            jnp.asarray(quantize_np(np.asarray(w), bit_width)) for w in ws
        )
        self._indptr = jax.device_put(jnp.asarray(dataset.graph.indptr))
        self._indices = jax.device_put(jnp.asarray(dataset.graph.indices))
        self._qx = jax.device_put(
            jnp.asarray(quantize_np(dataset.features, bit_width))
        )
        bw, mn, sh = bit_width, model, self.shifts
        self._fwd = jax.jit(
            lambda ip, ix, x, w: sparse_q_forward(
                ip, ix, x, w, out_bits=bw, model=mn, shifts=sh
            )
        )

    def forward(self) -> jnp.ndarray:
        return self._fwd(self._indptr, self._indices, self._qx, self._qws)

    def run_epochs(
        self, n_epochs: int = 20, sync_every_epoch: bool = False
    ) -> EpochStats:
        return _timed_epochs(self.forward, n_epochs, 1, sync_every_epoch)

    def evaluate(self, labels: np.ndarray) -> float:
        logits = np.asarray(self.forward())
        pred = logits[: len(labels)].argmax(axis=1)
        return float((pred == labels).mean())

    def evaluate_f1(self, multilabels: np.ndarray) -> dict:
        """Multilabel micro/macro F1 (see ``QGTCEngine.evaluate_f1``)."""
        logits = np.asarray(self.forward())[: len(multilabels)]
        return _threshold_f1(logits, multilabels)


class BaselineEngine:
    """Full-precision baseline engine (reference DGL-driver role,
    ``cluster_gcn_dgl.py`` / ``batched_gin_dgl.py``): dense bf16
    aggregation on the tensor cores over the same cluster batches."""

    def __init__(
        self,
        feat_dim: int,
        num_classes: int,
        model: str = "sage",
        hidden: Optional[int] = None,
        num_layers: int = 3,
        seed: int = 0,
    ):
        if hidden is None:
            hidden = 16 if model == "sage" else 64
        dims = [feat_dim] + [hidden] * (num_layers - 1) + [num_classes]
        self.weights = init_mlp_weights(jax.random.PRNGKey(seed), dims)
        fwd = sage_forward if model == "sage" else gin_forward
        self._fwd = fwd

        def step(a_dense, x, ws):
            return fwd(a_dense, x, ws)

        self._step = jax.jit(step)
        self._dense_cache: dict = {}

    def forward_batch(
        self, batch: ClusterBatch, dataset, features=None
    ) -> jnp.ndarray:
        # The DGL baseline ships the subgraph + float features to the
        # device per step (cluster_gcn_dgl.py:97-101); equivalent here:
        # dense uint8 A + f32 X over the link. ``features`` must be
        # the batcher's (which may be precalc-augmented); falls back
        # to the dataset's raw features.
        key = _batch_key(batch)
        if key not in self._dense_cache:
            feats = features if features is not None else dataset.features
            n, pn = batch.num_nodes, batch.padded_nodes
            a = np.zeros((pn, pn), np.uint8)
            a[:n, :n] = dataset.graph.subgraph_dense(batch.nodes)
            x = np.zeros((pn, batch.bit_X.shape[1]), np.float32)
            x[:n] = feats[batch.nodes][:, : batch.bit_X.shape[1]]
            self._dense_cache[key] = (a, x)
        a, x = self._dense_cache[key]
        return self._step(
            jax.device_put(a), jax.device_put(x), tuple(self.weights)
        )

    def run_epochs(
        self,
        batcher,
        dataset,
        n_epochs: int = 20,
        resident: bool = True,
        sync_every_epoch: bool = False,
    ) -> EpochStats:
        for b in batcher.batches:  # warm all buckets + fill dense cache
            jax.block_until_ready(
                self.forward_batch(b, dataset, batcher.features)
            )
        staged = None
        if resident:
            staged = []
            for b in batcher.batches:
                a, x = self._dense_cache[_batch_key(b)]
                staged.append((jax.device_put(a), jax.device_put(x)))
        ws = tuple(self.weights)

        def one_epoch():
            if resident:
                return [self._step(a_d, x_d, ws) for a_d, x_d in staged]
            return [self.forward_batch(b, dataset) for b in batcher]

        return _timed_epochs(
            one_epoch, n_epochs, len(batcher), sync_every_epoch
        )

    def run_epochs_fused(
        self,
        batcher,
        dataset,
        n_epochs: int = 20,
        sync_every_epoch: bool = False,
    ) -> EpochStats:
        """Scan-fused baseline epochs (one dispatch per epoch)."""
        return _baseline_fused_epochs(
            self, batcher, dataset, n_epochs, sync_every_epoch
        )

    def evaluate(self, batcher, dataset, labels: np.ndarray) -> float:
        """Masked argmax accuracy (reference DGL ``evaluate`` role)."""
        correct = total = 0
        for batch in batcher.batches:
            logits = np.asarray(
                self.forward_batch(batch, dataset, batcher.features)
            )
            pred = logits[: batch.num_nodes].argmax(axis=1)
            correct += int((pred == labels[batch.nodes]).sum())
            total += batch.num_nodes
        return correct / max(total, 1)

    def evaluate_f1(self, batcher, dataset, multilabels: np.ndarray) -> dict:
        """Multilabel micro/macro F1 (reference ``calc_f1``,
        ``utils.py:43-60``)."""
        logit_rows, label_rows = [], []
        for batch in batcher.batches:
            logits = np.asarray(
                self.forward_batch(batch, dataset, batcher.features)
            )
            logit_rows.append(logits[: batch.num_nodes])
            label_rows.append(multilabels[batch.nodes])
        return _threshold_f1(
            np.concatenate(logit_rows), np.concatenate(label_rows)
        )


def _baseline_fused_epochs(
    engine: "BaselineEngine",
    batcher,
    dataset,
    n_epochs: int,
    sync_every_epoch: bool,
) -> EpochStats:
    """Scan-fused baseline epochs (one dispatch per bucket, like the
    quantized engine's fused mode). Dense adjacencies are staged uint8
    and cast in-graph."""
    for b in batcher.batches:
        jax.block_until_ready(
            engine.forward_batch(b, dataset, batcher.features)
        )
    groups: dict = {}
    for b in batcher.batches:
        a, x = engine._dense_cache[_batch_key(b)]
        groups.setdefault(a.shape, []).append((a, x))
    ws = tuple(engine.weights)
    fwd = engine._fwd

    staged = []
    for shape, items in groups.items():
        a_stack = jax.device_put(np.stack([a for a, _ in items]))
        x_stack = jax.device_put(np.stack([x for _, x in items]))

        @jax.jit
        def epoch(a_s, x_s, ws_):
            def body(carry, pair):
                a, x = pair
                return carry, fwd(a.astype(jnp.bfloat16), x, ws_)

            _, outs = jax.lax.scan(body, 0, (a_s, x_s))
            return outs

        staged.append((epoch, a_stack, x_stack))

    def one_epoch():
        return [fn(a_s, x_s, ws) for fn, a_s, x_s in staged]

    return _timed_epochs(
        one_epoch, n_epochs, len(batcher), sync_every_epoch
    )


def _threshold_f1(logits: np.ndarray, labels: np.ndarray) -> dict:
    """Micro/macro F1 with per-class mean-logit thresholds.

    The reference thresholds at 0 (``utils.py:44-47``); its float
    models emit signed logits. The quantized engines' logits are
    unsigned, so the equivalent decision boundary is the calibrated
    per-class mean (equivalent to a bias shift before the reference's
    0-threshold).
    """
    from qgtc_ppopp22.utils.metrics import multilabel_f1

    thr = logits.mean(axis=0, keepdims=True)
    centered = logits - thr
    return {
        "f1_micro": multilabel_f1(centered, labels, "micro"),
        "f1_macro": multilabel_f1(centered, labels, "macro"),
    }


def _batch_key(batch: ClusterBatch):
    """Content-derived cache key (``id()`` would dangle if batches
    were ever rebuilt between warmup and the timed run)."""
    return (
        batch.padded_nodes,
        batch.num_nodes,
        hash(batch.nodes.tobytes()),
    )


def _timed_epochs(
    one_epoch, n_epochs: int, n_batches: int, sync_every_epoch: bool
) -> EpochStats:
    """Reference timing semantics (``main_qgtc.py:112-159``): launch
    the epochs, synchronize once, divide. ``one_epoch()`` returns every
    bucket's logits, so no bucket's work is skipped. One warm-up epoch
    first compiles every shape; compilations inside the timed window
    are counted. ``sync_every_epoch=True`` gives per-epoch walls
    instead."""
    jax.block_until_ready(one_epoch())  # compile + warm
    with CompileCounter() as compiles:
        if sync_every_epoch:
            times = []
            for _ in range(n_epochs):
                t0 = time.perf_counter()
                jax.block_until_ready(one_epoch())
                times.append((time.perf_counter() - t0) * 1e3)
        else:
            t0 = time.perf_counter()
            out = None
            for _ in range(n_epochs):
                out = one_epoch()
            jax.block_until_ready(out)
            times = [(time.perf_counter() - t0) * 1e3 / max(n_epochs, 1)]
    return EpochStats(
        epoch_ms=times,
        n_batches=n_batches,
        compiles=compiles.count,
        device=device_info(),
    )
