"""MeshEngine: the production engine on a (dp, sp) device mesh.

Runs the same product as the single-device engine, on the packed
storage format (``graph/batching.ClusterBatch.a_words``):

* with ``sp == 1`` each device runs the single-device scanned epoch
  (``runtime.QGTCEngine.scan_epoch``) on its ``dp`` shard of every
  bucket's stacked batches, under ``shard_map``. Cluster batches are
  independent, so there are no collectives at steady state;
* with ``sp > 1`` the adjacency rows are ring-sharded and the
  shard-local GEMMs run through the same route
  (``parallel/packed.dp_sp_epoch_packed``);
* reachable from the CLI via ``--mesh DP,SP`` (``qgtc_ppopp22/cli.py``),
  timed with the same ``_timed_epochs`` as every other engine.

Multi-process: when ``jax.process_count() > 1`` each process stages only
its ``host_batch_slice`` share of every stacked group and the global
arrays are assembled shard-wise (no full-array broadcast).

The reference has no distributed path (SURVEY §2.3); single-device
semantics anchor to ``main_qgtc.py:112-159``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import jax
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from qgtc_ppopp22.graph.batching import ClusterBatcher
from qgtc_ppopp22.ops.bitpack import (
    DIGIT_BITS,
    BitTensor,
    num_digits,
)
from qgtc_ppopp22.ops.intmm import pad_width
from qgtc_ppopp22.parallel.multihost import host_batch_slice
from qgtc_ppopp22.parallel.packed import dp_sp_epoch_packed
from qgtc_ppopp22.parallel.sharded import make_mesh

__all__ = ["MeshEngine", "x_digits_np"]


def x_digits_np(bit_x: BitTensor, pn: int) -> np.ndarray:
    """Packed feature planes -> int8 digit planes, host-side.

    [bits, Mw, Kp256] words -> int8[nd, pn, pad_width(K)], the same
    trim ``ops/digits.to_digit_tensor`` applies on device, so the mesh
    path consumes bit-identical operands to the single-device one.
    """
    planes = np.asarray(bit_x.planes)
    bits = bit_x.bits
    _, K = bit_x.shape
    kp = pad_width(K)
    j = np.arange(32, dtype=np.uint32)[None, None, :, None]
    ones = (planes[:, :, None, :] >> j) & np.uint32(1)
    ones = ones.reshape(bits, -1, planes.shape[2])  # [bits, Mw*32, Kp]
    nd = num_digits(bits)
    out = []
    for d in range(nd):
        lo = d * DIGIT_BITS
        hi = min(lo + DIGIT_BITS, bits)
        acc = ones[lo].copy()
        for b in range(lo + 1, hi):
            acc |= ones[b] << np.uint32(b - lo)
        out.append(acc[:pn, :kp].astype(np.int8))
    return np.stack(out)


class MeshEngine:
    """Quantized GNN engine over a ``(dp, sp)`` mesh, packed format.

    Construction mirrors :class:`~qgtc_ppopp22.runtime.QGTCEngine` (it
    builds one, so weights are identical for the same seed/config and
    outputs are bit-exact against it); ``dp * sp`` must not exceed the
    device count.
    """

    def __init__(
        self,
        feat_dim: int,
        num_classes: int,
        dp: int = 1,
        sp: int = 1,
        model: str = "gcn",
        bit_width: int = 2,
        hidden: Optional[int] = None,
        num_layers: int = 3,
        seed: int = 0,
        shifts: Optional[Sequence[int]] = None,
        clamp_bits: Optional[int] = None,
        devices: Optional[Sequence] = None,
    ):
        from qgtc_ppopp22.runtime import QGTCEngine

        self.single = QGTCEngine(
            feat_dim, num_classes, model=model, bit_width=bit_width,
            hidden=hidden, num_layers=num_layers, seed=seed, shifts=shifts,
            clamp_bits=clamp_bits,
        )
        self.mesh = make_mesh(dp, sp, devices)
        self.dp, self.sp = dp, sp
        self.model = model
        self.bit_width = bit_width
        self.clamp_bits = self.single.clamp_bits
        self.shifts = self.single.shifts
        self.cfg = self.single.cfg
        self.float_weights = self.single.float_weights
        self.weights = self.single.weights

    # -- staging ---------------------------------------------------------

    def _put(self, arr: np.ndarray, spec: P):
        sh = NamedSharding(self.mesh, spec)
        if jax.process_count() == 1:
            return jax.device_put(arr, sh)
        # Multi-process: ``arr`` is this process's host_batch_slice
        # share of the batch axis; assemble the global array from local
        # shards without any cross-process broadcast.
        return jax.make_array_from_process_local_data(sh, arr)

    def _dp_fn(self, pn: int, xshape):
        """The single-device scanned epoch, per dp shard."""
        epoch = self.single.scan_epoch(pn, xshape)
        return jax.shard_map(
            epoch,
            mesh=self.mesh,
            in_specs=((P("dp"), P("dp")), P()),
            out_specs=P("dp"),
            check_vma=False,
        )

    def _sp_fn(self, x_cols: int):
        mesh, model = self.mesh, self.model
        ob, sh_t, xb = self.clamp_bits, self.shifts, self.bit_width

        def fn(t, w_):
            return dp_sp_epoch_packed(
                mesh, t[0], t[1], w_, ob, x_bits=xb, model=model,
                shifts=sh_t, x_cols=x_cols,
            )

        return fn

    def stage(self, batcher: ClusterBatcher) -> None:
        """Build + place every shape bucket's stacked epoch arrays and
        jit one epoch function over all of them."""
        if batcher.bit_width != self.bit_width:
            raise ValueError(
                f"batcher bit width {batcher.bit_width} != engine "
                f"{self.bit_width}"
            )
        self.single.weights = self.weights
        self._staged = []  # (fn, args, bs_real, pn)
        multi = jax.process_count() > 1
        for key, bs, a_np, x_np in self.single._fused_groups(batcher):
            pn = key[0]
            if pn % (self.sp * 256):
                raise ValueError(
                    f"bucket pn={pn} not divisible by sp*256="
                    f"{self.sp * 256}; rebuild the batcher with "
                    f"bucket_rows a multiple of {self.sp * 256}"
                )
            Bp = -(-len(bs) // self.dp) * self.dp
            sl = host_batch_slice(Bp) if multi else slice(0, Bp)

            def local(arr):
                # pad the batch axis to a multiple of dp (repeating the
                # last batch), then keep this process's share
                pad = np.repeat(arr[-1:], Bp - len(arr), axis=0)
                return np.concatenate([arr, pad])[sl]

            if self.sp == 1:
                args = tuple(
                    self._put(local(h), P("dp", *([None] * (h.ndim - 1))))
                    for h in (a_np, x_np)
                )
                fn = self._dp_fn(pn, bs[0].bit_X.shape)
            else:
                xd = np.stack([x_digits_np(b.bit_X, pn) for b in bs])
                args = (
                    self._put(local(a_np), P("dp", None, "sp", None)),
                    self._put(local(xd), P("dp", None, "sp", None)),
                )
                fn = self._sp_fn(self.cfg.in_dim)
            self._staged.append((fn, args, bs, pn))

        staged = self._staged

        def epoch_all(all_args, w_):
            # every bucket's logits are returned
            return tuple(s[0](t, w_) for s, t in zip(staged, all_args))

        self._epoch_all = jax.jit(epoch_all)
        self._all_args = tuple(s[1] for s in staged)
        self._ws = tuple(self.weights)

    # -- epochs ----------------------------------------------------------

    def run_epochs(
        self,
        batcher: ClusterBatcher,
        n_epochs: int = 20,
        sync_every_epoch: bool = False,
    ):
        from qgtc_ppopp22.runtime import _timed_epochs

        self.stage(batcher)
        return _timed_epochs(
            lambda: self._epoch_all(self._all_args, self._ws),
            n_epochs, len(batcher), sync_every_epoch,
        )

    # -- exactness / accuracy ---------------------------------------------

    def forward_batches(self, batcher: ClusterBatcher) -> List[np.ndarray]:
        """Logits per real batch, [num_nodes, num_classes] each —
        de-padded and sliced for exactness tests and evaluation.
        Single-process only (gathers full outputs to the host)."""
        if not hasattr(self, "_staged"):
            self.stage(batcher)
        outs = jax.device_get(self._epoch_all(self._all_args, self._ws))
        per_batch = {}
        for (fn, args, bs, pn), o in zip(self._staged, outs):
            for i, b in enumerate(bs):
                per_batch[id(b)] = np.asarray(
                    o[i][: b.num_nodes, : self.cfg.out_dim]
                )
        return [per_batch[id(b)] for b in batcher.batches]

    def evaluate(self, batcher: ClusterBatcher, labels: np.ndarray) -> float:
        correct = total = 0
        for b, logits in zip(
            batcher.batches, self.forward_batches(batcher)
        ):
            pred = logits.argmax(axis=1)
            correct += int((pred == labels[b.nodes]).sum())
            total += b.num_nodes
        return correct / max(total, 1)
