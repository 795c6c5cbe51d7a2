"""Multi-device execution: mesh-sharded quantized GNN forward.

The reference is strictly single-GPU (SURVEY §2.3 — its only NCCL
reference is a vestigial macro, ``utility.h:94-101``); this layer is
new design: shard node features and adjacency tiles over a
``jax.sharding.Mesh`` built from ``jax.devices()`` (every card reaches
every other at the same rate, so the mesh follows the algorithm) and
let XLA hand the collectives to NCCL.

Two composable axes:

* ``dp`` — data parallelism over *cluster batches* (the natural outer
  axis of the Cluster-GCN dataflow, ``sampler.py:67``): each device
  runs whole batches independently; no cross-device traffic.
* ``sp`` — graph-shard parallelism *within* a batch (the sequence-
  parallel analog for graphs, SURVEY §6): the adjacency is sharded by
  row-tile (each device owns the out-edges into its node rows), node
  features/hiddens are sharded by the same rows, and each aggregation
  ``A @ H`` all-gathers ``H`` (small: hidden<=128 int8 columns)
  while the bit-GEMM against the resident row-shard runs — the
  owner-computes halo pattern. Weight multiplies ``H @ W`` need no
  communication (contraction is over features, which are replicated).

All shard-local GEMMs take the same plain XLA route as the
single-device path (``ops/intmm.py``); collectives are XLA's
(``all_gather``, ``ppermute``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from qgtc_ppopp22.models.qmodels import _mm_to_bits
from qgtc_ppopp22.ops.digits import DigitTensor
from qgtc_ppopp22.ops.intmm import requant_digits
from qgtc_ppopp22.ops.digitmm import (
    digitmm_to_digits,
    digitmm_to_f32,
    digitmm_to_i32,
)


def make_mesh(
    dp: int = 1, sp: int = 1, devices: Optional[Sequence] = None
) -> Mesh:
    """(dp, sp) mesh over the first dp * sp of ``jax.devices()``."""
    devices = list(devices if devices is not None else jax.devices())
    need = dp * sp
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    arr = np.array(devices[:need]).reshape(dp, sp)
    return Mesh(arr, ("dp", "sp"))


def _wrap_digits(arr: jax.Array, shape, bits: int) -> DigitTensor:
    return DigitTensor(digits=arr, shape=shape, bits=bits)


def _make_ring_agg(a_d, nd_a, rows_loc, a_bits, n_sp):
    """Build the ring-pipelined shard-local aggregation ``A @ H``.

    Instead of all-gathering the hidden matrix before each ``A @ H``,
    the hidden shard rotates around the ``sp`` ring with
    ``jax.lax.ppermute`` while each device multiplies its local
    adjacency *column block* against the shard currently in hand:

        out_local = sum_r  A_local[:, cols(r)] @ H_(r)

    — the graph analog of ring attention: per step only ``n/d`` rows
    of H cross a link, and the GEMM for rotation ``r`` can overlap the
    transfer of rotation ``r+1``. Partial sums ride the raw int32
    accumulator (``digitmm_to_i32``), so exactness never depends on
    the f32 mantissa bound regardless of bit width or shard size.
    """
    perm = [(i, (i + 1) % n_sp) for i in range(n_sp)]

    def ring_agg(h_loc, ob, final_shape_cols=None):
        idx = jax.lax.axis_index("sp")
        ncols = h_loc.digits.shape[2]
        acc = jnp.zeros((rows_loc, ncols), jnp.int32)
        cur = h_loc.digits
        src = idx
        for _ in range(n_sp):
            # A column block owned by the shard currently in hand
            blk_start = src * rows_loc
            a_blk = jax.lax.dynamic_slice(
                a_d,
                (0, 0, blk_start),
                (nd_a, rows_loc, rows_loc),
            )
            a_blk_t = _wrap_digits(a_blk, (rows_loc, rows_loc), a_bits)
            h_t = _wrap_digits(cur, (rows_loc, ncols), h_loc.bits)
            acc = acc + digitmm_to_i32(a_blk_t, h_t)
            cur = jax.lax.ppermute(cur, "sp", perm)
            src = jax.lax.rem(src + n_sp - 1, n_sp)
        if ob is None:
            return acc.astype(jnp.float32)
        return DigitTensor(
            digits=requant_digits(acc, ob),
            shape=(rows_loc, h_loc.shape[1]), bits=ob,
        )

    return ring_agg


def sp_gcn_forward_ring(
    mesh: Mesh,
    a: DigitTensor,
    x: DigitTensor,
    ws: Sequence[DigitTensor],
    out_bits: int,
) -> jnp.ndarray:
    """Row-sharded QGCN with ring-pipelined aggregation (see
    :func:`_make_ring_agg`). Bit-exact with :func:`sp_gcn_forward`
    (tested on a CPU mesh)."""
    n_sp = mesh.shape["sp"]
    nd_a, mp, kp = a.digits.shape
    assert mp % n_sp == 0, (mp, n_sp)
    rows_loc = mp // n_sp
    a_bits, x_bits = a.bits, x.bits
    x_shape = x.shape
    w_meta = [(w.shape, w.bits) for w in ws]

    def body(a_d, x_d, *w_ds):
        h = _wrap_digits(x_d, (rows_loc, x_shape[1]), x_bits)
        ws_loc = [
            _wrap_digits(w_d, meta[0], meta[1])
            for w_d, meta in zip(w_ds, w_meta)
        ]
        n_layers = len(ws_loc)
        ring_agg = _make_ring_agg(
            a_d, nd_a, rows_loc, a_bits, n_sp
        )

        for l, w in enumerate(ws_loc):
            h = _mm_to_bits(h, w, out_bits)
            if l < n_layers - 1:
                h = ring_agg(h, out_bits)
        return ring_agg(h, None)

    spec_row = P(None, "sp", None)
    fn = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(spec_row, spec_row) + tuple(P() for _ in ws),
        out_specs=P("sp", None),
        check_vma=False,
    )
    return fn(a.digits, x.digits, *[w.digits for w in ws])[
        : a.shape[0], : ws[-1].shape[1]
    ]


def sp_gin_forward_ring(
    mesh: Mesh,
    a: DigitTensor,
    x: DigitTensor,
    ws: Sequence[DigitTensor],
    out_bits: int,
) -> jnp.ndarray:
    """Row-sharded QGIN with ring-pipelined aggregation
    (aggregate-then-update dataflow, ``main_qgtc.py:131-138``).
    Bit-exact with :func:`sp_gin_forward` (tested on a CPU mesh)."""
    n_sp = mesh.shape["sp"]
    nd_a, mp, kp = a.digits.shape
    assert mp % n_sp == 0, (mp, n_sp)
    rows_loc = mp // n_sp
    a_bits, x_bits = a.bits, x.bits
    x_shape = x.shape
    w_meta = [(w.shape, w.bits) for w in ws]

    def body(a_d, x_d, *w_ds):
        h = _wrap_digits(x_d, (rows_loc, x_shape[1]), x_bits)
        ws_loc = [
            _wrap_digits(w_d, meta[0], meta[1])
            for w_d, meta in zip(w_ds, w_meta)
        ]
        ring_agg = _make_ring_agg(
            a_d, nd_a, rows_loc, a_bits, n_sp
        )

        h = ring_agg(h, out_bits)
        for w in ws_loc[:-1]:
            h = _mm_to_bits(h, w, out_bits)
            h = ring_agg(h, out_bits)
        return digitmm_to_f32(h, ws_loc[-1])

    spec_row = P(None, "sp", None)
    fn = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(spec_row, spec_row) + tuple(P() for _ in ws),
        out_specs=P("sp", None),
        check_vma=False,
    )
    return fn(a.digits, x.digits, *[w.digits for w in ws])[
        : a.shape[0], : ws[-1].shape[1]
    ]


def sp_gin_forward(
    mesh: Mesh,
    a: DigitTensor,
    x: DigitTensor,
    ws: Sequence[DigitTensor],
    out_bits: int,
) -> jnp.ndarray:
    """Row-sharded QGIN forward (aggregate-then-update dataflow)."""
    n_sp = mesh.shape["sp"]
    nd_a, mp, kp = a.digits.shape
    assert mp % n_sp == 0, (mp, n_sp)
    a_bits, x_bits = a.bits, x.bits
    x_shape, a_shape = x.shape, a.shape
    w_meta = [(w.shape, w.bits) for w in ws]

    def body(a_d, x_d, *w_ds):
        rows = a_d.shape[1]
        a_loc = _wrap_digits(a_d, (rows, a_shape[1]), a_bits)
        h = _wrap_digits(x_d, (rows, x_shape[1]), x_bits)
        ws_loc = [
            _wrap_digits(w_d, meta[0], meta[1])
            for w_d, meta in zip(w_ds, w_meta)
        ]

        def agg(h_, ob):
            full = jax.lax.all_gather(h_.digits, "sp", axis=1, tiled=True)
            h_full = _wrap_digits(full, (a_shape[1], h_.shape[1]), h_.bits)
            return digitmm_to_digits(a_loc, h_full, ob)

        h = agg(h, out_bits)
        for w in ws_loc[:-1]:
            h = _mm_to_bits(h, w, out_bits)
            h = agg(h, out_bits)
        return digitmm_to_f32(h, ws_loc[-1])

    spec_row = P(None, "sp", None)
    fn = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(spec_row, spec_row) + tuple(P() for _ in ws),
        out_specs=P("sp", None),
        check_vma=False,
    )
    return fn(a.digits, x.digits, *[w.digits for w in ws])[
        : a.shape[0], : ws[-1].shape[1]
    ]


def sp_gcn_forward(
    mesh: Mesh,
    a: DigitTensor,
    x: DigitTensor,
    ws: Sequence[DigitTensor],
    out_bits: int,
) -> jnp.ndarray:
    """Row-sharded QGCN forward over the mesh's ``sp`` axis.

    ``a``: (n, n) 1-bit digits; rows sharded. ``x``: (n, d) digits;
    rows sharded. Weights replicated. Returns float32 logits sharded
    by rows. Semantics identical to
    :func:`~qgtc_ppopp22.models.qmodels.qgcn_forward`.
    """
    n_sp = mesh.shape["sp"]
    nd_a, mp, kp = a.digits.shape
    assert mp % n_sp == 0, (mp, n_sp)
    a_bits, x_bits = a.bits, x.bits
    x_shape, a_shape = x.shape, a.shape
    w_meta = [(w.shape, w.bits) for w in ws]

    def body(a_d, x_d, *w_ds):
        # shard-local containers (row shard of A and X)
        rows = a_d.shape[1]
        a_loc = _wrap_digits(a_d, (rows, a_shape[1]), a_bits)
        h = _wrap_digits(x_d, (rows, x_shape[1]), x_bits)
        ws_loc = [
            _wrap_digits(w_d, meta[0], meta[1])
            for w_d, meta in zip(w_ds, w_meta)
        ]
        n_layers = len(ws_loc)
        for l, w in enumerate(ws_loc):
            h = _mm_to_bits(h, w, out_bits)
            if l < n_layers - 1:
                h = _aggregate(a_loc, h, out_bits)
        return _aggregate(a_loc, h, None)

    def _aggregate(a_loc, h, ob):
        # all-gather the row-sharded hidden along sp -> full-K operand
        full = jax.lax.all_gather(h.digits, "sp", axis=1, tiled=True)
        h_full = _wrap_digits(
            full, (a_loc.shape[1], h.shape[1]), h.bits
        )
        if ob is None:
            return digitmm_to_f32(a_loc, h_full)
        return digitmm_to_digits(a_loc, h_full, ob)

    spec_row = P(None, "sp", None)  # shard digit rows (axis 1)
    fn = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(spec_row, spec_row) + tuple(P() for _ in ws),
        out_specs=P("sp", None),
        check_vma=False,
    )
    return fn(a.digits, x.digits, *[w.digits for w in ws])[
        : a.shape[0], : ws[-1].shape[1]
    ]


def dp_sp_epoch_step(
    mesh: Mesh,
    a_stack: jax.Array,  # [B, nd_a, n, n] int8 digit planes
    x_stack: jax.Array,  # [B, nd_x, n, d]
    ws: Sequence[DigitTensor],
    out_bits: int,
    a_bits: int = 1,
    x_bits: int = 2,
    model: str = "gcn",
    agg_mode: str = "ring",
) -> jnp.ndarray:
    """Full mesh step: batches over ``dp``, rows over ``sp``.

    ``B`` must be a multiple of ``dp``; each dp group processes its
    batches with the sp-sharded forward. Aggregations use the
    ring-pipelined schedule by default (``agg_mode='ring'``, see
    :func:`_make_ring_agg`; ``'gather'`` selects the all-gather
    variant). Returns [B, n, classes].
    """
    if model not in ("gcn", "gin"):
        raise ValueError(model)
    if agg_mode not in ("ring", "gather"):
        raise ValueError(agg_mode)
    n_sp = mesh.shape["sp"]
    B, nd_a, n, n2 = a_stack.shape
    _, nd_x, _, d = x_stack.shape
    w_meta = [(w.shape, w.bits) for w in ws]

    def one_batch(a_d, x_d, w_ds):
        rows = a_d.shape[1]
        a_loc = _wrap_digits(a_d, (rows, n2), a_bits)
        h = _wrap_digits(x_d, (rows, d), x_bits)
        ws_loc = [
            _wrap_digits(w_d, meta[0], meta[1])
            for w_d, meta in zip(w_ds, w_meta)
        ]
        n_layers = len(ws_loc)

        if agg_mode == "ring":
            agg = _make_ring_agg(
                a_d, nd_a, rows, a_bits, n_sp
            )
        else:
            def agg(h_, ob):
                full = jax.lax.all_gather(
                    h_.digits, "sp", axis=1, tiled=True
                )
                h_full = _wrap_digits(full, (n2, h_.shape[1]), h_.bits)
                if ob is None:
                    return digitmm_to_f32(a_loc, h_full)
                return digitmm_to_digits(a_loc, h_full, ob)

        if model == "gcn":
            for l, w in enumerate(ws_loc):
                h = _mm_to_bits(h, w, out_bits)
                if l < n_layers - 1:
                    h = agg(h, out_bits)
            return agg(h, None)
        # gin: aggregate first, output weight last (no final agg)
        h = agg(h, out_bits)
        for w in ws_loc[:-1]:
            h = _mm_to_bits(h, w, out_bits)
            h = agg(h, out_bits)
        return digitmm_to_f32(h, ws_loc[-1])

    def body(a_s, x_s, *w_ds):
        # a_s: [B/dp, nd_a, n/sp, n]; loop local batches with scan-free
        # python loop (B/dp is small and static)
        outs = []
        for i in range(a_s.shape[0]):
            outs.append(one_batch(a_s[i], x_s[i], w_ds))
        return jnp.stack(outs)

    fn = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P("dp", None, "sp", None), P("dp", None, "sp", None))
        + tuple(P() for _ in ws),
        out_specs=P("dp", "sp", None),
        check_vma=False,
    )
    return fn(a_stack, x_stack, *[w.digits for w in ws])


def shard_batches(
    mesh: Mesh, a_stack: np.ndarray, x_stack: np.ndarray
) -> Tuple[jax.Array, jax.Array]:
    """Place stacked packed batches with (dp, sp) sharding."""
    sh = NamedSharding(mesh, P("dp", None, "sp", None))
    return jax.device_put(a_stack, sh), jax.device_put(x_stack, sh)
