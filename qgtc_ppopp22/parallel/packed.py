"""Multi-device execution of the packed fast path.

``parallel/sharded.py`` runs the mesh math on dense int8 digit planes.
This module runs the same ``(dp, sp)`` meshes on the **storage format
the single-device engine ships**: the packed adjacency words of
:class:`~qgtc_ppopp22.ops.packmm.PackedTensor`.

:func:`dp_sp_epoch_packed` shards batches over ``dp`` and each batch's
adjacency *rows* over ``sp``. Aggregations use the ring schedule of
``parallel/sharded.py``: the hidden shard rotates via
``jax.lax.ppermute`` while each device multiplies its local packed
**column block** against the shard in hand, through the plain XLA
route (``ops/packmm.packmm_to_i32``) with int32-exact partials. XLA
hands the ``ppermute`` to NCCL on GPUs. (Batches sharded over ``dp``
alone run the single-device scanned epoch per shard:
``parallel/engine.MeshEngine``.)

The reference is single-GPU (SURVEY §2.3; its one NCCL trace is a
vestigial macro, ``utility.h:94-101``). Single-device parity semantics
anchor to the reference's epoch loop (``main_qgtc.py:112-159``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from qgtc_ppopp22.ops.digits import DigitTensor
from qgtc_ppopp22.ops.digitmm import digitmm_to_digits, digitmm_to_f32
from qgtc_ppopp22.ops.intmm import requant_digits
from qgtc_ppopp22.ops.packmm import TILE, PackedTensor, packmm_to_i32

__all__ = ["dp_sp_epoch_packed"]

_VPW = 32  # adjacency columns per packed word (1-bit)


def _make_ring_agg_packed(a_words, nd_a, rows_loc, n_sp):
    """Ring-pipelined ``A @ H`` where A is the shard's packed words.

    ``a_words``: int32[nd_a, rows_loc, pn//32], this device's row block
    of the batch adjacency in the packed storage layout. At rotation
    ``r`` the device multiplies the column block owned by the shard
    whose hidden rows are currently in hand:

        out_local = sum_r  packmm(A_local[:, cols(r)], H_(r))

    Partials stay int32, so exactness never depends on the f32
    mantissa bound. A column range of A is a contiguous range of words
    (the layout packs along K).
    """
    perm = [(i, (i + 1) % n_sp) for i in range(n_sp)]
    kw_loc = rows_loc // _VPW

    def ring_agg(h_loc: DigitTensor, ob, shift: int = 0):
        idx = jax.lax.axis_index("sp")
        ncols = h_loc.digits.shape[2]
        acc = jnp.zeros((rows_loc, ncols), jnp.int32)
        cur = h_loc.digits
        src = idx
        for _ in range(n_sp):
            w_blk = jax.lax.dynamic_slice(
                a_words, (0, 0, src * kw_loc), (nd_a, rows_loc, kw_loc)
            )
            a_blk = PackedTensor(
                words=w_blk, shape=(rows_loc, rows_loc), bits=1
            )
            h_t = DigitTensor(
                digits=cur, shape=(rows_loc, h_loc.shape[1]),
                bits=h_loc.bits,
            )
            acc = acc + packmm_to_i32(a_blk, h_t)
            cur = jax.lax.ppermute(cur, "sp", perm)
            src = jax.lax.rem(src + n_sp - 1, n_sp)
        if ob is None:
            return acc.astype(jnp.float32)
        return DigitTensor(
            digits=requant_digits(acc, ob, shift),
            shape=(rows_loc, h_loc.shape[1]), bits=ob,
        )

    return ring_agg


def dp_sp_epoch_packed(
    mesh: Mesh,
    a_stack: jax.Array,  # int32[B, nd_a, pn, pn//32] packed words
    x_stack: jax.Array,  # int8[B, nd_x, pn, xp] feature digits
    ws: Sequence[DigitTensor],
    out_bits: int,
    x_bits: int = 2,
    model: str = "gcn",
    shifts: Optional[Sequence[int]] = None,
    x_cols: Optional[int] = None,
) -> jnp.ndarray:
    """Mesh step on the packed storage format: batches over ``dp``,
    adjacency rows + feature rows over ``sp``; each device scans its
    local batches.

    ``x_cols``: the features' real (unpadded) column count — the
    contraction extent against the first weight's logical rows.

    ``B`` must divide by ``dp`` and ``pn`` by ``sp * 256`` (whole
    256-row tiles per shard). Semantics identical to the
    single-device :func:`~qgtc_ppopp22.models.qmodels.qgcn_forward`
    / ``qgin_forward`` on each batch; returns [B, pn, cls_padded]
    float32 logits.
    """
    if model not in ("gcn", "gin"):
        raise ValueError(model)
    n_sp = mesh.shape["sp"]
    B, nd_a, pn, kw = a_stack.shape
    _, nd_x, pnx, xp = x_stack.shape
    if kw * _VPW != pn or pn != pnx:
        raise ValueError(f"bad stacks {a_stack.shape} / {x_stack.shape}")
    if pn % (n_sp * TILE):
        raise ValueError(
            f"pn={pn} must divide by sp*{TILE}={n_sp * TILE} "
            "(whole row tiles per shard)"
        )
    rows_loc = pn // n_sp
    w_meta = [(w.shape, w.bits) for w in ws]
    n_layers = len(ws)
    sh = list(shifts) if shifts is not None else [0] * (2 * n_layers - 1)

    xc = xp if x_cols is None else int(x_cols)

    def one_batch(a_w, x_d, w_ds):
        h = DigitTensor(digits=x_d, shape=(rows_loc, xc), bits=x_bits)
        ws_loc = [
            DigitTensor(digits=w_d, shape=m[0], bits=m[1])
            for w_d, m in zip(w_ds, w_meta)
        ]
        ring_agg = _make_ring_agg_packed(a_w, nd_a, rows_loc, n_sp)
        if model == "gcn":
            si = 0
            for l, w in enumerate(ws_loc):
                h = digitmm_to_digits(h, w, out_bits, shift=sh[si])
                si += 1
                if l < n_layers - 1:
                    h = ring_agg(h, out_bits, sh[si])
                    si += 1
            return ring_agg(h, None)
        # gin: aggregate-then-update (main_qgtc.py:131-138)
        si = 0
        h = ring_agg(h, out_bits, sh[si])
        si += 1
        for w in ws_loc[:-1]:
            h = digitmm_to_digits(h, w, out_bits, shift=sh[si])
            si += 1
            h = ring_agg(h, out_bits, sh[si])
            si += 1
        return digitmm_to_f32(h, ws_loc[-1])

    def body(a_s, x_s, *w_ds):
        def step(carry, ax):
            return carry, one_batch(ax[0], ax[1], w_ds)

        return jax.lax.scan(step, 0, (a_s, x_s))[1]

    fn = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P("dp", None, "sp", None), P("dp", None, "sp", None))
        + tuple(P() for _ in ws),
        out_specs=P("dp", "sp", None),
        check_vma=False,
    )
    return fn(a_stack, x_stack, *[w.digits for w in ws])
