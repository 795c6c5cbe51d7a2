"""QAT training: STE fidelity and learnability."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from qgtc_ppopp22.graph import ClusterBatcher, synthesize
from qgtc_ppopp22.graph.batching import quantize_np
from qgtc_ppopp22.models.qmodels import (
    QModelConfig,
    init_weights,
    pack_weights,
    qgcn_forward,
)
from qgtc_ppopp22.models.train import (
    _dense_batches,
    calibrate_shifts,
    float_twin_forward,
    qat_train,
    quantized_accuracy,
)
from qgtc_ppopp22.ops.digits import digit_pack


@pytest.fixture(scope="module")
def ds_it():
    ds = synthesize("Proteins", scale=0.04, seed=7)
    it = ClusterBatcher(ds, 8, 2, bit_width=2, bucket_rows=512,
                       shuffle=False)
    return ds, it


def test_ste_twin_is_integer_exact(ds_it):
    """The STE forward equals the deployed engine bit-for-bit."""
    ds, it = ds_it
    bits = 2
    cfg = QModelConfig(it.feat_dim, 16, ds.num_classes, bit_width=bits)
    ws = init_weights(jax.random.PRNGKey(3), cfg, scale=0.4)
    qws = [quantize_np(np.asarray(w), bits) for w in ws]
    shifts = calibrate_shifts(ds, it, qws, bits)

    a, x, _, _ = _dense_batches(ds, it)[0]
    twin = np.asarray(
        float_twin_forward(
            jnp.asarray(a), jnp.asarray(x), ws, bits, shifts=shifts
        )
    )
    da = digit_pack(jnp.asarray(a.astype(np.int32)), 1)
    dx = digit_pack(jnp.asarray(quantize_np(x, bits)), bits)
    dws = pack_weights(ws, bits, fmt="digits")
    eng = np.asarray(
        qgcn_forward(da, dx, dws, out_bits=bits, shifts=shifts)
    )
    np.testing.assert_array_equal(twin, eng)


def test_shifted_golden_matches_engine(rng):
    """shifts thread consistently through golden + kernel paths."""
    from qgtc_ppopp22.models.qmodels import qgcn_golden
    from tests.golden import quantize_np as qnp

    bits = 2
    n, dim = 256, 32
    a = (rng.random((n, n)) < 0.05).astype(np.int32)
    qx = qnp(rng.standard_normal((n, dim)) * 2 + 1, bits)
    cfg = QModelConfig(dim, 16, 8, bit_width=bits)
    ws = init_weights(jax.random.PRNGKey(5), cfg)
    qws = [qnp(np.asarray(w), bits) for w in ws]
    shifts = [1, 2, 1, 2, 1]

    da = digit_pack(jnp.asarray(a), 1)
    dx = digit_pack(jnp.asarray(qx), bits)
    dws = [digit_pack(jnp.asarray(q), bits) for q in qws]
    got = np.asarray(
        qgcn_forward(da, dx, dws, out_bits=bits, shifts=shifts)
    )
    want = qgcn_golden(a, qx, qws, bits, bits, shifts=shifts)
    np.testing.assert_array_equal(got, want.astype(np.float32))


def test_qat_learns_above_chance(ds_it):
    """End-to-end QAT reaches well above chance at 2 bits, and the
    deployed engine reproduces the training accuracy exactly."""
    ds, it = ds_it
    cfg = QModelConfig(it.feat_dim, 16, ds.num_classes, bit_width=2)
    best = 0.0
    for seed in (0, 1):
        ws, sh, acc = qat_train(
            ds, it, cfg, smooth_epochs=20, ste_epochs=12, seed=seed
        )
        if acc > best:
            best = acc
            q_acc = quantized_accuracy(ds, it, ws, 2, shifts=sh)
            assert abs(q_acc - acc) < 1e-9
    assert best > 0.65, best  # chance = 0.5

def test_checkpoint_roundtrip(tmp_path, ds_it):
    from qgtc_ppopp22.models.train import (
        load_checkpoint,
        save_checkpoint,
    )

    ds, it = ds_it
    cfg = QModelConfig(it.feat_dim, 16, ds.num_classes, bit_width=2)
    ws = init_weights(jax.random.PRNGKey(11), cfg)
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, ws, [1, 2, 1, 2, 1], cfg, model="gcn")
    ws2, sh2, cfg2, model2 = load_checkpoint(path)
    assert sh2 == [1, 2, 1, 2, 1] and cfg2 == cfg and model2 == "gcn"
    for a, b in zip(ws, ws2):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_wide_engine_emulates_narrow_exactly(ds_it):
    """A b-bit datapath reproduces a 2-bit model bit-for-bit when fed
    the 2-bit grid (``quant_bits=2``: upper digit planes zero) with
    the requant clamp narrowed (``clamp_bits=2``) — the deployment
    form of the accuracy ladder's exact-emulation candidate, which
    makes the committed frontier monotone by construction."""
    from qgtc_ppopp22.runtime import QGTCEngine

    ds, it2 = ds_it
    it8 = ClusterBatcher(
        ds, 8, 2, bit_width=8, bucket_rows=512, shuffle=False,
        quant_bits=2,
    )
    for model in ("gcn", "gin"):
        eng2 = QGTCEngine(
            feat_dim=it2.feat_dim, num_classes=ds.num_classes,
            model=model, bit_width=2, seed=5,
        )
        eng8 = QGTCEngine(
            feat_dim=it8.feat_dim, num_classes=ds.num_classes,
            model=model, bit_width=8, clamp_bits=2, seed=5,
        )
        eng8.float_weights = list(eng2.float_weights)
        eng8.weights = pack_weights(
            eng2.float_weights, 8, fmt="digits", quant_bits=2
        )
        for b2, b8 in zip(it2.batches, it8.batches):
            got2 = np.asarray(eng2.forward_batch(b2))
            got8 = np.asarray(eng8.forward_batch(b8))
            np.testing.assert_array_equal(got2, got8)


def test_quant_bits_guards():
    ds = synthesize("Proteins", scale=0.04, seed=7)
    with pytest.raises(ValueError):
        ClusterBatcher(ds, 8, 2, bit_width=2, quant_bits=4)
    with pytest.raises(ValueError):
        pack_weights([jnp.ones((4, 4))], 2, fmt="digits", quant_bits=4)
