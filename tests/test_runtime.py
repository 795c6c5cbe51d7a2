"""Engine + CLI tests (fast CPU path, small synthetic graphs)."""

import numpy as np
import pytest

from qgtc_ppopp22.graph import ClusterBatcher, synthesize
from qgtc_ppopp22.runtime import BaselineEngine, QGTCEngine


@pytest.fixture(scope="module")
def small():
    ds = synthesize("Proteins", scale=0.02, seed=5)
    it = ClusterBatcher(
        ds, 4, 2, bit_width=2, bucket_rows=256, shuffle=False
    )
    return ds, it


@pytest.mark.parametrize("fmt", ["digits", "bits"])
def test_engine_formats_agree(small, fmt):
    ds, it = small
    eng = QGTCEngine(
        feat_dim=it.feat_dim,
        num_classes=ds.num_classes,
        bit_width=2,
        fmt=fmt,
        seed=1,
    )
    out = np.asarray(eng.forward_batch(it.batches[0]))
    assert out.shape == (it.batches[0].padded_nodes, ds.num_classes)
    # digits and bits paths share weights derivation from the same
    # float init -> identical quantized weights -> identical logits
    eng2 = QGTCEngine(
        feat_dim=it.feat_dim,
        num_classes=ds.num_classes,
        bit_width=2,
        fmt="digits" if fmt == "bits" else "bits",
        seed=1,
    )
    out2 = np.asarray(eng2.forward_batch(it.batches[0]))
    np.testing.assert_array_equal(out, out2)


def test_engine_zerotile_agrees(small):
    ds, it = small
    kw = dict(
        feat_dim=it.feat_dim, num_classes=ds.num_classes,
        bit_width=2, seed=2,
    )
    """Two engines of the same seed agree; the batches carry pack-time
    zero-tile counts consistent with their packed adjacency."""
    from qgtc_ppopp22.ops.packmm import build_tile_map_packed_np

    one, two = QGTCEngine(**kw), QGTCEngine(**kw)
    a = np.asarray(one.forward_batch(it.batches[0]))
    b = np.asarray(two.forward_batch(it.batches[0]))
    np.testing.assert_array_equal(a, b)
    for batch in it.batches:
        kidx, kcnt = build_tile_map_packed_np(batch.a_words, 1)
        np.testing.assert_array_equal(kcnt, batch.tile_kcnt)
        assert kidx.shape == (batch.padded_nodes // 256,) * 2


def test_engine_epochs_and_eval(small):
    ds, it = small
    eng = QGTCEngine(
        feat_dim=it.feat_dim, num_classes=ds.num_classes, bit_width=2
    )
    st = eng.run_epochs(it, n_epochs=2, sync_every_epoch=True)
    assert len(st.epoch_ms) == 2 and st.n_batches == len(it)
    # reference methodology: one sync at the end -> single amortized avg
    st2 = eng.run_epochs(it, n_epochs=2, resident=True)
    assert len(st2.epoch_ms) == 1 and st2.avg_ms > 0
    acc = eng.evaluate(it, ds.labels)
    assert 0.0 <= acc <= 1.0


def test_engine_fused_and_mega_match_stepwise(small):
    """The scanned (fused) epoch == the per-batch step, every batch."""
    ds, it = small
    eng = QGTCEngine(
        feat_dim=it.feat_dim, num_classes=ds.num_classes, bit_width=2,
        seed=4,
    )
    st = eng.run_epochs_fused(it, n_epochs=1)
    assert st.avg_ms > 0 and st.compiles == 0
    assert st.device["platform"] == "cpu" and st.device["count"] >= 1
    for b, got in zip(it.batches, eng.forward_all(it)):
        np.testing.assert_array_equal(got, np.asarray(eng.forward_batch(b)))


def _golden_logits(eng, batch, bits, shifts):
    from qgtc_ppopp22.models import qgcn_golden, qgin_golden
    from qgtc_ppopp22.ops.bitpack import unpack_bits
    from tests.golden import quantize_np

    qa = np.asarray(unpack_bits(batch.bit_A))
    qx = np.asarray(unpack_bits(batch.bit_X))
    qws = [quantize_np(np.asarray(w), bits) for w in eng.float_weights]
    gold = qgcn_golden if eng.model == "gcn" else qgin_golden
    return gold(qa, qx, qws, bits, bits, shifts=shifts).astype(np.float32)


@pytest.mark.parametrize("shifts", [None, (1, 2, 1, 2, 1)])
@pytest.mark.parametrize("model", ["gcn", "gin"])
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_engine_fused_step_golden(small, bits, model, shifts):
    """Engine level, every bit width (the 8-bit signed/two-digit chain
    included) x model x requant shifts: fused == step == golden."""
    ds, it = small
    it = it.rebit(bits)
    eng = QGTCEngine(
        feat_dim=it.feat_dim, num_classes=ds.num_classes, model=model,
        bit_width=bits, seed=bits, shifts=shifts,
    )
    fused = eng.forward_all(it)
    for b, got in zip(it.batches, fused):
        step = np.asarray(eng.forward_batch(b))
        np.testing.assert_array_equal(got, step)
        np.testing.assert_array_equal(
            got, _golden_logits(eng, b, bits, shifts)
        )


def test_gin_engine(small):
    ds, it = small
    eng = QGTCEngine(
        feat_dim=it.feat_dim,
        num_classes=ds.num_classes,
        model="gin",
        bit_width=2,
    )
    assert eng.cfg.hidden == 64  # reference 0_7b…py:6
    out = np.asarray(eng.forward_batch(it.batches[0]))
    assert out.shape == (it.batches[0].padded_nodes, ds.num_classes)


def test_baseline_engine_precalc(small):
    """--use-pp path: baseline must consume the batcher's augmented
    features (regression: crashed reading dataset.features)."""
    ds, _ = small
    it = ClusterBatcher(
        ds, 4, 2, bit_width=2, bucket_rows=256, precalc=True,
        shuffle=False,
    )
    eng = BaselineEngine(
        feat_dim=it.feat_dim, num_classes=ds.num_classes, model="sage"
    )
    st = eng.run_epochs(it, ds, n_epochs=1)
    assert st.avg_ms > 0


def test_mega_nonstandard_buckets_and_gin_layers(small):
    """Scanned epoch: 256-multiple buckets and 1/2-layer GIN chains."""
    ds, _ = small
    it = ClusterBatcher(ds, 4, 2, bit_width=2, bucket_rows=256,
                        shuffle=False)
    for nl in (1, 2):
        eng = QGTCEngine(
            feat_dim=it.feat_dim, num_classes=ds.num_classes,
            model="gin", bit_width=2, num_layers=nl,
        )
        st = eng.run_epochs_fused(it, n_epochs=1)
        assert st.avg_ms > 0
        for b, got in zip(it.batches, eng.forward_all(it)):
            np.testing.assert_array_equal(
                got, np.asarray(eng.forward_batch(b))
            )


def test_baseline_mega_matches_stepwise(small):
    """The scanned bf16 baseline epoch == the per-step baseline forward
    (same bf16 operands and f32 accumulation on the same backend)."""
    import jax
    import jax.numpy as jnp

    ds, it = small
    eng = BaselineEngine(
        feat_dim=it.feat_dim, num_classes=ds.num_classes, model="sage"
    )
    ref = np.asarray(eng.forward_batch(it.batches[0], ds, it.features))
    st = eng.run_epochs_fused(it, ds, n_epochs=1)
    assert st.avg_ms > 0
    b = it.batches[0]
    a, x = eng._dense_cache[
        (b.padded_nodes, b.num_nodes, hash(b.nodes.tobytes()))
    ]
    out = jax.lax.map(
        lambda ax: eng._fwd(ax[0].astype(jnp.bfloat16), ax[1],
                            tuple(eng.weights)),
        (jnp.asarray(a)[None], jnp.asarray(x)[None]),
    )
    np.testing.assert_allclose(
        np.asarray(out[0]), ref, rtol=1e-5, atol=1e-4
    )


def test_baseline_engine(small):
    ds, it = small
    eng = BaselineEngine(
        feat_dim=it.feat_dim, num_classes=ds.num_classes, model="sage"
    )
    st = eng.run_epochs(it, ds, n_epochs=2, sync_every_epoch=True)
    assert len(st.epoch_ms) == 2
    st = eng.run_epochs(it, ds, n_epochs=2)
    assert len(st.epoch_ms) == 1 and st.avg_ms > 0


def test_cli_main(small, tmp_path, capsys):
    from qgtc_ppopp22.cli import main

    rc = main([
        "--dataset", "Proteins", "--dataset-scale", "0.02",
        "--psize", "4", "--batch-size", "2", "--n-epochs", "1",
        "--bit_width", "2", "--use_QGTC", "--cache-dir", str(tmp_path),
        "--json-out", str(tmp_path / "out.jsonl"),
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Avg. Epoch:" in out
    assert (tmp_path / "out.jsonl").exists()


def test_sparse_engine_matches_sparse_forward(small):
    """SparseEngine == direct sparse_q_forward; evaluate in [0, 1]."""
    import jax.numpy as jnp

    from qgtc_ppopp22.graph.batching import quantize_np
    from qgtc_ppopp22.models.sparse import sparse_q_forward
    from qgtc_ppopp22.runtime import SparseEngine

    ds, _ = small
    eng = SparseEngine(ds, model="gcn", bit_width=2, seed=7)
    got = np.asarray(eng.forward())
    want = np.asarray(
        sparse_q_forward(
            jnp.asarray(ds.graph.indptr),
            jnp.asarray(ds.graph.indices),
            jnp.asarray(quantize_np(ds.features, 2)),
            eng._qws,
            out_bits=2,
            model="gcn",
        )
    )
    np.testing.assert_array_equal(got, want)
    st = eng.run_epochs(2, sync_every_epoch=True)
    assert len(st.epoch_ms) == 2
    assert 0.0 <= eng.evaluate(ds.labels) <= 1.0


def test_cli_sparse_engine(small, tmp_path, capsys):
    """--sparse routes through SparseEngine; unsupported flags warn."""
    from qgtc_ppopp22.cli import main

    rc = main([
        "--dataset", "Proteins", "--dataset-scale", "0.02",
        "--n-epochs", "1", "--bit_width", "2", "--sparse",
        "--use-pp", "--eval-accuracy",
        "--json-out", str(tmp_path / "sp.jsonl"),
    ])
    assert rc == 0
    cap = capsys.readouterr()
    assert "Avg. Epoch:" in cap.out
    assert "accuracy:" in cap.out
    assert "--use-pp has no effect" in cap.err


def test_ppi_multilabel_f1_end_to_end(tmp_path, capsys):
    """ppi carries multilabels; engines + CLI report micro/macro F1
    (reference calc_f1/evaluate role, utils.py:43-60)."""
    from qgtc_ppopp22.cli import main

    ds = synthesize("ppi", scale=0.01, seed=3)
    assert ds.multilabels is not None
    assert ds.multilabels.shape == (ds.num_nodes, ds.num_classes)
    it = ClusterBatcher(ds, 4, 2, bit_width=2, bucket_rows=256,
                        shuffle=False)
    eng = QGTCEngine(
        feat_dim=it.feat_dim, num_classes=ds.num_classes, bit_width=2
    )
    f1 = eng.evaluate_f1(it, ds.multilabels)
    assert 0.0 <= f1["f1_micro"] <= 1.0 and 0.0 <= f1["f1_macro"] <= 1.0

    beng = BaselineEngine(
        feat_dim=it.feat_dim, num_classes=ds.num_classes, model="sage"
    )
    beng.run_epochs(it, ds, n_epochs=1)
    f1b = beng.evaluate_f1(it, ds, ds.multilabels)
    assert 0.0 <= f1b["f1_micro"] <= 1.0

    rc = main([
        "--dataset", "ppi", "--dataset-scale", "0.01",
        "--psize", "4", "--batch-size", "2", "--n-epochs", "1",
        "--use_QGTC", "--eval-accuracy", "--cache-dir", str(tmp_path),
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "F1-mic:" in out and "F1-mac:" in out


def test_cli_checkpoint_roundtrip(small, tmp_path, capsys):
    """QAT -> save_checkpoint -> CLI --weights end-to-end."""
    import jax

    from qgtc_ppopp22.cli import main
    from qgtc_ppopp22.models.qmodels import QModelConfig, init_weights
    from qgtc_ppopp22.models.train import save_checkpoint

    ds, it = small
    cfg = QModelConfig(it.feat_dim, 16, ds.num_classes, bit_width=2)
    ws = init_weights(jax.random.PRNGKey(21), cfg)
    ck = str(tmp_path / "model.npz")
    save_checkpoint(ck, ws, [1, 2, 1, 2, 1], cfg, model="gcn")

    rc = main([
        "--dataset", "Proteins", "--dataset-scale", "0.02",
        "--psize", "4", "--batch-size", "2", "--n-epochs", "1",
        "--use_QGTC", "--weights", ck, "--eval-accuracy",
        "--cache-dir", str(tmp_path),
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "loaded checkpoint: gcn, 2-bit" in out
    assert "accuracy:" in out


def test_engine_mega_resident_compact_smoke(small):
    """Resident step epochs, transfer-inclusive step epochs and fused
    epochs all time the same engine; each result names its device."""
    ds, it = small
    eng = QGTCEngine(feat_dim=it.feat_dim, num_classes=ds.num_classes,
                     bit_width=2, seed=6)
    groups = eng._fused_groups(it)
    assert sum(len(g[1]) for g in groups) == len(it)
    for st in (
        eng.run_epochs(it, n_epochs=1, resident=True),
        eng.run_epochs(it, n_epochs=1, resident=False),
        eng.run_epochs_fused(it, n_epochs=1),
    ):
        assert st.avg_ms > 0 and st.n_batches == len(it)
        assert st.compiles == 0 and st.device["platform"] == "cpu"
