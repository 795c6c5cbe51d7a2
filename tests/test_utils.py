"""Utility tests: metrics vs sklearn, logging, host benchmarking."""

import os

import numpy as np

from qgtc_ppopp22.utils import (
    Logger,
    f1_score,
    host_bench,
    multilabel_f1,
    write_csv,
    write_json_line,
)


def test_f1_matches_sklearn(rng):
    from sklearn.metrics import f1_score as sk_f1

    y_true = rng.integers(0, 5, 500)
    y_pred = rng.integers(0, 5, 500)
    for avg in ("micro", "macro"):
        ours = f1_score(y_true, y_pred, num_classes=5, average=avg)
        theirs = sk_f1(y_true, y_pred, average=avg)
        assert abs(ours - theirs) < 1e-9, (avg, ours, theirs)


def test_multilabel_f1_matches_sklearn(rng):
    from sklearn.metrics import f1_score as sk_f1

    logits = rng.standard_normal((200, 7)).astype(np.float32)
    labels = (rng.random((200, 7)) < 0.3).astype(np.int64)
    for avg in ("micro", "macro"):
        ours = multilabel_f1(logits, labels, average=avg)
        theirs = sk_f1(
            labels, (logits > 0).astype(np.int64), average=avg,
            zero_division=0,
        )
        assert abs(ours - theirs) < 1e-9, (avg, ours, theirs)


def test_logger_and_csv(tmp_path):
    log = Logger(str(tmp_path / "run.log"))
    log.write("hello")
    log.write("world")
    lines = open(tmp_path / "run.log").read().strip().splitlines()
    assert len(lines) == 2 and lines[0].endswith("hello")

    rows = [dict(a=1, b="x"), dict(a=2, b="y")]
    write_csv(str(tmp_path / "out.csv"), rows, ["a", "b"])
    content = open(tmp_path / "out.csv").read().strip().splitlines()
    assert content[0] == "a,b" and len(content) == 3

    line = write_json_line(str(tmp_path / "out.jsonl"), dict(m=1.5))
    assert '"m": 1.5' in line
    assert os.path.exists(tmp_path / "out.jsonl")


def test_host_bench_runs():
    import jax.numpy as jnp

    t = host_bench(lambda x: x + 1, (jnp.zeros((8, 128)),), iters=3)
    assert t > 0


def test_device_info_names_the_device():
    from qgtc_ppopp22.utils import device_info

    info = device_info()
    assert info["platform"] == "cpu"
    assert info["kind"] and info["count"] >= 1


def test_compile_counter_counts_only_inside():
    import jax
    import jax.numpy as jnp

    from qgtc_ppopp22.utils.timing import CompileCounter

    f = jax.jit(lambda x: x * 3 + 1)
    x = jnp.arange(7.0)
    with CompileCounter() as c:
        jax.block_until_ready(f(x))
    assert c.count >= 1
    with CompileCounter() as warm:
        jax.block_until_ready(f(x))
    assert warm.count == 0


def test_compile_cache_env_wins(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the helper sets nothing."""
    import jax

    from qgtc_ppopp22.utils.cache import setup_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert setup_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    """Without the variable: one fixed, gitignored directory inside the
    checkout (no pid, time or temp name)."""
    import jax

    from qgtc_ppopp22.utils.cache import CACHE_DIR, setup_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert CACHE_DIR == os.path.join(root, ".jax_cache")
    assert setup_compile_cache() == CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == CACHE_DIR
    ignored = open(os.path.join(root, ".gitignore")).read().split()
    assert ".jax_cache/" in ignored


def test_bench_refuses_without_gpu(capsys):
    import bench

    assert bench.main(["--n-epochs", "1"]) != 0
    assert "metric" not in capsys.readouterr().out
