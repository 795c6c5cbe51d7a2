"""chip_smoke.py's phases at toy size on the CPU (the script itself
runs them at full size on the card), and its refusal without a GPU."""

import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke
from tests.conftest import ROOT, run_on_cpu_mesh

TOY = dict(dataset="Proteins", psize=4, batch=2, scale=0.02)


def test_phase0_refuses_cpu():
    with pytest.raises(SystemExit):
        chip_smoke.phase0()
    assert chip_smoke.phase0(require_gpu=False)


def test_phase1_toy_exact():
    n = chip_smoke.phase1(pn=1024, widths=(16, 64), bit_list=(1, 8),
                          x_shape=(512, 32))
    assert n == 2 * 2 * 2 + 2


@pytest.mark.parametrize("config", chip_smoke.CONFIGS, ids=lambda c: c[0])
def test_phase2_toy_golden(config):
    n = chip_smoke.phase2(data=TOY, configs=(config,), n_epochs=1)
    assert n >= 3  # >= 1 bucket per mode, plus the bf16 baseline


def test_phase3_toy_mesh():
    code = (
        "import chip_smoke\n"
        "toy = dict(dataset='Proteins', psize=8, batch=2, scale=0.05)\n"
        "n = chip_smoke.phase3(data=toy, n_epochs=1)\n"
        "print('PHASE3', n)\n"
    )
    out = run_on_cpu_mesh(code, n_devices=4, timeout=600)
    assert "PHASE3 8" in out


def test_main_exits_nonzero_without_gpu(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_alone_in_a_directory_fails(tmp_path):
    """Without the rest of the repo the script fails and prints no
    result."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.gpu
def test_phase1_on_the_card(gpu):
    """Every GEMM at real widths, compiled for the GPU (skips here)."""
    assert chip_smoke.phase1() == 2 * 2 * 4 + 4
