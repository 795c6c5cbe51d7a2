import os

import numpy as np
import pytest

from qgtc_ppopp22.utils.cache import setup_compile_cache

setup_compile_cache()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(3)


@pytest.fixture
def gpu():
    """For tests marked ``gpu``: skips unless JAX's default device is a
    GPU (decided here, at run time, never at import)."""
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU; run `python -m pytest -m gpu` on the card")
    return jax.devices()[0]


def run_subprocess(code: str, env_overrides: dict, timeout: int = 600) -> str:
    """Run a python snippet in a fresh interpreter with env overrides
    (multi-device CPU meshes need their XLA flags before JAX starts)."""
    import subprocess
    import sys

    env = dict(os.environ)
    env.update(env_overrides)
    proc = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True,
        text=True,
        timeout=timeout,
        env=env,
        cwd=ROOT,
    )
    if proc.returncode != 0:
        raise AssertionError(
            f"subprocess failed (rc={proc.returncode})\n"
            f"--- stdout ---\n{proc.stdout}\n--- stderr ---\n{proc.stderr}"
        )
    return proc.stdout


def run_on_cpu_mesh(code: str, n_devices: int = 8, timeout: int = 600) -> str:
    """Run a snippet on a virtual multi-device CPU mesh."""
    return run_subprocess(
        code,
        {
            "JAX_PLATFORMS": "cpu",
            "PYTHONPATH": ROOT,
            "XLA_FLAGS": f"--xla_force_host_platform_device_count={n_devices}",
        },
        timeout,
    )
