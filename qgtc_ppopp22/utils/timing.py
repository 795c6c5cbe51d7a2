"""Host-clock timing of device work (the reference's cudaEvent role).

JAX returns before the device finishes, so every timed window here ends
in ``jax.block_until_ready``; a window without it would time the
enqueue. Results carry the device they ran on (:func:`device_info`).
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import jax


def device_info() -> dict:
    """Platform, device kind and device count, as JAX reports them."""
    dev = jax.devices()[0]
    return dict(
        platform=dev.platform,
        kind=dev.device_kind,
        count=len(jax.devices()),
    )


def host_bench(fn: Callable, args: Sequence, iters: int = 100) -> float:
    """Seconds per call of ``fn(*args)``: one warm-up call, then a host
    clock around ``iters`` calls ending in ``block_until_ready``.
    Includes per-call dispatch, as the reference's launch loop does
    (``QGTC_device.cu:409-422``)."""
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


class CompileCounter:
    """Counts backend compilations while active (``with`` block): a
    timed window should hold none."""

    _EVENT = "/jax/core/compile/backend_compile_duration"

    def __init__(self):
        self.count = 0

    def _listen(self, event, duration, **kwargs):
        if event == self._EVENT:
            self.count += 1

    def __enter__(self):
        jax.monitoring.register_event_duration_secs_listener(self._listen)
        return self

    def __exit__(self, *exc):
        from jax._src import monitoring

        monitoring.unregister_event_duration_listener(self._listen)
