"""Multi-process bring-up helpers.

The reference has no distributed execution (SURVEY §2.3). The code in
:mod:`qgtc_ppopp22.parallel.sharded` and ``parallel/engine.py`` runs
unchanged across processes; only process bring-up differs:

1. every process runs the same program and calls :func:`initialize`
   first, with the coordinator address, process count and process id,
2. the mesh comes from :func:`pod_mesh`: ``dp`` spans processes
   (cluster batches are independent; the only cross-process traffic is
   the initial shard placement), ``sp`` stays within a process's local
   devices,
3. each process stages its own share of the cluster batches
   (:func:`host_batch_slice`) and calls the same jitted step.

Bit-exact two-process execution is tested on CPU devices
(``tests/test_parallel.py``).
"""

from __future__ import annotations

from typing import Optional

import jax

from qgtc_ppopp22.parallel.sharded import make_mesh


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """``jax.distributed.initialize`` wrapper; no-op when
    single-process. Nothing discovers a cluster here: pass the
    coordinator address (``host:port``), the process count and this
    process's id."""
    if num_processes is not None and num_processes <= 1:
        return
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def pod_mesh(sp_per_host: Optional[int] = None):
    """(dp, sp) mesh over all processes' devices.

    ``sp`` defaults to the local device count so the sp collectives
    stay within a process; ``dp`` takes the remaining factor.
    """
    n = jax.device_count()
    sp = sp_per_host or jax.local_device_count()
    while n % sp:
        sp //= 2
    sp = max(sp, 1)
    return make_mesh(dp=n // sp, sp=sp)


def host_batch_slice(n_batches: int) -> slice:
    """This process's contiguous share of the epoch's cluster batches."""
    p = jax.process_index()
    np_ = jax.process_count()
    per = -(-n_batches // np_)
    return slice(p * per, min((p + 1) * per, n_batches))
