from qgtc_ppopp22.parallel.sharded import (
    dp_sp_epoch_step,
    make_mesh,
    shard_batches,
    sp_gcn_forward,
    sp_gcn_forward_ring,
    sp_gin_forward,
    sp_gin_forward_ring,
)
from qgtc_ppopp22.parallel.multihost import (
    host_batch_slice,
    initialize,
    pod_mesh,
)
from qgtc_ppopp22.parallel.packed import dp_sp_epoch_packed
from qgtc_ppopp22.parallel.engine import MeshEngine, x_digits_np
